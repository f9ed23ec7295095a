"""The structured event journal: a bounded in-process ring of typed
operational events.

Counterpart of dragnet_tpu/obs/events.py (whole).  Each entry carries
the wall time it happened, a monotonically increasing sequence
number, the event type, the active request's trace id when one exists
(always None in the port, which has no tracing runtime yet) and the
event's own attributes.  In the port the emitters are the follow
loop's publish pauses (`resource.paused`, coalesced by emit_burst)
and the resource governor's mode transitions (`resource.mode`).

Off by default, **zero allocations when disabled**: every emit site
calls ``emit(...)``, which is one module-global None check when no
journal is installed.  Arm with DN_EVENTS (ring capacity) and/or
DN_EVENTS_FILE (JSONL spill; implies a default ring) through
``install``.  The optional file spill appends one JSON line per
event, fsync-free: a crash loses the tail.  The spill is SIZE-BOUNDED
(DN_EVENTS_FILE_MAX_MB, default 64; 0 disables): past the cap it
rotates to ``<path>.1``.  A spill write failure (including an armed
or real ENOSPC at the ``events.spill`` seam) disables the spill
(counted), never the ring.
"""

import json
import os
import threading
import time

EVENTS_VERSION = 1

# default ring capacity when DN_EVENTS_FILE arms the journal without
# an explicit DN_EVENTS size
DEFAULT_RING = 1024

# coalescing window for burst-prone events (emit_burst): at most one
# entry per (type, key) per window; suppressed occurrences flush as
# one aggregated `coalesced`-count entry when the window ends
BURST_WINDOW_S = 1.0

# default spill size cap (DN_EVENTS_FILE_MAX_MB): past it the file
# rotates to `<path>.1` (one predecessor kept, both filtered as
# `.dn_events*` durable tree metadata when spilled inside an index
# tree) — a busy member's telemetry must never fill its own disk
DEFAULT_SPILL_MAX_MB = 64


def spill_max_bytes(env=None):
    """The parsed-but-forgiving DN_EVENTS_FILE_MAX_MB spill cap in
    BYTES (config.obs_config rejects malformed values; a live reader
    must not crash on an env edit).  0 disables rotation."""
    if env is None:
        env = os.environ
    raw = env.get('DN_EVENTS_FILE_MAX_MB')
    if raw is None or raw == '':
        return DEFAULT_SPILL_MAX_MB << 20
    try:
        return max(0, int(raw)) << 20
    except ValueError:
        return DEFAULT_SPILL_MAX_MB << 20


def events_env(env=None):
    """(ring_capacity, spill_path): the parsed-but-forgiving view of
    DN_EVENTS / DN_EVENTS_FILE (config.obs_config REJECTS malformed
    values; a live reader must not crash on an env edit)."""
    if env is None:
        env = os.environ
    path = env.get('DN_EVENTS_FILE') or None
    raw = env.get('DN_EVENTS')
    ring = 0
    if raw:
        try:
            ring = max(0, int(raw))
        except ValueError:
            ring = 0
    if ring == 0 and path:
        ring = DEFAULT_RING
    return ring, path


class EventJournal(object):
    """The bounded ring + optional JSONL spill.  Thread-safe; reads
    (tail) and writes (record) contend on one short lock."""

    def __init__(self, capacity, path=None, member=None,
                 max_bytes=None):
        self.capacity = max(1, int(capacity))
        self.path = path
        self.member = member
        # spill rotation cap (bytes; 0 = unbounded): the file rotates
        # to `<path>.1` once an append would cross it
        self.max_bytes = spill_max_bytes() if max_bytes is None \
            else max(0, int(max_bytes))
        self.rotations = 0
        self._spill_bytes = None     # lazily stat'd current size
        self._lock = threading.Lock()
        # the spill's own lock: ring appends must never wait on disk
        # I/O (a slow spill target would otherwise serialize every
        # emit site behind it)
        self._spill_lock = threading.Lock()
        self._ring = []
        self._start = 0          # ring slot 0's position
        self.seq = 0             # last assigned sequence number
        self.dropped = 0         # evicted from the ring
        self.spill_errors = 0
        self._spill_dead = False
        # (etype, key) -> [window_t0, suppressed_count, last_attrs]
        self._bursts = {}

    # -- writing ----------------------------------------------------------

    def record(self, etype, trace=None, **attrs):
        """Append one event; returns its sequence number."""
        ent = {'ts': round(time.time(), 3), 'type': etype}
        if self.member is not None:
            ent['member'] = self.member
        if trace is None:
            # join the active trace when one exists: the event line
            # and the DN_TRACE line share the id
            from . import trace as mod_trace
            tctx = mod_trace.current_trace()
            trace = tctx.trace_id if tctx is not None else None
        ent['trace'] = trace
        if attrs:
            ent.update({k: v for k, v in attrs.items()
                        if v is not None})
        with self._lock:
            self.seq += 1
            ent['seq'] = self.seq
            self._ring.append(ent)
            if len(self._ring) > self.capacity:
                del self._ring[0]
                self.dropped += 1
        self._spill(ent)
        return ent['seq']

    def record_burst(self, etype, key=None, **attrs):
        """Coalesced emission for burst-prone events (shed storms):
        at most one journal entry per (type, `key`) per
        BURST_WINDOW_S.  The first occurrence of a window records
        immediately (an operator watching `dn events --follow` sees
        the storm begin, not its end); occurrences suppressed inside
        a window flush as ONE aggregated entry carrying `coalesced`
        when the window ends — on the next same-keyed emission, or on
        the next journal read (_flush_bursts), so a storm's tail is
        never silently uncounted.  `key` scopes the window (e.g. the
        shed reason) so distinct flavors do not fold into each
        other's counts; high-cardinality attrs (tenant) stay OUT of
        the key on purpose — one window per tenant would re-create
        the ring flush coalescing exists to prevent."""
        now = time.monotonic()
        wkey = (etype, key)
        with self._lock:
            ent = self._bursts.get(wkey)
            if ent is not None and now - ent[0] < BURST_WINDOW_S:
                ent[1] += 1
                ent[2] = attrs
                return None
            pending = ent[1] if ent is not None else 0
            pattrs = ent[2] if ent is not None else None
            self._bursts[wkey] = [now, 0, None]
        if pending:
            self.record(etype, coalesced=pending, **(pattrs or {}))
        return self.record(etype, **attrs)

    def _flush_bursts(self):
        """Flush every EXPIRED burst window's suppressed count as an
        aggregated entry (readers call this, so `dn events` after a
        storm sees its full size even when no later event arrives)."""
        now = time.monotonic()
        flush = []
        with self._lock:
            for wkey, ent in self._bursts.items():
                if ent[1] and now - ent[0] >= BURST_WINDOW_S:
                    flush.append((wkey[0], ent[1], ent[2]))
                    ent[1] = 0
                    ent[2] = None
        for etype, pending, pattrs in flush:
            self.record(etype, coalesced=pending, **(pattrs or {}))

    def _spill(self, ent):
        if self.path is None or self._spill_dead:
            return
        from .. import faults as mod_faults
        try:
            line = json.dumps(ent, sort_keys=True,
                              separators=(',', ':')) + '\n'
            # append + flush, no fsync: telemetry must never pay
            # durability's latency; a crash loses the tail.  Under
            # the spill's OWN lock — ring appends never wait on disk
            with self._spill_lock:
                # the resource-exhaustion seam: a spill failure
                # (injected or real ENOSPC) disables the spill, never
                # the ring — counted below
                mod_faults.fire('events.spill')
                if self._spill_bytes is None:
                    try:
                        self._spill_bytes = os.path.getsize(self.path)
                    except OSError:
                        self._spill_bytes = 0
                if self.max_bytes and self._spill_bytes > 0 and \
                        self._spill_bytes + len(line) > \
                        self.max_bytes:
                    # size-bounded rotation: keep exactly one
                    # predecessor (`<path>.1`), so the spill's disk
                    # footprint is bounded by ~2x the cap
                    os.replace(self.path, self.path + '.1')
                    self._spill_bytes = 0
                    self.rotations += 1
                with open(self.path, 'a') as f:
                    f.write(line)
                self._spill_bytes += len(line)
        except (OSError, mod_faults.FaultInjected):
            with self._lock:
                self.spill_errors += 1
                self._spill_dead = True

    # -- reading ----------------------------------------------------------

    def tail(self, since=0, limit=None):
        """Entries with seq > `since`, oldest first, at most `limit`
        (the newest ones when limited — a tail, not a head)."""
        self._flush_bursts()
        with self._lock:
            if since <= 0:
                out = list(self._ring)
            else:
                out = [e for e in self._ring if e['seq'] > since]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def doc(self):
        """The /stats `events` section: versioned summary, never the
        entries themselves (the `events` op returns those — /stats
        must stay bounded)."""
        with self._lock:
            return {'version': EVENTS_VERSION, 'enabled': True,
                    'capacity': self.capacity, 'seq': self.seq,
                    'buffered': len(self._ring),
                    'dropped': self.dropped,
                    'file': self.path,
                    'file_max_bytes': self.max_bytes,
                    'rotations': self.rotations,
                    'spill_errors': self.spill_errors}


def disabled_doc():
    """The `events` section when no journal is installed:
    shape-stable, zero storage."""
    return {'version': EVENTS_VERSION, 'enabled': False,
            'capacity': 0, 'seq': 0, 'buffered': 0, 'dropped': 0,
            'file': None, 'file_max_bytes': 0, 'rotations': 0,
            'spill_errors': 0}


# -- module-global journal (the emit sites' target) -------------------------

_JOURNAL = None


def install(capacity=None, path=None, member=None, env=None):
    """Install the process journal from explicit values or the
    DN_EVENTS / DN_EVENTS_FILE environment; returns it (None when
    disabled).  The reference's `dn serve` calls this at bind; tests
    call it directly."""
    global _JOURNAL
    if capacity is None and path is None:
        capacity, path = events_env(env)
    elif capacity is None:
        capacity = DEFAULT_RING
    if not capacity:
        _JOURNAL = None
        return None
    _JOURNAL = EventJournal(capacity, path=path, member=member)
    return _JOURNAL


def uninstall():
    global _JOURNAL
    _JOURNAL = None


def journal():
    return _JOURNAL


def enabled():
    return _JOURNAL is not None


def emit(etype, **attrs):
    """Record one event in the process journal.  THE cost contract:
    one module-global None check and an immediate return when the
    journal is disabled — no dict, no string, no lock."""
    j = _JOURNAL
    if j is None:
        return None
    return j.record(etype, **attrs)


def emit_burst(etype, **attrs):
    """emit() with per-type BURST_WINDOW_S coalescing — for events
    that arrive in storms (load shedding) and would otherwise evict
    everything else from the ring."""
    j = _JOURNAL
    if j is None:
        return None
    return j.record_burst(etype, **attrs)
