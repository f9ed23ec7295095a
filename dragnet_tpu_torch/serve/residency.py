"""Device-memory residency for `dn serve`: keep the device lane's hot
state on the card across requests, and fetch only final results.

Counterpart of dragnet_tpu/serve/residency.py.  A resident server (a)
uploads each staged shard's index columns at most once while they stay
valid, (b) keeps the folded accumulator on the card between requests,
and (c) pays the D2H fetch once per distinct accumulator, not once per
request.  A repeat of the same stacked aggregation answers from the
pinned accumulator with no transfer in either direction.

Entries pin two things: the device-side accumulator (the device bytes
`bytes` reports) and its one fetched host copy (what a hit returns,
byte-identical by construction — it IS the array the first execution
produced).  Keyed by the content digest of the staged host inputs
(`content_key`, the same bytes the reference hashes), so two requests
whose stacked columns differ can never alias.

Invalidation is the result cache's epoch contract (serve/qcache.py):
`index_query_mt.cache_epoch()`, bumped by the server's
`install_writer_invalidation` hook on every completed in-process index
write.  Any write anywhere retires every pinned entry.  `clear()`
drops every device reference at drain so the caching allocator can
reuse the memory.

CUDA hazards the reference's jax arrays do not have, and what this
module does about them:

* Ordering across threads and streams: a shard pin records a CUDA
  event on the stream that produced it; a reader on any thread waits
  on that event on its own current stream before it uses the tensors,
  and marks them in use there (`record_stream`), so an eviction while
  the reader's kernels are queued cannot hand their block to a new
  allocation before those kernels ran.
* No donated buffers: torch has no `is_deleted`, and no pinned tensor
  is ever the target of a later in-place op — the accumulator is
  pinned only after its last `index_add_`, and no other fold receives
  it; a shard pin is only ever read.

Budgeted LRU, like the result cache — but against the DEVICE budget
(DN_DEVICE_RESIDENCY_MB), not the host governor.  0 (the default)
disables residency; the device lane then uploads and fetches per
request — byte-identical either way.

The module-level singleton (`configure`/`active`/`deconfigure`) is the
seam the index-query device lane reads: a bare CLI process never
configures it, so `dn query` costs nothing and changes nothing.
"""

import hashlib
import threading
import time
from collections import OrderedDict

_LOCK = threading.Lock()
_ACTIVE = None


def configure(budget_bytes):
    """Install the process-wide residency manager (server startup).
    Returns the manager; a zero budget installs a disabled one so
    /stats still reports the knob honestly."""
    global _ACTIVE
    mgr = DeviceResidency(budget_bytes)
    with _LOCK:
        _ACTIVE = mgr
    from ..obs import metrics as obs_metrics
    obs_metrics.set_residency_source(stats)
    return mgr


def deconfigure():
    """Drop the manager and every pinned device array (drain path)."""
    global _ACTIVE
    with _LOCK:
        mgr, _ACTIVE = _ACTIVE, None
    if mgr is not None:
        mgr.clear()
    from ..obs import metrics as obs_metrics
    obs_metrics.set_residency_source(None)


def active():
    """The enabled manager, or None — the device lane's fast check."""
    mgr = _ACTIVE
    return mgr if mgr is not None and mgr.enabled() else None


def stats():
    """The active manager's stats doc ({'enabled': False} when none
    is configured) — /stats, fleet aggregation, and the device gauges
    all read this one shape."""
    mgr = _ACTIVE
    return mgr.stats() if mgr is not None else {'enabled': False}


def content_key(kind, arrays, shape):
    """Digest-of-content cache key for a set of staged device inputs:
    two uploads collide only when every byte agrees, so a pinned
    accumulator can never answer for different columns.  `shape` folds
    in the static program parameters (padded sizes) that select the
    compiled program."""
    h = hashlib.blake2b(digest_size=16)
    for arr in arrays:
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return (kind, shape, h.hexdigest())


def _ready_event(tensors):
    """A CUDA event recorded on the current stream after the work that
    produced `tensors` was queued (None on the CPU)."""
    t = tensors[0]
    if getattr(getattr(t, 'device', None), 'type', None) != 'cuda':
        return None
    import torch
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _adopt(tensors, ev):
    """Order this thread's current stream after a pin's producer and
    mark the tensors in use there (see the module docstring)."""
    t = tensors[0]
    if getattr(getattr(t, 'device', None), 'type', None) != 'cuda':
        return
    import torch
    stream = torch.cuda.current_stream(t.device)
    if ev is not None:
        stream.wait_event(ev)
    for x in tensors:
        x.record_stream(stream)


class DeviceResidency(object):
    """LRU of device-resident accumulators, bounded by HBM bytes,
    invalidated by the writer epoch.  Thread-safe — the serve workers
    race on it."""

    def __init__(self, budget_bytes, shard_share=None):
        self.budget = int(budget_bytes or 0)
        if shard_share is None:
            import os
            try:
                shard_share = float(os.environ.get(
                    'DN_INDEX_RESIDENCY_SHARE', '0.5'))
            except ValueError:
                shard_share = 0.5
        self.shard_share = min(max(float(shard_share), 0.0), 1.0)
        self._lock = threading.Lock()
        self._entries = OrderedDict()
        self._bytes = 0
        self._shard_bytes = 0
        self._hits = 0
        self._misses = 0
        self._stale = 0
        self._evictions = 0
        self._shed = 0
        self._h2d_saved = 0
        self._d2h_saved = 0

    def enabled(self):
        return self.budget > 0

    # -- internals (call with self._lock held) ----------------------------

    def _drop_locked(self, key, ent):
        if self._entries.get(key) is not ent:
            return
        del self._entries[key]
        self._bytes -= ent['nbytes']
        if ent.get('kind') == 'shard':
            self._shard_bytes -= ent['nbytes']

    def _evict_lru_locked(self, kind=None):
        for key, ent in self._entries.items():
            if kind is not None and ent.get('kind') != kind:
                continue
            self._drop_locked(key, ent)
            self._evictions += 1
            return True
        return False

    def _evict_global_locked(self):
        """Global-budget eviction prefers the host-side (whole-result)
        pins: the shard share exists precisely so staged shard columns
        survive distinct-query churn — whole-result pins only answer
        exact repeats, so they are the cheaper loss.  Shard pins go
        only when nothing else is left."""
        for key, ent in self._entries.items():
            if ent.get('kind') == 'shard':
                continue
            self._drop_locked(key, ent)
            self._evictions += 1
            return True
        return self._evict_lru_locked(kind='shard')

    # -- the residency protocol --------------------------------------------

    def get(self, key, epoch):
        """The pinned host copy for `key`, or None.  A hit counts the
        transfers it avoided: the inputs' H2D upload and the
        accumulator's D2H fetch."""
        if not self.enabled() or key is None:
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent.get('kind') == 'shard':
                ent = None       # device-only pin: not this protocol
            if ent is not None and ent['epoch'] != epoch:
                self._drop_locked(key, ent)
                self._stale += 1
                ent = None
            if ent is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            self._h2d_saved += ent['h2d_bytes']
            self._d2h_saved += ent['nbytes']
            return ent['host']

    def put(self, key, epoch, device, host, h2d_bytes):
        """Pin a freshly computed accumulator: `device` is the
        device-side tensor (held alive = resident on the card), `host` its
        one fetched copy, `h2d_bytes` what the inputs cost to upload
        (the savings a future hit books).  Over-budget pins evict LRU;
        an accumulator alone over budget is shed."""
        if not self.enabled() or key is None:
            return False
        try:
            nbytes = int(device.nbytes)
        except (AttributeError, TypeError):
            nbytes = int(getattr(host, 'nbytes', 0) or 0)
        if nbytes <= 0 or nbytes > self.budget:
            with self._lock:
                self._shed += 1
            return False
        ent = {'epoch': epoch, 'device': device, 'host': host,
               'nbytes': nbytes, 'h2d_bytes': int(h2d_bytes or 0),
               'ts': time.time()}
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._drop_locked(key, old)
            while self._bytes + nbytes > self.budget:
                if not self._evict_global_locked():
                    break
            self._entries[key] = ent
            self._bytes += nbytes
        return True

    # -- per-shard device-tensor pins (device_index.py) --------------------

    def get_device(self, key, epoch):
        """The pinned DEVICE tensors for a staged shard (a tuple of
        tensors), or None.  Unlike get(), nothing is fetched — a hit
        hands the device references straight back into the next
        dispatch (ordered after their producer on this thread's
        stream) and books only the H2D upload it skipped."""
        if not self.enabled() or key is None:
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and (ent.get('kind') != 'shard'
                                    or ent['epoch'] != epoch):
                if ent.get('kind') == 'shard':
                    self._drop_locked(key, ent)
                    self._stale += 1
                ent = None
            if ent is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            self._h2d_saved += ent['h2d_bytes']
            device, ready = ent['device'], ent['ready']
        _adopt(device, ready)
        return device

    def put_device(self, key, epoch, device, nbytes, h2d_bytes=None):
        """Pin one shard's staged device tensors (a tuple; no host copy
        — the host never needs them back).  Bounded twice: by the global HBM
        budget AND by the shard share (DN_INDEX_RESIDENCY_SHARE of the
        budget), so shard columns cannot starve the pinned
        accumulators that answer exact repeats with zero transfer."""
        if not self.enabled() or key is None:
            return False
        nbytes = int(nbytes or 0)
        cap = int(self.budget * self.shard_share)
        if nbytes <= 0 or nbytes > cap:
            with self._lock:
                self._shed += 1
            return False
        ent = {'epoch': epoch, 'device': device, 'host': None,
               'ready': _ready_event(device),
               'nbytes': nbytes, 'kind': 'shard',
               'h2d_bytes': int(h2d_bytes if h2d_bytes is not None
                                else nbytes),
               'ts': time.time()}
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._drop_locked(key, old)
            while self._shard_bytes + nbytes > cap:
                if not self._evict_lru_locked(kind='shard'):
                    break
            while self._bytes + nbytes > self.budget:
                if not self._evict_global_locked():
                    break
            self._entries[key] = ent
            self._bytes += nbytes
            self._shard_bytes += nbytes
        return True

    def clear(self):
        """Release every pinned device array (drain, invalidation
        hammer for tests)."""
        with self._lock:
            for key, ent in list(self._entries.items()):
                self._drop_locked(key, ent)

    def drop_host_pins(self):
        """Drop every whole-result (host-copy) pin, keeping the shard
        pins — the state distinct-query churn converges to under
        budget pressure (_evict_global_locked goes host-first).  Bench
        and tests use this to exercise the pinned-shard repeat path
        deterministically."""
        with self._lock:
            for key, ent in list(self._entries.items()):
                if ent.get('kind') != 'shard':
                    self._drop_locked(key, ent)

    def stats(self):
        with self._lock:
            hits, misses = self._hits, self._misses
            doc = {
                'enabled': self.enabled(),
                'budget_bytes': self.budget,
                'bytes': self._bytes,
                'entries': len(self._entries),
                'shard_bytes': self._shard_bytes,
                'shard_share': self.shard_share,
                'hits': hits,
                'misses': misses,
                'stale_drops': self._stale,
                'evictions': self._evictions,
                'shed': self._shed,
                'h2d_saved_bytes': self._h2d_saved,
                'd2h_saved_bytes': self._d2h_saved,
            }
        total = hits + misses
        doc['hit_rate'] = round(hits / total, 4) if total else 0.0
        return doc


# -- serve-start pre-warm ---------------------------------------------------

# padded (rows, segments) shapes warmed before the first request: the
# pow2 ladder index_query_stack pads real queries into
_PREWARM_SHAPES = ((1 << 10, 1 << 8), (1 << 14, 1 << 10))


def prewarm(shapes=_PREWARM_SHAPES, deadline_s=None, device=None):
    """Serve-start device pre-warm on `device` (default CUDA): bring up
    the CUDA context, run K7a (index_query_stack._sums_program) once at
    each representative shape, and report the persisted audition cache
    — before the first request pays for any of it.  Eager torch
    compiles nothing, so the work is the context's start-up and the
    first launches.  Runs under the probe deadline on the caller's
    (background) thread: a wedged card costs a bounded wait and an
    honest 'timeout' doc, never a hung server; a failure is reported
    as 'failed' with its error, and the device lane keeps raising —
    nothing falls back to the host.  Returns {'state', 'backend',
    'programs', 'auditions', 'audition_wins', 'audition_path', 'ms'}
    (and 'error' when it failed)."""
    from .. import device_scan as mod_ds
    doc = {'state': 'failed', 'backend': None, 'programs': 0,
           'auditions': 0, 'audition_path': None, 'ms': 0.0}
    if deadline_s is None:
        deadline_s = mod_ds.probe_deadline_s()
    t0 = time.monotonic()

    def warm():
        import torch
        from ..ops import resolve_device
        from .. import index_query_stack as mod_iqs
        dev = resolve_device(device)
        warmed = 0
        for pn, pu in shapes:
            prog = mod_iqs._sums_program(pn, pu)
            zeros = torch.zeros(pn, dtype=torch.int64, device=dev)
            prog(zeros, zeros).cpu()     # launch + wait
            warmed += 1
        return warmed, mod_ds._backend_id(dev)

    status, out = mod_ds.run_with_deadline(warm, deadline_s,
                                           'serve-prewarm')
    if status == 'ok':
        doc['state'] = 'ok'
        doc['programs'], doc['backend'] = out
    elif status == 'timeout':
        doc['state'] = 'timeout'
    else:
        doc['error'] = str(out)
    path, entries, wins = mod_ds.audition_cache_entries()
    doc['audition_path'] = path
    doc['auditions'] = entries
    doc['audition_wins'] = wins
    doc['ms'] = round((time.monotonic() - t0) * 1000.0, 3)
    from ..obs import metrics as obs_metrics
    obs_metrics.set_gauge('device_prewarm_ok',
                          1.0 if doc['state'] == 'ok' else 0.0)
    obs_metrics.set_gauge('device_prewarm_ms', doc['ms'])
    return doc
