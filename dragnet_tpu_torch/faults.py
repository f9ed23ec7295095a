"""Deterministic fault injection for chaos soaks and crash drills.

The robustness machinery this repo now carries — journaled index
publishing, the recovery sweep, the retry-hardened remote client —
is only trustworthy if failure paths are *exercised on purpose*.
This module is the single switchboard: named injection sites threaded
through the hot seams (index sink create/flush/rename, shard reads,
serve socket accept/read/write, client connect/send/recv, the device
probe), armed via one env knob:

    DN_FAULTS=site:kind:rate[:seed],site:kind:rate[:seed],...

Each armed site draws from its OWN seeded PRNG, so a chaos soak with a
given spec is replayable: the k-th check at a site fires (or not)
identically run over run.  (Cross-thread interleaving can reorder
which *operation* meets the k-th draw; rate=1.0 specs are fully
deterministic regardless.)  Kinds:

* ``error`` — raise FaultInjected (a DNError: callers' existing error
  contracts wrap and report it cleanly, never a traceback).
* ``delay`` — sleep DN_FAULT_DELAY_MS (default 25) and continue; for
  shaking out timeout/retry paths without failing the operation.
* ``torn``  — partial bytes then crash: at sites that hand a
  ``torn_path`` (the sink rename seam), truncate the tmp file to half
  its bytes and SIGKILL the process — the classic mid-write power
  cut.  Sites without a torn_path degrade to ``error``.
* ``kill``  — SIGKILL the process at the seam (mid-flush crash
  drills; only meaningful under a subprocess harness).
* ``enospc`` / ``emfile`` — resource exhaustion: raise
  ``OSError(ENOSPC)`` / ``OSError(EMFILE)`` at the seam, exactly what
  a full disk or an exhausted fd table produces mid-write.  Armed at
  every write seam (sink create/flush/rename, journal commit record,
  follow checkpoint, integrity catalog update, events spill, handoff
  apply, repair land) to prove each leaves a recoverable tree —
  journal rolls back, no torn shards, no stranded tmps
  (docs/robustness.md, the resource-governance section).
* ``flip``  — silent corruption: at sites that hand a file path
  (``flip_path``, or ``torn_path`` where no safer target exists),
  XOR one seeded-random byte of the target file and CONTINUE — the
  bit rot the integrity catalog (integrity.py) exists to catch.
  Armed at ``sink.rename`` (the file flipped is the prepared tmp,
  AFTER its checksum landed in the commit record, so the committed
  shard disagrees with the catalog exactly like post-publish rot)
  and ``handoff.apply``; sites without a path degrade to ``error``,
  mirroring ``torn``.

Every check and every firing is counted per site (stats(), plus the
hidden 'fault injected <site>' global counters `dn serve` surfaces in
/stats), so a soak can assert exactly how much chaos it generated.

The spec is validated through config.faults_config (the shared DNError
contract `dn serve --validate` checks); a malformed DN_FAULTS raises
that DNError at the first armed-site check rather than silently
injecting nothing.
"""

import os
import random
import signal
import threading
import time

from .errors import DNError
from .vpipe import counter_bump

KINDS = ('error', 'torn', 'delay', 'kill', 'flip', 'enospc',
         'emfile')

# the injection-site catalog (docs/robustness.md documents each seam)
SITES = (
    'sink.create',      # index sink creation (index_sink/index_dnc)
    'sink.flush',       # sink prepare: tmp-file body write
    'sink.rename',      # sink commit: the atomic rename (torn_path)
    'iq.shard_read',    # per-shard index reads (index_query_mt)
    'serve.accept',     # dn serve: accepted-connection handling
    'serve.read',       # dn serve: request read/parse
    'serve.write',      # dn serve: response write
    'serve.frame_torn',  # dn serve: v2 response framing (torn frame)
    'serve.push_torn',  # dn serve: subscription push framing (torn)
    'serve.stall',      # dn serve: per-request handling stall
    'tenant.flood',     # admission: per-tenant enqueue (overload)
    'client.connect',   # remote client: connect()
    'client.send',      # remote client: request send
    'client.recv',      # remote client: response header/payload read
    'device.probe',     # device backend probe (device_scan)
    'router.dispatch',  # scatter-gather: per-partition dispatch
    'router.merge',     # scatter-gather: partial-aggregate merge
    'member.health',    # dn serve: the health op a router probes
    'follow.read',      # dn follow: tailer source reads
    'follow.checkpoint',  # dn follow: checkpoint tmp write
    'follow.publish',   # dn follow: batch publish (pre-commit)
    'topo.poll',        # dynamic topology: coordinator-file poll
    'handoff.manifest',  # handoff: donor shard-manifest build
    'handoff.fetch',    # handoff: joiner per-shard fetch
    'handoff.apply',    # handoff: joiner shard rename-into-place
    'journal.commit',   # index journal: the commit-record write
    'integrity.catalog',  # integrity: catalog read-modify-write
    'events.spill',     # obs/events: the JSONL spill append
    'repair.land',      # serve/scrub: replica-repair shard landing
    'rollup.publish',   # rollup: per-shard rollup build/publish
    'compact.publish',  # rollup: compacted-group publish (pre-commit)
)


class FaultInjected(DNError):
    """An injected 'error'-kind fault.  A DNError so every existing
    error contract (index "<path>" wrapping, dn: framing, the remote
    client's retry classification) handles it like a real failure."""


class _Site(object):
    __slots__ = ('site', 'kind', 'rate', 'seed', 'rng', 'lock',
                 'checked', 'fired')

    def __init__(self, site, kind, rate, seed):
        self.site = site
        self.kind = kind
        self.rate = rate
        self.seed = seed
        # seeded per (site, seed): replayable draws, independent sites
        self.rng = random.Random('%s:%d' % (site, seed))
        self.lock = threading.Lock()
        self.checked = 0
        self.fired = 0


_REG_LOCK = threading.Lock()
# one atomically-replaced (env spec string, {site: _Site} | DNError)
# pair: fire() sits on per-shard hot seams, so the unarmed case must
# cost one env lookup + one atomic list read — no lock
_REG = [(None, {})]


def _registry():
    spec = os.environ.get('DN_FAULTS', '')
    cached_spec, table = _REG[0]
    if cached_spec == spec:
        return table
    with _REG_LOCK:
        cached_spec, table = _REG[0]
        if cached_spec == spec:
            return table
        from .config import faults_config
        parsed = faults_config()
        if isinstance(parsed, DNError):
            table = parsed
        else:
            table = {site: _Site(site, kind, rate, seed)
                     for site, (kind, rate, seed)
                     in parsed['sites'].items()}
        _REG[0] = (spec, table)
    return table


def reset():
    """Drop the parsed registry (tests: re-seed PRNGs / re-read a
    monkeypatched DN_FAULTS immediately)."""
    with _REG_LOCK:
        _REG[0] = (None, {})


def enabled():
    table = _registry()
    return bool(table) and not isinstance(table, DNError)


def _delay_s():
    try:
        return max(0.0, float(os.environ.get('DN_FAULT_DELAY_MS',
                                             '25'))) / 1000.0
    except ValueError:
        return 0.025


def fire(site, torn_path=None, flip_path=None):
    """The injection seam: no-op unless DN_FAULTS arms `site`; on a
    hit, act per the armed kind (see module docstring).  `torn_path`
    names the bytes a 'torn' kind may cut short (the sink's tmp
    file); `flip_path` the bytes a 'flip' kind may corrupt in place
    (falling back to torn_path — distinct parameters because a site
    where a torn tmp would be rolled FORWARD by recovery, like the
    sink commit seam, can safely hand flip a target it must never
    hand torn)."""
    table = _registry()
    if isinstance(table, DNError):
        raise table
    ent = table.get(site)
    if ent is None:
        return
    with ent.lock:
        ent.checked += 1
        hit = ent.rng.random() < ent.rate
        if hit:
            ent.fired += 1
            if ent.kind == 'flip':
                # the flip's offset/mask draws come off the same
                # seeded stream, so a given spec corrupts replayably
                flip_draw = (ent.rng.random(),
                             ent.rng.randrange(1, 256))
    if not hit:
        return
    counter_bump('faults injected')
    counter_bump('fault injected %s' % site)
    # observability: firings land as span events (chaos soaks become
    # traceable — the trace shows exactly which request absorbed which
    # injection) and as a typed counter in /stats `metrics`
    from .obs import metrics as obs_metrics
    from .obs import trace as obs_trace
    obs_metrics.inc('faults_injected_total', site=site, kind=ent.kind)
    obs_trace.event('fault.injected', site=site, kind=ent.kind)
    kind = ent.kind
    if kind == 'delay':
        time.sleep(_delay_s())
        return
    if kind in ('enospc', 'emfile'):
        import errno
        code = errno.ENOSPC if kind == 'enospc' else errno.EMFILE
        raise OSError(code, 'injected %s at "%s"'
                      % (kind.upper(), site))
    if kind == 'kill':
        os.kill(os.getpid(), signal.SIGKILL)
    if kind == 'torn' and torn_path is not None:
        _tear(torn_path)
        os.kill(os.getpid(), signal.SIGKILL)
    if kind == 'flip':
        target = flip_path if flip_path is not None else torn_path
        if target is not None:
            _flip(target, flip_draw[0], flip_draw[1])
            return           # silent: the corruption IS the fault
    raise FaultInjected('injected %s fault at "%s"' % (kind, site))


def _flip(path, offset_frac, mask):
    """XOR one byte of `path` at a seeded-random offset — silent bit
    rot, injected (best-effort: an unreadable target simply stays
    uncorrupted; the draw already happened so replay is intact)."""
    try:
        size = os.path.getsize(path)
        if size == 0:
            return
        off = min(size - 1, int(offset_frac * size))
        with open(path, 'r+b') as f:
            f.seek(off)
            b = f.read(1)
            if not b:
                return
            f.seek(off)
            f.write(bytes([b[0] ^ mask]))
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        pass


def _tear(path):
    """Cut `path` to half its bytes — the partial write a power cut
    leaves behind (best-effort: the crash is the point)."""
    try:
        size = os.path.getsize(path)
        with open(path, 'r+b') as f:
            f.truncate(size // 2)
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        pass


def stats():
    """Per-site injection telemetry: {site: {kind, rate, seed,
    checked, fired}} for the armed sites (empty when DN_FAULTS is
    unset/malformed) — `dn serve` /stats and the chaos soak's
    assertions read this."""
    table = _registry()
    if isinstance(table, DNError):
        return {}
    out = {}
    for site, ent in table.items():
        with ent.lock:
            out[site] = {'kind': ent.kind, 'rate': ent.rate,
                         'seed': ent.seed, 'checked': ent.checked,
                         'fired': ent.fired}
    return out


def total_fired():
    return sum(s['fired'] for s in stats().values())
