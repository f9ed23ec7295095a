"""Index-shard query fan-out: reader pool, time-range pruning, and a
shard-handle cache.

Counterpart (a copy) of dragnet_tpu/index_query_mt.py.  The serving
path (`dn query`) answers from pre-built hour/day index shards; this
module owns its three host-side pieces:

* ShardQueryExecutor: a bounded worker pool that queries shards
  concurrently and merges per-shard point lists IN FIND ORDER on the
  caller's thread, so output — including the aggregator's
  insertion-ordered emission — is byte-identical to the sequential
  path for any worker count.  DN_IQ_THREADS sets the pool size (auto =
  up to 6, bounded by CPU count; 0 = the sequential
  open/query/close loop).  Workers do host work only: no CUDA call is
  made on a worker thread.

* Time-range pruning: each hour/day shard's coverage window is derived
  from its strftime filename layout, and shards wholly outside the
  query's [after, before) bounds are skipped without being opened.
  Pruned/queried counts are hidden per-stage counters ("index shards
  pruned" / "index shards queried" on the Index List stage;
  DN_COUNTERS_ALL=1 makes them visible).

* A process-wide LRU cache of open shard handles (DNC mmap / sqlite3
  connections plus their parsed config, metrics, and decoded
  dictionaries) keyed by (path, mtime_ns, size, inode), so repeated
  queries against the same index set skip open/parse cost.  Handles
  are leased exclusively to one worker at a time; index writers
  invalidate rewritten paths.  A watchdog.LeakCheck makes undrained
  executors and leaked (never checked-in) handles fail loudly at exit.

Pool workers adopt the submitting request's counter scope
(vpipe.adopt_scope), so a `dn serve` request's counters attribute to it.
"""

import os
import queue
import threading
import time
from collections import OrderedDict

from . import vpipe
from datetime import datetime, timedelta, timezone

from .errors import DNError
from .aggr import Aggregator
from . import faults as mod_faults
from .vpipe import counter_bump
from .watchdog import LeakCheck
from . import find as mod_find
from .index_query import open_index

# an executor that is never drained means submitted shards may never
# have merged into the result
_EXECUTOR_LEAKS = LeakCheck(
    'index-query executor(s) never drained; results may be incomplete',
    lambda ex: not ex.closed)

# a handle checked out of the cache but never checked back in (or
# closed) holds an open file/connection and blocks reuse
_HANDLE_LEAKS = LeakCheck(
    'index shard handle(s) leased but never released',
    lambda h: h.leased)


def iq_threads():
    """Worker-pool size for the index-query fan-out.  DN_IQ_THREADS:
    auto (default) = min(6, cpus - 1) — one core stays with the
    caller, which merges results and walks the index tree concurrently
    with the pool (shard queries are partially GIL-bound, so a pool as
    wide as the machine convoys with the merger instead of helping);
    at least 1, 0 = sequential.  DN_QUERY_CONCURRENCY is honored as a
    legacy alias (1 = sequential) when DN_IQ_THREADS is unset."""
    v = os.environ.get('DN_IQ_THREADS')
    if v is None:
        legacy = os.environ.get('DN_QUERY_CONCURRENCY')
        if legacy is not None:
            try:
                n = int(legacy)
            except ValueError:
                n = None     # unparseable: fail open to auto, as the
            if n is not None:  # pre-pool code ignored bad values
                return 0 if n <= 1 else n
        v = 'auto'
    if v != 'auto':
        try:
            return max(0, int(v))
        except ValueError:
            return 0
    return max(1, min(6, (os.cpu_count() or 2) - 1))


# -- pool auto-degrade ----------------------------------------------------

# EMA of the warm per-shard query cost (ms), fed by every cached shard
# query.  Round-5 bench: at 0.654 ms/shard the pool's queue handoffs
# and GIL convoy made the threaded fan-out SLOWER than the sequential
# walk (index_query_p50_ms 238.7 vs 218.6 over 365 shards), so when
# the measured cost sits below the dispatch-amortization threshold the
# fan-out degrades to the sequential cached loop — byte-identical
# output either way.
_SEQ_EMA = [None]
_SEQ_EMA_LOCK = threading.Lock()


def _note_shard_ms(ms):
    with _SEQ_EMA_LOCK:
        prev = _SEQ_EMA[0]
        _SEQ_EMA[0] = ms if prev is None else prev * 0.8 + ms * 0.2


def _iq_auto():
    """True when the pool size came from 'auto' — an explicit
    DN_IQ_THREADS / DN_QUERY_CONCURRENCY is an operator override the
    degrade heuristic must respect."""
    v = os.environ.get('DN_IQ_THREADS')
    if v is None:
        return os.environ.get('DN_QUERY_CONCURRENCY') is None
    return v == 'auto'


def degrade_to_sequential(npaths, nworkers):
    """Whether this fan-out should skip the pool on PRIOR evidence
    alone: per-shard cost below DN_IQ_SEQ_MS (default 2.0 ms; 'off'
    disables the heuristic), or fewer than DN_IQ_MIN_PER_WORKER
    (default 4) shards per worker — either way pool dispatch costs
    more than it overlaps.  Applies only in auto mode.  The fan-out
    entry point consults this only until both strategies have a
    measured whole-fan-out cost (_choose_fanout), because the
    per-shard EMA is fed from inside pool workers where GIL convoying
    inflates wall times — a busy pool can read 3-6x the true cost and
    pin the estimate above the threshold forever."""
    if not _iq_auto():
        return False
    v = os.environ.get('DN_IQ_SEQ_MS', '2.0')
    if v == 'off':
        return False
    try:
        threshold = float(v)
    except ValueError:
        threshold = 2.0
    try:
        min_per = max(1, int(os.environ.get('DN_IQ_MIN_PER_WORKER',
                                            '4')))
    except ValueError:
        min_per = 4
    if npaths < nworkers * min_per:
        return True
    with _SEQ_EMA_LOCK:
        ema = _SEQ_EMA[0]
    return ema is not None and ema < threshold


# -- measured fan-out strategy selection ----------------------------------

# effective per-shard cost (ms, wall clock / nshards) of each complete
# multi-shard fan-out, by strategy.  Unlike _SEQ_EMA (one shard's wall
# time, convoy-inflated under the pool), this is the quantity the
# caller actually waits for, so comparing the two EMAs picks the
# strategy that is empirically faster ON THIS MACHINE for this
# workload — the round-5 regression (pool 238.7 ms vs sequential
# 218.6 ms over 365 shards) becomes a one-fan-out mistake instead of
# a permanent tax.
_FANOUT_LOCK = threading.Lock()
_FANOUT_EMA = {'pool': None, 'seq': None}
_FANOUT_STATE = {'n': 0, 'last_mode': None}

# re-measure the losing strategy once per this many fan-outs, so a
# verdict reached under transient load (or before the handle cache
# warmed) is not frozen forever; costs at most one slower fan-out per
# window
_FANOUT_REEXPLORE = 100


def _note_fanout(mode, ms_per_shard):
    with _FANOUT_LOCK:
        prev = _FANOUT_EMA[mode]
        _FANOUT_EMA[mode] = ms_per_shard if prev is None \
            else prev * 0.7 + ms_per_shard * 0.3
        _FANOUT_STATE['last_mode'] = mode


def _fanout_reset():
    with _FANOUT_LOCK:
        _FANOUT_EMA['pool'] = _FANOUT_EMA['seq'] = None
        _FANOUT_STATE['n'] = 0
        _FANOUT_STATE['last_mode'] = None


def fanout_stats():
    """Measured per-shard fan-out costs + the last strategy used —
    `dn serve` /stats surfaces it so a degraded pool is visible, not
    silent."""
    with _FANOUT_LOCK:
        return {'pool_ms_per_shard': _FANOUT_EMA['pool'],
                'seq_ms_per_shard': _FANOUT_EMA['seq'],
                'fanouts': _FANOUT_STATE['n'],
                'last_mode': _FANOUT_STATE['last_mode']}


def _choose_fanout(npaths, nworkers):
    """'pool' or 'seq' (the cached sequential loop) for a multi-shard
    fan-out.  Explicit DN_IQ_THREADS overrides always pool; too few
    shards per worker always degrades.  Otherwise: once both
    strategies have a measured cost, take the empirical winner
    (re-measuring the loser once per _FANOUT_REEXPLORE fan-outs);
    until then fall back to the threshold prior
    (degrade_to_sequential), measuring whichever side it picks so the
    comparison completes itself."""
    if nworkers <= 1:
        # one worker cannot overlap anything; the pool is pure
        # queue-handoff overhead over the same cached loop
        return 'seq' if _iq_auto() else 'pool'
    if not _iq_auto():
        return 'pool'
    try:
        min_per = max(1, int(os.environ.get('DN_IQ_MIN_PER_WORKER',
                                            '4')))
    except ValueError:
        min_per = 4
    if npaths < nworkers * min_per:
        return 'seq'
    with _FANOUT_LOCK:
        pool_ms = _FANOUT_EMA['pool']
        seq_ms = _FANOUT_EMA['seq']
        _FANOUT_STATE['n'] += 1
        n = _FANOUT_STATE['n']
    if pool_ms is not None and seq_ms is not None:
        winner = 'pool' if pool_ms < seq_ms else 'seq'
        if n % _FANOUT_REEXPLORE == 0:
            return 'seq' if winner == 'pool' else 'pool'
        return winner
    if degrade_to_sequential(npaths, nworkers):
        return 'seq'
    return 'pool' if pool_ms is None else 'seq'


# -- shard filename time ranges ------------------------------------------

def shard_time_range(path, timeformat):
    """The [start_ms, end_ms) coverage window a shard's filename
    declares, derived from the interval tree's strftime layout
    ('%Y-%m-%d.sqlite' for day trees, '%Y-%m-%d-%H.sqlite' for hour
    trees).  Returns None when the name doesn't match the layout —
    callers must treat such shards as covering all time (query, don't
    prune)."""
    entries = _layout_entries(timeformat)
    if entries is None:
        return None
    return _range_from_entries(path, entries)


def _layout_entries(timeformat):
    """Parse the layout pattern once per query, not once per shard."""
    entries = mod_find.parse_strftime_pattern(
        os.path.basename(timeformat))
    if isinstance(entries, DNError):
        return None
    return entries


def _range_from_entries(path, entries):
    name = os.path.basename(path)
    vals = {}
    i = 0
    for entry in entries:
        if entry['kind'] == 'str':
            if not name.startswith(entry['value'], i):
                return None
            i += len(entry['value'])
            continue
        width = 4 if entry['kind'] == 'Y' else 2
        digits = name[i:i + width]
        if len(digits) != width or not digits.isdigit():
            return None
        vals[entry['kind']] = int(digits)
        i += width
    if i != len(name):
        # a compactor-pending follow generation ("<base>-gNNNNNN",
        # index_journal.GEN_SEP) covers exactly its base shard's window
        rest = name[i:]
        if not (rest.startswith('-g') and rest[2:].isdigit()):
            return None
    if 'Y' not in vals:
        return None
    try:
        start = datetime(vals['Y'], vals.get('m', 1), vals.get('d', 1),
                         vals.get('H', 0), tzinfo=timezone.utc)
    except ValueError:
        return None
    if 'H' in vals:
        end = start + timedelta(hours=1)
    elif 'd' in vals:
        end = start + timedelta(days=1)
    elif 'm' in vals:
        end = start.replace(year=start.year + 1, month=1) \
            if start.month == 12 else start.replace(month=start.month + 1)
    else:
        end = start.replace(year=start.year + 1)
    return (int(start.timestamp() * 1000), int(end.timestamp() * 1000))


def prune_shards(paths, timeformat, after_ms, before_ms):
    """Drop shards whose filename window is wholly outside the query's
    [after_ms, before_ms) bounds.  Returns (kept_paths, npruned).
    Shards with unparseable names are kept (they may cover any time) —
    same fail-open rule for a None timeformat or unbounded query."""
    if timeformat is None or before_ms is None or after_ms is None:
        return (list(paths), 0)
    entries = _layout_entries(timeformat)
    if entries is None:
        return (list(paths), 0)
    kept = []
    npruned = 0
    for path in paths:
        window = _range_from_entries(path, entries)
        if window is not None and \
                not (window[0] < before_ms and window[1] > after_ms):
            npruned += 1
            continue
        kept.append(path)
    return (kept, npruned)


def count_pruned_shards(root, timeformat, after_ms, before_ms):
    """How many shard files in the interval tree fall wholly outside the
    query bounds.  Time-bounded queries never even enumerate these (the
    strftime path enumerator expands only in-window names), so this one
    cheap listdir is what makes the skipped work observable in
    counters."""
    if timeformat is None or before_ms is None or after_ms is None:
        return 0
    entries = _layout_entries(timeformat)
    if entries is None:
        return 0
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    npruned = 0
    for name in names:
        window = _range_from_entries(name, entries)
        if window is not None and \
                not (window[0] < before_ms and window[1] > after_ms):
            npruned += 1
    return npruned


# -- shard handle cache ---------------------------------------------------

class ShardHandle(object):
    """An open shard querier plus the stat identity it was opened
    against.  `leased` is True while exactly one worker owns it;
    `checked_at` is when the stat identity was last verified; `gen` is
    the path's invalidation generation at lease time (a handle leased
    across a shard_cache_invalidate call must not re-enter the
    cache)."""

    __slots__ = ('path', 'statkey', 'querier', 'leased', 'checked_at',
                 'last_used', 'gen', '__weakref__')

    def __init__(self, path, statkey, querier, now, gen):
        self.path = path
        self.statkey = statkey
        self.querier = querier
        self.leased = True
        self.checked_at = now
        self.last_used = now
        self.gen = gen
        _HANDLE_LEAKS.track(self)


_CACHE_LOCK = threading.Lock()
_CACHE = OrderedDict()          # path -> ShardHandle (not leased)
_CACHE_STATS = {'hits': 0, 'misses': 0}
# path -> invalidation generation: bumped by shard_cache_invalidate so
# handles leased across the invalidation (and thus missed by the cache
# pop) are closed at checkin instead of re-cached.  _EPOCH is the
# cache-wide analog for shard_cache_clear: a handle leased across a
# clear must not re-enter the emptied cache either.
_INVAL_GEN = {}
_EPOCH = [0]


_CAP_MEMO = [None, 0]      # (env value, capacity) — getrlimit once


def _cache_capacity():
    """DN_IQ_CACHE caps cached handles (0 disables); auto = 512 bounded
    to a quarter of the fd soft limit (each handle holds an open file
    or sqlite connection)."""
    v = os.environ.get('DN_IQ_CACHE', 'auto')
    if v == _CAP_MEMO[0]:
        return _CAP_MEMO[1]
    if v != 'auto':
        try:
            cap = max(0, int(v))
        except ValueError:
            cap = 0
    else:
        cap = 512
        try:
            import resource
            soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
            if soft > 0:
                cap = min(cap, max(16, soft // 4))
        except Exception:
            pass
    _CAP_MEMO[0] = v
    _CAP_MEMO[1] = cap
    return cap


_TTL_MEMO = [None, 0.0]


def _stat_ttl():
    """How long (seconds) a cached handle's verified stat identity
    stays trusted without re-statting.  In-process writers invalidate
    explicitly, so the stat only guards against *external* rewrites;
    amortizing it (DN_IQ_STAT_TTL_MS, default 1000) keeps the serving
    hot path off the filesystem — the open-file-cache validity-timer
    pattern.  0 re-stats on every checkout."""
    v = os.environ.get('DN_IQ_STAT_TTL_MS', '1000')
    if v == _TTL_MEMO[0]:
        return _TTL_MEMO[1]
    try:
        ttl = max(0, int(v)) / 1000.0
    except ValueError:
        ttl = 1.0
    _TTL_MEMO[0] = v
    _TTL_MEMO[1] = ttl
    return ttl


def stat_ttl_s():
    """The handle-cache stat TTL in seconds — the bound on how stale
    a process that did NOT observe a write (no in-process hook) can
    read the tree.  Consumers that must outwait another process's
    staleness window (serve/subscribe.py's confirm delay) schedule
    past this."""
    return _stat_ttl()


def _statkey(path):
    try:
        st = os.stat(path)
    except OSError:
        return None       # open_index reports the real error
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def checkout_shard(path):
    """Lease a querier for `path`: a cached handle when its stat
    identity still matches (verified at most once per stat TTL), a
    fresh open otherwise.  Raises the same DNError('index "<path>"')
    the sequential path raises on a bad open.

    Verified reads (integrity.py): under DN_VERIFY=open the shard's
    size+crc32 are checked against the tree's integrity catalog on
    every FRESH open — the cache's (path, mtime_ns, size, ino)
    identity then amortizes it, so the hot serving path pays the read
    once per shard generation.  DN_VERIFY=full re-verifies on every
    lease, cache hit or not.  A mismatch quarantines the shard, bumps
    its cache generation (a concurrently-leased handle closes at
    checkin instead of re-entering), and raises the clean retryable
    ShardIntegrityError."""
    from . import integrity as mod_integrity
    vmode = mod_integrity.verify_mode()
    if _cache_capacity() > 0:
        with _CACHE_LOCK:
            handle = _CACHE.pop(path, None)
        if handle is not None:
            if vmode == 'full':
                try:
                    mod_integrity.verify_shard(path)
                except mod_integrity.ShardIntegrityError:
                    # the quarantine bumped the generation this
                    # handle was cached under; close it here (it was
                    # popped, so checkin will never see it)
                    handle.querier.close()
                    raise
            now = time.monotonic()
            if now - handle.checked_at < _stat_ttl():
                with _CACHE_LOCK:
                    _CACHE_STATS['hits'] += 1
                    # re-lease under the CURRENT generation: this
                    # handle survived any sweeps since it was cached,
                    # so only invalidations during the new lease
                    # should retire it at checkin
                    handle.gen = (_EPOCH[0], _INVAL_GEN.get(path, 0))
                counter_bump('index handle cache hits')
                handle.last_used = now
                handle.leased = True
                return handle
            statkey = _statkey(path)
            if statkey is not None and handle.statkey == statkey:
                with _CACHE_LOCK:
                    _CACHE_STATS['hits'] += 1
                    handle.gen = (_EPOCH[0], _INVAL_GEN.get(path, 0))
                counter_bump('index handle cache hits')
                handle.checked_at = now
                handle.last_used = now
                handle.leased = True
                return handle
            handle.querier.close()    # rewritten underneath the cache
    if vmode != 'off':
        # a fresh open: this path was not in the cache (or the cache
        # is off/stale), so the generation pays its one verification
        mod_integrity.verify_shard(path)
    with _CACHE_LOCK:
        _CACHE_STATS['misses'] += 1
        gen = (_EPOCH[0], _INVAL_GEN.get(path, 0))
    counter_bump('index handle cache misses')
    statkey = _statkey(path)
    try:
        querier = open_index(path)
    except DNError as e:
        raise DNError('index "%s"' % path, cause=e)
    return ShardHandle(path, statkey, querier, time.monotonic(), gen)


def checkin_shard(handle, ok=True):
    """Return a leased handle.  Healthy handles of stat-identified files
    go back into the LRU (evicting the oldest beyond capacity); failed
    or unidentifiable ones are closed."""
    handle.leased = False
    cap = _cache_capacity()
    if not ok or cap <= 0 or handle.statkey is None:
        handle.querier.close()
        return
    closing = []
    now = time.monotonic()
    # an LRU entry still hot (used within the admission window) is
    # about to be requested again: under a cyclic full-tree sweep
    # wider than the cache, evicting it for the incoming handle gives
    # a 0% hit rate (every shard evicted moments before its reuse).
    # Rejecting the admission instead keeps a resident prefix and a
    # capacity/nshards hit rate; entries idle past the window age out
    # normally, so workload shifts still repopulate the cache.
    stale_before = now - max(1.0, _stat_ttl())
    with _CACHE_LOCK:
        if (_EPOCH[0], _INVAL_GEN.get(handle.path, 0)) != handle.gen:
            # the shard was invalidated (rewritten) or the cache
            # cleared while this handle was leased — it must not
            # serve again
            closing.append(handle)
        else:
            old = _CACHE.pop(handle.path, None)
            if old is not None:
                closing.append(old)
            if old is not None or len(_CACHE) < cap:
                _CACHE[handle.path] = handle
                while len(_CACHE) > cap:
                    closing.append(_CACHE.popitem(last=False)[1])
            else:
                lru = next(iter(_CACHE.values()))
                if lru.last_used < stale_before:
                    closing.append(_CACHE.popitem(last=False)[1])
                    _CACHE[handle.path] = handle
                else:
                    closing.append(handle)    # admission rejected
    for stale in closing:
        stale.querier.close()


def shard_cache_invalidate(path):
    """Drop (and close) any cached handle for `path` — index writers
    call this after rewriting a shard, so in-process serving sees the
    new bytes even if the stat identity were to collide.  Handles
    currently leased to a worker are invalidated at checkin via the
    per-path generation.  The shard-list cache for the containing
    directory drops too (a rewrite may have ADDED the shard)."""
    with _CACHE_LOCK:
        _INVAL_GEN[path] = _INVAL_GEN.get(path, 0) + 1
        handle = _CACHE.pop(path, None)
    with _FIND_LOCK:
        _FIND_CACHE.pop(os.path.dirname(path), None)
    if handle is not None:
        handle.querier.close()


def shard_cache_clear():
    """Close every cached handle (tests, and before deleting index
    trees)."""
    with _CACHE_LOCK:
        handles = list(_CACHE.values())
        _CACHE.clear()
        _INVAL_GEN.clear()
        _EPOCH[0] += 1     # leased handles must not re-enter
        _CACHE_STATS['hits'] = 0
        _CACHE_STATS['misses'] = 0
    with _SEQ_EMA_LOCK:
        _SEQ_EMA[0] = None
    _fanout_reset()
    with _FIND_LOCK:
        _FIND_CACHE.clear()
    for handle in handles:
        handle.querier.close()


def shard_cache_stats():
    with _CACHE_LOCK:
        return dict(_CACHE_STATS, size=len(_CACHE))


def invalidate_index_tree(root):
    """Drop every cached handle and find-memo entry at or under
    `root` — the serving layer's post-build coherence hook: a rebuild
    touches many shards (and may DELETE some), so after the per-path
    writer invalidations the whole tree's cached state is retired in
    one sweep.  Cheap when nothing under `root` is cached."""
    root = os.path.abspath(root)
    prefix = root + os.sep
    closing = []
    with _CACHE_LOCK:
        for path in [p for p in _CACHE
                     if os.path.abspath(p) == root or
                     os.path.abspath(p).startswith(prefix)]:
            _INVAL_GEN[path] = _INVAL_GEN.get(path, 0) + 1
            closing.append(_CACHE.pop(path))
        # handles currently LEASED to an in-flight query are not in
        # _CACHE, so per-path generation bumps cannot reach them; the
        # epoch bump makes every handle leased across this sweep
        # close at checkin instead of re-entering the cache
        _EPOCH[0] += 1
    with _FIND_LOCK:
        for d in [d for d in _FIND_CACHE
                  if os.path.abspath(d) == root or
                  os.path.abspath(d).startswith(prefix)]:
            _FIND_CACHE.pop(d)
    for handle in closing:
        handle.querier.close()


def find_cache_stats():
    """Size of the whole-tree find memo (`dn serve` /stats)."""
    with _FIND_LOCK:
        return {'size': len(_FIND_CACHE)}


def cache_epoch():
    """Monotonic epoch of the shard/find caches — bumped by
    shard_cache_clear and every whole-tree invalidation
    (invalidate_index_tree), i.e. whenever an index under this process
    was rewritten.  The serve result cache and the device residency
    pins stamp entries with it, so an epoch bump retires them all at
    once."""
    with _CACHE_LOCK:
        return _EPOCH[0]


# -- shard-list (find) cache ----------------------------------------------

# root directory -> (dir statkey, [(path, stat)], stage snapshot).
# Unbounded queries walk the whole flat index tree — one os.stat per
# shard, ~25 ms of syscalls on a 365-shard year — to produce a file
# list the serving path then reads THROUGH the handle cache anyway.
# The listing is a pure function of the directory, whose own stat
# identity changes on every add/remove/rename within it (shard
# rewrites land via tmp+rename), so one directory stat validates the
# whole cached walk; in-process writers invalidate explicitly via
# shard_cache_invalidate, same contract as the handle cache.
_FIND_LOCK = threading.Lock()
_FIND_CACHE = {}


def cached_find_walk(root, pipeline):
    """find_walk([root]) memoized on the directory's stat identity,
    replaying the walk's pipeline stages and counters exactly (the
    --counters bytes are pinned).  Only for the index-query path: the
    cached per-file statbufs go stale (the query path never reads
    them), and warn_func consumers must take the real walk."""
    from . import find as mod_find
    statkey = _statkey(root)
    if statkey is not None:
        with _FIND_LOCK:
            cached = _FIND_CACHE.get(root)
        if cached is not None and cached[0] == statkey:
            _, files, stages = cached
            for name, counters, hidden in stages:
                stage = pipeline.stage(name)
                stage.counters.update(counters)
                stage.hidden.update(hidden)
            return list(files)
    nstages = len(pipeline.stages)
    files = mod_find.find_walk([root], pipeline)
    if statkey is not None:
        stages = [(s.name, dict(s.counters), set(s.hidden))
                  for s in pipeline.stages[nstages:]]
        with _FIND_LOCK:
            if len(_FIND_CACHE) >= 64:
                _FIND_CACHE.pop(next(iter(_FIND_CACHE)))
            _FIND_CACHE[root] = (statkey, list(files), stages)
    return files


# -- query execution ------------------------------------------------------

def query_shard_once(path, query):
    """The sequential building block: open (uncached), query into a
    fresh sub-aggregator, close.  Error wrapping matches the reference
    fan-in (lib/datasource-file.js:629-689).  Returns the shard's
    aggregate as key items (Aggregator.key_items order) — replaying
    them with write_key() merges byte-identically to re-writing the
    shard's points.  Every open here is fresh, so DN_VERIFY=open and
    =full both verify every read on this path."""
    from . import integrity as mod_integrity
    if mod_integrity.verify_mode() != 'off':
        mod_integrity.verify_shard(path)
    try:
        querier = open_index(path)
    except DNError as e:
        raise DNError('index "%s"' % path, cause=e)
    try:
        mod_faults.fire('iq.shard_read')
        sub = Aggregator(query)
        querier.run(query, aggr=sub)
        return list(sub.key_items())
    except DNError as e:
        raise DNError('index "%s" query' % path, cause=e)
    finally:
        querier.close()


def _shard_obs(path, stacked=False):
    """Per-shard observability, tuned for the hot path: the span (and
    its attr construction — basename, kwargs) only exists when a
    trace context is live; the shard_read_ms histogram is always on
    but costs one lock + a few adds."""
    from .obs import trace as obs_trace
    if obs_trace.current_trace() is None:
        return obs_trace.NULL_SPAN
    return obs_trace.span('index_query_mt.shard',
                          shard=os.path.basename(path),
                          stacked=stacked)


def _query_shard_cached(path, query):
    from time import perf_counter
    from .obs import metrics as obs_metrics
    handle = checkout_shard(path)
    ok = False
    t0 = perf_counter()
    try:
        with _shard_obs(path):
            mod_faults.fire('iq.shard_read')
            sub = Aggregator(query)
            handle.querier.run(query, aggr=sub)
            items = list(sub.key_items())
        ok = True
        return items
    except DNError as e:
        raise DNError('index "%s" query' % path, cause=e)
    finally:
        ms = (perf_counter() - t0) * 1000.0
        obs_metrics.observe('shard_read_ms', ms)
        _note_shard_ms(ms)
        checkin_shard(handle, ok=ok)


def _catalog_sig(querier):
    """Identity of a querier's embedded metric catalog.  Computed once
    per open handle (the handle cache keeps queriers hot, so warm
    serving queries never recompute it): shards written by one build
    share a byte-identical catalog, which lets the stacked loader
    reuse one metric selection + composed filter across all of them
    instead of re-running find_metric per shard."""
    sig = getattr(querier, '_stack_catalog_sig', None)
    if sig is None:
        sig = tuple((m['qm_id'], m['qm_label'], m['qm_filter_raw'],
                     repr(m['qm_params'])) for m in querier.qi_metrics)
        querier._stack_catalog_sig = sig
    return sig


def _load_shard_blocks_cached(path, query, memo):
    """Stacked-mode building block: lease a shard handle and load the
    query's matching column blocks (querier.stack_blocks) instead of
    executing a per-shard group-by.  `memo` caches the metric
    selection / composed filter / groupby projection per catalog
    signature for the duration of one fan-out (find_metric and the
    filter deepcopy+escape are pure functions of (query, catalog)).
    Error wrapping is identical to the query path: a bad open raises
    DNError('index "<path>"') from checkout_shard, anything mid-load
    DNError('index "<path>" query') — so a corrupt or truncated shard
    reports the same way whichever execution mode hit it, and the
    failed handle is closed (never re-cached) by the ok=False
    checkin."""
    from time import perf_counter
    from .obs import metrics as obs_metrics
    handle = checkout_shard(path)
    ok = False
    t0 = perf_counter()
    try:
        with _shard_obs(path, stacked=True):
            mod_faults.fire('iq.shard_read')
            querier = handle.querier
            plan = memo.get(_catalog_sig(querier))
            if plan is None:
                table = querier.find_metric(query)
                if isinstance(table, DNError):
                    raise table
                filt = querier._compose_filter(query, table)
                groupby = querier._groupby_columns(query)
                plan = (table, filt, groupby)
                memo[_catalog_sig(querier)] = plan
            table, filt, groupby = plan
            blocks = querier.stack_blocks(table, filt, groupby)
        ok = True
        return blocks, handle.statkey
    except DNError as e:
        raise DNError('index "%s" query' % path, cause=e)
    finally:
        obs_metrics.observe('shard_read_ms',
                            (perf_counter() - t0) * 1000.0)
        checkin_shard(handle, ok=ok)


class ShardQueryExecutor(object):
    """Fan a query out across index shards on a worker pool and merge
    per-shard results in submission (find) order.

    Shards are dispatched in CHUNKS (a warm cached shard query runs
    well under a millisecond, so per-shard queue handoffs would cost
    more in lock wakeups and GIL switches than the work itself).
    Workers pull (seq, [paths]) off a bounded queue, query each shard
    through the handle cache into a private sub-aggregator, and post
    (seq, [key_items...]) results; the caller's thread replays results
    into the real aggregator strictly by seq — so output and counter
    totals are byte-identical to the sequential loop.  The first shard
    error (by find order, deterministically) aborts the run and
    re-raises after the pool drains."""

    QUEUE_DEPTH = 4
    MAX_CHUNK = 32

    def __init__(self, query, nworkers):
        assert nworkers >= 1, nworkers
        self.closed = False
        _EXECUTOR_LEAKS.track(self)
        self.query = query
        self.nworkers = nworkers
        self.workq = queue.Queue(maxsize=nworkers + self.QUEUE_DEPTH)
        self.resultq = queue.Queue()
        self._stopping = False
        # workers adopt the submitting request's counter scope so
        # cache-hit/miss telemetry attributes to the right `dn serve`
        # request even on the per-shard pool path
        self._scope = vpipe.current_scope()
        self.threads = []
        for _ in range(nworkers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self.threads.append(t)

    def _worker(self):
        with vpipe.adopt_scope(self._scope):
            self._worker_loop()

    def _worker_loop(self):
        while True:
            item = self.workq.get()
            if item is None:
                return
            seq, chunk = item
            results = []
            error = None
            if not self._stopping:
                for path in chunk:
                    try:
                        results.append(
                            _query_shard_cached(path, self.query))
                    except BaseException as e:
                        error = e     # shards before it still merge
                        break
            self.resultq.put((seq, results, error))

    def run(self, paths, on_items):
        """Query every shard in `paths`, calling on_items(key_items)
        once per shard in find order; returns after all shards merged.
        Must be called exactly once."""
        # ~4 chunks per worker balances handoff amortization against
        # tail imbalance
        chunk = max(1, min(self.MAX_CHUNK,
                           len(paths) // (self.nworkers * 4) or 1))
        pending = {}
        state = {'want': 0, 'error': None}

        def drain(block):
            try:
                item = self.resultq.get(block=block)
            except queue.Empty:
                return False
            seq, results, error = item
            pending[seq] = (results, error)
            while state['want'] in pending:
                results, error = pending.pop(state['want'])
                state['want'] += 1
                if state['error'] is not None:
                    continue
                for items in results:
                    on_items(items)
                if error is not None:
                    state['error'] = error
                    self._stopping = True
            return True

        try:
            nsubmitted = 0
            for start in range(0, len(paths), chunk):
                if state['error'] is not None:
                    break
                self.workq.put((nsubmitted,
                                paths[start:start + chunk]))
                nsubmitted += 1
                while drain(False):
                    pass
            while state['want'] < nsubmitted:
                drain(True)
        finally:
            self.close()
        if state['error'] is not None:
            raise state['error']

    def close(self):
        if self.closed:
            return
        self._stopping = True
        for _ in self.threads:
            self.workq.put(None)
        for t in self.threads:
            t.join()
        self.threads = []
        self.closed = True


def run_shard_queries(paths, query, nworkers, on_items):
    """Entry point for the datasource query path: fan out across
    `paths` on `nworkers` threads (0 = the sequential uncached loop,
    byte-identical output either way), merging per-shard key items in
    find order through on_items.  A single shard skips the pool but
    still goes through the handle cache — repeated narrow queries
    (an 'all' index, a window pruned to one shard) are exactly the
    serving shape the cache amortizes."""
    if nworkers <= 0:
        for path in paths:
            on_items(query_shard_once(path, query))
        return
    if len(paths) == 0:
        return                    # empty window: nothing to query
    if len(paths) == 1:
        on_items(_query_shard_cached(paths[0], query))
        return
    mode = _choose_fanout(len(paths), min(nworkers, len(paths)))
    t0 = time.monotonic()
    if mode == 'seq':
        counter_bump('index query pool degraded')
        for path in paths:
            on_items(_query_shard_cached(path, query))
    else:
        ex = ShardQueryExecutor(query, min(nworkers, len(paths)))
        ex.run(paths, on_items)
    # note only completed fan-outs: a shard error above raises before
    # this line, and a partial timing would poison the comparison
    _note_fanout(mode, (time.monotonic() - t0) * 1000.0 / len(paths))


def run_shard_loads(paths, query, on_blocks):
    """Stacked-mode shard fan-out: load every shard's matching column
    blocks through the handle cache, calling on_blocks(blocks, path,
    statkey) once per shard in find order — path + statkey are the
    shard identity the device lane's residency pins key on
    (device_index._shard_identity upgrades them to the integrity
    catalog's (size, crc32) when the tree publishes one).  Loads run
    on the CALLER's thread
    deliberately: unlike full per-shard queries (whose per-group
    Python work a pool overlaps), a block load is ~50 us of small-
    array numpy that never releases the GIL, and measured on the
    365-shard bench a reader pool made the stacked path ~1.5x SLOWER
    (queue handoffs + GIL convoy), so DN_IQ_THREADS applies only to
    the per-shard execution path.  Loads always go through the handle
    cache — block loading exists only to feed the stacked aggregation,
    so there is no uncached variant.  Error contract matches
    run_shard_queries: the first failing shard in find order raises."""
    memo = {}
    for path in paths:
        blocks, statkey = _load_shard_blocks_cached(path, query, memo)
        on_blocks(blocks, path, statkey)
