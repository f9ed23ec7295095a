"""Server-side query-result cache: repeated identical queries answer
from memory, skipping admission-slot compute entirely.

Correctness before speed — a hit must be byte-identical to
re-executing the query, so an entry is served only while THREE
staleness signals all agree:

* **Key**: admission.compute_key — the canonical coalescing key (op,
  datasource, config identity, normalized query document, interval) —
  already excludes everything that only affects output formatting.

* **Epoch**: index_query_mt.cache_epoch(), bumped by
  invalidate_index_tree — which the server's
  lifecycle.install_writer_invalidation hook fires on EVERY completed
  in-process index write (build, follow publish, compaction, rollup
  build).  Any write anywhere retires every entry: conservative,
  O(1), and exactly the invalidation contract the issue's write-hook
  machinery provides.

* **Validators**: stat identities of the queried tree's shard-bearing
  directories, re-checked on every hit.  A CROSS-process writer (a
  `dn build` run against a live server's tree) publishes by renaming
  into those directories, which changes their mtime — the in-process
  epoch can't see it, the validator does.

Memory accounting shares ONE budget with request admission
(resources.ResourceGovernor.reserve_cache): cached residency and
in-flight request footprint draw on the same DN_SERVE_MEM_BUDGET_MB
pool, so a full cache sheds admissions before the process swaps, and
admission pressure evicts cache entries rather than both sides
double-counting the same RAM.  The cache's own byte bound is
DN_SERVE_CACHE_MB (0 = disabled; the serve path is then byte-for-byte
the uncached one).
"""

import json
import os
import threading
from collections import OrderedDict

from .. import integrity as mod_integrity


def _estimate_nbytes(result):
    """Resident-size estimate of a ScanResult: the serialized length
    of its points plus pipeline counters — the same order of bytes a
    client response carries, which is what the budget is protecting
    against."""
    n = 256
    try:
        if result.points is not None:
            n += len(json.dumps(result.points, default=repr))
        if result.dry_run_files is not None:
            n += sum(len(p) + 16 for p in result.dry_run_files)
        for s in result.pipeline.stages:
            n += 64 + 32 * len(s.counters)
    except (TypeError, ValueError):
        n += 1 << 20        # unserializable points: assume big
    return n


def tree_validators(indexroot):
    """Stat identities of every directory a publish renames into
    (plus the `all` shard file).  None entries record absence — a
    directory appearing later is a change too.

    The integrity catalog rides along because the directory stats
    alone are blind to one cross-process case: a publish that renames
    into per-day subdirectories which ALL already exist changes
    by_day/<day> but not by_day itself.  Every commit rewrites the
    catalog atomically, so its stat identity is a per-publish change
    signal at the tree root — one extra os.stat per hit."""
    if not indexroot:
        return []
    paths = [indexroot,
             mod_integrity.catalog_path(indexroot),
             os.path.join(indexroot, 'all'),
             os.path.join(indexroot, 'by_day'),
             os.path.join(indexroot, 'by_hour'),
             os.path.join(indexroot, 'rollup', 'by_day'),
             os.path.join(indexroot, 'rollup', 'by_month')]
    out = []
    for p in paths:
        try:
            st = os.stat(p)
            out.append((p, (st.st_mtime_ns, st.st_size)))
        except OSError:
            out.append((p, None))
    return out


def _validators_ok(validators):
    for p, sig in validators:
        try:
            st = os.stat(p)
            cur = (st.st_mtime_ns, st.st_size)
        except OSError:
            cur = None
        if cur != sig:
            return False
    return True


class ResultCache(object):
    """LRU over ScanResults, bounded by bytes, validated by epoch +
    tree stat identity.  Thread-safe; governor reservations are only
    ever taken under the cache lock (one-directional lock order:
    cache -> governor, never the reverse)."""

    def __init__(self, budget_bytes, governor=None):
        self.budget = int(budget_bytes or 0)
        self.governor = governor
        self._lock = threading.Lock()
        self._entries = OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._stale = 0
        self._evictions = 0
        self._shed = 0

    def enabled(self):
        return self.budget > 0

    # -- internals (call with self._lock held) ----------------------------

    def _drop_locked(self, key, ent):
        # identity-checked: between a reader's two lock windows a put
        # may have replaced this key — dropping the NEW entry while
        # refunding the OLD entry's bytes would skew the accounting
        if self._entries.get(key) is not ent:
            return
        del self._entries[key]
        self._bytes -= ent['nbytes']
        if self.governor is not None:
            self.governor.release_cache(ent['nbytes'])

    def _evict_lru_locked(self):
        if not self._entries:
            return False
        key, ent = next(iter(self._entries.items()))
        self._drop_locked(key, ent)
        self._evictions += 1
        return True

    # -- the cache protocol ------------------------------------------------

    def get(self, key, epoch):
        """The cached ScanResult for `key`, or None.  The caller must
        clone_for_output() before formatting (exactly like a
        coalesced execution) — the cached result is shared."""
        if not self.enabled() or key is None:
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent['epoch'] == epoch:
                self._entries.move_to_end(key)
            elif ent is not None:
                self._drop_locked(key, ent)
                self._stale += 1
                ent = None
        if ent is None:
            with self._lock:
                self._misses += 1
            return None
        # stat checks outside the lock — no other thread can free
        # this entry's governor bytes out from under a concurrent
        # put: a drop only ever releases what _bytes still accounts
        if not _validators_ok(ent['validators']):
            with self._lock:
                self._drop_locked(key, ent)
                self._stale += 1
                self._misses += 1
            return None
        with self._lock:
            self._hits += 1
        return ent['result']

    def put(self, key, epoch, validators, result):
        """Insert a computed result.  Over-budget inserts evict LRU
        entries; when the SHARED memory budget (governor) refuses even
        after the cache is empty, the insert is shed — request
        admission always outranks cache residency."""
        if not self.enabled() or key is None:
            return False
        nbytes = _estimate_nbytes(result)
        if nbytes > self.budget:
            with self._lock:
                self._shed += 1
            return False
        ent = {'epoch': epoch, 'validators': validators,
               'result': result, 'nbytes': nbytes}
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._drop_locked(key, old)
            while self._bytes + nbytes > self.budget:
                if not self._evict_lru_locked():
                    break
            if self.governor is not None:
                while not self.governor.reserve_cache(nbytes):
                    if not self._evict_lru_locked():
                        self._shed += 1
                        return False
            self._entries[key] = ent
            self._bytes += nbytes
        return True

    def clear(self):
        """Drop everything and hand every reserved byte back (drain
        path, and the big hammer for tests)."""
        with self._lock:
            for key, ent in list(self._entries.items()):
                self._drop_locked(key, ent)

    def stats(self):
        with self._lock:
            hits, misses = self._hits, self._misses
            doc = {
                'enabled': self.enabled(),
                'budget_bytes': self.budget,
                'bytes': self._bytes,
                'entries': len(self._entries),
                'hits': hits,
                'misses': misses,
                'stale_drops': self._stale,
                'evictions': self._evictions,
                'shed': self._shed,
            }
        total = hits + misses
        doc['hit_rate'] = round(hits / total, 4) if total else 0.0
        return doc
