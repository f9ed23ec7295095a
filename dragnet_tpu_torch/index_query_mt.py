"""The process-wide shard-handle cache and its invalidation hooks.

Counterpart of dragnet_tpu/index_query_mt.py, reduced for now to the
cache state and the two calls index writers make after publishing
(`shard_cache_invalidate`, `shard_cache_clear`).  The reader pool,
time-range pruning and the handle leases that fill the cache come with
the `dn query` slice; until then nothing in the port opens a cached
handle, and these calls retire an empty cache.
"""

import os
import threading
from collections import OrderedDict

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

# per-directory memo of the shard list an index walk found
_FIND_LOCK = threading.Lock()
_FIND_CACHE = {}


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
    with _FIND_LOCK:
        _FIND_CACHE.clear()
    for handle in handles:
        handle.querier.close()
