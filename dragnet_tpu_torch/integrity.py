"""Shard integrity: the per-tree checksum catalog, verified reads and
the scrub walk.

Counterpart of dragnet_tpu/integrity.py (whole):

* The catalog (`.dn_integrity.json` in the index root) records every
  committed shard's (size, crc32), written exactly like the journal
  commit record (fsynced tmp + atomic rename) and updated through the
  SAME publish path (index_build_mt.publish_prepared embeds the
  checksums in the commit record; the recovery sweep's roll-forward
  replays them), so the catalog can never disagree with a committed
  tree: builds, `dn follow` merge-publishes, handoff-fetched shards
  and repair pulls all land entries.

* Verified reads (DN_VERIFY=off|open|full): `open` checks size+crc on
  first shard-handle open — the handle cache's (path, mtime_ns, size,
  ino) identity then amortizes it; `full` re-verifies on every lease.
  A mismatch quarantines the shard into `.dn_quarantine/`, bumps the
  handle-cache generation and raises the clean retryable
  ShardIntegrityError naming the shard.  In verify modes the query
  walk also refuses a tree whose catalog names shards that are
  MISSING on disk: short results must be an explicit degradation, not
  a silent one.

* The scrub walk (scrub_tree — `dn scrub`, the `scrub` serve op and
  the DN_SCRUB_INTERVAL_S background thread) compares every shard's
  bytes against the catalog at a bounded read rate, quarantining
  mismatches; cluster members follow up with anti-entropy repair
  (serve/scrub.py), pulling the good copy from a committed co-replica.

All of it is host code: no device work, on the card or off it.
"""

import json
import os
import threading
import time
import zlib

from .errors import DNError
from .vpipe import counter_bump

CATALOG_NAME = '.dn_integrity.json'
CATALOG_VERSION = 1

_CRC_CHUNK = 1 << 20

VERIFY_MODES = ('off', 'open', 'full')


class ShardIntegrityError(DNError):
    """A shard's bytes do not match the integrity catalog (or a
    catalogued shard is missing).  Retryable by contract: in a
    cluster the router fails the partial over to a replica while the
    damaged member repairs itself; locally a retry reaches the tree
    once the operator (or `dn scrub --repair`) has healed it."""

    def __init__(self, message, indexroot=None, shards=None):
        super(ShardIntegrityError, self).__init__(message)
        self.retryable = True
        self.integrity_root = indexroot
        self.integrity_shards = list(shards or [])
        self.corrupt_shard = self.integrity_shards[0] \
            if self.integrity_shards else None


def file_crc(path, limiter=None):
    """(size, crc32) of a file, streamed in bounded chunks; an
    optional RateLimiter bounds the read bandwidth (the scrub's
    janitor discipline)."""
    crc = 0
    size = 0
    with open(path, 'rb') as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
            if limiter is not None:
                limiter.consume(len(chunk))
    return size, crc & 0xffffffff


# -- DN_VERIFY mode ---------------------------------------------------------

_MODE_MEMO = [None, 'off']


def verify_mode():
    """The resolved DN_VERIFY mode.  The runtime reads the env
    forgivingly (a live daemon must not crash on an env edit — an
    unknown value reads as 'off'); config.integrity_config is where
    malformed values are REJECTED with the shared DNError contract
    (`dn serve --validate`)."""
    v = os.environ.get('DN_VERIFY', 'off')
    if v == _MODE_MEMO[0]:
        return _MODE_MEMO[1]
    mode = v if v in VERIFY_MODES else 'off'
    _MODE_MEMO[0] = v
    _MODE_MEMO[1] = mode
    return mode


# -- the catalog ------------------------------------------------------------

def catalog_path(indexroot):
    return os.path.join(os.path.abspath(indexroot), CATALOG_NAME)


def indexroot_of(shard_path):
    """The index root a shard path belongs to: interval shards live
    one level down (`by_day/`, `by_hour/`), rollup shards two levels
    down (`rollup/by_day/`, `rollup/by_month/`), the `all` shard
    directly in the root."""
    d = os.path.dirname(os.path.abspath(shard_path))
    if os.path.basename(d) in ('by_day', 'by_hour', 'by_month'):
        d = os.path.dirname(d)
        if os.path.basename(d) == 'rollup':
            return os.path.dirname(d)
        return d
    return d


def shard_rel(indexroot, shard_path):
    return os.path.relpath(os.path.abspath(shard_path),
                           os.path.abspath(indexroot))


# one write lock per tree: catalog updates are read-modify-write, and
# concurrent in-process publishers (serve builds + follow) must not
# lose each other's entries
_LOCKS_LOCK = threading.Lock()
_TREE_LOCKS = {}


def _tree_lock(indexroot):
    key = os.path.abspath(indexroot)
    with _LOCKS_LOCK:
        return _TREE_LOCKS.setdefault(key, threading.Lock())


def _read_catalog_doc(path):
    """The parsed catalog document, or None when absent/unreadable.
    A malformed catalog (should be impossible: it lands via fsynced
    tmp+rename) reads as absent — verification degrades to
    'unverified', never to a traceback."""
    try:
        with open(path, 'r') as f:
            doc = json.loads(f.read())
        shards = doc.get('shards')
        if not isinstance(shards, dict):
            return None
        return doc
    except (OSError, ValueError):
        return None


def load_catalog(indexroot):
    """{relpath: (size, crc32)} for the tree, {} when no catalog
    exists (a legacy tree: nothing can be verified)."""
    doc = _read_catalog_doc(catalog_path(indexroot))
    if doc is None:
        return {}
    out = {}
    for rel, ent in doc['shards'].items():
        try:
            out[rel] = (int(ent[0]), int(ent[1]))
        except (TypeError, ValueError, IndexError):
            continue
    return out


def update_catalog(indexroot, add=None, remove=None):
    """Merge entries into the tree's catalog: read-modify-write under
    the per-tree in-process lock AND an flock on a sidecar lockfile
    (a `dn follow` publisher and a `dn serve` repair can both land
    entries in the same tree from different processes — without the
    flock the second rename would silently drop the first writer's
    entry), fsynced tmp + atomic rename like the journal commit
    record.  `add` is {relpath: (size, crc32)}; `remove` an iterable
    of relpaths.  Returns the resulting {relpath: (size, crc)}
    map."""
    import fcntl
    indexroot = os.path.abspath(indexroot)
    path = catalog_path(indexroot)
    with _tree_lock(indexroot):
        os.makedirs(indexroot, exist_ok=True)
        lockf = open(path + '.lock', 'a')
        try:
            try:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
            except OSError:
                pass             # flock-less filesystem: best effort
            shards = {}
            doc = _read_catalog_doc(path)
            if doc is not None:
                shards = doc['shards']
            for rel in (remove or ()):
                shards.pop(rel, None)
            for rel, (size, crc) in (add or {}).items():
                shards[rel] = [int(size), int(crc)]
            out_doc = {'version': CATALOG_VERSION, 'shards': shards}
            tmp = path + '.%d.tmp' % os.getpid()
            try:
                # the resource-exhaustion seam: an ENOSPC here leaves
                # the committed catalog untouched (tmp+rename) and no
                # tmp litter; when the update rode a publish whose
                # commit record carries the same entries, the
                # sweep's roll-forward re-lands them after recovery
                from . import faults as mod_faults
                mod_faults.fire('integrity.catalog')
                with open(tmp, 'w') as f:
                    f.write(json.dumps(out_doc, sort_keys=True))
                    f.flush()
                    os.fsync(f.fileno())
                os.rename(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        finally:
            lockf.close()        # releases the flock
    _drop_catalog_memo(indexroot)
    return {rel: (ent[0], ent[1]) for rel, ent in shards.items()}


def integrity_entries(paths, tmp_for=None):
    """{relpath-under-root: (size, crc)} for a publish's final shard
    paths, hashed from the PREPARED tmps (tmp_for maps final -> tmp;
    rename does not change bytes, so the tmp's crc IS the committed
    shard's) or from the files themselves.  Unreadable entries are
    skipped — a missing tmp at this point fails the publish itself
    through its own path."""
    out = {}
    for final in paths:
        src = tmp_for(final) if tmp_for is not None else final
        try:
            size, crc = file_crc(src)
        except OSError:
            continue
        root = indexroot_of(final)
        out.setdefault(root, {})[shard_rel(root, final)] = (size, crc)
    return out


def record_published(entries_by_root):
    """Land integrity_entries() output in each tree's catalog (called
    after the renames of a committed publish, and by the recovery
    sweep's roll-forward replaying a dead build's commit record)."""
    for root, entries in entries_by_root.items():
        update_catalog(root, add=entries)


# -- catalog lookup memo (the verified-read hot path) -----------------------

_CAT_MEMO_LOCK = threading.Lock()
_CAT_MEMO = {}        # abspath(indexroot) -> (statkey, {rel: (size,crc)})


def _catalog_statkey(path):
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size, st.st_ino)
    except OSError:
        return None


def _drop_catalog_memo(indexroot):
    with _CAT_MEMO_LOCK:
        _CAT_MEMO.pop(os.path.abspath(indexroot), None)


def cached_catalog(indexroot):
    """load_catalog memoized on the catalog file's stat identity (the
    same validation discipline as the shard-handle cache): one stat
    per lookup, a reparse only when the catalog actually changed."""
    key = os.path.abspath(indexroot)
    statkey = _catalog_statkey(catalog_path(key))
    with _CAT_MEMO_LOCK:
        cached = _CAT_MEMO.get(key)
        if cached is not None and cached[0] == statkey:
            return cached[1]
    table = load_catalog(key) if statkey is not None else {}
    with _CAT_MEMO_LOCK:
        if len(_CAT_MEMO) >= 64:
            _CAT_MEMO.pop(next(iter(_CAT_MEMO)))
        _CAT_MEMO[key] = (statkey, table)
    return table


def expected_entry(shard_path):
    """The catalog's (size, crc) for a shard path, or None when the
    tree has no catalog entry for it (legacy shard: unverifiable)."""
    root = indexroot_of(shard_path)
    return cached_catalog(root).get(shard_rel(root, shard_path))


def reset_memo():
    """Test hook: drop the catalog memo and mode memo."""
    with _CAT_MEMO_LOCK:
        _CAT_MEMO.clear()
    _MODE_MEMO[0] = None


# -- verified reads ---------------------------------------------------------

def quarantine_corrupt(shard_path, detail):
    """A shard failed verification: move it into the tree's
    `.dn_quarantine/` (forensics, never deleted here), retire any
    cached handle AND any handle currently leased (the per-path
    generation bump — a lease taken before the quarantine must not
    re-enter the cache), and raise the clean retryable error naming
    the shard.  The catalog entry is KEPT: it is the byte-exact
    repair target (`dn scrub --repair`, cluster self-healing)."""
    from . import index_journal as mod_journal
    from . import index_query_mt as mod_iqmt
    root = indexroot_of(shard_path)
    rel = shard_rel(root, shard_path)
    mod_journal._quarantine(root, shard_path)
    mod_iqmt.shard_cache_invalidate(shard_path)
    counter_bump('integrity corrupt shards')
    from .obs import events as obs_events
    from .obs import metrics as obs_metrics
    from .obs import trace as obs_trace
    obs_metrics.inc('integrity_corrupt_shards_total')
    obs_trace.event('integrity.corrupt', shard=rel)
    if obs_events.enabled():
        obs_events.emit('integrity.quarantine', shard=rel,
                        error=detail)
    raise ShardIntegrityError(
        'index "%s": shard integrity check failed (%s); shard '
        'quarantined' % (shard_path, detail),
        indexroot=root, shards=[rel])


def verify_shard(shard_path):
    """One verified read: compare the shard's bytes to its catalog
    entry.  No entry -> unverified (counted), never an error.  A
    mismatch quarantines and raises ShardIntegrityError (see
    quarantine_corrupt).  An unreadable shard falls through: the open
    path reports it with its own established error.

    Cross-process publish tolerance: a publisher in ANOTHER process
    (`dn follow` appending to a served tree) renames its shards and
    then lands the catalog update — a read in that millisecond window
    sees new bytes against the old entry.  A mismatch therefore gets
    one re-check after a short grace with both sides re-read fresh;
    true rot persists, the publish race does not (and a publisher
    that DIED in the window left its journal, which the next sweep
    rolls forward into the catalog before the next walk)."""
    expected = expected_entry(shard_path)
    if expected is None:
        counter_bump('integrity reads unverified')
        return False
    try:
        size, crc = file_crc(shard_path)
    except OSError:
        return False
    counter_bump('integrity reads verified')
    from .obs import metrics as obs_metrics
    obs_metrics.inc('integrity_verified_reads_total')
    if (size, crc) == expected:
        return True
    time.sleep(0.05)
    _drop_catalog_memo(indexroot_of(shard_path))
    expected = expected_entry(shard_path)
    try:
        size, crc = file_crc(shard_path)
    except OSError:
        return False
    if expected is None or (size, crc) == expected:
        return expected is not None
    quarantine_corrupt(
        shard_path,
        'size %d crc %d, catalog says size %d crc %d'
        % (size, crc, expected[0], expected[1]))


def check_missing(indexroot, present_paths, subdir=None,
                  timeformat=None, after_ms=None, before_ms=None,
                  partition_filter=None):
    """The missing-shard gate for verify modes: catalog entries whose
    files should have been in this query's walk but were not raise
    the same clean retryable contract as a corrupt detect — a
    quarantined-but-unrepaired (or externally deleted) shard must be
    an EXPLICIT degradation, never silently short result bytes.

    `present_paths` is the walked shard set; the expected set is the
    catalog's entries under `subdir` (e.g. 'by_day'; None = the bare
    'all' shard), narrowed by the query's time window (the walk never
    enumerates out-of-window shards) and, for cluster partials, by
    `partition_filter(abspath)`."""
    catalog = cached_catalog(indexroot)
    if not catalog:
        return
    indexroot = os.path.abspath(indexroot)
    present = {os.path.abspath(p) for p in present_paths}
    missing = []
    for rel in sorted(catalog):
        parts = rel.split('/')
        if subdir is None:
            if len(parts) != 1:
                continue
        elif len(parts) != 2 or parts[0] != subdir:
            continue
        path = os.path.join(indexroot, rel)
        if path in present:
            continue
        if timeformat is not None and before_ms is not None and \
                after_ms is not None:
            from .index_query_mt import shard_time_range
            window = shard_time_range(path, timeformat)
            if window is not None and \
                    not (window[0] < before_ms and
                         window[1] > after_ms):
                continue        # outside the query window: not ours
        if partition_filter is not None and \
                not partition_filter(path):
            continue
        missing.append(rel)
    if missing:
        counter_bump('integrity missing shards', len(missing))
        from .obs import metrics as obs_metrics
        obs_metrics.inc('integrity_missing_shards_total',
                        len(missing))
        raise ShardIntegrityError(
            'index "%s": %d catalogued shard(s) missing on disk '
            '(e.g. "%s"); repair or `dn scrub --forget-missing`'
            % (indexroot, len(missing), missing[0]),
            indexroot=indexroot, shards=missing)


# -- the scrub walk ---------------------------------------------------------

def iter_tree_shards(indexroot):
    """Every shard file under the tree as (relpath, abspath), litter
    filtered, sorted (the offline analog of serve/rebalance
    iter_shards, without needing a datasource)."""
    from . import index_journal as mod_journal
    indexroot = os.path.abspath(indexroot)
    for sub in ('', 'by_day', 'by_hour'):
        d = os.path.join(indexroot, sub) if sub else indexroot
        try:
            names = sorted(os.listdir(d))
        except OSError:
            continue
        for name in names:
            path = os.path.join(d, name)
            if not os.path.isfile(path):
                continue
            if mod_journal.is_index_litter(name):
                continue
            if not sub and name != 'all':
                continue        # only 'all' lives in the bare root
            yield (shard_rel(indexroot, path), path)


class RateLimiter(object):
    """Bound scrub read bandwidth (bytes/s); 0/None = unlimited.  The
    scrub is a background janitor — it must never compete with the
    serving path for disk."""

    def __init__(self, bytes_per_s):
        self.rate = bytes_per_s or 0
        self._t0 = time.monotonic()
        self._consumed = 0

    def consume(self, nbytes):
        if self.rate <= 0:
            return
        self._consumed += nbytes
        ahead = self._consumed / float(self.rate) - \
            (time.monotonic() - self._t0)
        if ahead > 0:
            time.sleep(min(ahead, 1.0))


def scrub_tree(indexroot, quarantine=True, forget_missing=False,
               rate_bytes_s=0, on_corrupt=None):
    """Walk one tree comparing bytes against the catalog.  Returns
    {'verified', 'corrupt', 'missing', 'uncataloged', 'bytes_read',
    'corrupt_shards': [rel], 'missing_shards': [rel]}.

    Mismatches are quarantined (quarantine=True; `--check` reports
    only) and reported through `on_corrupt(rel, path)` so a cluster
    member can schedule repair.  `forget_missing` drops catalog
    entries for shards gone from disk — the operator's explicit
    acknowledgment of loss (without it they keep failing verify-mode
    queries, by design)."""
    from . import index_journal as mod_journal
    from . import index_query_mt as mod_iqmt
    indexroot = os.path.abspath(indexroot)
    catalog = load_catalog(indexroot)
    limiter = RateLimiter(rate_bytes_s)
    res = {'verified': 0, 'corrupt': 0, 'missing': 0,
           'uncataloged': 0, 'bytes_read': 0,
           'corrupt_shards': [], 'missing_shards': []}
    seen = set()
    for rel, path in iter_tree_shards(indexroot):
        seen.add(rel)
        expected = catalog.get(rel)
        if expected is None:
            res['uncataloged'] += 1
            continue
        try:
            size, crc = file_crc(path, limiter=limiter)
        except OSError:
            # raced a concurrent retire/rewrite; the next pass sees
            # the settled tree
            continue
        res['bytes_read'] += size
        if (size, crc) == expected:
            res['verified'] += 1
            continue
        # re-read BOTH sides once after a short grace: a concurrent
        # publish renames shards then lands the catalog — either read
        # may have straddled it.  True rot persists.
        time.sleep(0.05)
        fresh = load_catalog(indexroot).get(rel)
        try:
            size, crc = file_crc(path, limiter=limiter)
        except OSError:
            continue
        res['bytes_read'] += size
        if fresh is None:
            res['uncataloged'] += 1
            continue
        if (size, crc) == fresh:
            res['verified'] += 1
            continue
        expected = fresh
        res['corrupt'] += 1
        res['corrupt_shards'].append(rel)
        counter_bump('integrity scrub corrupt')
        if quarantine:
            mod_journal._quarantine(indexroot, path)
            mod_iqmt.shard_cache_invalidate(path)
            counter_bump('integrity corrupt shards')
            from .obs import metrics as obs_metrics
            obs_metrics.inc('integrity_corrupt_shards_total')
        if on_corrupt is not None:
            on_corrupt(rel, path)
    for rel in sorted(set(catalog) - seen):
        res['missing'] += 1
        res['missing_shards'].append(rel)
    if forget_missing and res['missing_shards']:
        update_catalog(indexroot, remove=res['missing_shards'])
    return res


# -- quarantine inspection / cleanup ----------------------------------------

def quarantine_entries(indexroot):
    """[(name, bytes, age_s, path)] for the tree's quarantine
    directory, oldest first."""
    from . import index_journal as mod_journal
    qdir = os.path.join(os.path.abspath(indexroot),
                        mod_journal.QUARANTINE_DIR)
    out = []
    now = time.time()
    try:
        names = os.listdir(qdir)
    except OSError:
        return out
    for name in names:
        path = os.path.join(qdir, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        out.append((name, st.st_size, max(0.0, now - st.st_mtime),
                    path))
    out.sort(key=lambda e: -e[2])
    return out


def quarantine_stats(indexroot):
    """{'files', 'bytes'} of the tree's quarantine directory (the
    /stats `recovery.quarantine_bytes` gauge feed)."""
    entries = quarantine_entries(indexroot)
    return {'files': len(entries),
            'bytes': sum(e[1] for e in entries)}


def quarantine_clean(indexroot, older_than_s=0, max_bytes=None):
    """Delete quarantined artifacts older than `older_than_s` (0 =
    everything).  With `max_bytes`, evict OLDEST-FIRST only until the
    directory fits the byte budget (newer forensics survive — the
    most recent incident is the one an operator still wants).
    Returns (files_removed, bytes_removed).  This is the ONLY place
    quarantined forensics are deleted — on operator request
    (`dn quarantine clean [--max-bytes N]`) or the serve scrub
    timer's DN_QUARANTINE_MAX_MB budget."""
    entries = quarantine_entries(indexroot)
    total = sum(e[1] for e in entries)
    removed = 0
    freed = 0
    for name, size, age_s, path in entries:
        if max_bytes is not None and total <= max_bytes:
            break
        if age_s < older_than_s:
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        removed += 1
        freed += size
        total -= size
    return removed, freed


def configured_index_trees(cfg_path=None):
    """[(dsname, indexroot)] for every configured file datasource
    with an index tree — what `dn scrub`/`dn quarantine` walk by
    default and the serve-side scrubber iterates."""
    from . import config as mod_config
    backend = mod_config.ConfigBackendLocal(cfg_path)
    err, config = backend.load()
    if err is not None and not getattr(err, 'is_enoent', False):
        raise err
    out = []
    for dsname, dsdoc in config.datasource_list():
        idx = (dsdoc.get('ds_backend_config') or {}).get('indexPath')
        if idx:
            out.append((dsname, idx))
    return out
