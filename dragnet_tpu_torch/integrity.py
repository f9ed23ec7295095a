"""Shard integrity: the per-tree checksum catalog.

Counterpart of dragnet_tpu/integrity.py, its publish half: the catalog
(`.dn_integrity.json` in the index root) records every committed
shard's (size, crc32), written exactly like the journal commit record
(fsynced tmp + atomic rename) and updated through the SAME publish
path (index_build_mt.publish_prepared embeds the checksums in the
commit record; the recovery sweep's roll-forward replays them), so the
catalog can never disagree with a committed tree.

The reference's verified reads (DN_VERIFY), quarantine and scrub walk
read this catalog on the query side; they come with `dn query`.
"""

import json
import os
import threading
import zlib


CATALOG_NAME = '.dn_integrity.json'
CATALOG_VERSION = 1

_CRC_CHUNK = 1 << 20

def file_crc(path):
    """(size, crc32) of a file, streamed in bounded chunks."""
    crc = 0
    size = 0
    with open(path, 'rb') as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return size, crc & 0xffffffff


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
