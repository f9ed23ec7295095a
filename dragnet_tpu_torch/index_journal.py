"""Crash-safe index publishing: per-build commit journals + a
recovery sweep.

Each shard has always been written to a tmp name and renamed into
place atomically — one FILE can never be torn.  But a build writes a
whole SET of shards, and a builder that dies mid-set (kill -9, OOM,
power cut) used to leave two kinds of damage no error path could
clean: orphaned `<name>.<pid>` tmp files (crash hygiene only ran on
the failed process's own error paths), and — if it died between
renames — a half-renamed shard set: a reader saw some new shards next
to some old ones, a state neither the pre-build nor the post-build
query output describes.

This module closes both holes with a two-phase publish:

1. Every sink PREPARES: the complete shard body lands in its tmp
   file (`<shard>.<pid>.<seq>`, the build id — concurrent builds
   cannot collide, and the owner pid is readable off the name).
   Nothing is renamed yet.
2. The build JOURNAL (`.dn_build.<pid>.<seq>.json` in the index root,
   written atomically, fsynced) records every (tmp, final) pair —
   this is the commit point.
3. The tmps are renamed into place and the journal retired
   (unlinked).

The recovery sweep (sweep_index_tree — run at build start, `dn serve`
start, and TTL-throttled on the query path) lands any crash on
exactly one side of the commit point:

* a journal whose owner pid is dead is rolled FORWARD: every tmp was
  complete before the journal existed, so the remaining renames are
  finished and the tree is exactly post-build;
* tmps with no journal and a dead owner pid never reached the commit
  point: the build never happened.  They are quarantined into
  `<indexroot>/.dn_quarantine/` (moved, not deleted — torn bytes are
  forensics), leaving the tree exactly pre-build.

Tmps whose owner pid is alive (an in-flight build) and journals of
live pids are left strictly alone.  Readers filter journal, tmp, and
quarantine names out of index walks (is_index_litter), so a tree
mid-build or mid-recovery still serves a consistent view.

Recovery activity is counted ('index recovery rollbacks' /
'index recovery rollforwards', 'index tmps quarantined') via the
hidden global counters `dn serve` surfaces in /stats.
"""

import json
import os
import re
import threading
import time

from .vpipe import counter_bump

JOURNAL_PREFIX = '.dn_build.'
QUARANTINE_DIR = '.dn_quarantine'
# the per-tree integrity catalog (integrity.py): (size, crc32) of
# every committed shard, updated through the publish/recovery paths
# in this module so it can never disagree with a committed tree
INTEGRITY_NAME = '.dn_integrity.json'
# `dn follow`'s durable state (checkpoint.json, the mini-batch spool)
# lives under this subdirectory of the index root; its checkpoint
# publishes through the SAME commit journal as the shards, so the
# sweep treats its tmps like shard tmps
FOLLOW_DIR = '.dn_follow'
# the event journal's optional JSONL spill (obs/events.py,
# DN_EVENTS_FILE): operators may point it inside an index tree —
# readers must filter it from shard walks, and litter checkers must
# not flag it as a torn artifact
EVENTS_PREFIX = '.dn_events'

# `dn follow --append`'s mini-generation shards: `<shard>-gNNNNNN`
# next to their base shard.  The base name is a strict prefix, so a
# sorted directory listing replays base-then-generations in publish
# order.  rollup.py owns the naming; the journal only needs to treat
# generation tmps as tmps.
GEN_SEP = '-g'
# rollup shards (day-from-hour, month-from-day) live under
# `<indexroot>/rollup/<level>/`; the planner reads them, ordinary
# index walks never do.  Each level carries a `.dn_rollup.json`
# manifest naming the exact fine shards it was built from.
ROLLUP_DIR = 'rollup'
ROLLUP_MANIFEST = '.dn_rollup.json'
ROLLUP_SUBDIRS = (os.path.join(ROLLUP_DIR, 'by_day'),
                  os.path.join(ROLLUP_DIR, 'by_month'))

# tmp names: `<shard>.<pid>` (legacy single-sink flushes) or
# `<shard>.<pid>.<seq>` (journaled builds); shards are `all` or
# `*.sqlite` (optionally with a `-gNNNNNN` generation suffix), plus
# the follow checkpoint (`checkpoint.json.<pid>.<seq>` under
# FOLLOW_DIR — it rides the same two-phase publish).  A SIGKILLed
# SQLite engine additionally leaves its own `-journal`/`-wal`/`-shm`
# sidecars next to the tmp — same litter.
_TMP_RE = re.compile(
    r'^(all|.*\.sqlite|checkpoint\.json)(-g\d+)?(\.\d+)+'
    r'(-(journal|wal|shm))?$')

_SEQ_LOCK = threading.Lock()
_SEQ = [0]


def new_build_id():
    """`<pid>.<seq>`: unique per build within a process, and the
    recovery sweep can read the owner pid straight off any tmp name
    carrying it."""
    with _SEQ_LOCK:
        _SEQ[0] += 1
        return '%d.%d' % (os.getpid(), _SEQ[0])


def is_index_litter(name):
    """True when a directory entry is build machinery, not a shard:
    journals, in-flight/orphaned tmps, the quarantine directory.
    Readers drop these from index walks."""
    base = os.path.basename(name)
    return (base.startswith(JOURNAL_PREFIX) or
            base == QUARANTINE_DIR or
            base == FOLLOW_DIR or
            base == ROLLUP_DIR or
            base.startswith(INTEGRITY_NAME) or
            base.startswith(ROLLUP_MANIFEST) or
            base.startswith(EVENTS_PREFIX) or
            _TMP_RE.match(base) is not None)


def is_durable_metadata(name):
    """True for tree metadata that readers filter from shard walks
    but that is NOT litter: the committed integrity catalog and its
    cross-process flock sidecar, and the event journal's JSONL spill
    (append-only, fsync-free — never a torn shard).  Litter checkers
    (the soaks' zero-torn-shards invariant) exempt these; catalog
    `.tmp`s stay litter."""
    base = os.path.basename(name)
    return base in (INTEGRITY_NAME, INTEGRITY_NAME + '.lock',
                    ROLLUP_MANIFEST) or \
        base.startswith(EVENTS_PREFIX)


def _tmp_owner_pid(name):
    """The pid embedded in a tmp name (the first of its trailing
    numeric components), or None.  SQLite sidecar suffixes are
    stripped so `x.sqlite.<pid>.1-journal` reads the same owner as
    its tmp."""
    name = re.sub(r'-(journal|wal|shm)$', '', name)
    parts = name.split('.')
    run = []
    for p in reversed(parts):
        if p.isdigit():
            run.append(p)
        else:
            break
    if not run:
        return None
    return int(run[-1])


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


class BuildJournal(object):
    """One build's commit record: created up front for its build id
    (every sink of the build writes tmps under `tmp_suffix`), written
    to disk only at the commit point."""

    def __init__(self, indexroot):
        self.indexroot = os.path.abspath(indexroot)
        self.build_id = new_build_id()
        self.tmp_suffix = self.build_id
        self.path = os.path.join(
            self.indexroot, JOURNAL_PREFIX + self.build_id + '.json')
        self.entries = []        # [(tmp_path, final_path)]

    def tmp_for(self, final):
        return final + '.' + self.tmp_suffix

    def record_commit(self, final_paths, integrity=None,
                      deletes=None, integrity_remove=None):
        """THE commit point: atomically publish the (tmp, final) list.
        Every tmp must already be complete on disk.  After this
        record lands, the build WILL be observed (the renames below,
        or the recovery sweep's roll-forward).  `integrity` is the
        shard set's {indexroot: {relpath: (size, crc)}} checksum map
        (integrity.integrity_entries, hashed from the prepared tmps):
        riding the commit record means the sweep's roll-forward can
        land the SAME catalog entries the in-process publish would
        have — the catalog never disagrees with a committed tree.
        `deletes` (absolute paths) names shards this publish
        SUPERSEDES (the compactor's consumed generations): they are
        unlinked AFTER the renames land, in-process or by the
        roll-forward, with `integrity_remove` ({root: [relpaths]})
        retiring their catalog entries in the same pass."""
        self.entries = [(self.tmp_for(os.path.abspath(p)),
                         os.path.abspath(p)) for p in final_paths]
        # wall clock ON PURPOSE: this is a
        # forensic timestamp in a persisted record read across
        # processes, never a duration — monotonic would be meaningless
        doc = {'pid': os.getpid(), 'build_id': self.build_id,
               'state': 'commit', 'time': time.time(),
               'entries': [[t, f] for t, f in self.entries]}
        if integrity:
            doc['integrity'] = {
                root: {rel: [size, crc]
                       for rel, (size, crc) in entries.items()}
                for root, entries in integrity.items()}
        if deletes:
            doc['deletes'] = [os.path.abspath(p) for p in deletes]
        if integrity_remove:
            doc['integrity_remove'] = {
                root: list(rels)
                for root, rels in integrity_remove.items()}
        tmp = self.path + '.tmp'
        # a zero-bucket build never had a sink create indexroot, but
        # the commit record still lands there
        os.makedirs(self.indexroot, exist_ok=True)
        try:
            # the resource-exhaustion seam: an ENOSPC here is
            # PRE-commit — no record landed, the caller aborts its
            # prepared tmps and the tree is exactly pre-build
            from . import faults as mod_faults
            mod_faults.fire('journal.commit')
            with open(tmp, 'w') as f:
                f.write(json.dumps(doc))
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self.path)
        except BaseException:
            # never strand a half-written record tmp: the commit
            # point was not reached, so the tmp is pure litter
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def retire(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass


def apply_commit_deletes(doc):
    """Apply a commit record's `deletes` + `integrity_remove`
    sections (the compactor's consumed generations).  Runs AFTER the
    renames — the superseding shard is already in place, so a crash
    anywhere in here leaves at worst an extra generation the next
    compaction pass (or roll-forward of this very record) retires;
    every step is idempotent."""
    deletes = doc.get('deletes') or []
    if not deletes:
        return
    from .index_query_mt import shard_cache_invalidate
    for path in deletes:
        try:
            os.unlink(path)
            shard_cache_invalidate(path)
        except OSError:
            pass
    removals = doc.get('integrity_remove')
    if isinstance(removals, dict):
        from . import integrity as mod_integrity
        for root, rels in removals.items():
            try:
                mod_integrity.update_catalog(root, remove=list(rels))
            except OSError:
                pass


# -- recovery sweep --------------------------------------------------------

def _quarantine(indexroot, path):
    """Move a torn/orphaned artifact into `<indexroot>/.dn_quarantine`
    (never delete: the operator may want the forensics)."""
    qdir = os.path.join(indexroot, QUARANTINE_DIR)
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, os.path.basename(path))
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(
                qdir, '%s.%d' % (os.path.basename(path), n))
        os.rename(path, dest)
        counter_bump('index tmps quarantined')
        return True
    except OSError:
        return False


def _roll_forward(indexroot, jpath, doc, result):
    """Finish a dead build's renames from its commit record, then
    retire the journal.  Idempotent: already-renamed entries have no
    tmp left.  The record's integrity map (when present) lands in the
    per-tree catalog exactly as the dead publisher would have landed
    it — a recovered tree verifies like a cleanly published one."""
    from .index_query_mt import shard_cache_invalidate
    for tmp, final in (doc.get('entries') or []):
        if os.path.exists(tmp):
            try:
                os.rename(tmp, final)
                shard_cache_invalidate(final)
            except OSError:
                _quarantine(indexroot, tmp)
    integ = doc.get('integrity')
    if isinstance(integ, dict):
        from . import integrity as mod_integrity
        try:
            mod_integrity.record_published({
                root: {rel: (ent[0], ent[1])
                       for rel, ent in entries.items()
                       if isinstance(ent, list) and len(ent) == 2}
                for root, entries in integ.items()
                if isinstance(entries, dict)})
        except OSError:
            pass
    apply_commit_deletes(doc)
    counter_bump('index recovery rollforwards')
    result['rollforwards'] += 1
    try:
        os.unlink(jpath)
    except OSError:
        pass


def sweep_index_tree(indexroot):
    """Recover dead builds' journals and quarantine orphaned tmps
    under `indexroot` (the datasource indexPath: shards live in it
    directly ('all') and under by_day/ and by_hour/).  Journals and
    tmps whose owner pid is alive — in-flight builds — are left
    strictly alone.  Returns a summary dict."""
    indexroot = os.path.abspath(indexroot)
    result = {'rollbacks': 0, 'rollforwards': 0, 'quarantined': 0,
              'live_builds': 0}
    try:
        names = sorted(os.listdir(indexroot))
    except OSError:
        return result

    live_tmps = set()
    for name in names:
        if name.startswith(INTEGRITY_NAME + '.') and \
                name.endswith('.tmp'):
            # a catalog update cut short mid-write: the committed
            # catalog (renamed atomically) is untouched; the torn tmp
            # of a dead writer is litter
            parts = name.split('.')
            pid = int(parts[-2]) if len(parts) >= 2 and \
                parts[-2].isdigit() else None
            if pid is None or not _pid_alive(pid):
                _quarantine(indexroot, os.path.join(indexroot, name))
            continue
        if not name.startswith(JOURNAL_PREFIX):
            continue
        jpath = os.path.join(indexroot, name)
        if name.endswith('.json.tmp'):
            # a journal write cut short mid-record: the build never
            # committed; its shard tmps are quarantined below
            parts = name.split('.')
            pid = int(parts[2]) if len(parts) > 2 and \
                parts[2].isdigit() else None
            if pid is None or not _pid_alive(pid):
                _quarantine(indexroot, jpath)
            continue
        if not name.endswith('.json'):
            continue
        try:
            with open(jpath) as f:
                doc = json.loads(f.read())
            pid = int(doc.get('pid'))
        except (OSError, ValueError, TypeError):
            # unreadable journal (should be impossible: journals land
            # via tmp+rename) — quarantine it
            _quarantine(indexroot, jpath)
            continue
        if _pid_alive(pid):
            result['live_builds'] += 1
            for tmp, final in (doc.get('entries') or []):
                live_tmps.add(os.path.abspath(tmp))
            continue
        _roll_forward(indexroot, jpath, doc, result)

    rolled_back = False
    for sub in ('', 'by_day', 'by_hour', FOLLOW_DIR) + ROLLUP_SUBDIRS:
        d = os.path.join(indexroot, sub) if sub else indexroot
        try:
            entries = sorted(os.listdir(d))
        except OSError:
            continue
        for name in entries:
            if name.startswith(ROLLUP_MANIFEST + '.'):
                # a manifest update cut short mid-write (same shape as
                # the catalog-tmp case above): committed manifests
                # rename atomically, a dead writer's tmp is litter
                parts = name.split('.')
                pid = int(parts[-2]) if len(parts) >= 2 and \
                    parts[-2].isdigit() else None
                if pid is None or not _pid_alive(pid):
                    _quarantine(indexroot, os.path.join(d, name))
                continue
            if _TMP_RE.match(name) is None:
                continue
            path = os.path.join(d, name)
            if os.path.abspath(path) in live_tmps:
                continue
            pid = _tmp_owner_pid(name)
            if pid is not None and _pid_alive(pid):
                continue             # an in-flight builder's tmp
            if _quarantine(indexroot, path):
                result['quarantined'] += 1
                rolled_back = True
    if rolled_back:
        # journal-less tmps of a dead builder: the build never
        # reached its commit point — quarantining them IS the
        # rollback
        counter_bump('index recovery rollbacks')
        result['rollbacks'] += 1
    return result


def publish_in_flight(indexroot, stale_s, ignore_pid=None):
    """Whether another live process is part way through a publish
    under `indexroot`: one of its tmps (written from the prepare phase
    on) or its commit journal (retired after the renames and the
    catalog) is on disk and was written within the last `stale_s`
    seconds.  A reader that watches the tree's stat identities
    (serve/subscribe.py's revalidation tick) waits for such a publish
    to land instead of walking a tree that is still changing.  Residue
    of `ignore_pid`, and residue older than `stale_s` (what a publish
    whose renames failed leaves in place, until its process publishes
    again or dies), holds nothing: a process's own publishes signal
    themselves, and a wait on a publish that never lands would have no
    end."""
    indexroot = os.path.abspath(indexroot)
    oldest = time.time() - stale_s
    for sub in ('', 'by_day', 'by_hour', FOLLOW_DIR) + ROLLUP_SUBDIRS:
        d = os.path.join(indexroot, sub) if sub else indexroot
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            if name.startswith(JOURNAL_PREFIX):
                # .dn_build.<pid>.<seq>.json (or its .tmp)
                parts = name.split('.')
                pid = int(parts[2]) if len(parts) > 2 and \
                    parts[2].isdigit() else None
            elif _TMP_RE.match(name) is not None:
                pid = _tmp_owner_pid(name)
            else:
                continue
            if pid is None or pid == ignore_pid or not _pid_alive(pid):
                continue
            try:
                if os.stat(os.path.join(d, name)).st_mtime >= oldest:
                    return True
            except OSError:
                continue        # renamed or retired since the listing
    return False


def cleanup_own_stale(indexroot):
    """Retire THIS process's leftover commit journals under
    `indexroot` — the residue of an earlier publish whose rename
    phase failed in-process (the journal and unrenamed tmps are left
    in place as recoverable state).  A new build over the same tree
    supersedes that intent, and must retire it BEFORE publishing:
    otherwise, after this process dies, the sweep would roll the
    STALE journal forward over the newer shards.  Callers are the
    publishers themselves, at publish start (one publish per tree at
    a time — the serve layer's TreeLock serializes; the CLI is one
    build per process)."""
    indexroot = os.path.abspath(indexroot)
    try:
        names = sorted(os.listdir(indexroot))
    except OSError:
        return
    me = str(os.getpid())
    for name in names:
        if not (name.startswith(JOURNAL_PREFIX) and
                name.endswith('.json')):
            continue
        parts = name.split('.')
        if len(parts) < 3 or parts[2] != me:
            continue
        jpath = os.path.join(indexroot, name)
        try:
            with open(jpath) as f:
                doc = json.loads(f.read())
        except (OSError, ValueError):
            doc = {}
        for tmp, final in (doc.get('entries') or []):
            if os.path.exists(tmp):
                _quarantine(indexroot, tmp)
        counter_bump('index stale journals superseded')
        try:
            os.unlink(jpath)
        except OSError:
            pass


def recover_own_committed(indexroot):
    """Roll THIS process's committed-but-unrenamed journals forward
    (finish the renames, retire the record) and return the final
    paths completed.  The follow publisher's retry seam: an
    in-process failure AFTER the commit record (a rename blowing up
    mid-set) leaves complete, fsynced intent — every tmp was fully
    prepared before the record landed.  `cleanup_own_stale` would
    quarantine that intent as superseded, which is correct for a
    full rebuild (the new build rewrites everything) but WRONG for
    an incremental merge: the retry would then re-merge its batch
    over a half-renamed tree and double-count every point in the
    shards that did rename.  Completing the intent first lets the
    retry observe the batch as already published (the checkpoint
    seq renamed with it) and skip it exactly."""
    indexroot = os.path.abspath(indexroot)
    try:
        names = sorted(os.listdir(indexroot))
    except OSError:
        return []
    me = str(os.getpid())
    finals = []
    result = {'rollforwards': 0}
    for name in names:
        if not (name.startswith(JOURNAL_PREFIX) and
                name.endswith('.json')):
            continue
        parts = name.split('.')
        if len(parts) < 3 or parts[2] != me:
            continue
        jpath = os.path.join(indexroot, name)
        try:
            with open(jpath) as f:
                doc = json.loads(f.read())
        except (OSError, ValueError):
            continue                 # cleanup_own_stale quarantines
        _roll_forward(indexroot, jpath, doc, result)
        finals.extend(final for _, final in (doc.get('entries')
                                             or []))
    return finals


# -- TTL-throttled sweep for the query path --------------------------------

_SWEEP_LOCK = threading.Lock()
_SWEEP_MEMO = {}                 # abspath(indexroot) -> monotonic


def _sweep_ttl_s():
    """How long a swept tree stays trusted on the query path
    (DN_SWEEP_TTL_MS, default 1000; 0 sweeps every query).  The sweep
    is three listdirs — cheap, but not free at serving rates."""
    try:
        return max(0, int(os.environ.get('DN_SWEEP_TTL_MS',
                                         '1000'))) / 1000.0
    except ValueError:
        return 1.0


def maybe_sweep(indexroot):
    """sweep_index_tree throttled per tree (queries call this on every
    tree open; builds and `dn serve` startup sweep unconditionally)."""
    if indexroot is None:
        return None
    key = os.path.abspath(indexroot)
    now = time.monotonic()
    with _SWEEP_LOCK:
        last = _SWEEP_MEMO.get(key)
        if last is not None and now - last < _sweep_ttl_s():
            return None
        _SWEEP_MEMO[key] = now
    return sweep_index_tree(indexroot)


def reset_sweep_memo():
    """Test hook."""
    with _SWEEP_LOCK:
        _SWEEP_MEMO.clear()
