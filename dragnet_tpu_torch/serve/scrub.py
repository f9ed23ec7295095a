"""Serve-side integrity: self-healing replica repair, the background
scrub thread, and cluster anti-entropy.

Counterpart (a copy) of dragnet_tpu/serve/scrub.py.  Host code.

The read path (integrity.py) DETECTS damage — a verified read that
fails quarantines the shard and rejects retryably, and the router
fails the partial over to a replica that has the bytes.  This module
closes the loop so detection becomes self-healing:

* RepairManager: when a member's partial hits a corrupt (or
  catalogued-but-missing) shard, the serve layer schedules it here.
  A background worker re-fetches the good copy from a committed
  co-replica over the pooled `shard_fetch` path — crc-verified
  against THIS member's catalog entry, landed journal-style tmp +
  rename (exactly the handoff joiner's discipline, shared code:
  rebalance.land_shard) — and the member serves the partition again
  with byte-identical data.  Repair counters ride /stats
  `integrity`.

* ScrubThread (DN_SCRUB_INTERVAL_S > 0): periodically walks every
  configured tree comparing bytes against the catalog at a bounded
  read rate (DN_SCRUB_RATE_MB_S), quarantining mismatches and
  scheduling their repair.

* anti_entropy: in cluster mode the scrub additionally diffs this
  member's shard set against co-replicas' `shard_manifest` answers
  for every partition it owns, pulling what is missing outright
  (shards this member lost entirely, including their catalog
  entries).  A shard that matches OUR catalog but differs from a
  donor's manifest is counted `diverged` and left alone — that is a
  concurrent publish racing the scrub, not rot; the next pass sees
  the settled trees.

The `scrub` serve op (`dn scrub --remote SOCK`) runs one pass on
demand under the server's tree read locks (an in-process build can
never swap shards mid-scrub), returning the summary as JSON.
"""

import collections
import os
import threading

from ..errors import DNError
from .. import integrity as mod_integrity
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from . import rebalance as mod_rebalance

# the interval-tree layouts index_find_params produces: a manifest/
# catalog relpath maps back to its assignment rule by its subdir
TIMEFORMATS = {'by_day': '%Y-%m-%d.sqlite',
               'by_hour': '%Y-%m-%d-%H.sqlite'}


def rel_timeformat(rel):
    head = rel.split('/')[0] if '/' in rel else rel
    return TIMEFORMATS.get(head)


class RepairManager(object):
    """The damaged member's background self-repair queue.

    schedule() is called from the request path (a corrupt detect must
    not block the rejection riding back to the router) and from the
    scrub; the worker drains one shard at a time.  Work is deduped by
    (indexroot, rel) — a flood of partials hitting the same corrupt
    shard schedules ONE repair."""

    def __init__(self, server):
        self.server = server
        self._lock = threading.Lock()
        self._pending = set()          # (indexroot, rel) queued/active
        self._queue = collections.deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        self.counters = {'scheduled': 0, 'completed': 0,
                         'failed': 0, 'no_donor': 0,
                         'no_catalog': 0, 'bytes_repaired': 0}

    def _bump(self, name, n=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def stats(self):
        with self._lock:
            return dict(self.counters, queued=len(self._queue))

    def schedule(self, dsname, indexroot, rels):
        """Queue shards of `dsname`'s tree for repair (cluster mode
        only — without replicas there is nothing to pull from)."""
        if self.server.cluster is None or self.server.member is None:
            return
        started = False
        with self._lock:
            for rel in rels:
                key = (os.path.abspath(indexroot), rel)
                if key in self._pending:
                    continue
                self._pending.add(key)
                self._queue.append((dsname, key[0], rel))
                self.counters['scheduled'] += 1
                started = True
                if obs_events.enabled():
                    obs_events.emit('repair.scheduled', shard=rel,
                                    ds=dsname)
        if started:
            self._wake.set()
            self._ensure_thread()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, name='dn-shard-repair', daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()

    def _run(self):
        paused = False
        while not self._stop.is_set():
            # resource governance: repair pulls are BACKGROUND disk
            # consumers — under low/critical pressure queued work
            # stays queued (resuming automatically when the governor
            # recovers) instead of filling the last free bytes the
            # serving path needs.  Only pause when there IS work: an
            # idle worker under a long pressure window must not emit
            # a pause event per second for the whole incident.
            gov = getattr(self.server, 'governor', None)
            with self._lock:
                has_work = bool(self._queue)
            if has_work and gov is not None and gov.mode() != 'ok':
                if not paused:
                    paused = True
                    obs_events.emit('resource.paused',
                                    component='repair')
                    obs_metrics.inc('resource_paused_total',
                                    component='repair')
                # pace on the STOP event (the wake event may already
                # be set by a schedule(); waiting on it here would
                # spin) — stop still interrupts the pause instantly
                self._stop.wait(1.0)
                continue
            paused = False
            with self._lock:
                item = self._queue.popleft() if self._queue else None
            if item is None:
                self._wake.clear()
                if self._wake.wait(5.0):
                    continue
                # idle timeout: retire ONLY if nothing raced in —
                # a schedule() between our pop and this check saw a
                # live thread and did not respawn, so returning with
                # a non-empty queue (its keys already in _pending)
                # would strand that shard unrepaired forever
                with self._lock:
                    if self._queue:
                        continue
                    self._thread = None   # next schedule respawns
                return
            dsname, indexroot, rel = item
            try:
                ok = self._repair_one(dsname, indexroot, rel)
            except Exception as e:
                ok = False
                if self.server.log is not None:
                    self.server.log.error('shard repair failed',
                                          rel=rel, err=repr(e))
            finally:
                with self._lock:
                    self._pending.discard((indexroot, rel))
            if ok:
                self._bump('completed')
            else:
                self._bump('failed')
            obs_events.emit(
                'repair.completed' if ok else 'repair.failed',
                shard=rel, ds=dsname)

    def _repair_one(self, dsname, indexroot, rel):
        """Pull one shard's good copy from a committed co-replica,
        verified against OUR catalog entry (the byte-exact repair
        target the publish recorded)."""
        server = self.server
        topo = server.cluster           # committed snapshot
        if topo is None:
            return False
        # the resource-exhaustion seam (and the read-only gate: a
        # repair LANDS bytes — on a disk-critical member that write
        # is refused like any other until space frees)
        from .. import faults as mod_faults
        mod_faults.fire('repair.land')
        gov = getattr(server, 'governor', None)
        if gov is not None:
            gov.check_writable('shard repair')
        expected = mod_integrity.load_catalog(indexroot).get(rel)
        if expected is None:
            self._bump('no_catalog')
            return False
        size, crc = expected
        dest = os.path.join(indexroot, rel)
        try:
            if mod_integrity.file_crc(dest) == expected:
                return True             # healed by another path
        except OSError:
            pass
        pid = topo.partition_of(dest, rel_timeformat(rel))
        donors = [m for m in topo.replicas(pid)
                  if m != server.member]
        if not donors:
            self._bump('no_donor')
            return False
        timeout_s = server.topo_conf['handoff_timeout_s']
        for donor in donors:
            try:
                mod_rebalance.land_shard(
                    topo.endpoint(donor), dsname, None, topo.epoch,
                    rel, size, crc, dest, timeout_s,
                    indexroot=indexroot)
            except (OSError, ValueError, DNError):
                continue
            from .. import index_query_mt as mod_iqmt
            mod_iqmt.shard_cache_invalidate(dest)
            self._bump('bytes_repaired', size)
            obs_metrics.inc('integrity_repairs_total')
            obs_metrics.inc('integrity_repair_bytes_total', size)
            if server.log is not None:
                server.log.info('shard repaired', rel=rel,
                                donor=donor, bytes=size)
            return True
        return False


# -- the scrub pass ----------------------------------------------------------

def member_datasources(server):
    """[(dsname, ds)] of file datasources with index trees under the
    server's view of the world (its topology member config when
    declared, the process default otherwise)."""
    from .. import datasource_for_name
    from .. import config as mod_config
    cfg_path = None
    if server.cluster is not None and server.member is not None:
        cfg_path = server.cluster.member_config(server.member)
    backend = mod_config.ConfigBackendLocal(cfg_path or None)
    err, config = backend.load()
    if err is not None and not getattr(err, 'is_enoent', False):
        raise err
    out = []
    for dsname, dsdoc in config.datasource_list():
        idx = (dsdoc.get('ds_backend_config') or {}).get('indexPath')
        if not idx:
            continue
        ds = datasource_for_name(config, dsname)
        if isinstance(ds, DNError):
            continue
        out.append((dsname, ds))
    return out


def anti_entropy(server, dsname, ds, repair=True):
    """Diff this member's shard set against co-replicas' manifests
    for every partition it owns; pull what is missing.  Returns
    {'checked', 'pulled', 'diverged', 'unreachable'}."""
    from . import client as mod_client
    res = {'checked': 0, 'pulled': 0, 'diverged': 0,
           'unreachable': 0}
    topo = server.cluster
    if topo is None or server.member is None:
        return res
    import json as mod_json
    catalog = mod_integrity.load_catalog(ds.ds_indexpath)
    timeout_s = server.topo_conf['handoff_timeout_s']
    for pid in topo.partitions_of(server.member):
        donors = [m for m in topo.replicas(pid)
                  if m != server.member]
        got = None
        used_donor = None
        for donor in donors:
            try:
                rc, header, out, err = mod_client.request_bytes(
                    topo.endpoint(donor),
                    {'op': 'shard_manifest', 'ds': dsname,
                     'epoch': topo.epoch, 'partitions': [pid]},
                    timeout_s=timeout_s, retry=True, pooled=True)
                if rc == 0:
                    got = mod_json.loads(
                        out.decode('utf-8'))['shards']
                    used_donor = donor
                    break
            except (OSError, ValueError, KeyError, DNError):
                pass
        if got is None:
            if donors:
                res['unreachable'] += 1
            continue
        for rel, size, crc in got:
            res['checked'] += 1
            dest = mod_rebalance.safe_rel(ds.ds_indexpath, rel)
            try:
                have = mod_integrity.file_crc(dest)
            except OSError:
                have = None
            if have == (size, crc):
                continue
            if have is not None and catalog.get(rel) == have:
                # our bytes match OUR catalog: the trees diverged
                # (a publish racing the scrub) — not rot, not ours
                # to clobber
                res['diverged'] += 1
                continue
            if not repair:
                res['diverged'] += 1
                continue
            try:
                mod_rebalance.land_shard(
                    topo.endpoint(used_donor), dsname, None,
                    topo.epoch, rel, size, crc, dest, timeout_s,
                    indexroot=ds.ds_indexpath)
            except (OSError, ValueError, DNError):
                res['unreachable'] += 1
                continue
            from .. import index_query_mt as mod_iqmt
            mod_iqmt.shard_cache_invalidate(dest)
            res['pulled'] += 1
            obs_metrics.inc('integrity_repairs_total')
            obs_metrics.inc('integrity_repair_bytes_total', size)
    return res


def scrub_member(server, repair=True, rate_bytes_s=0,
                 quarantine=True):
    """One scrub pass over the server's trees (the `scrub` op and the
    background thread): verify bytes against catalogs (tree
    read-locked — an in-process build cannot swap shards mid-walk),
    quarantine + schedule repair for mismatches, then run cluster
    anti-entropy.  quarantine=False (`dn scrub --check --remote`)
    reports without acting.  Returns the summary doc."""
    doc = {'trees': {}, 'anti_entropy': {}}
    for dsname, ds in member_datasources(server):
        lock = server._tree_lock(ds, dsname)

        def on_corrupt(rel, path, dsname=dsname, ds=ds):
            if repair:
                server.repair.schedule(dsname, ds.ds_indexpath,
                                       [rel])

        with lock.read():
            res = mod_integrity.scrub_tree(
                ds.ds_indexpath, quarantine=quarantine,
                rate_bytes_s=rate_bytes_s, on_corrupt=on_corrupt)
        if repair and res['missing_shards']:
            server.repair.schedule(dsname, ds.ds_indexpath,
                                   res['missing_shards'])
        doc['trees'][dsname] = res
        if server.cluster is not None:
            doc['anti_entropy'][dsname] = anti_entropy(
                server, dsname, ds, repair=repair and quarantine)
    return doc


class ScrubThread(object):
    """The background scrubber `dn serve` runs under
    DN_SCRUB_INTERVAL_S > 0: one scrub_member pass per interval,
    rate-limited reads, last-pass summary in /stats `integrity`."""

    def __init__(self, server, interval_s, rate_bytes_s, log=None):
        self.server = server
        self.interval_s = interval_s
        self.rate_bytes_s = rate_bytes_s
        self.log = log
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.runs = 0
        self.last = None
        self.last_error = None
        self.quarantine_evicted_files = 0
        self.quarantine_evicted_bytes = 0
        self._thread = threading.Thread(
            target=self._run, name='dn-scrub', daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def stats(self):
        with self._lock:
            return {'interval_s': self.interval_s,
                    'rate_bytes_s': self.rate_bytes_s,
                    'runs': self.runs, 'last': self.last,
                    'quarantine_evicted_files':
                    self.quarantine_evicted_files,
                    'quarantine_evicted_bytes':
                    self.quarantine_evicted_bytes,
                    'last_error': self.last_error}

    def _enforce_quarantine_budget(self):
        """The DN_QUARANTINE_MAX_MB auto-clean hook: after each scrub
        pass, evict the OLDEST quarantined forensics past the byte
        budget so quarantined corruption can never fill the disk it
        was saved from.  0 (the default) keeps the manual-only
        `dn quarantine clean` contract."""
        max_mb = self.server.integrity_conf.get('quarantine_max_mb',
                                                0)
        if not max_mb:
            return
        budget = max_mb << 20
        for dsname, ds in member_datasources(self.server):
            n, b = mod_integrity.quarantine_clean(
                ds.ds_indexpath, max_bytes=budget)
            if not n:
                continue
            with self._lock:
                self.quarantine_evicted_files += n
                self.quarantine_evicted_bytes += b
            obs_metrics.inc('quarantine_evicted_total', n)
            obs_metrics.inc('quarantine_evicted_bytes_total', b)
            obs_events.emit('quarantine.evicted', ds=dsname,
                            files=n, bytes=b)
            if self.log is not None:
                self.log.info('quarantine budget enforced',
                              ds=dsname, files=n, bytes=b)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._enforce_quarantine_budget()
                doc = scrub_member(self.server, repair=True,
                                   rate_bytes_s=self.rate_bytes_s)
                with self._lock:
                    self.runs += 1
                    self.last = doc
                    self.last_error = None
                obs_metrics.inc('integrity_scrub_runs_total')
                if obs_events.enabled():
                    trees = doc.get('trees') or {}
                    obs_events.emit(
                        'scrub.summary',
                        trees=len(trees),
                        corrupt=sum(
                            len(t.get('corrupt_shards') or [])
                            for t in trees.values()),
                        missing=sum(
                            len(t.get('missing_shards') or [])
                            for t in trees.values()))
            except Exception as e:
                with self._lock:
                    self.last_error = repr(e)
                if self.log is not None:
                    self.log.error('scrub pass failed', err=repr(e))


class MaintenanceThread(object):
    """The rollup/compaction timer `dn serve` runs under
    DN_ROLLUP_INTERVAL_S / DN_COMPACT_INTERVAL_S > 0 — the scrub
    thread's sibling on the same member-datasource walk and the same
    governor discipline (background disk consumers pause under
    pressure and resume on their own).

    * Rollup refresh (rollup.build_rollups) runs WITHOUT the tree
      write lock: a build only ADDS shards and atomically republishes
      the manifest — concurrent queries either still plan fine shards
      or pick up the finished rollup, never a torn view.

    * Compaction holds the tree write lock per GROUP (one base shard
      + its generations — the same short exclusive window a build
      takes), so a query can never enumerate a generation the commit
      record is about to delete.  Every completed group bumps the
      writer-invalidation epoch through _notify_index_written, which
      retires result-cache entries and reader memos.
    """

    INTERVALS = ('hour', 'day')

    def __init__(self, server, rollup_s, compact_s, min_gens,
                 log=None):
        self.server = server
        self.rollup_s = rollup_s
        self.compact_s = compact_s
        self.min_gens = min_gens
        self.log = log
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.runs = 0
        self.last = None
        self.last_error = None
        self.backlog = 0
        self._thread = threading.Thread(
            target=self._run, name='dn-maintenance', daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def stats(self):
        with self._lock:
            return {'rollup_interval_s': self.rollup_s,
                    'compact_interval_s': self.compact_s,
                    'compact_min_gens': self.min_gens,
                    'runs': self.runs,
                    'compact_backlog': self.backlog,
                    'last': self.last,
                    'last_error': self.last_error}

    def _rollup_pass(self):
        from .. import rollup as mod_rollup
        doc = {'built': 0, 'fresh': 0, 'removed': 0, 'paused': False}
        for dsname, ds in member_datasources(self.server):
            for interval in self.INTERVALS:
                r = mod_rollup.build_rollups(
                    ds.ds_indexpath, interval,
                    governor=self.server.governor)
                for k in ('built', 'fresh', 'removed'):
                    doc[k] += r[k]
                doc['paused'] = doc['paused'] or r['paused']
        if doc['built']:
            obs_metrics.inc('rollup_shards_built_total',
                            doc['built'])
        return doc

    def _compact_pass(self):
        from .. import rollup as mod_rollup
        doc = {'groups': 0, 'compacted': 0, 'generations_removed': 0,
               'paused': False}
        backlog = 0
        for dsname, ds in member_datasources(self.server):
            root = ds.ds_indexpath
            for interval in self.INTERVALS:
                groups = [
                    (b, g)
                    for b, g in mod_rollup.find_gen_groups(root,
                                                           interval)
                    if len(g) >= self.min_gens]
                doc['groups'] += len(groups)
                for base, gens in groups:
                    if self.server.governor.mode() != 'ok':
                        doc['paused'] = True
                        obs_events.emit_burst(
                            'resource.paused', key='compact',
                            component='compact')
                        break
                    if self._stop.is_set():
                        break
                    # the same short exclusive window a build takes:
                    # queries drain, the group rewrites, queries
                    # resume against the compacted shard
                    with self.server._tree_lock(ds, dsname).write():
                        mod_rollup.compact_group(root, interval,
                                                 base, gens)
                    doc['compacted'] += 1
                    doc['generations_removed'] += len(gens)
                backlog += mod_rollup.compaction_backlog(root,
                                                         interval)
        if doc['compacted']:
            obs_metrics.inc('compact_groups_total', doc['compacted'])
            obs_metrics.inc('compact_generations_removed_total',
                            doc['generations_removed'])
        obs_metrics.set_gauge('compact_backlog', backlog)
        with self._lock:
            self.backlog = backlog
        return doc

    def _run(self):
        import time as mod_time
        tick = min(s for s in (self.rollup_s, self.compact_s)
                   if s > 0)
        next_rollup = mod_time.monotonic() + self.rollup_s \
            if self.rollup_s > 0 else None
        next_compact = mod_time.monotonic() + self.compact_s \
            if self.compact_s > 0 else None
        while not self._stop.wait(tick):
            now = mod_time.monotonic()
            last = {}
            try:
                if next_compact is not None and now >= next_compact:
                    last['compact'] = self._compact_pass()
                    next_compact = mod_time.monotonic() \
                        + self.compact_s
                if next_rollup is not None and now >= next_rollup:
                    last['rollup'] = self._rollup_pass()
                    next_rollup = mod_time.monotonic() \
                        + self.rollup_s
                if last:
                    with self._lock:
                        self.runs += 1
                        self.last = last
                        self.last_error = None
            except Exception as e:
                with self._lock:
                    self.last_error = repr(e)
                if self.log is not None:
                    self.log.error('maintenance pass failed',
                                   err=repr(e))
