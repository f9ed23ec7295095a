"""Partition handoff (shard streaming) and the rebalance planner.

Counterpart (a copy) of dragnet_tpu/serve/rebalance.py.  Host code:
a handoff moves shard files, never device state.

When a pending epoch assigns a member shards it does not hold — a
fresh joiner, a widened replica set, or a partition moved toward load
— the member STREAMS those shards from their committed owners before
the epoch commits, so the cutover never serves a short shard set:

* Donor side: the `shard_manifest` op enumerates a member's shards
  for the requested committed partitions — every interval tree
  (by_hour / by_day / all), journal/tmp/quarantine litter filtered
  exactly like a query walk — as (relpath, size, crc32) triples; the
  `shard_fetch` op returns one shard's raw bytes (tree read-locked,
  so a concurrent build can never hand out a half-written shard).
  Both ops are epoch-gated like query partials.
* Joiner side: HandoffPuller plans in SHARD terms, not partition ids
  (partition boundaries renumber freely across epochs — 3 partitions
  may become 5): the global shard list is the union of committed
  owners' manifests, the needed set is the shards the PENDING map
  assigns to this member that are not already present byte-identical
  (size + crc match — a shared-filesystem deployment streams
  nothing), and each fetch rides the pooled multiplexed connection
  (serve/pool.py) with failover across donor replicas.  Fetched
  bytes land as journal-style tmps (`<shard>.<pid>.<seq>` — readers
  filter them, and the crash-recovery sweep quarantines them if we
  die) and rename into place only after the crc verifies.

A SIGKILLed joiner loses nothing but its own progress: the committed
map is untouched, already-renamed shards are complete and verified,
and a restart re-pulls idempotently (present-and-identical shards are
skipped).  `handoff_ready` flips only when every needed shard landed;
until then the member rejects partials for the affected partitions
retryably (server.py) — degraded never silently short.

The planner (propose_moves) turns per-member load — query_partial
counts and the latency histograms out of /stats — into a bounded
set of partition moves from the hottest member toward the coldest,
emitted as a new topology document for begin_transition.
"""

import json
import os
import threading
import zlib

from ..errors import DNError
from .. import config as mod_config
from .. import faults as mod_faults
from .. import index_journal as mod_journal
from .. import integrity as mod_integrity
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics

# shards larger than this stream in bounded range-fetches instead of
# one buffered response: the protocol buffers whole payloads on both
# sides, and a multi-GB sqlite shard must not drive the donor (or
# joiner) to OOM mid-resize
FETCH_CHUNK_BYTES = 8 << 20

# (size, crc32) of a file, streamed — now owned by integrity.py (the
# manifest triples and the integrity catalog must agree by
# construction); the old name stays for handoff callers
file_crc = mod_integrity.file_crc


def _interval_trees(ds):
    """[(interval, root, timeformat)] for the datasource's index
    trees (the same roots index_find_params hands a query)."""
    out = []
    for interval in ('hour', 'day', 'all'):
        params = ds.index_find_params(interval, None, None)
        if isinstance(params, DNError):
            continue
        out.append((interval, params[0], params[1]))
    return out


def iter_shards(ds):
    """Every shard file in the datasource's index trees as
    (relpath, abspath, timeformat), litter filtered, in sorted
    order (deterministic across members of a shared tree)."""
    indexroot = ds.ds_indexpath
    for interval, root, timeformat in _interval_trees(ds):
        if os.path.isfile(root):
            # the `all` interval may be a single shard file
            if not mod_journal.is_index_litter(root):
                yield (os.path.relpath(root, indexroot), root,
                       timeformat)
            continue
        if not os.path.isdir(root):
            continue
        for r, dirs, names in os.walk(root):
            dirs[:] = sorted(d for d in dirs
                             if not mod_journal.is_index_litter(d))
            for name in sorted(names):
                if mod_journal.is_index_litter(name):
                    continue
                path = os.path.join(r, name)
                yield (os.path.relpath(path, indexroot), path,
                       timeformat)


def shard_manifest(ds, topology, partition_ids):
    """The donor-side manifest: [[relpath, size, crc32], ...] for
    every shard of `partition_ids` under `topology`'s assignment.
    Fires the handoff.manifest fault seam."""
    mod_faults.fire('handoff.manifest')
    want = set(partition_ids)
    out = []
    for rel, path, timeformat in iter_shards(ds):
        if topology.partition_of(path, timeformat) not in want:
            continue
        try:
            size, crc = file_crc(path)
        except OSError:
            # raced a concurrent retire: a shard that vanished is not
            # ours to offer
            continue
        out.append([rel, size, crc])
    return out


def safe_rel(indexroot, rel):
    """Resolve a manifest relpath under the index root, refusing
    escapes and litter names — the donor must never hand out a file a
    query walk would not serve."""
    if not isinstance(rel, str) or not rel or rel.startswith('/'):
        raise DNError('bad shard relpath: %r' % (rel,))
    norm = os.path.normpath(rel)
    if norm.startswith('..') or os.path.isabs(norm):
        raise DNError('bad shard relpath: %r' % (rel,))
    if mod_journal.is_index_litter(norm):
        raise DNError('shard relpath names build litter: %r' % (rel,))
    return os.path.join(indexroot, norm)


def read_shard(ds, rel, offset=0, length=None):
    """Donor-side shard read for the `shard_fetch` op: the raw bytes
    of one shard file, or the `[offset, offset+length)` range of it
    (large shards stream in bounded chunks).  The caller holds the
    tree read lock."""
    path = safe_rel(ds.ds_indexpath, rel)
    try:
        with open(path, 'rb') as f:
            if offset:
                f.seek(offset)
            return f.read(length) if length is not None else f.read()
    except OSError as e:
        raise DNError('shard "%s" unreadable' % rel,
                      cause=DNError(str(e)))


def _shard_timeformats(ds):
    """{interval-tree subdir: timeformat} for mapping a manifest
    relpath back to its assignment rule."""
    out = {}
    for interval, root, timeformat in _interval_trees(ds):
        out[os.path.basename(root)] = timeformat
    return out


# -- the shared fetch-and-land path -----------------------------------------
#
# One verified way for bytes to enter a tree over the wire: bounded
# range fetches off the pooled connection, assembled into a
# journal-style tmp (readers filter it, the recovery sweep
# quarantines it if we die), crc-checked against the expected
# (size, crc), fsynced, atomically renamed, and recorded in the
# integrity catalog.  The handoff joiner (HandoffPuller) and the
# self-healing repair path (serve/scrub.py) both ride it.

def fetch_shard_range(endpoint, dsname, cfg_path, epoch, rel,
                      offset, length, timeout_s):
    """One `shard_fetch` exchange; returns the raw bytes or raises
    DNError/OSError."""
    from . import client as mod_client
    req = {'op': 'shard_fetch', 'ds': dsname, 'config': cfg_path,
           'epoch': epoch, 'rel': rel}
    if length is not None:
        req['offset'] = offset
        req['length'] = length
    rc, header, out, err = mod_client.request_bytes(
        endpoint, req, timeout_s=timeout_s, retry=True)
    if rc != 0:
        raise DNError(err.decode('utf-8', 'replace').strip() or
                      'shard_fetch failed')
    return out


def land_shard(endpoint, dsname, cfg_path, epoch, rel, size, crc,
               dest, timeout_s, indexroot=None):
    """Stream one shard from a donor into place: bounded range
    fetches (FETCH_CHUNK_BYTES at a time — neither side ever buffers
    a whole multi-GB shard) appended to a journal-style tmp, crc
    verified over the assembled bytes, fsync, atomic rename, catalog
    entry landed (when `indexroot` is given) so the fetched copy
    verifies like a locally-published one."""
    d = os.path.dirname(dest)
    if d and not os.path.isdir(d):
        os.makedirs(d, exist_ok=True)
    tmp = dest + '.' + mod_journal.new_build_id()
    try:
        got_crc = 0
        with open(tmp, 'wb') as f:
            if size <= FETCH_CHUNK_BYTES:
                data = fetch_shard_range(endpoint, dsname, cfg_path,
                                         epoch, rel, 0, None,
                                         timeout_s)
                if len(data) != size:
                    raise DNError(
                        'shard "%s": %d bytes, expected %d '
                        '(donor tree changed?)'
                        % (rel, len(data), size))
                got_crc = zlib.crc32(data)
                f.write(data)
            else:
                written = 0
                while written < size:
                    want = min(FETCH_CHUNK_BYTES, size - written)
                    data = fetch_shard_range(
                        endpoint, dsname, cfg_path, epoch, rel,
                        written, want, timeout_s)
                    if len(data) != want:
                        raise DNError(
                            'shard "%s": short range at %d '
                            '(donor tree changed?)' % (rel, written))
                    got_crc = zlib.crc32(data, got_crc)
                    f.write(data)
                    written += want
            f.flush()
            os.fsync(f.fileno())
        if (got_crc & 0xffffffff) != crc:
            raise DNError(
                'shard "%s": bytes do not match the expected crc '
                '(donor tree changed?)' % rel)
        mod_faults.fire('handoff.apply', torn_path=tmp)
        os.rename(tmp, dest)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if indexroot is not None:
        mod_integrity.update_catalog(
            indexroot,
            add={mod_integrity.shard_rel(indexroot, dest):
                 (size, crc)})


class HandoffPuller(object):
    """The joiner-side shard streamer for one pending epoch.

    Runs on its own thread; `ready` flips True only when every shard
    the pending map assigns to this member is present and verified.
    status() feeds the /stats `topology` section and the `topology`
    op the coordinator polls for commit readiness."""

    def __init__(self, committed, pending, member, topo_conf=None,
                 log=None, governor=None):
        if topo_conf is None:
            topo_conf = mod_config.topo_config()
        if isinstance(topo_conf, DNError):
            raise topo_conf
        self.committed = committed
        self.pending = pending
        self.member = member
        self.target_epoch = pending.epoch
        self.conf = topo_conf
        self.log = log
        # resource governance (resources.py): handoff fetches are
        # background disk consumers — low pressure PAUSES the pull
        # (resumes when space frees), critical fails it with the
        # clean retryable disk_full error (the topology watcher's
        # retry_failed_handoff restarts it every poll, so recovery
        # is automatic there too)
        self.governor = governor
        self.ready = False
        self.failed = False
        self.error = None
        # partitions whose shard set may still be incomplete: ALL of
        # this member's pending partitions until the plan proves
        # otherwise (server.py rejects partials for these, retryably,
        # until ready)
        self.affected_pids = set(pending.partitions_of(member))
        self._lock = threading.Lock()
        self.counters = {'shards_needed': 0, 'shards_streamed': 0,
                         'bytes_streamed': 0, 'shards_skipped': 0,
                         'fetch_failures': 0, 'manifest_failures': 0}
        self._stale = threading.Event()
        self._done = threading.Event()
        self._thread = None

    # -- lifecycle --------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name='dn-handoff-pull',
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        """Mark the pull stale (superseded epoch / server drain): the
        thread exits at the next shard boundary."""
        self._stale.set()

    def wait(self, timeout_s=None):
        return self._done.wait(timeout_s)

    def _bump(self, name, n=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def status(self):
        with self._lock:
            counters = dict(self.counters)
        return {
            'epoch': self.target_epoch,
            'ready': self.ready,
            'failed': self.failed,
            'error': self.error,
            'partitions_moving': sorted(self.affected_pids),
            'counters': counters,
        }

    # -- the pull ---------------------------------------------------------

    def _run(self):
        try:
            missing = self._pull()
            if self._stale.is_set():
                return
            if missing:
                self.failed = True
                self.error = ('%d shard(s) could not be streamed '
                              '(e.g. %s)'
                              % (len(missing), missing[0]))
            else:
                self.ready = True
            obs_metrics.set_gauge('handoff_ready',
                                  1.0 if self.ready else 0.0)
            obs_events.emit(
                'handoff.ready' if self.ready else 'handoff.failed',
                epoch=self.target_epoch, error=self.error,
                partitions=sorted(self.affected_pids))
        except Exception as e:
            self.failed = True
            self.error = str(e)
            obs_events.emit('handoff.failed', epoch=self.target_epoch,
                            error=self.error)
            if self.log is not None:
                self.log.error('handoff pull failed', err=repr(e))
        finally:
            self._done.set()

    def _datasources(self):
        """Every file datasource with an index tree under this
        member's config (the topology's per-member config when
        declared, the process default otherwise)."""
        from .. import datasource_for_name
        cfg_path = self.pending.member_config(self.member)
        backend = mod_config.ConfigBackendLocal(cfg_path or None)
        err, config = backend.load()
        if err is not None and not getattr(err, 'is_enoent', False):
            raise err
        out = []
        for dsname, dsdoc in config.datasource_list():
            idx = (dsdoc.get('ds_backend_config') or {}) \
                .get('indexPath')
            if not idx:
                continue
            ds = datasource_for_name(config, dsname)
            if isinstance(ds, DNError):
                continue
            out.append((dsname, ds, backend.cbl_path))
        return out

    def _request(self, endpoint, req, timeout_s):
        from . import client as mod_client
        return mod_client.request_bytes(endpoint, req,
                                        timeout_s=timeout_s,
                                        retry=True)

    def _pull(self):
        """Stream every needed shard; returns the relpaths that could
        not be fetched (empty = ready)."""
        timeout_s = self.conf['handoff_timeout_s']
        retries = self.conf['handoff_retries']
        missing = []
        affected = set()
        for dsname, ds, cfg_path in self._datasources():
            if self._stale.is_set():
                return missing
            # 1. the global shard list, from committed owners
            manifest = {}      # rel -> (size, crc, [donor names])
            for pid in self.committed.partition_ids():
                if self.member in self.committed.replicas(pid):
                    # we are ourselves a committed owner of this
                    # partition: our tree already holds its complete
                    # shard set — enumerate locally instead of
                    # depending on another donor surviving
                    got = None
                    for attempt in range(retries + 1):
                        try:
                            got = shard_manifest(ds,
                                                 self.committed,
                                                 [pid])
                            break
                        except DNError:
                            self._bump('manifest_failures')
                    if got is None:
                        missing.append('%s: partition %d local '
                                       'manifest failed'
                                       % (dsname, pid))
                        continue
                    for rel, size, crc in got:
                        manifest[rel] = (size, crc, [])
                    continue
                donors = [m for m in self.committed.replicas(pid)
                          if m != self.member]
                got = None
                attempts = max(1, retries + 1) * \
                    max(1, len(donors))
                for attempt in range(attempts):
                    donor = donors[attempt % len(donors)]
                    try:
                        rc, header, out, err = self._request(
                            self.committed.endpoint(donor),
                            {'op': 'shard_manifest', 'ds': dsname,
                             'config': cfg_path,
                             'epoch': self.committed.epoch,
                             'partitions': [pid]}, timeout_s)
                        if rc == 0:
                            got = json.loads(
                                out.decode('utf-8'))['shards']
                            break
                    except (OSError, ValueError, KeyError,
                            DNError):
                        pass
                    self._bump('manifest_failures')
                if got is None:
                    # no committed owner would tell us what this
                    # partition holds: completeness is UNPROVABLE,
                    # so the pull must not report ready — an empty
                    # answer here silently dropped shards
                    missing.append('%s: partition %d manifest '
                                   'unavailable' % (dsname, pid))
                    with self._lock:
                        self.affected_pids |= set(
                            self.pending.partitions_of(self.member))
                    continue
                for rel, size, crc in got:
                    # every committed replica of the pid can donate
                    # this shard: the fetch fails over across them
                    manifest[rel] = (size, crc, list(donors))
            # 2. the needed set, in PENDING-map terms
            my_pids = set(self.pending.partitions_of(self.member))
            fmt_by_dir = _shard_timeformats(ds)
            needed = []
            for rel in sorted(manifest):
                size, crc, donors = manifest[rel]
                timeformat = fmt_by_dir.get(
                    rel.split(os.sep)[0] if os.sep in rel else rel)
                pid = self.pending.partition_of(rel, timeformat)
                if pid not in my_pids:
                    continue
                dest = safe_rel(ds.ds_indexpath, rel)
                try:
                    have_size, have_crc = file_crc(dest)
                    if have_size == size and have_crc == crc:
                        self._bump('shards_skipped')
                        continue
                except OSError:
                    pass
                affected.add(pid)
                needed.append((rel, size, crc, donors, dest))
            self._bump('shards_needed', len(needed))
            # 3. stream
            streamed_any = False
            for rel, size, crc, donors, dest in needed:
                if self._stale.is_set():
                    return missing
                self._wait_writable()
                if self._fetch_shard(dsname, cfg_path, rel, size,
                                     crc, donors, dest,
                                     timeout_s, retries,
                                     ds.ds_indexpath):
                    streamed_any = True
                else:
                    missing.append(rel)
            if streamed_any:
                # resident readers must re-walk: renamed-in shards
                # change the tree under any cached find memo
                from .. import index_query_mt as mod_iqmt
                mod_iqmt.invalidate_index_tree(ds.ds_indexpath)
        # narrow the reject window to partitions that actually had
        # shards in motion (a member whose assignment is unchanged
        # must not reject its own traffic while others hand off) —
        # but only when the pull proved complete: an unprovable pull
        # keeps the conservative full set
        with self._lock:
            if not missing:
                self.affected_pids = affected
        return missing

    def _wait_writable(self):
        """The per-shard resource gate: hold the pull while the
        governor reports low pressure (stop/stale still interrupt
        instantly), and fail it cleanly — retryable disk_full — once
        the disk goes critical: streaming more shards onto a full
        disk can only make the incident worse."""
        gov = self.governor
        if gov is None:
            return
        from .. import resources as mod_resources
        paused = False
        while not self._stale.is_set() and gov.mode() == 'low':
            if not paused:
                paused = True
                obs_events.emit_burst('resource.paused',
                                      key='handoff',
                                      component='handoff')
                obs_metrics.inc('resource_paused_total',
                                component='handoff')
                if self.log is not None:
                    self.log.info('handoff pull paused: disk low')
            self._stale.wait(0.5)
        if not self._stale.is_set() and gov.is_read_only():
            raise mod_resources.disk_full_error('handoff pull')

    def _fetch_shard(self, dsname, cfg_path, rel, size, crc, donors,
                     dest, timeout_s, retries, indexroot):
        """One shard: fetch bytes from a donor (failing over), verify
        size+crc, land via the shared land_shard path (journal-style
        tmp + crc + rename + catalog entry).  Returns True on
        success."""
        if not donors:
            # locally-enumerated shard that somehow went missing
            # before the present-check: nobody to fetch it from
            self._bump('fetch_failures')
            return False
        attempts = max(1, retries + 1) * max(1, len(donors))
        for attempt in range(attempts):
            donor = donors[attempt % len(donors)]
            try:
                mod_faults.fire('handoff.fetch')
                land_shard(self.committed.endpoint(donor), dsname,
                           cfg_path, self.committed.epoch, rel,
                           size, crc, dest, timeout_s,
                           indexroot=indexroot)
                self._bump('shards_streamed')
                self._bump('bytes_streamed', size)
                obs_metrics.inc('handoff_shards_streamed_total')
                obs_metrics.inc('handoff_bytes_streamed_total',
                                size)
                return True
            except (OSError, ValueError, DNError) as e:
                self._bump('fetch_failures')
                if self.log is not None:
                    self.log.warn('shard fetch failed', rel=rel,
                                  donor=donor, err=str(e))
        return False


# -- the rebalance planner --------------------------------------------------

def member_load_score(stats_doc):
    """One member's load score from its /stats document: served
    partial count (the partition work actually done) plus the live
    queue pressure, tie-broken by the observed per-op latency
    (the latency histograms)."""
    req = stats_doc.get('requests') or {}
    by_op = req.get('by_op') or {}
    partials = by_op.get('query_partial', 0) + by_op.get('query', 0)
    depth = stats_doc.get('inflight') or {}
    pressure = (depth.get('active', 0) or 0) + \
        (depth.get('queued', 0) or 0)
    p95 = 0.0
    hists = (stats_doc.get('metrics') or {}).get('histograms') or {}
    for name, ent in hists.items():
        if name.startswith('serve_op_latency_ms') and \
                'query' in name:
            p95 = max(p95, ent.get('p90') or 0.0)
    return float(partials + 10 * pressure) + p95 / 1000.0


def collect_loads(topology, timeout_s=5.0):
    """{member: load score} from each member's /stats (unreachable
    members score None — the planner never moves TOWARD a member it
    cannot see)."""
    from . import client as mod_client
    loads = {}
    for name in topology.member_names():
        try:
            doc = mod_client.stats(topology.endpoint(name),
                                   timeout_s=timeout_s)
            loads[name] = member_load_score(doc)
        except (OSError, ValueError, DNError):
            loads[name] = None
    return loads


def propose_moves(topology, loads, max_moves=None, ratio=1.5):
    """Propose up to `max_moves` partition moves from the
    hottest-loaded member toward the coldest: in each step the
    hottest member's lowest-id primary partition that the coldest
    does not replicate swaps that replica slot.  Deterministic for a
    given (topology, loads).  Returns (new_doc_or_None, decisions):
    None when the spread is already within `ratio` (or nothing can
    move)."""
    if max_moves is None:
        conf = mod_config.topo_config()
        max_moves = 2 if isinstance(conf, DNError) \
            else conf['max_moves']
    doc = topology.doc()
    known = {m: s for m, s in loads.items()
             if s is not None and m in doc['members']}
    if len(known) < 2:
        return None, []
    work = dict(known)
    decisions = []
    for _ in range(max_moves):
        hot = max(sorted(work), key=lambda m: work[m])
        cold = min(sorted(work), key=lambda m: work[m])
        if work[hot] <= max(1.0, work[cold] * ratio):
            break
        moved = None
        for p in doc['partitions']:
            replicas = p['replicas']
            if replicas and replicas[0] == hot and \
                    cold not in replicas:
                moved = p
                break
        if moved is None:
            # the hot member fronts nothing movable: try any replica
            # slot it holds that the cold member does not
            for p in doc['partitions']:
                if hot in p['replicas'] and \
                        cold not in p['replicas']:
                    moved = p
                    break
        if moved is None:
            break
        idx = moved['replicas'].index(hot)
        moved['replicas'][idx] = cold
        decisions.append({'partition': moved['id'], 'from': hot,
                          'to': cold,
                          'load_from': round(work[hot], 3),
                          'load_to': round(work[cold], 3)})
        shift = (work[hot] - work[cold]) / 2.0
        work[hot] -= shift
        work[cold] += shift
        obs_metrics.inc('rebalance_moves_proposed_total')
    if not decisions:
        return None, []
    doc['epoch'] = topology.epoch + 1
    return doc, decisions
