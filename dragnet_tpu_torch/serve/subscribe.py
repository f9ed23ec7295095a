"""`dn subscribe`: standing queries with incremental aggregation and
pushed result frames.

Counterpart of dragnet_tpu/serve/subscribe.py for a single member.  A
dashboard that polls pays the full query path — N viewers of one
metric cost N stacked aggregations per refresh, even though
`dn follow` already publishes the mini-batches that change the
answer.  This module extends the paper's "pre-aggregate once, answer
cheaply many times" to TIME: a subscriber registers a standing,
normalized QueryConfig over a persistent v2 connection; the manager
maintains the aggregation incrementally as publishes land and PUSHES
delta or full result frames, so fan-out per publish is one
incremental merge instead of N repeated scans.

The correctness contract is the headline: **a subscriber's pushed
frame at index-tree epoch E is byte-identical to a poll executed at
epoch E.**  That falls out structurally, not by re-verification:

* Subscriptions sharing one (datasource, config, query document,
  interval, output options) tuple share one GROUP.  A group's state
  is the per-shard key-item memo — ``{shard: (stat identity,
  key items)}`` — exactly the per-shard aggregate export the
  poll's own per-shard path merges (index_query_mt.run_shard_queries
  / Aggregator.merge_key_items).
* A recompute re-enumerates the shard walk (the identical
  index_query_paths enumerate/litter/prune path a poll runs), folds
  ONLY shards whose stat identity changed (`dn follow` merge-publish
  rewrites a small set of hour shards per batch; everything else
  replays from the memo), drops deleted shards, and merges all
  per-shard items in global find order into a fresh aggregator.
* The result renders through the SAME output layer a poll uses
  (cli.dn_output under the server's thread-stdio capture), so the
  frame bytes equal the poll bytes by construction.

Dirty signals: the in-process index write hook
(index_build_mt.register_index_write_hook) fires for every completed
publish — builds, follow mini-batches, compaction, rollups — and a
revalidation tick at the coalesce cadence catches CROSS-process
writers via the same tree stat validators the query cache trusts
(qcache.tree_validators), bumping the writer-invalidation epoch
before recomputing so frame epochs and poll epochs agree.  The
coalesce latency (DN_SUB_COALESCE_MS) is the StreamBox-HBM-style
target bound: a dirty group waits that long to batch adjacent
publishes, then pushes once.

Backpressure rides the front end's write queues: pushes are
loop.send() enqueues (never block the pusher), a subscriber with
DN_SUB_QUEUE_DEPTH unacked frames is degraded to one coalesced FULL
frame when its acks catch up (deltas need a base the peer provably
has), and a peer that stops reading altogether is reaped by the
existing write deadline.  One stalled dashboard can never wedge the
publisher or delay healthy subscribers.

Wire shape: server-initiated frames on the v2 framing carry ``sub``
(the subscription id) instead of a request ``id`` — see
protocol.encode_push.  A v1 peer can never receive one: registration
itself requires a v2 frame.  Every frame carries a resume token; a
reconnecting subscriber presents it and is either told 'current'
(digest match — keep your payload, no re-seed) or re-seeded with a
full frame at the current epoch.

One recompute per publish, where the reference can walk twice: the
port consumes a group's change signals under the tree's read lock (a
served build holds the write lock until its publish has landed), the
sweep skips a group while its registration seeds it, and the tick
waits while another process's tmps or commit journal are on disk and
fresh (index_journal.publish_in_flight: residue unchanged for
IN_FLIGHT_STALE_S, a publish whose renames failed, holds nothing).
The bytes pushed are the reference's; only the number of walks
differs.

On the card: the recompute is host work (per-shard key items through
the handle cache), so the pusher thread allocates nothing on the
device and never touches the residency pins; the poll a frame equals
runs the served device lane.  On a cluster member a group scatters
through the router (serve/router.py) as a poll does, one scatter per
publish batch for every subscriber, and a confirming scatter past the
peers' stat-TTL window (_confirm_delay) catches a peer process that
answered from its memo.
"""

import hashlib
import json
import os
import threading
import time

from .. import config as mod_config
from .. import faults as mod_faults
from .. import index_build_mt as mod_build
from .. import index_journal as mod_journal
from .. import index_query_mt as mod_iqmt
from .. import query as mod_query
from ..errors import DNError
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from . import admission as mod_admission
from . import protocol as mod_protocol
from . import qcache as mod_qcache

# output options a standing query may carry: everything else either
# writes run-varying bytes (counters, warnings) or is a local-only
# mode flag — both would break the pushed-vs-polled identity contract
_ALLOWED_OPTS = ('raw', 'points')

# how long another process's tmp or commit journal, unwritten since,
# holds the revalidation tick: a publish in flight writes its residue
# more often than that (each prepared tmp in turn, then the journal at
# its commit point); older residue is a publish whose renames failed,
# which no wait would land
IN_FLIGHT_STALE_S = 2.0


def _group_doc(req):
    """The canonical standing-query document: everything that
    determines the PUSHED BYTES (unlike admission.compute_key, the
    output options are included — a group caches rendered bytes, not
    a re-renderable result)."""
    watch = req.get('watch') or 'query'
    if watch == 'fleet':
        doc = {'watch': 'fleet',
               'events': req.get('events')
               if isinstance(req.get('events'), int) and
               not isinstance(req.get('events'), bool) and
               req.get('events') >= 0 else 50,
               'interval_ms': req.get('interval_ms')
               if isinstance(req.get('interval_ms'), int) and
               not isinstance(req.get('interval_ms'), bool) and
               req.get('interval_ms') >= 100 else 2000}
        return doc
    opts = req.get('opts') or {}
    return {
        'watch': 'query',
        'ds': req.get('ds'),
        'config': req.get('config'),
        'queryconfig': req.get('queryconfig'),
        'interval': req.get('interval') or 'day',
        'opts': {k: bool(opts.get(k)) for k in _ALLOWED_OPTS
                 if opts.get(k)},
    }


def _group_key(doc):
    blob = json.dumps(doc, sort_keys=True, separators=(',', ':'))
    return blob, hashlib.sha1(blob.encode('utf-8')).hexdigest()[:16]


def _payload_digest(payload):
    return hashlib.sha1(payload or b'').hexdigest()[:16]


class _OutOpts(object):
    """The minimal options surface cli.dn_output reads, rebuilt from
    a group's normalized output-option doc."""

    def __init__(self, doc):
        for name in ('raw', 'points', 'counters', 'gnuplot'):
            setattr(self, name, bool(doc.get(name)))
        self.dry_run = False


class Subscription(object):
    __slots__ = ('sid', 'conn', 'group', 'seq', 'acked', 'lagging',
                 'dirty', 'last_payload', 'peer', 'created',
                 'frames_full', 'frames_delta', 'sheds')

    def __init__(self, sid, conn, group):
        self.sid = sid
        self.conn = conn
        self.group = group
        self.seq = 0              # last frame sent
        self.acked = 0            # highest frame acked
        self.lagging = False      # over the unacked-depth bound
        self.dirty = False        # missed at least one group version
        self.last_payload = None  # delta base (shares group bytes)
        self.peer = conn.peer
        self.created = time.time()
        self.frames_full = 0
        self.frames_delta = 0
        self.sheds = 0


class Group(object):
    """One standing query's shared state: the per-shard memo, the
    current rendered payload, and the subscribers riding it.  One
    recompute per publish batch serves every member."""

    def __init__(self, key, kdigest, doc):
        self.key = key
        self.kdigest = kdigest
        self.doc = doc
        self.subs = set()
        self.memo = {}            # shard path -> (stat ident, items)
        self.payload = None       # current rendered stdout bytes
        self.digest = None
        self.epoch = 0
        self.version = 0          # bumps when the payload changes
        self.validators = None    # cross-process change detector
        self.dirty = True
        self.confirm_at = None    # routed reconvergence deadline
                                  # (armed by routed groups only)
        self.last_error = None
        self.seeding = False      # the registration's seed is running
        self.last_compute = 0.0
        self.recomputes = 0
        # serializes seed vs pusher recompute (reentrant: the seed
        # path holds it across _recompute, which the sweep also does)
        self.compute_lock = threading.RLock()


class SubscriptionManager(object):
    def __init__(self, server, conf=None):
        if conf is None:
            conf = mod_config.subscribe_config()
        if isinstance(conf, DNError):
            raise conf
        self.server = server
        self.conf = conf
        self.log = server.log
        self._lock = threading.RLock()
        self._groups = {}         # key -> Group
        self._subs = {}           # sid -> Subscription
        self._by_conn = {}        # conn fd -> set of sids
        self._next = 1
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None
        self._hook = None
        self._counters = {'registered': 0, 'dropped': 0,
                          'resumed': 0, 'recomputes': 0,
                          'shards_folded': 0, 'shards_reused': 0,
                          'pushes': 0, 'push_bytes': 0,
                          'frames_full': 0, 'frames_delta': 0,
                          'lagging_sheds': 0, 'duplicate_acks': 0,
                          'reconfirms': 0, 'compute_errors': 0}

    # -- lifecycle --------------------------------------------------------

    def enabled(self):
        return self.conf['max'] > 0

    def start(self):
        if not self.enabled():
            return self
        self._hook = self._on_index_write
        mod_build.register_index_write_hook(self._hook)
        self._thread = threading.Thread(target=self._run,
                                        name='dn-subscribe',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Drain: tell every subscriber the stream is over (a clean
        'end' frame beats a bare EOF — the client reconnects with its
        resume token instead of guessing), then stop the pusher."""
        self._stop.set()
        self._wake.set()
        if self._hook is not None:
            mod_build.unregister_index_write_hook(self._hook)
            self._hook = None
        with self._lock:
            subs = list(self._subs.values())
            self._subs.clear()
            self._groups.clear()
            self._by_conn.clear()
        loop = self.server.loop
        for sub in subs:
            if loop is not None and not sub.conn.closed:
                frame = mod_protocol.encode_push(
                    sub.sid, sub.seq + 1, sub.group.epoch, 'end',
                    extra={'reason': 'draining'})
                loop.send(sub.conn, frame, close_after=True)
        self._set_gauges()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None

    def _bump(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    def _set_gauges(self):
        with self._lock:
            obs_metrics.set_gauge('sub_active', len(self._subs))
            obs_metrics.set_gauge('sub_groups', len(self._groups))

    # -- registration (worker threads) ------------------------------------

    def subscribe(self, conn, req, proto):
        """Register one standing query for `conn`.  Returns (rc, out,
        err, extra, subscription-or-None); the caller sends the
        response FIRST, then calls activate() so the seed frame can
        never outrun the registration ack."""
        if proto != mod_protocol.PROTO_V2:
            return (1, b'', b'dn: subscribe requires protocol 2 (a '
                    b'persistent connection); v1 peers cannot '
                    b'receive pushed frames\n', {}, None)
        if not self.enabled():
            return (1, b'', b'dn: subscriptions disabled '
                    b'(DN_SUB_MAX=0)\n', {}, None)
        if self.server.draining:
            return (1, b'', b'dn: server is draining\n',
                    {'retryable': True}, None)
        doc = _group_doc(req)
        if doc['watch'] == 'query':
            if not doc.get('ds'):
                return (1, b'', b'dn: subscribe: missing "ds"\n',
                        {}, None)
            bad = sorted(k for k, v in (req.get('opts') or {}).items()
                         if v and k not in _ALLOWED_OPTS)
            if bad:
                return (1, b'', ('dn: subscribe: option(s) %s cannot '
                                 'ride a standing query\n'
                                 % ','.join('"%s"' % b for b in bad))
                        .encode(), {}, None)
            qc = mod_query.query_load(doc['queryconfig'] or {})
            if isinstance(qc, DNError):
                return (1, b'', ('dn: %s\n' % qc.message).encode(),
                        {}, None)
        with self._lock:
            if len(self._subs) >= self.conf['max']:
                return (1, b'', ('dn: subscription limit reached '
                                 '(DN_SUB_MAX=%d)\n'
                                 % self.conf['max']).encode(),
                        {'retryable': True,
                         'retry_after_ms': 1000}, None)
            key, kdigest = _group_key(doc)
            group = self._groups.get(key)
            fresh = group is None
            if fresh:
                group = Group(key, kdigest, doc)
                group.seeding = True
                self._groups[key] = group
        if fresh:
            # seed from one ordinary query at the registration epoch,
            # under an admission slot — a subscribe is real work and
            # must respect the overload posture (busy/draining answer
            # retryably, exactly like a poll)
            try:
                with group.compute_lock:
                    self._recompute(group, seed=True)
                if self.server.router is not None:
                    # a seed scatter right after another process's
                    # publish can catch a peer inside its stat-TTL
                    # window exactly like a sweep scatter can —
                    # confirm it too
                    group.confirm_at = (time.monotonic() +
                                        self._confirm_delay())
            except (mod_admission.BusyError,
                    mod_admission.DrainingError,
                    mod_admission.OverloadedError) as e:
                with self._lock:
                    if not group.subs:
                        self._groups.pop(key, None)
                return (1, b'', ('dn: %s\n' % e.message).encode(),
                        {'retryable': True,
                         'retry_after_ms':
                         getattr(e, 'retry_after_ms', None)}, None)
            except DNError as e:
                with self._lock:
                    if not group.subs:
                        self._groups.pop(key, None)
                return (1, b'', ('dn: %s\n' % e.message).encode(),
                        {}, None)
            finally:
                group.seeding = False
        with self._lock:
            sid = 's%d' % self._next
            self._next += 1
            sub = Subscription(sid, conn, group)
            group.subs.add(sub)
            self._subs[sid] = sub
            self._by_conn.setdefault(conn.fd, set()).add(sid)
            self._counters['registered'] += 1
        # resume: a token whose payload digest matches the group's
        # CURRENT bytes means the reconnecting client already holds
        # the answer — seed nothing, start deltas from its base
        resumed = False
        token = req.get('resume')
        if isinstance(token, dict) and \
                token.get('k') == group.kdigest and \
                token.get('d') == group.digest and \
                group.payload is not None:
            sub.last_payload = group.payload
            resumed = True
            self._bump('resumed')
        self.server.loop.pin(conn)
        self._set_gauges()
        if obs_events.enabled():
            obs_events.emit('subscribe.register', sub=sid,
                            watch=doc['watch'],
                            ds=doc.get('ds'), peer=sub.peer,
                            resumed=resumed)
        body = json.dumps({
            'sub': sid, 'epoch': group.epoch, 'seq': 0,
            'resumed': resumed,
            'token': self._token(group, 0),
        }, sort_keys=True) + '\n'
        return 0, body.encode(), b'', {}, sub

    def activate(self, sub):
        """Queue the seed frame (the registration response is already
        on the wire ahead of it).  A resumed subscriber needs none —
        its next frame comes with the next change."""
        if sub.last_payload is not None:
            return
        group = sub.group
        with self._lock:
            if sub.sid not in self._subs:
                return
            if group.payload is None:
                sub.dirty = True
                return
            self._send_frame(sub, group, force_full=True)

    def _token(self, group, seq):
        return {'k': group.kdigest, 'seq': seq,
                'epoch': group.epoch, 'd': group.digest}

    # -- acks / unsubscribe (worker threads) ------------------------------

    def ack(self, req):
        """One `sub_ack` control frame: advance the subscriber's
        acked watermark; a lagging subscriber whose window reopens
        gets its coalesced catch-up FULL frame here.  Duplicate and
        reordered acks are idempotent — the watermark only moves
        forward."""
        sid = req.get('sub')
        seq = req.get('seq')
        with self._lock:
            sub = self._subs.get(sid)
            if sub is None:
                return (1, b'', ('dn: unknown subscription %r\n'
                                 % (sid,)).encode(), {})
            if not isinstance(seq, int) or isinstance(seq, bool) or \
                    seq < 1 or seq > sub.seq:
                return (1, b'', ('dn: bad ack seq %r for "%s" '
                                 '(last sent %d)\n'
                                 % (seq, sid, sub.seq)).encode(), {})
            if seq <= sub.acked:
                self._counters['duplicate_acks'] += 1
                return 0, b'', b'', {}
            sub.acked = seq
            catch_up = (sub.dirty and
                        sub.seq - sub.acked <
                        self.conf['queue_depth'] and
                        sub.group.payload is not None)
            if catch_up:
                # degraded mode's exit: one full frame carrying the
                # CURRENT state, however many versions were skipped
                self._send_frame(sub, sub.group, force_full=True)
        return 0, b'', b'', {}

    def unsubscribe(self, req):
        sid = req.get('sub')
        with self._lock:
            sub = self._subs.get(sid)
            if sub is None:
                return (1, b'', ('dn: unknown subscription %r\n'
                                 % (sid,)).encode(), {})
            self._drop(sub, reason='unsubscribe')
        return 0, b'', b'', {}

    def _drop(self, sub, reason):
        """Caller holds the lock."""
        if self._subs.pop(sub.sid, None) is None:
            return
        sub.group.subs.discard(sub)
        sids = self._by_conn.get(sub.conn.fd)
        if sids is not None:
            sids.discard(sub.sid)
            if not sids:
                self._by_conn.pop(sub.conn.fd, None)
        if not sub.group.subs:
            # last rider gone: retire the group and its memo
            self._groups.pop(sub.group.key, None)
        self._counters['dropped'] += 1
        if not sub.conn.closed:
            self.server.loop.unpin(sub.conn)
        if obs_events.enabled():
            obs_events.emit('subscribe.drop', sub=sub.sid,
                            reason=reason, frames=sub.seq)
        self._set_gauges()

    def on_conn_close(self, conn):
        """Loop-thread callback: the subscriber died (EOF, reap,
        kill) — deregister everything it carried.  Quick dict
        surgery only."""
        with self._lock:
            sids = self._by_conn.pop(conn.fd, None)
            if not sids:
                return
            for sid in list(sids):
                sub = self._subs.get(sid)
                if sub is not None and sub.conn is conn:
                    self._drop(sub, reason='conn_closed')

    # -- dirty signals ----------------------------------------------------

    def _on_index_write(self, indexroot, shard_paths):
        """The in-process publish hook (builds, follow mini-batches,
        compaction, rollups): mark matching groups dirty and wake the
        pusher — the coalesce window starts now."""
        hit = False
        with self._lock:
            for group in self._groups.values():
                if group.doc['watch'] != 'query':
                    continue
                root = group.doc.get('_indexroot')
                if root and indexroot and \
                        os.path.normpath(root) == \
                        os.path.normpath(indexroot):
                    group.dirty = True
                    hit = True
        if hit:
            self._wake.set()

    # -- the pusher thread ------------------------------------------------

    def _run(self):
        period = self.conf['coalesce_ms'] / 1000.0
        while not self._stop.is_set():
            fired = self._wake.wait(period)
            if self._stop.is_set():
                return
            if fired:
                self._wake.clear()
                # the coalesce window: let the publish batch finish
                # landing, push once for all of it
                if self._stop.wait(period):
                    return
            try:
                self._sweep()
            except Exception as e:
                # the pusher must survive anything a recompute
                # throws: log, count, carry on — a wedged pusher
                # would silently freeze every dashboard
                self._bump('compute_errors')
                self.log.error('subscription sweep failed',
                               err=repr(e))

    def _sweep(self):
        with self._lock:
            groups = list(self._groups.values())
        now = time.monotonic()
        for group in groups:
            if self._stop.is_set():
                return
            signal = True
            if group.doc['watch'] == 'fleet':
                due = (now - group.last_compute) * 1000.0 >= \
                    group.doc['interval_ms']
                if not due:
                    continue
            elif group.seeding:
                # the seed is this group's first recompute; its
                # validators are not taken yet, which would read as a
                # change and walk again right after it (the reference
                # does)
                continue
            else:
                signal = group.dirty or \
                    self._validators_changed(group)
                confirm = (group.confirm_at is not None and
                           now >= group.confirm_at)
                if not signal and not confirm:
                    self._flush_dirty_subs(group)
                    continue
                if not signal:
                    self._bump('reconfirms')
            with group.compute_lock:
                group.dirty = False
                try:
                    changed = self._recompute(group)
                except DNError as e:
                    # keep the last good payload; retry next tick
                    group.dirty = True
                    group.last_error = e.message
                    self._bump('compute_errors')
                    continue
                except Exception as e:
                    group.dirty = True
                    group.last_error = repr(e)
                    self._bump('compute_errors')
                    continue
            if group.doc['watch'] == 'query' and \
                    self.server.router is not None:
                # routed reconvergence: a scatter answered by a peer
                # PROCESS that did not see this write's hook can lag
                # by the peer's stat-TTL memo window (the poll path
                # self-heals by re-scattering every request; a
                # standing query scatters only when signalled).  One
                # confirming scatter after the window expires either
                # observes the settled bytes (unchanged -> converged,
                # stop) or pushes the newer state and re-arms
                if signal or changed:
                    group.confirm_at = now + self._confirm_delay()
                else:
                    group.confirm_at = None
            if changed:
                self._push_group(group)
            else:
                self._flush_dirty_subs(group)

    def _flush_dirty_subs(self, group):
        """Subscribers that missed a frame for a reason OTHER than
        their own lag (joined while the seed was still computing,
        shed once and acked quietly): hand them the current payload
        as soon as their window allows."""
        with self._lock:
            for sub in list(group.subs):
                if sub.dirty and not sub.conn.closed and \
                        group.payload is not None and \
                        sub.seq - sub.acked < self.conf['queue_depth']:
                    self._send_frame(sub, group, force_full=True)

    def _validators_changed(self, group):
        """Cross-process writers (a `dn follow` publishing from its
        own process) never fire OUR write hook; the tree validators
        — the same stat identities the query cache trusts — catch
        them at the coalesce cadence.  A detected change bumps the
        writer-invalidation epoch first, so the frame's epoch and a
        poll's epoch agree."""
        root = group.doc.get('_indexroot')
        if not root or group.validators is None:
            return group.validators is None
        current = mod_qcache.tree_validators(root)
        if current != group.validators:
            if mod_journal.publish_in_flight(root, IN_FLIGHT_STALE_S,
                                             ignore_pid=os.getpid()):
                # another process is between its first tmp and its
                # journal's retirement: walking now would fold a
                # partial publish (or none) and walk again when it
                # lands — wait for it (the reference walks at once:
                # two recomputes, and a frame of the partial tree, for
                # one publish).  This process's own publishes fire
                # the write hook (a served one holds the tree's write
                # lock until it has landed).
                return False
            mod_iqmt.invalidate_index_tree(root)
            return True
        return False

    def _confirm_delay(self):
        """How long a routed group waits before its confirming
        scatter: past every peer process's stat-TTL memo window,
        plus a coalesce period of slack for the publish batch to
        finish landing."""
        return (mod_iqmt.stat_ttl_s() +
                self.conf['coalesce_ms'] / 1000.0 + 0.1)

    # -- recompute --------------------------------------------------------

    def _recompute(self, group, seed=False):
        """One incremental merge for the whole group, every
        subscriber's next frame.  Returns True when the rendered
        payload changed.  Raises DNError on a failed compute (the
        caller keeps the previous payload)."""
        if group.doc['watch'] == 'fleet':
            return self._recompute_fleet(group)
        return self._recompute_query(group, seed=seed)

    def _recompute_fleet(self, group):
        from . import fleet as mod_fleet
        doc = mod_fleet.fleet_doc(self.server,
                                  events_limit=group.doc['events'])
        payload = (json.dumps(doc, sort_keys=True, indent=2) +
                   '\n').encode()
        group.last_compute = time.monotonic()
        return self._install_payload(group, payload,
                                     mod_iqmt.cache_epoch())

    def _recompute_query(self, group, seed=False):
        from .. import datasource_for_name
        from . import server as mod_server
        t0 = time.monotonic()
        doc = group.doc
        backend = mod_config.ConfigBackendLocal(doc.get('config')
                                                or None)
        err, config = backend.load()
        if err is not None and not getattr(err, 'is_enoent', False):
            raise err
        ds = datasource_for_name(config, doc['ds'])
        if isinstance(ds, DNError):
            raise ds
        qc = mod_query.query_load(doc['queryconfig'] or {})
        if isinstance(qc, DNError):
            raise qc
        doc['_indexroot'] = getattr(ds, 'ds_indexpath', None)

        slot = lease = None
        if seed:
            lease = self.server._admit_resources('query', ds)
            try:
                slot = self.server.admission.acquire()
            except BaseException:
                lease.release()
                raise
        try:
            with self.server._tree_lock(ds, doc['ds']).read():
                # the change signals are consumed HERE, under the read
                # lock: a served build holds the write lock until its
                # publish has landed, so this walk sees it whole and
                # absorbs the hook it fired (and the tree changes a
                # tick saw while it ran) — one recompute per publish.
                # The reference takes them before the lock, so a tick
                # during a served build costs it a second walk.  The
                # epoch is still captured BEFORE the walk (the qcache's
                # ordering): a write racing this recompute re-dirties
                # the group — via the hook or the validators — and the
                # next sweep reconverges; the frame's epoch is never
                # newer than its bytes
                group.dirty = False
                epoch = mod_iqmt.cache_epoch()
                validators = mod_qcache.tree_validators(
                    doc['_indexroot'])
                if self.server.router is not None:
                    # a cluster member's walk covers only its
                    # partitions: the group scatters like a poll
                    result = self._routed_result(ds, doc, qc)
                else:
                    result = self._incremental_result(group, ds, qc)
        finally:
            if slot is not None:
                slot.release()
            if lease is not None:
                lease.release()

        # render through the SAME output layer a poll uses — the
        # byte-identity contract is this line, not a comparison
        cap = mod_server._Capture()
        with mod_server.bound_stdio(cap):
            mod_cli = _cli()
            mod_cli.dn_output(qc, _OutOpts(doc.get('opts') or {}),
                              result, doc['ds'])
        payload, _ = cap.finish()
        group.validators = validators
        group.last_compute = time.monotonic()
        group.recomputes += 1
        self._bump('recomputes')
        obs_metrics.inc('sub_group_recomputes_total')
        obs_metrics.observe('sub_recompute_ms',
                            (time.monotonic() - t0) * 1000.0)
        return self._install_payload(group, payload, epoch)

    def _incremental_result(self, group, ds, qc):
        """The heart of the subsystem: re-enumerate the walk, fold
        only shards whose stat identity changed, replay the rest from
        the memo, merge in global find order.  Structurally
        byte-identical to a poll: the same per-shard key items the
        poll's per-shard path merges, in the same order."""
        from ..aggr import Aggregator
        from ..datasource_file import ScanResult
        from ..vpipe import Pipeline

        doc = group.doc
        pipeline = Pipeline()
        root, timeformat, files = ds.index_query_paths(
            qc, doc['interval'], pipeline)
        idents = {}
        for p, st in files:
            try:
                idents[p] = (st.st_mtime_ns, st.st_size)
            except AttributeError:
                s = os.stat(p)
                idents[p] = (s.st_mtime_ns, s.st_size)
        paths = [p for p, st in files]
        paths, _ = mod_iqmt.prune_shards(paths, timeformat,
                                         qc.qc_after, qc.qc_before)
        from .. import integrity as mod_integrity
        if mod_integrity.verify_mode() != 'off':
            mod_integrity.check_missing(
                ds.ds_indexpath, paths,
                subdir=os.path.basename(root)
                if timeformat is not None else None,
                timeformat=timeformat, after_ms=qc.qc_after,
                before_ms=qc.qc_before)

        memo = group.memo
        changed = [p for p in paths
                   if p not in memo or memo[p][0] != idents[p]]
        reused = len(paths) - len(changed)
        fresh = {}
        state = {'i': 0}

        def on_items(items):
            path = changed[state['i']]
            state['i'] += 1
            fresh[path] = (idents[path], list(items))

        mod_iqmt.run_shard_queries(changed, qc,
                                   mod_iqmt.iq_threads(), on_items)
        # rebuild the memo from THIS walk's shard set: deleted and
        # compacted-away shards fall out here instead of leaking
        group.memo = {p: fresh[p] if p in fresh else memo[p]
                      for p in paths}
        self._bump('shards_folded', len(changed))
        self._bump('shards_reused', reused)
        obs_metrics.inc('sub_shards_folded_total', len(changed))
        obs_metrics.inc('sub_shards_reused_total', reused)

        index_list = pipeline.stage('Index List')
        aggr = Aggregator(qc, stage=pipeline.stage(
            'Index Result Aggregator'))
        for p in paths:
            items = group.memo[p][1]
            npts = len(items)
            if npts == 0:
                continue
            index_list.bump('ninputs', npts)
            index_list.bump('noutputs', npts)
            aggr.stage.bump('ninputs', npts)
            aggr.merge_key_items(items)
        index_list.bump_hidden('index shards queried', len(paths))
        return ScanResult(pipeline, points=aggr.points())

    def _routed_result(self, ds, doc, qc):
        """Cluster mode: the member's own walk only covers its
        partitions, so a standing query scatters like a poll does —
        still ONE scatter per publish batch for every subscriber of
        the group."""
        req = {'op': 'query', 'ds': doc['ds'],
               'config': doc.get('config'),
               'queryconfig': doc['queryconfig'],
               'interval': doc['interval']}
        result, missing = self.server.router.scatter(
            ds, doc['ds'], qc, doc['interval'], req)
        if missing:
            raise DNError('standing query degraded: partition(s) %s '
                          'unavailable'
                          % ','.join(str(p) for p in missing))
        return result

    def _install_payload(self, group, payload, epoch):
        digest = _payload_digest(payload)
        if group.payload is not None and digest == group.digest \
                and payload == group.payload:
            group.epoch = epoch
            return False
        group.payload = payload
        group.digest = digest
        group.epoch = epoch
        group.version += 1
        return True

    # -- pushing ----------------------------------------------------------

    def _push_group(self, group):
        with self._lock:
            subs = list(group.subs)
            for sub in subs:
                if sub.conn.closed:
                    continue
                self._send_frame(sub, group)

    def _send_frame(self, sub, group, force_full=False):
        """Caller holds the lock.  One frame for one subscriber —
        or a shed, if its unacked window is full (the frame is NOT
        queued; the catch-up full frame rides its next ack)."""
        pending = sub.seq - sub.acked
        if pending >= self.conf['queue_depth']:
            sub.sheds += 1
            sub.dirty = True
            self._counters['lagging_sheds'] += 1
            obs_metrics.inc('sub_lagging_sheds_total')
            if not sub.lagging:
                sub.lagging = True
                if obs_events.enabled():
                    obs_events.emit('subscribe.lagging', sub=sub.sid,
                                    pending=pending, peer=sub.peer)
            return
        payload = group.payload
        seq = sub.seq + 1
        kind = 'full'
        body = payload
        extra = {'token': self._token(group, seq),
                 'version': group.version}
        delta_pct = self.conf['delta_pct']
        if not force_full and not sub.lagging and delta_pct > 0 and \
                sub.last_payload is not None:
            off, keep, ins = mod_protocol.byte_delta(
                sub.last_payload, payload)
            if len(ins) * 100 <= len(payload) * delta_pct:
                kind = 'delta'
                body = ins
                extra['delta'] = {'off': off, 'keep': keep,
                                  'base_seq': sub.seq}
        frame = mod_protocol.encode_push(sub.sid, seq, group.epoch,
                                         kind, body, extra)
        try:
            mod_faults.fire('serve.push_torn')
        except mod_faults.FaultInjected:
            # a torn push frame: half the bytes then EOF — the
            # client must detect the cut stream and resume, never
            # hang or mis-splice
            self.server.loop.send(sub.conn,
                                  frame[:max(1, len(frame) // 2)],
                                  close_after=True)
            return
        self.server.loop.send(sub.conn, frame)
        sub.seq = seq
        sub.last_payload = payload
        sub.dirty = False
        sub.lagging = False
        if kind == 'delta':
            sub.frames_delta += 1
            self._counters['frames_delta'] += 1
            obs_metrics.inc('sub_frames_delta_total')
        else:
            sub.frames_full += 1
            self._counters['frames_full'] += 1
            obs_metrics.inc('sub_frames_full_total')
        self._counters['pushes'] += 1
        self._counters['push_bytes'] += len(frame)
        obs_metrics.inc('sub_pushes_total')
        obs_metrics.inc('sub_push_bytes_total', len(frame))

    # -- observability ----------------------------------------------------

    def stats_doc(self):
        with self._lock:
            groups = []
            for g in self._groups.values():
                groups.append({
                    'watch': g.doc['watch'],
                    'ds': g.doc.get('ds'),
                    'subscribers': len(g.subs),
                    'version': g.version,
                    'epoch': g.epoch,
                    'payload_bytes': len(g.payload)
                    if g.payload is not None else 0,
                    'memo_shards': len(g.memo),
                    'recomputes': g.recomputes,
                    'last_error': g.last_error,
                })
            subs = []
            for s in self._subs.values():
                subs.append({
                    'sub': s.sid, 'peer': s.peer,
                    'seq': s.seq, 'acked': s.acked,
                    'lagging': s.lagging,
                    'frames_full': s.frames_full,
                    'frames_delta': s.frames_delta,
                    'sheds': s.sheds,
                })
            return {
                'enabled': self.enabled(),
                'active': len(self._subs),
                'max': self.conf['max'],
                'coalesce_ms': self.conf['coalesce_ms'],
                'queue_depth': self.conf['queue_depth'],
                'delta_pct': self.conf['delta_pct'],
                'counters': dict(self._counters),
                'groups': groups,
                'subscribers': subs,
            }


def _cli():
    from .. import cli as mod_cli
    return mod_cli
