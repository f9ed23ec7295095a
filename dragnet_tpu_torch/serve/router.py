"""Scatter-gather query routing for a `dn serve` cluster.

Counterpart of dragnet_tpu/serve/router.py (whole).  Routing is host
code, as in the reference: each member's partial walks its own shards
through index_query_mt.run_shard_queries, and the router merges key
items on the host.  The card's part is each member's own device work
(the pre-warm, residency, served scans and builds).

Any cluster member can be the router for an incoming index query: it
fans one partition-scoped partial query (`query_partial`) to a live
replica of every partition in the topology, merges the partial
aggregates through the Aggregator key-items wire format, and formats
the merged result through the unmodified CLI output layer — so a
routed query's RESULT bytes are identical to a single-process run.
(`--counters` debug output is explicitly outside that contract: it
renders pipeline stages, and the router's merge pipeline is not the
single-process find/walk pipeline — each member ran its own walk.)

Byte-identity is structural, not hopeful: final output order depends
on the FIRST-OCCURRENCE order of string-like group keys across the
whole shard set (aggr.js_key_order), so partials travel as
PER-SHARD key-item lists (each member answers for its shards in find
order) and the router merges every shard — across all partitions —
in global find order (the path-component sort below).  The merge loop
is the same write_key replay `datasource_file.query` runs for its own
shard fan-in.

Failure-first design (the headline of this layer):

* Per-member circuit breakers (closed -> open after
  DN_ROUTER_FAILURES consecutive failures -> half-open one trial
  after DN_ROUTER_COOLDOWN_MS), fed by both a background health
  prober (the `health` op, DN_ROUTER_PROBE_MS cadence) and live
  dispatch outcomes.
* Automatic failover: a partial that fails on one replica
  (connect/transport errors, retryable rejections, epoch mismatch)
  moves to the next-ranked replica.  Replica ranking demotes DRAINING
  members before their socket dies and open-breaker members to
  last-resort (they are still dialed when nothing better exists — the
  breaker must never turn a blip into a guaranteed outage).
* Hedged reads: when a partial is slower than the observed p95
  (floored at DN_ROUTER_HEDGE_MS; 0 disables), the router fires a
  duplicate at the next replica and keeps whichever answers first;
  fired/won/wasted counts are accounted.
* Clean degraded results: when EVERY replica of a partition is down,
  DN_ROUTER_PARTIAL picks the contract — 'error' raises a retryable
  DNError naming the missing partitions; 'allow' merges the live
  partitions and names the missing ones in the response header.
  Never a hang (DN_ROUTER_FETCH_TIMEOUT_S bounds each fetch), never
  a traceback, never silently short bytes.

Every decision lands in the obs layer: router_* counters and the
router_partial_ms histogram (which also feeds the hedge delay),
router.scatter/router.partial/router.merge spans, and the /stats
`cluster` section (serve/server.py).

Dynamic topology (serve/coordinator.py): the serving map can change
while the router runs.  update_topology() swaps the map atomically —
departed members' prober threads stop and their pooled connections
close/evict (no thread or fd leak, no log-noise probing of dead
endpoints), new members get fresh states and probers.  Every scatter
snapshots ONE topology (a whole query is answered under exactly one
epoch — never a mix of partition maps), and a member that answers a
partial with an epoch-mismatch rejection raises TopologyEpochError so
the server can re-fetch the current map and retry the scatter.
"""

import json
import os
import queue
import threading
import time

from ..errors import DNError
from .. import config as mod_config
from .. import faults as mod_faults
from .. import vpipe as mod_vpipe
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace


class RouterPartitionError(DNError):
    """Every replica of >= 1 partition is down and DN_ROUTER_PARTIAL
    is 'error': a clean, retryable degraded response naming the
    missing partitions (the `missing_partitions` attribute rides into
    the response header)."""

    def __init__(self, missing, detail, retry_after_ms=None):
        super(RouterPartitionError, self).__init__(
            'cluster partition(s) unavailable: %s (%s)'
            % (','.join(str(p) for p in missing), detail))
        self.missing_partitions = list(missing)
        self.retryable = True
        # when the partitions failed because members were SHEDDING
        # (busy/overloaded, not down), the members' retry hints ride
        # up to the client — shed != down, and the client should back
        # off exactly as long as the most loaded member asked
        self.retry_after_ms = retry_after_ms


class TopologyEpochError(DNError):
    """A member rejected a partial because it serves a NEWER topology
    epoch than the one this scatter ran under: the router's map is
    stale.  Retryable — the server re-polls the coordinator source
    and retries the whole scatter under the refreshed map."""

    def __init__(self, detail, current_epoch=None):
        super(TopologyEpochError, self).__init__(
            'topology epoch stale during scatter: %s' % detail)
        self.retryable = True
        self.epoch_mismatch = True
        self.current_epoch = current_epoch


class _BreakerOpen(Exception):
    """Internal: a dial was suppressed by an open breaker."""


# every router counter also lands in the typed registry as
# ``router_<name>_total`` (_bump below); module-level so the
# Prometheus-exposition completeness gate can enumerate the family
# without constructing a Router
COUNTER_NAMES = ('scatters', 'partials_local', 'partials_remote',
                 'failovers', 'hedges_fired', 'hedges_won',
                 'hedges_wasted', 'degraded', 'partial_responses',
                 'breaker_skips', 'breaker_forced_dials',
                 'epoch_updates', 'epoch_mismatches',
                 'corrupt_failovers')


# -- circuit breaker --------------------------------------------------------

class Breaker(object):
    """Per-member circuit breaker: CLOSED (healthy) -> OPEN after
    `failures` consecutive failures -> HALF_OPEN one trial after
    `cooldown_ms` -> CLOSED on trial success / back to OPEN on trial
    failure.  allow() consumes the half-open trial; record_success /
    record_failure feed it from probes and live dispatches alike."""

    CLOSED, OPEN, HALF_OPEN = 'closed', 'open', 'half-open'

    def __init__(self, failures, cooldown_ms, clock=time.monotonic,
                 name=None):
        self._lock = threading.Lock()
        self._clock = clock
        self.failures_threshold = failures
        self.cooldown_s = cooldown_ms / 1000.0
        self.name = name
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._opened_at = None
        self._trial_inflight = False
        self.transitions = {self.CLOSED: 0, self.OPEN: 0,
                            self.HALF_OPEN: 0}

    def _to(self, state):
        prior = self.state
        self.state = state
        self.transitions[state] += 1
        if obs_events.enabled():
            # probes flip breakers with no request active: no trace
            obs_events.emit('breaker.' + state, member=self.name,
                            prior=prior,
                            failures=self.consecutive_failures)

    def allow(self):
        """May a request be sent to this member right now?"""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._to(self.HALF_OPEN)
                    self._trial_inflight = True
                    return True
                return False
            # HALF_OPEN: exactly one trial in flight at a time
            if self._trial_inflight:
                return False
            self._trial_inflight = True
            return True

    def record_success(self):
        with self._lock:
            self.consecutive_failures = 0
            self._trial_inflight = False
            if self.state != self.CLOSED:
                self._to(self.CLOSED)

    def record_failure(self):
        with self._lock:
            self.consecutive_failures += 1
            self._trial_inflight = False
            if self.state == self.HALF_OPEN:
                self._opened_at = self._clock()
                self._to(self.OPEN)
            elif self.state == self.CLOSED and \
                    self.consecutive_failures >= \
                    self.failures_threshold:
                self._opened_at = self._clock()
                self._to(self.OPEN)

    def snapshot(self):
        with self._lock:
            return {'state': self.state,
                    'consecutive_failures': self.consecutive_failures,
                    'transitions': dict(self.transitions)}


class MemberState(object):
    """What the router knows about one member: endpoint, breaker, and
    the last health-probe verdict."""

    def __init__(self, name, endpoint, breaker):
        self.name = name
        self.endpoint = endpoint
        self.breaker = breaker
        self.lock = threading.Lock()
        self.draining = False
        # disk-critical read-only member (resources.py): still
        # serving queries byte-identically, demoted only for
        # write-shaped dispatch
        self.degraded_ro = False
        self.last_ok = None        # monotonic of last good signal
        # set when the member leaves the topology: its prober thread
        # exits at the next wakeup instead of probing a dead endpoint
        # forever (the pre-dynamic-topology leak)
        self.gone = threading.Event()

    def note_health(self, doc):
        ok = bool(doc.get('ok'))
        with self.lock:
            self.draining = bool(doc.get('draining'))
            self.degraded_ro = bool(doc.get('degraded_ro'))
            if ok:
                self.last_ok = time.monotonic()
        if ok:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()

    def snapshot(self):
        with self.lock:
            draining = self.draining
            degraded_ro = self.degraded_ro
            last_ok = self.last_ok
        snap = self.breaker.snapshot()
        snap.update({'endpoint': self.endpoint, 'draining': draining,
                     'degraded_ro': degraded_ro,
                     'last_ok_age_s':
                     round(time.monotonic() - last_ok, 3)
                     if last_ok is not None else None})
        return snap


# -- member-side partial execution ------------------------------------------

def partial_query(ds, query, interval, topology, partition_ids):
    """Execute an index query over THIS member's slice of the shard
    set: the identical enumerate/sweep/litter-filter/prune walk a
    single-process query performs (datasource_file.index_query_paths),
    restricted to the shards `partition_ids` own, each shard's
    aggregate exported as key items in find order.  Returns
    [[relpath, [[keys..., ], weight], ...], ...] — the JSON wire shape
    of the `query_partial` op."""
    from .. import index_query_mt as mod_iqmt
    from ..vpipe import Pipeline
    pipeline = Pipeline()
    root, timeformat, files = ds.index_query_paths(query, interval,
                                                   pipeline)
    paths = [p for p, st in files]
    paths, _ = mod_iqmt.prune_shards(paths, timeformat,
                                     query.qc_after, query.qc_before)
    want = set(partition_ids)
    paths = [p for p in paths
             if topology.partition_of(p, timeformat) in want]
    mod_vpipe.counter_bump('cluster partial shards', len(paths))
    # verified reads: a catalogued shard of OUR partitions missing
    # from the walk (quarantined post-corruption, not yet repaired)
    # rejects the partial retryably — the router fails over to a
    # replica that has the bytes, instead of this member silently
    # merging a short shard set
    from .. import integrity as mod_integrity
    if mod_integrity.verify_mode() != 'off':
        mod_integrity.check_missing(
            ds.ds_indexpath, paths,
            subdir=os.path.basename(root)
            if timeformat is not None else None,
            timeformat=timeformat, after_ms=query.qc_after,
            before_ms=query.qc_before,
            partition_filter=lambda p:
            topology.partition_of(p, timeformat) in want)
    indexroot = ds.ds_indexpath
    shards = []
    state = {'i': 0}

    def on_items(items):
        # run_shard_queries reports once per shard in `paths` order
        path = paths[state['i']]
        state['i'] += 1
        shards.append([os.path.relpath(path, indexroot),
                       [[list(k), w] for k, w in items]])

    mod_iqmt.run_shard_queries(paths, query, mod_iqmt.iq_threads(),
                               on_items)
    return shards


# -- the router -------------------------------------------------------------

class Router(object):
    """The scatter-gather executor one cluster member runs.

    `local_exec(partition_ids, req)` is the server-provided callable
    that executes a partial for partitions THIS member owns without
    dialing itself (admission slot + tree read-lock inside) — routing
    through our own socket could deadlock a full admission queue.
    `self_draining()` reports the local server's drain state so the
    self replica demotes exactly like a remote draining member."""

    def __init__(self, topology, member, conf=None, local_exec=None,
                 self_draining=None, self_degraded=None):
        if conf is None:
            conf = mod_config.router_config()
        if isinstance(conf, DNError):
            raise conf
        self.topo = topology
        self.member = member
        self.conf = conf
        self.local_exec = local_exec
        self.self_draining = self_draining or (lambda: False)
        # the local server's read-only (disk critical) state, the
        # self-member analog of a probed degraded_ro flag
        self.self_degraded = self_degraded or (lambda: False)
        self.states = {}
        for name in topology.member_names():
            self.states[name] = MemberState(
                name, topology.endpoint(name),
                Breaker(conf['failures'], conf['cooldown_ms'],
                        name=name))
        self._stop = threading.Event()
        self._prober_started = False
        self._prober_threads = []
        # serializes topology swaps against each other; scatters
        # never take it — they snapshot self.topo once per scatter
        self._swap_lock = threading.Lock()
        self._lock = threading.Lock()
        self._counters = {name: 0 for name in COUNTER_NAMES}
        # the hedge-delay source: observed partial latencies (also
        # exported through the typed registry as router_partial_ms)
        self._latency = obs_metrics.Histogram()
        self._latency_lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def start(self):
        if not self._prober_started:
            # ONE prober thread per member: a probe of a hard-down
            # TCP member can block for the client's full retry
            # budget, and a shared serial sweep would starve every
            # other member's breaker/draining freshness of exactly
            # the signal DN_ROUTER_PROBE_MS promises
            self._prober_started = True
            with self._swap_lock:
                for name, st in list(self.states.items()):
                    self._start_prober(name, st)
        return self

    def stop(self):
        self._stop.set()
        for st in list(self.states.values()):
            st.gone.set()
        for t in self._prober_threads:
            t.join(2.0)
        self._prober_threads = []
        self._prober_started = False

    def update_topology(self, topology):
        """Swap the serving map while live (the dynamic-topology
        cutover).  Departed members are retired — prober thread
        stopped (MemberState.gone), pooled connection closed and
        evicted — new members get fresh states (and probers when
        probing runs), and a retained member whose endpoint moved
        drops its old connection.  In-flight scatters finish on the
        topology they snapshotted; members that already cut over
        reject them with the epoch-mismatch contract and the server
        retries under the new map."""
        from . import pool as mod_pool
        with self._swap_lock:
            new_names = set(topology.member_names())
            kept_endpoints = {topology.endpoint(n)
                              for n in new_names}
            for name in list(self.states):
                if name in new_names:
                    continue
                st = self.states.pop(name)
                st.gone.set()
                if st.endpoint not in kept_endpoints:
                    mod_pool.get().close_endpoint(st.endpoint)
            for name in sorted(new_names):
                st = self.states.get(name)
                if st is None:
                    st = MemberState(
                        name, topology.endpoint(name),
                        Breaker(self.conf['failures'],
                                self.conf['cooldown_ms'],
                                name=name))
                    self.states[name] = st
                    if self._prober_started:
                        self._start_prober(name, st)
                elif st.endpoint != topology.endpoint(name):
                    old_ep = st.endpoint
                    st.endpoint = topology.endpoint(name)
                    if old_ep not in kept_endpoints:
                        mod_pool.get().close_endpoint(old_ep)
            self.topo = topology
        self._bump('epoch_updates')
        obs_trace.event('router.topology', epoch=topology.epoch)

    # -- health probing ---------------------------------------------------

    def _start_prober(self, name, st):
        # call with _swap_lock held.  Prune exited probers (departed
        # members') first — a long-lived member under topology churn
        # must not accumulate dead Thread objects forever
        self._prober_threads = [t for t in self._prober_threads
                                if t.is_alive()]
        t = threading.Thread(
            target=self._probe_loop, args=(name, st),
            name='dn-router-probe-%s' % name, daemon=True)
        t.start()
        self._prober_threads.append(t)

    def _probe_loop(self, name, st):
        from . import client as mod_client
        period = self.conf['probe_ms'] / 1000.0
        while not st.gone.wait(period):
            if self._stop.is_set():
                return
            if name == self.member:
                st.note_health({'ok': True,
                                'draining': self.self_draining()})
                continue
            doc = mod_client.health(st.endpoint,
                                    timeout_s=min(
                                        5.0, period * 4 + 1.0))
            if self._stop.is_set() or st.gone.is_set():
                return
            st.note_health(doc)

    def probe_once(self):
        """One synchronous probe sweep (tests, and a cold router that
        wants member state before its first scatter)."""
        from . import client as mod_client
        for name, st in list(self.states.items()):
            if name == self.member:
                st.note_health({'ok': True,
                                'draining': self.self_draining()})
            else:
                st.note_health(mod_client.health(st.endpoint,
                                                 timeout_s=5.0))

    # -- accounting -------------------------------------------------------

    def _bump(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        obs_metrics.inc('router_%s_total' % name, n)

    def _observe_latency(self, ms):
        with self._latency_lock:
            self._latency.observe(ms)
        obs_metrics.observe('router_partial_ms', ms)

    def _hedge_delay_s(self):
        """The hedge trigger: the larger of DN_ROUTER_HEDGE_MS and
        the observed p95 partial latency (a hedge should chase the
        tail, not the median); None when hedging is disabled."""
        floor_ms = self.conf['hedge_ms']
        if floor_ms <= 0:
            return None
        with self._latency_lock:
            p95 = self._latency.quantile(0.95) \
                if self._latency.total >= 8 else None
        return max(floor_ms, p95 or 0.0) / 1000.0

    def stats_doc(self):
        with self._lock:
            counters = dict(self._counters)
        return {
            'member': self.member,
            'epoch': self.topo.epoch,
            'assign': self.topo.assign,
            'partitions_owned': self.topo.partitions_of(self.member),
            'partitions': len(self.topo.partitions),
            'counters': counters,
            'members': {name: st.snapshot()
                        for name, st in self.states.items()},
        }

    # -- replica ranking --------------------------------------------------

    def _rank(self, replicas, write_shaped=False):
        """Dispatch preference: healthy members first (self preferred
        — a local partial never pays the socket), draining members
        demoted, open-breaker members last-resort.  `write_shaped`
        additionally demotes read-only (disk-critical ``degraded_ro``)
        members: they keep serving queries byte-identically, so READ
        dispatch ranks them exactly like healthy members, but a
        write-shaped op would only bounce off their disk_full
        rejection.  Returns the full list — a last-resort member is
        still better than a degraded response."""
        def score(name):
            st = self.states.get(name)
            if st is None:
                # left the topology mid-scatter: worst rank, and the
                # dial itself fails cleanly into the failover path
                return (4, 1, replicas.index(name))
            snap = st.breaker.snapshot()
            with st.lock:
                draining = st.draining
                degraded_ro = st.degraded_ro
            if name == self.member:
                draining = draining or self.self_draining()
                degraded_ro = degraded_ro or self.self_degraded()
            penalty = 0
            if draining:
                penalty += 1
            if write_shaped and degraded_ro:
                penalty += 1
            if snap['state'] == Breaker.OPEN:
                penalty += 2
            return (penalty, 0 if name == self.member else 1,
                    replicas.index(name))
        return sorted(replicas, key=score)

    def rank_for_write(self, replicas):
        """Replica preference for write-shaped dispatch (remote
        builds, repair/handoff landing targets): read-only members
        rank behind writable ones."""
        return self._rank(replicas, write_shaped=True)

    # -- partial fetch ----------------------------------------------------

    def _fetch_one(self, name, pid, partial_req, timeout_s,
                   force=False):
        """One partial attempt at one member; returns the shard list
        or raises (DNError for member-reported failures, OSError/
        ValueError for transport, _BreakerOpen for a suppressed
        dial).  Breaker accounting happens here.  `force` bypasses
        the breaker gate (outcomes still feed it): the exhaustion
        path force-dials suppressed replicas before degrading — an
        open breaker must never turn a blip into a guaranteed
        outage."""
        from . import client as mod_client
        t0 = time.monotonic()
        if name == self.member:
            with obs_trace.span('router.partial', member=name,
                                partition=pid, local=True):
                shards = self.local_exec(partial_req['partitions'],
                                         partial_req)
            self._bump('partials_local')
            self._observe_latency((time.monotonic() - t0) * 1000.0)
            return shards
        st = self.states.get(name)
        if st is None:
            raise DNError('member "%s" left the topology' % name)
        if not force and not st.breaker.allow():
            self._bump('breaker_skips')
            raise _BreakerOpen(name)
        # trace propagation over the pooled v2 path: the partial
        # carries the active trace id and asks for the member's span
        # subtree, exactly like the v1 `--remote` client path — a
        # traced routed query yields ONE joined tree spanning router
        # and members (the member's subtree grafts under this
        # router.partial span below)
        tctx = obs_trace.current_trace()
        if tctx is not None and 'trace' not in partial_req:
            partial_req = dict(partial_req,
                               trace={'id': tctx.trace_id,
                                      'want': True})
        try:
            with obs_trace.span('router.partial', member=name,
                                partition=pid):
                # partials ride the pooled persistent connection (one
                # socket per member, multiplexed across partitions
                # and concurrent scatters) — no dial per partial
                rc, header, out, err = mod_client.request_bytes(
                    st.endpoint, partial_req, timeout_s=timeout_s,
                    pooled=True)
                if tctx is not None:
                    mod_client.graft_remote_trace(tctx, header)
        except (OSError, ValueError, DNError) as e:
            st.breaker.record_failure()
            raise DNError('member "%s"' % name,
                          cause=DNError(str(e)))
        if rc != 0:
            # the member answered: it is alive (busy/draining/epoch
            # mismatch are retryable rejections, not breaker food)
            if header.get('retryable'):
                st.breaker.record_success()
            else:
                st.breaker.record_failure()
            msg = err.decode('utf-8', 'replace').strip() or \
                'partial failed'
            e = DNError('member "%s": %s' % (name, msg))
            if header.get('retryable'):
                e.retryable = True
                e.retry_after_ms = header.get('retry_after_ms')
            hstats = header.get('stats') or {}
            if hstats.get('epoch_mismatch'):
                # the member serves a different epoch than this
                # scatter's snapshot: surfaced so scatter() can tell
                # a stale MAP from a dead member
                e.epoch_mismatch = True
                e.current_epoch = hstats.get('current_epoch')
            if hstats.get('corrupt_shard'):
                # the member detected (or is missing) a corrupt
                # shard: it is ALIVE and self-healing — the failover
                # to the next replica is the whole contract (counted
                # uniformly in _fetch_partition, which also sees the
                # LOCAL partial's ShardIntegrityError)
                e.corrupt_shard = hstats.get('corrupt_shard')
            raise e
        st.breaker.record_success()
        try:
            doc = json.loads(out.decode('utf-8'))
            shards = doc['shards']
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            raise DNError('member "%s": malformed partial response'
                          % name, cause=DNError(str(e)))
        self._bump('partials_remote')
        self._observe_latency((time.monotonic() - t0) * 1000.0)
        return shards

    def _fetch_partition(self, pid, partial_req, scope, topo):
        """Fetch one partition's partial with failover + hedging
        under the scatter's topology snapshot `topo`.  Returns the
        shard list; raises DNError when every replica failed."""
        with mod_vpipe.adopt_scope(scope):
            mod_faults.fire('router.dispatch')
            ranked = self._rank(topo.replicas(pid))
            timeout_s = self.conf['fetch_timeout_s']
            if partial_req.get('deadline_ms'):
                # a propagated deadline bounds the fetch too: waiting
                # longer than the client will cannot help
                timeout_s = min(
                    timeout_s,
                    partial_req['deadline_ms'] / 1000.0 + 1.0)
            resultq = queue.Queue()
            launched = []

            def launch(name, role, force=False):
                launched.append(name)

                def body():
                    with mod_vpipe.adopt_scope(scope):
                        try:
                            resultq.put(
                                (role, name, True,
                                 self._fetch_one(name, pid,
                                                 partial_req,
                                                 timeout_s,
                                                 force=force)))
                        except _BreakerOpen:
                            resultq.put((role, name, False, None))
                        except (DNError, Exception) as e:
                            resultq.put((role, name, False, e))
                t = threading.Thread(
                    target=body, daemon=True,
                    name='dn-router-p%s-%s' % (pid, name))
                t.start()

            errors = []
            skipped = []
            hedge_delay = self._hedge_delay_s()
            hedged = False
            forced = False
            outstanding = 1
            nxt = 1
            launch(ranked[0], 'primary')
            deadline = time.monotonic() + timeout_s * len(ranked) + 5
            while outstanding > 0:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                if not hedged and hedge_delay is not None and \
                        nxt < len(ranked):
                    wait = min(wait, hedge_delay)
                try:
                    role, name, ok, value = resultq.get(timeout=wait)
                except queue.Empty:
                    if not hedged and hedge_delay is not None and \
                            nxt < len(ranked):
                        # the in-flight partial is slower than the
                        # tail: duplicate it at the next replica and
                        # keep whichever answers first
                        hedged = True
                        self._bump('hedges_fired')
                        obs_trace.event('router.hedge',
                                        partition=pid,
                                        member=ranked[nxt])
                        if obs_events.enabled():
                            obs_events.emit('router.hedge',
                                            partition=pid,
                                            to=ranked[nxt])
                        launch(ranked[nxt], 'hedge')
                        nxt += 1
                        outstanding += 1
                    continue
                outstanding -= 1
                if ok:
                    if hedged:
                        # the loser is abandoned; its eventual result
                        # is discarded — account the cancellation
                        if role == 'hedge':
                            self._bump('hedges_won')
                        else:
                            self._bump('hedges_wasted')
                    return value
                if value is not None:
                    errors.append(value)
                    if getattr(value, 'corrupt_shard', None) \
                            is not None:
                        # a replica rejected because its shard bytes
                        # are damaged (it repairs itself meanwhile):
                        # the failover below is working as designed
                        self._bump('corrupt_failovers')
                else:
                    skipped.append(name)
                if nxt < len(ranked):
                    self._bump('failovers')
                    obs_trace.event('router.failover', partition=pid,
                                    to=ranked[nxt])
                    if obs_events.enabled():
                        obs_events.emit(
                            'router.failover', partition=pid,
                            to=ranked[nxt], frm=name,
                            error=getattr(value, 'message', None)
                            if value is not None else 'breaker open')
                    launch(ranked[nxt], 'failover')
                    nxt += 1
                    outstanding += 1
                elif outstanding == 0 and skipped and not forced:
                    # every remaining candidate was suppressed by an
                    # open breaker: before degrading, force one real
                    # dial at each — a breaker still inside its
                    # cooldown must never turn a transient blip into
                    # a guaranteed outage when it holds the only
                    # live replica
                    forced = True
                    for skip_name in skipped:
                        self._bump('breaker_forced_dials')
                        obs_trace.event('router.breaker_force',
                                        partition=pid,
                                        member=skip_name)
                        if obs_events.enabled():
                            obs_events.emit('router.breaker_force',
                                            partition=pid,
                                            to=skip_name)
                        launch(skip_name, 'forced', force=True)
                        outstanding += 1
            detail = '; '.join(
                getattr(e, 'message', None) or str(e)
                for e in errors[-2:]) or 'no replica reachable'
        e = DNError('partition %d: all replicas failed '
                    '(tried %s): %s'
                    % (pid, ','.join(launched), detail))
        hints = [getattr(x, 'retry_after_ms', None) for x in errors]
        hints = [h for h in hints if h is not None]
        if hints:
            e.retry_after_ms = max(hints)
        mism = [x for x in errors
                if getattr(x, 'epoch_mismatch', False)]
        if mism:
            # at least one replica is serving a different epoch: the
            # scatter's map may be stale, not the partition dead
            e.epoch_mismatch = True
            epochs = [getattr(x, 'current_epoch', None)
                      for x in mism]
            epochs = [v for v in epochs if isinstance(v, int)]
            if epochs:
                e.current_epoch = max(epochs)
        raise e

    # -- scatter-gather ---------------------------------------------------

    def scatter(self, ds, dsname, query, interval, req,
                deadline_at=None):
        """Fan `req` (an index query) across every partition and
        merge.  Returns (ScanResult, missing_partition_ids); raises
        RouterPartitionError in DN_ROUTER_PARTIAL=error mode when any
        partition has no live replica.  `deadline_at` (monotonic) is
        the routed request's propagated deadline: the REMAINING
        budget rides every member partial as its deadline_ms, so a
        member sheds partials it cannot finish in time instead of
        computing past the client's patience."""
        from ..aggr import Aggregator
        from ..datasource_file import ScanResult
        from ..vpipe import Pipeline

        self._bump('scatters')
        # ONE topology snapshot per scatter: every partial of this
        # query runs under the same epoch's partition map, so the
        # merge can never mix two epochs' shard assignments even
        # while a cutover swaps self.topo mid-flight
        topo = self.topo
        pids = topo.partition_ids()
        partial_req = {
            'op': 'query_partial', 'ds': dsname,
            'config': req.get('config'),
            'interval': interval,
            'queryconfig': req.get('queryconfig'),
            'epoch': topo.epoch,
        }
        if req.get('tenant'):
            # fairness identity rides the hop: a member under load
            # sheds per originating tenant, not per router
            partial_req['tenant'] = req['tenant']
        if deadline_at is not None:
            remaining_ms = int((deadline_at - time.monotonic())
                               * 1000.0)
            partial_req['deadline_ms'] = max(1, remaining_ms)
        scope = mod_vpipe.current_scope()
        results = {}
        failures = {}
        threads = []
        lock = threading.Lock()

        def fetch(pid):
            preq = dict(partial_req, partitions=[pid])
            try:
                shards = self._fetch_partition(pid, preq, scope,
                                               topo)
                with lock:
                    results[pid] = shards
            except DNError as e:
                with lock:
                    failures[pid] = e
            except Exception as e:
                # a partition must NEVER drop out silently: any
                # non-DNError bug in the fetch path becomes a named
                # failure (degraded response), not a short merge
                with lock:
                    failures[pid] = DNError(
                        'partition %d: internal fetch error: %r'
                        % (pid, e))

        with obs_trace.span('router.scatter', partitions=len(pids)):
            for pid in pids:
                t = threading.Thread(target=fetch, args=(pid,),
                                     daemon=True,
                                     name='dn-scatter-%s' % pid)
                threads.append(t)
                t.start()
            for t in threads:
                t.join()

        missing = sorted(failures)
        if missing:
            mism = [p for p in missing
                    if getattr(failures[p], 'epoch_mismatch', False)]
            if mism:
                # a member is on a different epoch: this is OUR map
                # being stale, not a dead partition — raise the
                # resync signal instead of a degraded result in
                # EITHER partial mode (serving a partial merge under
                # a stale map could drop partitions that moved)
                self._bump('epoch_mismatches')
                obs_metrics.inc('topo_epoch_mismatch_total')
                epochs = [getattr(failures[p], 'current_epoch', None)
                          for p in mism]
                epochs = [v for v in epochs if isinstance(v, int)]
                raise TopologyEpochError(
                    failures[mism[0]].message,
                    current_epoch=max(epochs) if epochs else None)
            self._bump('degraded')
            detail = '; '.join(
                failures[p].message for p in missing[:2])
            if obs_events.enabled():
                obs_events.emit('router.degraded',
                                partitions=list(missing),
                                error=detail)
            hints = [getattr(failures[p], 'retry_after_ms', None)
                     for p in missing]
            hints = [h for h in hints if h is not None]
            if self.conf['partial'] == 'error':
                raise RouterPartitionError(
                    missing, detail,
                    retry_after_ms=max(hints) if hints else None)
            self._bump('partial_responses')

        # merge in GLOBAL find order: every member reported its shards
        # in its own find order; the path-component sort reproduces
        # the single-process walk order across partitions, so string
        # keys first-occur in the identical order
        pipeline = Pipeline()
        index_list = pipeline.stage('Index List')
        aggr = Aggregator(query,
                          stage=pipeline.stage(
                              'Index Result Aggregator'))
        all_shards = []
        for pid in sorted(results):
            all_shards.extend(results[pid])
        all_shards.sort(key=lambda s: tuple(s[0].split('/')))
        with obs_trace.span('router.merge', shards=len(all_shards)):
            mod_faults.fire('router.merge')
            seen = set()
            aggr_stage = aggr.stage
            for relpath, items in all_shards:
                if relpath in seen:
                    # partitions are disjoint by construction; a
                    # shard arriving twice means mismatched topologies
                    # slipped past the epoch gate — refuse to
                    # double-count
                    raise DNError('cluster merge: shard "%s" '
                                  'reported by two partitions '
                                  '(topology mismatch?)' % relpath)
                seen.add(relpath)
                npts = len(items)
                if npts == 0:
                    continue
                index_list.bump('ninputs', npts)
                index_list.bump('noutputs', npts)
                aggr_stage.bump('ninputs', npts)
                aggr.merge_key_items([(tuple(k), w)
                                      for k, w in items])
        index_list.bump_hidden('index shards queried',
                               len(all_shards))
        return ScanResult(pipeline, points=aggr.points()), missing
