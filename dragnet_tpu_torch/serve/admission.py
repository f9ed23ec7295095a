"""Admission control, per-tenant fairness, per-request deadlines, and
request coalescing for `dn serve`.

Four mechanisms keep a resident server healthy under concurrent load,
in the order a request meets them:

* Coalescing (`Coalescer`): identical in-flight computations — same
  datasource, same query shape, same config identity — share ONE
  execution.  The first request in becomes the leader and computes;
  followers attach and wait for the leader's result (StreamBox-HBM's
  target-latency batching of concurrent pipeline work, applied to the
  serving tier).  Compatible requests that differ only in OUTPUT
  options (--raw vs --points vs pretty vs --counters) coalesce too:
  the compute key deliberately excludes formatting, and the server
  demuxes one shared ScanResult through each request's own output
  path.  Because the shared run goes through the default stacked
  cross-shard execution (index_query_stack), N concurrent index
  queries over the same tree cost one stacked aggregation.

* Per-tenant admission (`Admission`): at most `max_inflight`
  executions run at once; up to `queue_depth` more may wait — but the
  waiting room is now PER TENANT (tenants identified by the request's
  `tenant` field, defaulting to the connection's peer identity), each
  tenant bounded by `tenant_quota` queued requests and dequeued by
  WEIGHTED FAIR scheduling (stride scheduling over configured
  weights): a dashboard flooding one tenant's queue saturates its own
  quota and is rejected 429-style, while every other tenant's
  requests keep being admitted in weight proportion.  Beyond the
  global queue depth (or the tenant's quota) the request fails FAST
  with a retryable BusyError carrying `retry_after_ms` derived from
  the observed service time, instead of joining an unbounded convoy.
  Coalesced followers do not consume slots — attaching to an
  in-flight execution is the cheap path the whole design rewards.

* Load shedding (`OverloadedError`): a request whose propagated
  deadline cannot be met — the remaining budget is smaller than the
  observed typical service time, or the deadline expires while still
  queued — is shed EARLY with a clean retryable error carrying
  `retry_after_ms`.  Shed and expired work never occupies an
  execution slot (StreamBox-HBM's target-latency discipline: work
  that will miss its latency target is not worth starting).

* Deadlines: each request runs under `DN_SERVE_DEADLINE_MS` (or its
  own `deadline_ms`) on a reaper-armored thread
  (device_scan.run_with_deadline) — a wedged device op or a
  pathological query costs the client a bounded wait and a DNError,
  never a hung connection.  A coalesced follower shares its leader's
  fate: if the leader's execution times out, every attached request
  reports the deadline error.
"""

import json
import threading
import time
from collections import deque
from contextlib import contextmanager

from ..errors import DNError
from .. import faults as mod_faults
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics


class BusyError(DNError):
    """Queue-full fast rejection (the 429 analog).  Retryable: the
    client's backoff loop may try again, after `retry_after_ms` when
    the server derived one from observed service time."""

    def __init__(self, message, retry_after_ms=None, cause=None):
        super(BusyError, self).__init__(message, cause=cause)
        self.retry_after_ms = retry_after_ms


class OverloadedError(BusyError):
    """Deadline-aware load shed (the 503 analog): the request's
    remaining deadline budget cannot cover the observed service time,
    so it is rejected EARLY — before occupying an execution slot —
    with a retry hint.  Subclasses BusyError so every existing
    retryable-rejection contract applies unchanged."""


class DeadlineError(DNError):
    """Per-request deadline expiry (the 504 analog)."""


class DrainingError(DNError):
    """The server is draining (SIGTERM/stop): queued-but-unadmitted
    requests get this clean, retryable rejection instead of a
    connection reset when the process exits.  A retrying client (or
    the scatter-gather router) re-sends to the replacement server."""


class Slot(object):
    """One admitted execution slot.  release() is IDEMPOTENT: a
    deadline-expired request's reaper frees the slot immediately while
    the abandoned job thread's own finally releases again when (if)
    the wedged operation eventually finishes — only the first call
    counts, so accounting never goes negative and a permanently
    wedged op cannot pin a slot forever."""

    __slots__ = ('_admission', '_released')

    def __init__(self, admission):
        self._admission = admission
        self._released = False

    def release(self):
        self._admission._release(self)


class _Ticket(object):
    """One queued waiter: granted by the fair scheduler, woken via the
    shared condition."""

    __slots__ = ('tenant', 'granted', 'cancelled')

    def __init__(self, tenant):
        self.tenant = tenant
        self.granted = False
        self.cancelled = False


class _Tenant(object):
    """Per-tenant admission state: the FIFO of waiting tickets, the
    stride-scheduling pass value, and fairness accounting."""

    __slots__ = ('name', 'weight', 'waiting', 'vpass', 'counters')

    def __init__(self, name, weight):
        self.name = name
        self.weight = max(1, weight)
        self.waiting = deque()
        self.vpass = 0.0
        self.counters = {'requests': 0, 'admitted': 0,
                         'rejected_busy': 0, 'shed_overload': 0,
                         'completed': 0}


_DEFAULT_TENANT = 'default'

# tenants default to peer identity, so a long-lived TCP server sees
# an unbounded stream of them: the table is pruned (idle entries
# evicted, counters aggregated) past this size
_TENANT_TABLE_CAP = 4096


class Admission(object):
    """Bounded execution slots with per-tenant bounded waiting rooms
    and weighted-fair dequeue.  The legacy two-argument constructor
    (global slots + one waiting room) still works: with no tenant
    quota/weights configured every caller lands in one default tenant
    and behaves exactly like a single global gate."""

    def __init__(self, max_inflight, queue_depth, tenant_quota=0,
                 tenant_weights=None, tenant_default_weight=1):
        self.max_inflight = max_inflight
        self.queue_depth = queue_depth
        # 0 = no per-tenant cap (the global queue_depth still binds)
        self.tenant_quota = tenant_quota
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_default_weight = max(1, tenant_default_weight)
        self._cond = threading.Condition()
        self._tenants = {}
        # names of tenants with non-empty waiting queues: the fair
        # scheduler and the no-barging fast path scan THIS, not the
        # whole ever-seen tenant table
        self._active = set()
        # the scheduler's global virtual time: the pass value of the
        # last granted tenant.  Tenants joining (or REJOINING)
        # contention clamp to it, so a pass accumulated in a past
        # flood — or a zero pass minted during a lull — can never buy
        # starvation-length runs against the other side
        self._vtime = 0.0
        self._evicted = {}
        self._evicted_n = 0
        self._inflight = 0
        self._queued = 0
        self._draining = False
        # observed service time (EWMA, ms): the retry_after_ms and
        # early-shed estimate.  None until the first completion.
        self._service_ewma_ms = None
        self._shed_overload = 0
        self._shed_expired = 0

    # -- tenants -----------------------------------------------------------

    def _tenant(self, name):
        # call with self._cond held
        name = name or _DEFAULT_TENANT
        t = self._tenants.get(name)
        if t is None:
            weight = self.tenant_weights.get(
                name, self.tenant_default_weight)
            t = _Tenant(name, weight)
            # a newcomer must not replay history: start at the
            # scheduler's virtual time so it gets its fair share
            # from NOW, not a catch-up burst
            t.vpass = self._vtime
            self._tenants[name] = t
            if len(self._tenants) > _TENANT_TABLE_CAP:
                self._prune(keep=name)
        return t

    def _prune(self, keep=None):
        # call with _cond held: evict idle tenants (no queued work),
        # aggregating their counters so totals stay honest
        for name in [n for n, x in self._tenants.items()
                     if not x.waiting and n != keep]:
            ev = self._tenants.pop(name)
            self._active.discard(name)
            for k, v in ev.counters.items():
                self._evicted[k] = self._evicted.get(k, 0) + v
            self._evicted_n += 1

    def _pick_next(self):
        """The weighted-fair dequeue (call with _cond held): among
        tenants with waiters, grant the one with the smallest pass
        value, then advance its pass by 1/weight — a weight-3 tenant
        is granted 3x as often as a weight-1 tenant under contention.
        Returns the granted _Ticket or None."""
        best = None
        for name in self._active:
            t = self._tenants[name]
            if best is None or t.vpass < best.vpass:
                best = t
        if best is None:
            return None
        ticket = best.waiting.popleft()
        if not best.waiting:
            self._active.discard(best.name)
        self._vtime = best.vpass
        best.vpass += 1.0 / best.weight
        ticket.granted = True
        return ticket

    # -- service-time estimate / retry hints -------------------------------

    def note_service_ms(self, ms):
        """Feed the observed-service-time EWMA (one sample per
        completed data execution); the source of retry_after_ms and
        the early-shed estimate."""
        with self._cond:
            if self._service_ewma_ms is None:
                self._service_ewma_ms = float(ms)
            else:
                self._service_ewma_ms += \
                    0.2 * (float(ms) - self._service_ewma_ms)

    def _est_service_ms(self):
        # call with _cond held; a cold server guesses 100ms
        return self._service_ewma_ms \
            if self._service_ewma_ms is not None else 100.0

    def _retry_after_ms(self):
        """An honest retry hint: roughly when a freed slot could take
        new work — observed service time scaled by the queue's depth
        relative to capacity (call with _cond held)."""
        est = self._est_service_ms()
        load = (self._queued + 1.0) / max(1, self.max_inflight)
        return int(min(30000.0, max(25.0, est * load)))

    def retry_after_ms(self):
        with self._cond:
            return self._retry_after_ms()

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self):
        """Begin draining: every queued waiter (and every future
        acquire) raises DrainingError instead of waiting for a slot —
        in-flight executions are unaffected and finish normally."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def _release(self, slot):
        with self._cond:
            if slot._released:
                return
            slot._released = True
            self._inflight -= 1
            if not self._draining:
                ticket = self._pick_next()
                if ticket is not None:
                    self._inflight += 1
            self._cond.notify_all()

    def acquire(self, tenant=None, deadline_at=None):
        """Take an execution slot for `tenant`, waiting in its
        bounded queue if needed.  Returns a Slot (release it
        exactly-or-more-than once).  Raises BusyError immediately
        when the global queue or the tenant's quota is full,
        OverloadedError when `deadline_at` (a monotonic timestamp)
        cannot be met, DrainingError once shutdown() was called.  The
        rejections carry retry_after_ms derived from observed
        service time."""
        # the chaos seam fires OUTSIDE the condition lock: a
        # delay-kind arming must stall only this request, never every
        # acquire/release path behind the shared lock
        try:
            mod_faults.fire('tenant.flood')
        except mod_faults.FaultInjected as e:
            with self._cond:
                t = self._tenant(tenant)
                t.counters['requests'] += 1
                t.counters['rejected_busy'] += 1
                raise BusyError(
                    'server busy: %s' % e.message,
                    retry_after_ms=self._retry_after_ms())
        with self._cond:
            t = self._tenant(tenant)
            t.counters['requests'] += 1
            if self._draining:
                raise DrainingError('server draining: request not '
                                    'admitted; retry another replica')
            now = time.monotonic()
            if deadline_at is not None and now >= deadline_at:
                t.counters['shed_overload'] += 1
                self._shed_expired += 1
                raise OverloadedError(
                    'server overloaded: request deadline already '
                    'expired before admission',
                    retry_after_ms=self._retry_after_ms())
            if self._inflight < self.max_inflight and \
                    not self._active:
                self._inflight += 1
                t.counters['admitted'] += 1
                obs_metrics.observe('serve_queue_wait_ms', 0.0)
                return Slot(self)
            # the request must queue: shed it early if its deadline
            # cannot cover even one typical service time (it would
            # wait, run, and still miss — don't burn the slot)
            if deadline_at is not None and \
                    (deadline_at - now) * 1000.0 < \
                    self._est_service_ms():
                t.counters['shed_overload'] += 1
                self._shed_overload += 1
                obs_metrics.inc('serve_shed_total', reason='overload')
                if obs_events.enabled():
                    # coalesced: a shed STORM is one journal entry
                    # per window with the burst count, not a ring
                    # flush of everything else
                    obs_events.emit_burst('serve.shed',
                                          key='overload',
                                          reason='overload',
                                          tenant=t.name)
                raise OverloadedError(
                    'server overloaded: remaining deadline (%d ms) '
                    'below observed service time (%d ms); shed'
                    % (int((deadline_at - now) * 1000),
                       int(self._est_service_ms())),
                    retry_after_ms=self._retry_after_ms())
            if self._queued >= self.queue_depth:
                t.counters['rejected_busy'] += 1
                raise BusyError(
                    'server busy: %d request(s) in flight, %d queued '
                    '(DN_SERVE_MAX_INFLIGHT=%d DN_SERVE_QUEUE_DEPTH=%d)'
                    % (self._inflight, self._queued, self.max_inflight,
                       self.queue_depth),
                    retry_after_ms=self._retry_after_ms())
            if self.tenant_quota and \
                    len(t.waiting) >= self.tenant_quota:
                t.counters['rejected_busy'] += 1
                raise BusyError(
                    'server busy: tenant "%s" has %d request(s) '
                    'queued (DN_SERVE_TENANT_QUOTA=%d)'
                    % (t.name, len(t.waiting), self.tenant_quota),
                    retry_after_ms=self._retry_after_ms())
            ticket = _Ticket(t.name)
            t.waiting.append(ticket)
            if t.name not in self._active:
                # (re)joining contention: clamp a stale pass — high
                # from a past flood, or low from being created in a
                # lull — to the live virtual time, else the gap buys
                # starvation-length grant runs
                t.vpass = max(t.vpass, self._vtime)
                self._active.add(t.name)
            self._queued += 1
            try:
                with obs_metrics.timed_stage(
                        'serve.queue_wait',
                        metric='serve_queue_wait_ms', labels={}):
                    while not ticket.granted:
                        if self._draining:
                            self._cancel(t, ticket)
                            raise DrainingError(
                                'server draining: request not '
                                'admitted; retry another replica')
                        timeout = None
                        if deadline_at is not None:
                            timeout = deadline_at - time.monotonic()
                            if timeout <= 0:
                                self._cancel(t, ticket)
                                t.counters['shed_overload'] += 1
                                self._shed_expired += 1
                                obs_metrics.inc('serve_shed_total',
                                                reason='expired')
                                if obs_events.enabled():
                                    obs_events.emit_burst(
                                        'serve.shed',
                                        key='expired',
                                        reason='expired',
                                        tenant=t.name)
                                raise OverloadedError(
                                    'server overloaded: deadline '
                                    'expired while queued; shed',
                                    retry_after_ms=(
                                        self._retry_after_ms()))
                        self._cond.wait(timeout)
            finally:
                self._queued -= 1
            # granted by the scheduler (which already took the slot)
            t.counters['admitted'] += 1
            return Slot(self)

    def _cancel(self, tenant, ticket):
        # call with _cond held: withdraw an ungranted ticket; if the
        # scheduler granted it in the same instant, hand the slot on
        if ticket.granted:
            ticket.cancelled = True
            self._inflight -= 1
            nxt = self._pick_next()
            if nxt is not None:
                self._inflight += 1
            self._cond.notify_all()
        else:
            try:
                tenant.waiting.remove(ticket)
            except ValueError:
                pass
            if not tenant.waiting:
                self._active.discard(tenant.name)

    def note_completed(self, tenant=None):
        """Fairness accounting: one request for `tenant` ran to
        completion (the soak's per-tenant completion ratios)."""
        with self._cond:
            self._tenant(tenant).counters['completed'] += 1

    def depth(self):
        with self._cond:
            return {'active': self._inflight, 'queued': self._queued,
                    'max_inflight': self.max_inflight,
                    'queue_depth': self.queue_depth}

    def tenants_doc(self):
        """The /stats `tenants` section: per-tenant weights, queue
        depths, and admission/shed/completion counters, plus the
        shed totals and the live service-time estimate."""
        with self._cond:
            return {
                'quota': self.tenant_quota,
                'default_weight': self.tenant_default_weight,
                'service_est_ms': round(self._est_service_ms(), 3),
                'shed_overload': self._shed_overload,
                'shed_expired': self._shed_expired,
                'evicted_tenants': self._evicted_n,
                'tenants': {
                    t.name: dict(t.counters, weight=t.weight,
                                 queued=len(t.waiting))
                    for t in self._tenants.values()},
            }


class TreeLock(object):
    """Writer-priority reader/writer lock, one per index tree: index
    queries hold the read side while they execute, builds hold the
    write side — so a query never enumerates a tree mid-rewrite (the
    writer's tmp+rename discipline makes each SHARD atomic, but the
    tree as a whole grows tmp litter and partial shard sets while a
    build runs, and a resident server overlaps those freely).  Writer
    priority keeps a build from starving under a steady query load."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class _Execution(object):
    __slots__ = ('done', 'value', 'error', 'followers')

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error = None
        self.followers = 0


# followers never wait forever even if a leader thread dies without
# publishing (a bug, but one that must not strand client connections)
_FOLLOW_CAP_S = 3600.0


class Coalescer(object):
    """Share one execution across identical in-flight requests.

    run(key, compute) returns (value, shared): the leader executes
    `compute()` and publishes; followers wait and receive the same
    value (or re-raise the same error).  The key is removed from the
    in-flight table BEFORE the result publishes, so a request arriving
    after completion always starts a fresh execution — this is
    in-flight sharing only, never a result cache (writer invalidation
    stays trivial: there is nothing stale to invalidate)."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._inflight = {}
        self._stats = {'executions': 0, 'coalesced': 0}

    def run(self, key, compute, lease=None):
        if not self.enabled or key is None:
            with self._lock:
                self._stats['executions'] += 1
            return compute(), False
        with self._lock:
            ex = self._inflight.get(key)
            if ex is None:
                ex = _Execution()
                self._inflight[key] = ex
                self._stats['executions'] += 1
                leader = True
            else:
                ex.followers += 1
                self._stats['coalesced'] += 1
                leader = False
        if not leader:
            with obs_metrics.timed_stage(
                    'serve.coalesce_wait',
                    metric='serve_coalesce_wait_ms', labels={}):
                done = ex.done.wait(_FOLLOW_CAP_S)
            if not done:
                raise DeadlineError('coalesced execution never '
                                    'completed')
            if ex.error is not None:
                raise ex.error
            return ex.value, True
        if lease is not None:
            # the reaper's handle on this execution: a leader whose
            # request deadline expires must be abandon()ed so new
            # arrivals recompute instead of attaching to it forever
            lease['key'] = key
            lease['ex'] = ex
        try:
            ex.value = compute()
        except BaseException as e:
            ex.error = e
            raise
        finally:
            with self._lock:
                # identity-checked: abandon() may have replaced this
                # key with a fresh execution already
                if self._inflight.get(key) is ex:
                    self._inflight.pop(key)
            ex.done.set()
        return ex.value, False

    def abandon(self, key, ex):
        """Retire a leader's in-flight registration after its request
        deadline expired: the wedged execution must stop attracting
        followers, and any already attached must wake with the
        deadline error (they share their leader's fate).  No-op when
        the execution already completed or was replaced."""
        if key is None or ex is None:
            return
        with self._lock:
            if self._inflight.get(key) is not ex:
                return
            self._inflight.pop(key)
        if ex.error is None:
            ex.error = DeadlineError(
                'coalesced execution abandoned (leader request '
                'deadline expired)')
        ex.done.set()

    def stats(self):
        with self._lock:
            return dict(self._stats, inflight=len(self._inflight))


def compute_key(req, config_ident):
    """Canonical coalescing key for a data request: everything that
    determines the COMPUTED result (op, datasource, query document,
    interval, dry-run, plus the config file's identity so an edited
    datasource definition never shares with its predecessor) and
    nothing that only affects output formatting."""
    if req.get('op') not in ('scan', 'query', 'query_partial'):
        return None              # builds and debug ops never coalesce
    doc = {
        'op': req.get('op'),
        'ds': req.get('ds'),
        'config': config_ident,
        'queryconfig': req.get('queryconfig'),
        'interval': req.get('interval'),
        'dry_run': bool((req.get('opts') or {}).get('dry_run')),
    }
    if req.get('op') == 'query_partial':
        # partition-scoped partials only share when they cover the
        # same partitions under the same topology generation
        doc['partitions'] = sorted(req.get('partitions') or [])
        doc['epoch'] = req.get('epoch')
    return json.dumps(doc, sort_keys=True, separators=(',', ':'))
