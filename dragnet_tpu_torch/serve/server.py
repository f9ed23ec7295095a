"""`dn serve` on the card: a long-lived multi-threaded server that
executes scan/build/query requests with warm process state.

Counterpart of dragnet_tpu/serve/server.py for a single member.  Every
`dn query` pays a cold start per invocation: interpreter boot, the
CUDA context, the kernel libraries, shard handles, the find memo and
the audition cache.  This server is the one process that lives across
requests and holds them:

* the shard-handle LRU + whole-tree find memo (index_query_mt),
* the CUDA context, the built kernel libraries and the audition
  verdicts (device_scan, ops),
* the device residency pins (serve/residency.py): a repeat stacked
  aggregation answers from its pinned accumulator, a different query
  over the same shards from their pinned tensors,
* the stacked cross-shard execution path (index_query_stack), which
  request coalescing (admission.py) turns into one aggregation for N
  compatible concurrent queries.

Protocol: newline-JSON over a unix socket (TCP optional), framed by
serve/protocol.py — v1 (one request per connection) and v2 (persistent
multiplexed connections, `"proto": 2` plus a request `"id"`), served
by the selector front end (serve/ioloop.py).  Response: one JSON
header line {"ok", "rc", "nout", "nerr", "stats"} followed by exactly
nout stdout bytes and nerr stderr bytes, BYTE-IDENTICAL to what the
local CLI command would have written: requests run through the same
datasource entry points and output layer, on the server's device
(DN_TORCH_DEVICE, CUDA unless it says cpu) and engine (DN_ENGINE),
with each worker thread's stdout/stderr routed to per-request buffers
(the thread-stdio router below).

Overload posture (admission.py): per-tenant weighted-fair admission,
deadline propagation and early load shedding, as in the reference.

Ops: scan, query, build, stats, metrics, health, events, topology,
ping, query_partial, shard_manifest, shard_fetch, scrub, the standing
queries of serve/subscribe.py (`subscribe` on a v2 connection,
`sub_ack`, `unsubscribe`) and the fleet view of serve/fleet.py
(`fleet_stats`: every member of the cluster, or a lone server as a
one-member fleet), plus `_sleep` when DN_SERVE_TEST_OPS=1.
DN_METRICS_HISTORY_S > 0 arms the metric history (obs/history.py).

Cluster mode (`--cluster=TOPOLOGY.json --member=NAME`, serve/topology.py):
the member owns its partitions of the index tree and routes incoming
queries through the scatter-gather router (serve/router.py: the ops
`query_partial`, failover, hedging, the degraded modes), follows live
topology changes with shard handoff (serve/coordinator.py and
rebalance.py: `shard_manifest`, `shard_fetch`), and repairs damaged
shards from its co-replicas (serve/scrub.py: the repair manager, the
`scrub` op and the DN_SCRUB_INTERVAL_S / DN_ROLLUP_INTERVAL_S /
DN_COMPACT_INTERVAL_S threads).  All of that is host code; each
member's own requests run on its device.  A device fault in a request
fails that request (rc 1, "dn: ..."); the server keeps serving, and
nothing answers from the host where the device was asked for.
"""

import codecs
import contextlib
import gc
import io
import json
import os
import signal
import socket
import sys
import threading
import time

from .. import cli as mod_cli
from .. import config as mod_config
from .. import faults as mod_faults
from .. import integrity as mod_integrity
from .. import resources as mod_resources
from .. import vpipe as mod_vpipe
from .. import index_query_mt as mod_iqmt
from .. import log as mod_log
from ..errors import DNError
from ..obs import events as obs_events
from ..obs import export as obs_export
from ..obs import history as obs_history
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..watchdog import LeakCheck
from . import admission as mod_admission
from . import ioloop as mod_ioloop
from . import lifecycle as mod_lifecycle
from . import protocol as mod_protocol
from . import qcache as mod_qcache
from . import residency as mod_residency
from . import subscribe as mod_subscribe


MAX_REQUEST_BYTES = mod_protocol.MAX_FRAME_BYTES

# a server that exits while `running` never drained: in-flight
# requests (and their clients) may have been dropped on the floor
_SERVER_LEAKS = LeakCheck(
    'dn serve server(s) never drained; in-flight requests may have '
    'been dropped', lambda s: s.running)


# -- output-encoding parity with bin/dn.py ----------------------------------

def _dn_fffd(err):
    return ('�' * (err.end - err.start), err.end)


def output_errors():
    """The error handler name request buffers encode with — the same
    lone-surrogate -> U+FFFD behavior bin/dn.py installs on the real
    stdout, so response bytes match the CLI's byte-for-byte."""
    try:
        codecs.lookup_error('dn_fffd')
    except LookupError:
        codecs.register_error('dn_fffd', _dn_fffd)
    return 'dn_fffd'


# -- thread-directed stdio --------------------------------------------------
#
# The CLI output layer writes to sys.stdout / sys.stderr directly, and
# that is exactly what guarantees byte parity — so instead of
# refactoring every write site, the server routes the PROCESS streams
# through a per-thread binding: worker threads bind their request
# buffers, every other thread falls through to the real stream.  The
# binding registry is module-global (not per-router-instance) so a
# router displaced by test harnesses that swap sys.stdout can be
# reinstalled at any time without stranding live bindings.

_STDIO_TLS = threading.local()
_STDIO_LOCK = threading.Lock()


class _ThreadStream(object):
    def __init__(self, which, fallback):
        self._which = which
        self._fallback = fallback

    def _target(self):
        bound = getattr(_STDIO_TLS, self._which, None)
        return self._fallback if bound is None else bound

    def write(self, data):
        return self._target().write(data)

    def writelines(self, lines):
        return self._target().writelines(lines)

    def flush(self):
        return self._target().flush()

    def __getattr__(self, name):
        return getattr(self._target(), name)


def install_stdio_router():
    """Idempotently route sys.stdout/sys.stderr through the
    thread-binding proxies (re-wrapping whatever stream is current if
    something replaced them since the last install)."""
    with _STDIO_LOCK:
        if not isinstance(sys.stdout, _ThreadStream):
            sys.stdout = _ThreadStream('out', sys.stdout)
        if not isinstance(sys.stderr, _ThreadStream):
            sys.stderr = _ThreadStream('err', sys.stderr)


class _Capture(object):
    """Per-request byte buffers presented as text streams (utf-8 with
    the CLI's surrogate policy)."""

    def __init__(self):
        errors = output_errors()
        self.out_b = io.BytesIO()
        self.err_b = io.BytesIO()
        self.out_t = io.TextIOWrapper(self.out_b, encoding='utf-8',
                                      errors=errors, newline='')
        self.err_t = io.TextIOWrapper(self.err_b, encoding='utf-8',
                                      errors=errors, newline='')

    def finish(self):
        """Flush and return (stdout_bytes, stderr_bytes); the buffers
        detach so the text wrappers' GC cannot close them early."""
        self.out_t.flush()
        self.err_t.flush()
        out, err = self.out_b.getvalue(), self.err_b.getvalue()
        self.out_t.detach()
        self.err_t.detach()
        return out, err


@contextlib.contextmanager
def bound_stdio(capture):
    """Bind THIS thread's sys.stdout/sys.stderr to the capture."""
    install_stdio_router()
    prior = (getattr(_STDIO_TLS, 'out', None),
             getattr(_STDIO_TLS, 'err', None))
    _STDIO_TLS.out = capture.out_t
    _STDIO_TLS.err = capture.err_t
    try:
        yield
    finally:
        _STDIO_TLS.out, _STDIO_TLS.err = prior


@contextlib.contextmanager
def thread_stdio():
    """Capture this thread's CLI output as bytes (tests use this to
    compute expected local bytes through the same router the server
    routes through): yields the _Capture; read via .finish()."""
    cap = _Capture()
    with bound_stdio(cap):
        yield cap


# -- request options shim ---------------------------------------------------

class _ReqOpts(object):
    """The parsed-options surface cli.dn_query_config / cli.dn_output
    expect, rebuilt from a request's shipped documents."""


def _opts_shim(req):
    o = _ReqOpts()
    qc = req.get('queryconfig') or {}
    o.breakdowns = qc.get('breakdowns') or []
    o.after = qc.get('timeAfter')
    o.before = qc.get('timeBefore')
    o.filter = qc.get('filter')
    opts = req.get('opts') or {}
    for name in ('raw', 'points', 'counters', 'gnuplot'):
        setattr(o, name, opts.get(name))
    o.dry_run = bool(opts.get('dry_run'))
    o.interval = req.get('interval')
    return o


def _config_ident(path):
    try:
        st = os.stat(path)
        return [path, st.st_mtime_ns, st.st_size]
    except OSError:
        return [path, None, None]


_DEVICE_SIGNALS = ('ndevicebatches', 'nstackedbatches',
                   'index device sums')


def device_engaged(counters):
    return any(counters.get(k) for k in _DEVICE_SIGNALS)


# -- the server -------------------------------------------------------------

class DnServer(object):
    def __init__(self, socket_path=None, port=None, host='127.0.0.1',
                 conf=None, pidfile=None, device=None, cluster=None,
                 member=None, router_conf=None, pending=None,
                 topo_conf=None):
        from ..ops import resolve_device
        if conf is None:
            conf = mod_config.serve_config()
        if isinstance(conf, DNError):
            raise conf
        assert (socket_path is None) != (port is None), \
            'exactly one of socket_path/port'
        # embedders (tests, the chip smoke) pass partial conf dicts; the
        # front-end/tenancy knobs fall back to their defaults
        full = mod_config.serve_config(env={})
        full.update(conf)
        self.conf = conf = full
        # the device every request runs on: CUDA unless DN_TORCH_DEVICE
        # (or the caller) says cpu; CUDA asked for and absent fails
        # here, before anything binds
        self.device = str(resolve_device(
            device or os.environ.get('DN_TORCH_DEVICE') or 'cuda'))
        # cluster mode (`--cluster=TOPOLOGY.json --member=NAME`): this
        # server owns its partitions of the index tree and acts as
        # scatter-gather router for incoming queries (serve/router.py)
        self.cluster = cluster
        self.member = member
        self.router = None
        # dynamic topology (serve/coordinator.py): the committed map
        # can be swapped while serving, a pending epoch streams its
        # handoff (serve/rebalance.py), and DN_TOPO_POLL_MS > 0 polls
        # the topology file for both
        if topo_conf is None:
            topo_conf = mod_config.topo_config()
        if isinstance(topo_conf, DNError):
            raise topo_conf
        self.topo_conf = topo_conf
        self.pending = None
        self._initial_pending = pending
        self.puller = None
        self.topo_watcher = None
        self.topo_leaving = False
        self._topo_lock = threading.Lock()
        self._topo_counters = {'transitions': 0,
                               'mismatch_rejections': 0,
                               'resyncs': 0,
                               'handoff_rejections': 0,
                               'handoff_retries': 0}
        if cluster is not None:
            from . import router as mod_router
            self.router = mod_router.Router(
                cluster, member, conf=router_conf,
                local_exec=self._local_partial,
                self_draining=lambda: self.draining,
                self_degraded=lambda: self.governor.is_read_only())
        self.socket_path = socket_path
        self.port = port
        self.host = host
        self.pidfile = pidfile
        self.bound_port = None
        # shard integrity (integrity.py, serve/scrub.py): verified
        # reads quarantine + reject retryably; the repair manager
        # pulls good copies from co-replicas in the background; the
        # scrub thread (DN_SCRUB_INTERVAL_S) sweeps proactively
        integ_conf = mod_config.integrity_config()
        if isinstance(integ_conf, DNError):
            raise integ_conf
        obs_conf = mod_config.obs_config()
        if isinstance(obs_conf, DNError):
            raise obs_conf
        self.integrity_conf = integ_conf
        # resource governance (resources.py): disk watermarks drive
        # low/critical modes (the member flips read-only while queries
        # keep serving); the memory budget sheds over-footprint
        # admissions with retry hints
        res_conf = mod_config.resources_config()
        if isinstance(res_conf, DNError):
            raise res_conf
        self._resource_paths_memo = (None, 0.0)
        self.governor = mod_resources.ResourceGovernor(
            res_conf, paths=self._resource_paths, member=member)
        from . import scrub as mod_scrub
        self.repair = mod_scrub.RepairManager(self)
        self.scrubber = None
        self.maintainer = None
        self.admission = mod_admission.Admission(
            conf['max_inflight'], conf['queue_depth'],
            tenant_quota=conf['tenant_quota'],
            tenant_weights=conf['tenant_weights'],
            tenant_default_weight=conf['tenant_default_weight'])
        self.coalescer = mod_admission.Coalescer(conf['coalesce'])
        # query-result cache (serve/qcache.py): repeat identical
        # queries answer from memory, invalidated by the writer epoch
        # + tree stat validators.  DN_SERVE_CACHE_MB=0 (default)
        # disables.
        self.qcache = mod_qcache.ResultCache(
            conf['cache_mb'] << 20, governor=self.governor)
        # device residency (serve/residency.py): pinned accumulators
        # and shard tensors on the card, invalidated by the same
        # writer epoch.  DN_DEVICE_RESIDENCY_MB=0 (default) disables.
        dev_conf = mod_config.device_config()
        if isinstance(dev_conf, DNError):
            raise dev_conf
        self.device_conf = dev_conf
        iq_conf = mod_config.index_device_config()
        if isinstance(iq_conf, DNError):
            raise iq_conf
        self.index_device_conf = iq_conf
        self._memory_before = _device_memory(self.device)
        mod_residency.configure(dev_conf['residency_mb'] << 20)
        self._prewarm_doc = None
        self._prewarm_thread = None
        # the metric-history snapshotter (obs/history.py), armed at
        # bind from DN_METRICS_HISTORY_S; off by default
        self.history = None
        self.log = mod_log.get('serve')
        # standing queries (serve/subscribe.py): registered v2
        # subscribers get delta/full result frames PUSHED on publish
        # — one incremental merge per publish batch serves all of
        # them.  DN_SUB_MAX=0 disables (requests answer cleanly).
        self.subman = mod_subscribe.SubscriptionManager(self)
        self.running = False
        self.draining = False
        self._listener = None
        self.loop = None
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._workers = set()
        self._workers_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._counters = {'requests': 0, 'errors': 0,
                          'busy_rejected': 0, 'deadline_expired': 0,
                          'draining_rejected': 0,
                          'shed_overloaded': 0,
                          'build_idem_replays': 0}
        # build idempotency: key -> {'done': Event, 'result': tuple}.
        # A retried `dn build --remote` (same client-generated key)
        # replays the recorded response instead of double-writing.
        self._idem_lock = threading.Lock()
        self._idem = {}
        self._by_op = {}
        self._t0 = time.monotonic()
        self._started_wall = time.time()
        self._hook = None
        self._thread = None
        # per-index-tree reader/writer locks (admission.TreeLock):
        # index queries read-lock, builds write-lock
        self._tree_locks = {}
        self._tree_locks_lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def bind(self):
        if self.socket_path is not None:
            listener = socket.socket(socket.AF_UNIX,
                                     socket.SOCK_STREAM)
            listener.bind(self.socket_path)
        else:
            listener = socket.socket(socket.AF_INET,
                                     socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET,
                                socket.SO_REUSEADDR, 1)
            listener.bind((self.host, self.port))
            self.bound_port = listener.getsockname()[1]
        listener.listen(512)
        self._listener = listener
        # the selector front end (serve/ioloop.py): accepts, frames,
        # reaps; workers are spawned per dispatched request
        self.loop = mod_ioloop.IOLoop(
            listener,
            {'read_deadline_ms': self.conf['read_deadline_ms'],
             'write_deadline_ms': self.conf['write_deadline_ms'],
             'idle_ms': self.conf['idle_ms']},
            on_request=self._on_frame,
            on_overflow=self._on_overflow,
            on_accept=self._on_accept,
            on_close=self.subman.on_conn_close,
            log=self.log)
        self.subman.start()
        self.running = True
        _SERVER_LEAKS.track(self)
        self._hook = mod_lifecycle.install_writer_invalidation()
        if self.router is not None:
            self.router.start()
        if self.cluster is not None:
            obs_metrics.set_gauge('topo_epoch', self.cluster.epoch)
            if self._initial_pending is not None:
                # started mid-transition (e.g. a fresh joiner): begin
                # the handoff immediately
                self.apply_topology(self.cluster,
                                    self._initial_pending)
                self._initial_pending = None
            if self.cluster.path and self.topo_conf['poll_ms'] > 0:
                from . import coordinator as mod_coordinator
                self.topo_watcher = mod_coordinator.TopologyWatcher(
                    self, self.cluster.path,
                    self.topo_conf['poll_ms'],
                    log=self.log).start()
        if self.integrity_conf['scrub_interval_s'] > 0:
            from . import scrub as mod_scrub
            self.scrubber = mod_scrub.ScrubThread(
                self, self.integrity_conf['scrub_interval_s'],
                self.integrity_conf['scrub_rate_mb_s'] << 20,
                log=self.log).start()
        if self.integrity_conf['rollup_interval_s'] > 0 or \
                self.integrity_conf['compact_interval_s'] > 0:
            # the rollup/compaction timer (serve/scrub.py): refresh
            # day/month rollup shards and fold follow --append
            # mini-generations in the background, governor-paused
            # under disk pressure
            from . import scrub as mod_scrub
            self.maintainer = mod_scrub.MaintenanceThread(
                self, self.integrity_conf['rollup_interval_s'],
                self.integrity_conf['compact_interval_s'],
                self.integrity_conf['compact_min_gens'],
                log=self.log).start()
        # the event journal is per-PROCESS: the first server to bind
        # installs it (DN_EVENTS / DN_EVENTS_FILE arm it); embedded
        # co-process members share it (the fleet merge dedupes their
        # identical tails)
        if obs_events.journal() is None:
            obs_events.install(member=self.member)
        self.governor.start()
        # serve-time device pre-warm (serve/residency.py): the CUDA
        # context and K7a's first launches on a background thread,
        # bounded by the probe deadline — a wedged card costs a
        # bounded background wait, never a hung bind
        if self.device_conf['prewarm'] and self._device_lane_possible():
            self._prewarm_thread = threading.Thread(
                target=self._run_prewarm, name='dn-prewarm',
                daemon=True)
            self._prewarm_thread.start()
        hist_s = obs_history.history_interval_s()
        if hist_s > 0:
            self.history = obs_history.HistorySnapshotter(
                hist_s, provider=self._history_provider,
                log=self.log).start()
        self.log.info('listening',
                      socket=self.socket_path, port=self.bound_port,
                      device=self.device,
                      max_inflight=self.conf['max_inflight'])

    def serve_forever(self):
        """Run the selector front end (blocks until request_stop);
        drains on exit: stop accepting, finish in-flight, flush
        responses, flush caches, unlink the socket."""
        install_stdio_router()
        self.loop.start()
        try:
            self._stop.wait()
        finally:
            self._drain()

    def start(self):
        """Embedded mode (tests, the chip smoke): bind if needed and
        run the accept loop on a background thread."""
        if self._listener is None:
            self.bind()
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def request_stop(self):
        # queued-but-unadmitted requests wake NOW with the clean,
        # retryable DrainingError; admitted executions finish inside
        # the drain grace
        self.draining = True
        self.admission.shutdown()
        self._stop.set()

    def stop(self, wait=True):
        self.request_stop()
        if self._thread is not None and wait:
            self._thread.join(self.conf['drain_s'] + 5)
        elif wait:
            self._drained.wait(self.conf['drain_s'] + 5)

    def wait_prewarm(self, timeout=None):
        """The pre-warm's doc once its thread finished (None when it
        was gated off or is still running at `timeout`)."""
        if self._prewarm_thread is not None:
            self._prewarm_thread.join(timeout)
        return self._prewarm_doc

    def _drain(self):
        if self._drained.is_set():
            return
        self.loop.stop_accepting()
        deadline = time.monotonic() + self.conf['drain_s']
        with self._workers_lock:
            workers = list(self._workers)
        for t in workers:
            t.join(max(0.0, deadline - time.monotonic()))
        leftover = sum(1 for t in workers if t.is_alive())
        if leftover:
            self.log.warn('drain grace expired', abandoned=leftover)
        # standing queries end cleanly: each subscriber gets an 'end'
        # frame queued before the loop flushes and closes below
        self.subman.stop()
        # flush queued response bytes (the draining rejections the
        # workers just framed included), then close every connection
        self.loop.shutdown(max(1.0, deadline - time.monotonic() + 1))
        if self.topo_watcher is not None:
            self.topo_watcher.stop()
        if self.history is not None:
            self.history.stop()
        if self.scrubber is not None:
            self.scrubber.stop()
        if self.maintainer is not None:
            self.maintainer.stop()
        self.governor.stop()
        self.repair.stop()
        if self.puller is not None:
            self.puller.stop()
        if self.router is not None:
            self.router.stop()
        # flush warm state cleanly: cached shard handles hold open
        # mmaps / sqlite connections; the result cache hands its
        # reserved governor bytes back
        self.qcache.clear()
        mod_iqmt.shard_cache_clear()
        # drop every pinned device tensor so the caching allocator can
        # reuse the memory, and deregister the residency gauges; a
        # finished device scan can sit in a reference cycle until the
        # cyclic collector runs, holding its accumulators: collect now
        mod_residency.deconfigure()
        gc.collect()
        if self._hook is not None:
            mod_lifecycle.remove_writer_invalidation(self._hook)
            self._hook = None
        mod_lifecycle.release(socket_path=self.socket_path,
                              pidfile=self.pidfile)
        self.running = False
        _SERVER_LEAKS.untrack(self)
        self._drained.set()
        self.log.info('drained', requests=self._counters['requests'])

    # -- device lane (serve/residency.py) ---------------------------------

    def _device_lane_possible(self):
        """Can a request of this process reach the device lane?  The
        forced lane (DN_ENGINE=jax) always; auto only on CUDA (on the
        CPU auto stays on the host engine).  Env inspection only."""
        mode = mod_cli._engine()
        if mode == 'device':
            return True
        return mode == 'auto' and self.device.startswith('cuda')

    def _run_prewarm(self):
        try:
            doc = mod_residency.prewarm(
                deadline_s=self.device_conf['probe_timeout_s'],
                device=self.device)
        except Exception as e:        # honest doc over a dead thread
            doc = {'state': 'failed', 'error': str(e)}
        self._prewarm_doc = doc
        log = self.log.info if doc.get('state') == 'ok' \
            else self.log.error
        log('device prewarm', state=doc.get('state'),
            backend=doc.get('backend'), programs=doc.get('programs'),
            auditions=doc.get('auditions'), ms=doc.get('ms'),
            error=doc.get('error'))

    # -- dynamic topology -------------------------------------------------

    def apply_topology(self, committed, pending):
        """The live-membership cutover (TopologyWatcher calls this on
        every observed change; also called at bind for a server
        started mid-transition).  Idempotent: same-epoch re-applies
        are no-ops.  A committed epoch bump swaps the serving map
        atomically (router probers/pool conns for departed members
        retire); a pending epoch starts the shard handoff."""
        if self.cluster is None:
            return
        with self._topo_lock:
            if committed.epoch > self.cluster.epoch:
                self.cluster = committed
                self.topo_leaving = \
                    self.member not in committed.members
                if self.router is not None:
                    self.router.update_topology(committed)
                self._topo_counters['transitions'] += 1
                obs_metrics.inc('topo_epoch_transitions_total')
                obs_metrics.set_gauge('topo_epoch', committed.epoch)
                obs_events.emit('topo.commit', epoch=committed.epoch,
                                leaving=self.topo_leaving or None)
                self.log.info('topology committed',
                              epoch=committed.epoch,
                              leaving=self.topo_leaving)
            if pending is not None and \
                    pending.epoch > self.cluster.epoch:
                # dedupe by CONTENT, not epoch number: an abort
                # followed by a re-apply reuses committed+1, and a
                # member that only saw the final file must not keep
                # the withdrawn map's handoff state (serving the new
                # assignments with the old pull's shards would be a
                # silently short shard set)
                if self.pending is None or \
                        self.pending.epoch != pending.epoch or \
                        self.pending.doc() != pending.doc():
                    self.pending = pending
                    obs_metrics.set_gauge('topo_pending_epoch',
                                          pending.epoch)
                    obs_events.emit('topo.pending',
                                    epoch=pending.epoch)
                    self._start_handoff(self.cluster, pending)
                    self.log.info('topology pending',
                                  epoch=pending.epoch)
            elif self.pending is not None and \
                    (pending is None or
                     self.pending.epoch <= self.cluster.epoch):
                # resolved: committed (the puller's ready flag keeps
                # gating until its pull finishes) or aborted
                resolved = self.pending
                self.pending = None
                obs_metrics.set_gauge('topo_pending_epoch', 0)
                if pending is None and \
                        resolved.epoch > self.cluster.epoch:
                    obs_events.emit('topo.abort',
                                    epoch=resolved.epoch)
                if pending is None and self.puller is not None and \
                        self.puller.target_epoch == resolved.epoch \
                        and resolved.epoch > self.cluster.epoch:
                    # aborted outright: stop a pull for the withdrawn
                    # epoch (streamed shards are harmless litter the
                    # partition filter ignores)
                    self.puller.stop()
                    self.puller = None

    def _start_handoff(self, committed, pending):
        """Spawn the shard puller for a pending epoch (call with
        _topo_lock held).  Members LEAVING in the pending map pull
        nothing — they are demoted (health reports draining) and
        removed only after the commit, when ownership has moved."""
        if self.member is None or self.member not in pending.members:
            if self.puller is not None:
                self.puller.stop()
            self.puller = None
            return
        from . import rebalance as mod_rebalance
        if self.puller is not None:
            self.puller.stop()
        self.puller = mod_rebalance.HandoffPuller(
            committed, pending, self.member,
            topo_conf=self.topo_conf, log=self.log,
            governor=self.governor).start()

    def retry_failed_handoff(self):
        """Restart a FAILED pull for the still-pending epoch (the
        watcher calls this every poll): a donor that was transiently
        unreachable past the retry budget must not wedge the
        transition until a process restart.  One attempt per poll,
        never concurrent (only a finished, failed puller restarts);
        a pull left failed after a forced early commit is out of
        scope — its donors have moved epochs and the operator
        explicitly chose the degraded window."""
        with self._topo_lock:
            puller, pending = self.puller, self.pending
            if pending is None or puller is None or \
                    puller.target_epoch != pending.epoch:
                return False
            if puller.ready or not puller.failed or \
                    not puller.wait(0):
                return False
            self._topo_counters['handoff_retries'] = \
                self._topo_counters.get('handoff_retries', 0) + 1
            self.log.info('retrying failed handoff',
                          epoch=pending.epoch, error=puller.error)
            self._start_handoff(self.cluster, pending)
            return True

    def _topo_leaving_now(self):
        """Demotion signal: True once this member is absent from the
        pending map (leaving as soon as the transition starts, per
        the demote-then-remove contract) or from the committed map
        (already removed)."""
        with self._topo_lock:
            if self.cluster is None:
                return False
            if self.topo_leaving:
                return True
            return self.pending is not None and \
                self.member not in self.pending.members

    def _serving_for_epoch(self, epoch, pids=None):
        """The topology a partial at `epoch` executes under, with the
        epoch-mismatch and handoff gates applied.  Accepts the
        committed epoch always, and the pending epoch during a
        transition window (commits propagate asynchronously — a
        router that saw the commit first must not be reject-stormed
        by members that have not polled yet).  Raises the retryable
        mismatch/handoff-incomplete DNErrors otherwise."""
        with self._topo_lock:
            committed, pending = self.cluster, self.pending
            puller = self.puller
        serving = None
        if epoch == committed.epoch:
            serving = committed
        elif pending is not None and epoch == pending.epoch:
            serving = pending
        if serving is None:
            with self._topo_lock:
                self._topo_counters['mismatch_rejections'] += 1
            obs_metrics.inc('topo_epoch_mismatch_total')
            have = str(committed.epoch)
            if pending is not None:
                have += '/pending %d' % pending.epoch
            e = DNError('topology epoch mismatch (member has %s, '
                        'router sent %s)' % (have, epoch))
            e.retryable = True
            e.epoch_mismatch = True
            e.current_epoch = committed.epoch
            raise e
        if puller is not None and not puller.ready and \
                puller.target_epoch == epoch and pids is not None and \
                (set(pids) & puller.affected_pids):
            # this member's shards for the requested partitions are
            # still streaming in: serving now would return a SHORT
            # shard set with rc=0 — reject retryably instead (the
            # router fails over to a replica that has the bytes)
            with self._topo_lock:
                self._topo_counters['handoff_rejections'] += 1
            e = DNError('handoff incomplete for partition(s) %s '
                        '(epoch %d): shards still streaming'
                        % (','.join(str(p) for p in sorted(
                            set(pids) & puller.affected_pids)),
                           epoch))
            e.retryable = True
            raise e
        return serving

    def memory_doc(self):
        """Device memory now against its level when this server
        configured residency (bytes; None on the CPU)."""
        now = _device_memory(self.device)
        if now is None:
            return None
        return {'allocated_bytes': now,
                'before_server_bytes': self._memory_before}

    def topology_doc(self):
        """The /stats `topology` section and the `topology` op body:
        current/pending epochs, handoff progress, transition
        counters, watcher telemetry — what the coordinator polls for
        commit readiness and dashboards scrape."""
        with self._topo_lock:
            committed, pending = self.cluster, self.pending
            puller = self.puller
            counters = dict(self._topo_counters)
        doc = {'member': self.member,
               'configured': committed is not None}
        if committed is None:
            return doc
        doc.update({
            'epoch': committed.epoch,
            'state': 'pending' if pending is not None
            else 'committed',
            'pending_epoch': pending.epoch
            if pending is not None else None,
            'leaving': self._topo_leaving_now(),
            'source': committed.path,
            'poll_ms': self.topo_conf['poll_ms'],
            'partitions_owned':
            committed.partitions_of(self.member),
            'counters': counters,
        })
        doc['handoff'] = puller.status() if puller is not None \
            else None
        if pending is not None:
            ready = puller is not None and \
                puller.target_epoch == pending.epoch and puller.ready
            doc['handoff_ready'] = ready
            note = getattr(pending, 'note', None)
            if note is not None:
                doc['pending_note'] = note
        else:
            doc['handoff_ready'] = puller is None or puller.ready
        if self.topo_watcher is not None:
            doc['watcher'] = self.topo_watcher.stats()
        return doc

    # -- stats ------------------------------------------------------------

    def _bump(self, name, n=1):
        with self._stats_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def _resource_paths(self):
        """Index roots the resource governor watches (30s-memoized:
        resolving them loads the config, which must not run once per
        2s poll)."""
        paths, at = self._resource_paths_memo
        now = time.monotonic()
        if paths is not None and now - at < 30.0:
            return paths
        paths = []
        try:
            from . import scrub as mod_scrub
            for dsname, ds in mod_scrub.member_datasources(self):
                paths.append(ds.ds_indexpath)
        except Exception:
            pass
        self._resource_paths_memo = (paths, now)
        return paths

    def _admit_resources(self, op, ds):
        """Memory-budget admission (resources.py): reserve the
        request's estimated footprint for its lifetime; an over-budget
        request sheds through OverloadedError with an honest retry
        hint.  Returns the lease."""
        try:
            return self.governor.admit_request(op, ds)
        except mod_resources.MemoryBudgetError as e:
            obs_metrics.inc('serve_shed_total', reason='memory')
            raise mod_admission.OverloadedError(
                e.message,
                retry_after_ms=self.admission.retry_after_ms())

    def _quarantine_usage(self):
        """The quarantine_bytes/quarantine_files gauges for /stats
        `recovery`."""
        files = 0
        total = 0
        try:
            from . import scrub as mod_scrub
            for dsname, ds in mod_scrub.member_datasources(self):
                q = mod_integrity.quarantine_stats(ds.ds_indexpath)
                files += q['files']
                total += q['bytes']
        except Exception:
            pass
        obs_metrics.set_gauge('quarantine_bytes', float(total))
        return {'quarantine_files': files, 'quarantine_bytes': total}

    def _bump_op(self, op):
        with self._stats_lock:
            self._counters['requests'] += 1
            self._by_op[op] = self._by_op.get(op, 0) + 1

    def _history_provider(self):
        """Named operational series for the history snapshotter:
        request/shed/error totals (the admission counters predate the
        typed registry), live inflight depth, repair completions and
        follow ingest lag — the qps / shed-rate / repair-rate /
        ingest-lag trends by their headline names."""
        with self._stats_lock:
            requests = self._counters['requests']
            errors = self._counters['errors']
            shed = (self._counters['shed_overloaded'] +
                    self._counters['busy_rejected'])
        out = {
            'serve.requests': (obs_history.COUNTER_KIND, requests),
            'serve.errors': (obs_history.COUNTER_KIND, errors),
            'serve.shed': (obs_history.COUNTER_KIND, shed),
            'serve.inflight': (obs_history.GAUGE_KIND,
                               self.admission.depth()['active']),
            'repair.completed': (obs_history.COUNTER_KIND,
                                 self.repair.stats()['completed']),
        }
        from ..follow import stats_doc as follow_stats
        fs = follow_stats()
        if fs is not None:
            out['follow.ingest_lag_ms'] = (
                obs_history.GAUGE_KIND, fs.get('ingest_lag_ms'))
        return out

    def _index_query_doc(self):
        """The index query's device-lane engagement (device_index):
        dispatches, shards, rows, pinned shard hits, upload bytes and
        the bytes the pins saved, with the resolved lane knobs."""
        from .. import device_index as mod_di
        doc = mod_di.stats_doc()
        doc['mode'] = self.index_device_conf['mode']
        doc['batch_rows'] = self.index_device_conf['batch_rows']
        return doc

    def _scan_merge_doc(self):
        from .. import scan_mt as mod_scan_mt
        ms = mod_scan_mt.merge_stats()
        return {
            'partitions': mod_scan_mt.scan_partitions(),
            'merge_ms': round(ms['merge_ms'], 3),
            'merges': ms['engaged'],
            'rows_in': ms['rows'],
            'unique_rows': ms['unique'],
        }

    def stats_doc(self):
        from .. import device_scan as mod_ds
        counters = mod_vpipe.global_counters()
        with self._stats_lock:
            requests = dict(self._counters, by_op=dict(self._by_op))
        requests.update(self.coalescer.stats())
        doc = {
            'pid': os.getpid(),
            'uptime_s': round(time.monotonic() - self._t0, 3),
            'started_at': round(self._started_wall, 3),
            'socket': self.socket_path,
            'port': self.bound_port,
            'draining': self.draining,
            'requests': requests,
            'inflight': self.admission.depth(),
            'tenants': self.admission.tenants_doc(),
            'protocol': self.loop.stats()
            if self.loop is not None else {},
            # standing-query subscriptions (serve/subscribe.py):
            # active/group gauges, push/shed/recompute counters,
            # per-group and per-subscriber detail
            'subscriptions': self.subman.stats_doc(),
            'caches': {
                'shard_handles': mod_iqmt.shard_cache_stats(),
                'find_memo': mod_iqmt.find_cache_stats(),
                'results': self.qcache.stats(),
                'index_fanout': mod_iqmt.fanout_stats(),
                'audition_verdicts': mod_ds._audition_cache_file(),
            },
            'counters': counters,
            'device': {
                'device': self.device,
                'engaged': device_engaged(counters),
                'signals': {k: counters.get(k, 0)
                            for k in _DEVICE_SIGNALS},
                # device residency + serve-start pre-warm; prewarm is
                # None until the background thread reports (or when
                # gated off)
                'residency': mod_residency.stats(),
                'prewarm': self._prewarm_doc,
                'memory': self.memory_doc(),
                # pipelined-dispatch telemetry (device_scan): window
                # depth, dispatch/overlap counters, page-locked bytes
                'pipeline': obs_metrics.pipeline_doc(),
                'index_query': self._index_query_doc(),
            },
            'scan_merge': self._scan_merge_doc(),
            'resources': self.governor.stats_doc(),
            'faults': mod_faults.stats(),
            'recovery': dict(
                {k: counters.get(k, 0)
                 for k in ('index recovery rollbacks',
                           'index recovery rollforwards',
                           'index tmps quarantined')},
                **self._quarantine_usage()),
            'integrity': {
                'verify': mod_integrity.verify_mode(),
                'reads_verified':
                counters.get('integrity reads verified', 0),
                'reads_unverified':
                counters.get('integrity reads unverified', 0),
                'corrupt_shards':
                counters.get('integrity corrupt shards', 0),
                'missing_shards':
                counters.get('integrity missing shards', 0),
                # the repair queue and outcomes, and the last
                # background-scrub summary (serve/scrub.py)
                'repair': self.repair.stats(),
                'scrub': self.scrubber.stats()
                if self.scrubber is not None else None,
            },
            'rollup': {
                'covered_shards':
                counters.get('index shards via rollup', 0),
                'rollup_shards_read':
                counters.get('rollup shards queried', 0),
                'shards_queried':
                counters.get('index shards queried', 0),
                'coverage_ratio': round(
                    counters.get('index shards via rollup', 0) /
                    counters.get('index shards queried', 1), 4)
                if counters.get('index shards queried', 0) else 0.0,
            },
            # rollup/compaction timer summary (serve/scrub.py
            # MaintenanceThread): pass counters, compaction backlog;
            # None when both intervals are 0
            'maintenance': self.maintainer.stats()
            if self.maintainer is not None else None,
            'metrics': obs_export.stats_section(counters=counters),
            # metric-history rings (obs/history.py): windowed
            # qps/shed/lag trends when DN_METRICS_HISTORY_S arms the
            # snapshotter; a shape-stable disabled stub otherwise
            'history': self.history.history.doc()
            if self.history is not None
            else obs_history.disabled_doc(),
            'events': obs_events.journal().doc()
            if obs_events.journal() is not None
            else obs_events.disabled_doc(),
        }
        if self.router is not None:
            # scatter-gather observability: per-member breaker
            # states, failover/hedge/degraded counters (router.py)
            doc['cluster'] = self.router.stats_doc()
        if self.cluster is not None:
            # dynamic-topology observability: current/pending epoch,
            # handoff progress, transition counters
            # (serve/coordinator.py, serve/rebalance.py)
            doc['topology'] = self.topology_doc()
        return doc

    # -- connection front end (loop-thread callbacks) ---------------------

    def _on_accept(self, conn):
        """Accept veto hook (loop thread): an injected accept fault
        drops the connection, exactly the failure the client's
        pre-commit retry loop exists for."""
        try:
            mod_faults.fire('serve.accept')
        except mod_faults.FaultInjected:
            return False
        return True

    def _on_overflow(self, conn):
        """A frame grew past MAX_REQUEST_BYTES without a newline: the
        connection cannot be resynchronized — answer with a clean v1
        error and close (loop thread)."""
        msg = ('dn: bad request: frame exceeds %d bytes\n'
               % MAX_REQUEST_BYTES).encode()
        self.loop.send(conn,
                       mod_protocol.encode_response(1, b'', msg, {}),
                       close_after=True)

    def _on_frame(self, conn, line):
        """One complete request line (loop thread): parse, classify
        v1 vs v2, and hand execution to a worker thread.  Never
        blocks — malformed frames are answered (or the connection
        dropped) right here."""
        rx = time.monotonic()
        try:
            req = json.loads(line.decode('utf-8'))
            if not isinstance(req, dict):
                raise ValueError('not an object')
        except (ValueError, UnicodeDecodeError) as e:
            err = ('dn: bad request: %s\n' % e).encode()
            self.loop.send(
                conn, mod_protocol.encode_response(1, b'', err, {}),
                close_after=True, completes=True)
            return
        try:
            proto, rid = mod_protocol.classify_request(req)
        except mod_protocol.FrameError as e:
            err = ('dn: bad request: %s\n' % e).encode()
            self.loop.send(
                conn, mod_protocol.encode_response(1, b'', err, {}),
                close_after=True, completes=True)
            return
        if proto == mod_protocol.PROTO_V2:
            if conn.proto is None:
                self.loop._bump('v2_conns')
            conn.proto = mod_protocol.PROTO_V2
            if conn.inflight > 1:
                self.loop._bump('frames_pipelined')
            with conn.ids_lock:
                duplicate = rid in conn.inflight_ids
                if not duplicate:
                    conn.inflight_ids.add(rid)
            if duplicate:
                # a client re-using an in-flight id is out of sync;
                # answer retryably and close before responses can be
                # misattributed
                err = ('dn: bad request: duplicate request id %d\n'
                       % rid).encode()
                self.loop.send(
                    conn, mod_protocol.encode_response(
                        1, b'', err, {'retryable': True},
                        proto=proto, rid=rid),
                    close_after=True, completes=True)
                return
        else:
            conn.proto = 1
            # v1 contract: one request per connection — stop reading
            self.loop.pause_reading(conn)
        t = threading.Thread(target=self._handle_request,
                             args=(conn, req, proto, rid, rx),
                             daemon=True)
        # started under the lock: the drain's snapshot of the workers
        # (taken under it) must never hold a thread not yet started —
        # joining one raises, and the drain would die half done.  A
        # subscriber's sub_ack can land just as the drain begins
        with self._workers_lock:
            self._workers.add(t)
            t.start()

    # -- request handling (worker threads) --------------------------------

    def _handle_request(self, conn, req, proto, rid, rx):
        try:
            try:
                mod_faults.fire('serve.read')
                # the stall seam: `delay` holds THIS request (a slow
                # peer/stage), never the loop or other requests
                mod_faults.fire('serve.stall')
            except mod_faults.FaultInjected:
                self.loop.close_conn(conn, completes=True)
                return
            tenant = req.get('tenant') or conn.peer or 'default'
            deadline_ms = req.get('deadline_ms')
            if deadline_ms is None:
                deadline_ms = self.conf['deadline_ms']
            deadline_at = rx + deadline_ms / 1000.0 \
                if deadline_ms and deadline_ms > 0 else None
            if req.get('op') == 'subscribe':
                # needs the CONNECTION (execute() is transport-
                # blind): register, answer, THEN queue the seed
                # frame — the loop's FIFO write queue guarantees the
                # registration ack reaches the peer first
                self._bump_op('subscribe')
                rc, out, err, extra, sub = self.subman.subscribe(
                    conn, req, proto)
                self._send_response(conn, proto, rid, rc, out, err,
                                    extra)
                if sub is not None:
                    self.subman.activate(sub)
                return
            rc, out, err, extra = self.execute(
                req, tenant=tenant, deadline_at=deadline_at)
            self._send_response(conn, proto, rid, rc, out, err,
                                extra)
        except Exception as e:
            # a request must ALWAYS resolve: respond or close, never
            # strand the peer waiting on a frame that will not come
            self.log.error('request handling failed', err=repr(e))
            try:
                msg = ('%s: internal error: %r\n'
                       % (mod_cli.ARG0, e)).encode()
                self._send_response(conn, proto, rid, 1, b'', msg,
                                    {})
            except Exception:
                self.loop.close_conn(conn, completes=True)
        finally:
            if rid is not None:
                with conn.ids_lock:
                    conn.inflight_ids.discard(rid)
            with self._workers_lock:
                self._workers.discard(threading.current_thread())

    def _send_response(self, conn, proto, rid, rc, out, err, extra):
        data = mod_protocol.encode_response(rc, out, err, extra,
                                            proto=proto, rid=rid)
        try:
            mod_faults.fire('serve.write')
        except mod_faults.FaultInjected:
            # injected write fault: drop the connection — the peer
            # sees EOF before any header (pre-commit, retry-safe)
            self.loop.close_conn(conn, completes=True)
            return
        if proto == mod_protocol.PROTO_V2:
            try:
                mod_faults.fire('serve.frame_torn')
            except mod_faults.FaultInjected:
                # a torn frame: half the response then EOF — the
                # client must classify post-commit vs pre-commit by
                # whether ITS header arrived, never hang
                self.loop.send(conn, data[:max(1, len(data) // 2)],
                               close_after=True, completes=True)
                return
        self.loop.send(conn, data, close_after=(proto == 1),
                       completes=True)

    # -- request handling (worker threads: execution) ----------------------

    def execute(self, req, tenant=None, deadline_at=None):
        """Execute one request dict; returns (rc, stdout_bytes,
        stderr_bytes, header_stats).  `tenant` keys the fair-admission
        queue; `deadline_at` (monotonic) is the propagated request
        deadline load shedding enforces."""
        op = req.get('op')
        self._bump_op(op)
        if op == 'ping':
            return 0, b'', b'', {}
        if op == 'sub_ack':
            # subscription flow control (serve/subscribe.py): tiny,
            # never queued — a throttled ack path would BE the
            # backpressure bug it exists to prevent
            return self.subman.ack(req)
        if op == 'unsubscribe':
            return self.subman.unsubscribe(req)
        if op == 'health':
            # the replica-probe op (scatter-gather routers, load
            # balancers): tiny, never queued behind admission.  The
            # fault seam lets the chaos soak fail probes
            # deterministically (a FaultInjected here propagates to
            # _handle_conn, which drops the connection — exactly what
            # a dead member looks like to a prober).
            mod_faults.fire('member.health')
            # a member LEAVING the topology (absent from the pending
            # or committed map) reports draining so routers demote it
            # — but stays ok (healthy, still serving) so the breaker
            # never churns on an orderly departure
            leaving = self._topo_leaving_now()
            # a read-only member (disk critical) stays ok — queries
            # keep serving byte-identically, the breaker must not
            # churn — but reports degraded_ro so routers rank it
            # down for write-shaped ops
            degraded_ro = self.governor.is_read_only()
            doc = {
                'ok': not self.draining,
                'draining': self.draining or leaving,
                'degraded_ro': degraded_ro,
                'pid': os.getpid(),
                'uptime_s': round(time.monotonic() - self._t0, 3),
                'inflight': self.admission.depth(),
            }
            if degraded_ro:
                doc['health'] = 'degraded_ro'
            if self.cluster is not None:
                doc['member'] = self.member
                doc['epoch'] = self.cluster.epoch
                if self.pending is not None:
                    doc['pending_epoch'] = self.pending.epoch
            body = json.dumps(doc, sort_keys=True) + '\n'
            return 0, body.encode(), b'', {}
        if op == 'stats':
            body = json.dumps(self.stats_doc(), sort_keys=True,
                              indent=2) + '\n'
            return 0, body.encode(), b'', {}
        if op == 'topology':
            # the dynamic-topology status op (coordinator readiness
            # polls, `dn topo status`): tiny, never queued
            body = json.dumps(self.topology_doc(),
                              sort_keys=True) + '\n'
            return 0, body.encode(), b'', {}
        if op == 'metrics':
            # Prometheus text exposition of the typed registry (the
            # scrape endpoint; `dn stats --remote S --prom` renders
            # it).  Like stats/health: never queued behind admission.
            body = obs_export.prometheus_text(
                counters=mod_vpipe.global_counters())
            return 0, body.encode(), b'', {}
        if op == 'events':
            # the event-journal tail (`dn events [--follow]` and the
            # fleet scatter): entries with seq > `since`, newest
            # `limit`.  Control plane: never queued behind admission.
            j = obs_events.journal()
            since = req.get('since') or 0
            limit = req.get('limit')
            if not isinstance(since, int) or isinstance(since, bool) \
                    or (limit is not None and
                        (not isinstance(limit, int) or
                         isinstance(limit, bool) or limit < 1)):
                self._bump('errors')
                return (1, b'', b'dn: bad "since"/"limit" in events '
                        b'request\n', {})
            doc = {'member': self.member,
                   'enabled': j is not None,
                   'seq': j.seq if j is not None else 0,
                   'events': j.tail(since=since, limit=limit)
                   if j is not None else []}
            body = json.dumps(doc, sort_keys=True) + '\n'
            return 0, body.encode(), b'', {}
        if op == 'fleet_stats':
            # the cluster-aggregated view (serve/fleet.py): scatter
            # stats/events to every topology member over the pooled
            # path, merge one fleet doc.  Bounded by fleet_timeout_s
            # per member — a dead member becomes an error slot,
            # never a hang.  Control plane: no admission slot (the
            # fleet view must render DURING the flood it describes).
            from . import fleet as mod_fleet
            limit = req.get('events')
            if limit is not None and \
                    (not isinstance(limit, int) or
                     isinstance(limit, bool) or limit < 0):
                self._bump('errors')
                return (1, b'', b'dn: bad "events" in fleet_stats '
                        b'request\n', {})
            doc = mod_fleet.fleet_doc(
                self, events_limit=50 if limit is None else limit)
            body = json.dumps(doc, sort_keys=True, indent=2) + '\n'
            return 0, body.encode(), b'', {}
        if op == 'scrub':
            # one on-demand integrity pass (`dn scrub --remote`):
            # verify every configured tree against its catalog under
            # the tree read locks, quarantine + schedule repair for
            # mismatches, run cluster anti-entropy.  Control plane:
            # no admission slot (like shard_manifest — a scrub must
            # not starve behind a query flood).
            from . import scrub as mod_scrub
            try:
                doc = mod_scrub.scrub_member(
                    self, repair=bool(req.get('repair', True)),
                    rate_bytes_s=self.integrity_conf[
                        'scrub_rate_mb_s'] << 20,
                    quarantine=not req.get('check'))
            except DNError as e:
                self._bump('errors')
                return (1, b'',
                        ('dn: %s\n' % e.message).encode(), {})
            body = json.dumps(doc, sort_keys=True, indent=2) + '\n'
            return 0, body.encode(), b'', {}
        if op == 'build' and req.get('idempotency'):
            return self._execute_idempotent(req['idempotency'], req,
                                            tenant, deadline_at)
        if op in ('scan', 'query', 'build', 'query_partial',
                  'shard_manifest', 'shard_fetch') or \
                (op == '_sleep' and
                 os.environ.get('DN_SERVE_TEST_OPS') == '1'):
            return self._execute_data(req, tenant=tenant,
                                      deadline_at=deadline_at)
        self._bump('errors')
        return (1, b'',
                ('dn: unsupported request op: "%s"\n' % op).encode(),
                {})

    def _execute_idempotent(self, key, req, tenant=None,
                            deadline_at=None):
        """Builds are NOT idempotent, so a retried build must not run
        twice: the first request with a given client-generated key is
        the leader and executes; duplicates (the client's retry after
        a transport failure, which may have cut the RESPONSE, not the
        request) wait for and replay the leader's recorded response.
        Retryable rejections (busy/draining) are not recorded — the
        build never ran, so a retry must execute."""
        with self._idem_lock:
            ent = self._idem.get(key)
            leader = ent is None
            if leader:
                ent = {'done': threading.Event(), 'result': None}
                self._idem[key] = ent
        if not leader:
            if not ent['done'].wait(3600.0):
                self._bump('errors')
                return (1, b'',
                        b'dn: idempotent build never completed\n', {})
            self._bump('build_idem_replays')
            rc, out, err, extra = ent['result']
            return rc, out, err, dict(extra, idempotent_replay=True)
        try:
            result = self._execute_data(req, tenant=tenant,
                                        deadline_at=deadline_at)
        except BaseException:
            # the leader died without a recordable response: retire
            # the key so a retry RE-EXECUTES (nothing committed), and
            # wake any followers with a clean retryable rejection —
            # a poisoned key must never strand its duplicates for the
            # full follower wait
            with self._idem_lock:
                self._idem.pop(key, None)
            ent['result'] = (1, b'',
                             b'dn: build execution failed before a '
                             b'response was recorded; retry\n',
                             {'retryable': True})
            ent['done'].set()
            raise
        ent['result'] = result
        with self._idem_lock:
            if result[3].get('retryable'):
                self._idem.pop(key, None)
            else:
                # bound the table: drop oldest COMPLETED records
                done = [k for k, e in self._idem.items()
                        if e['done'].is_set()]
                for k in done[:max(0, len(self._idem) - 128)]:
                    self._idem.pop(k, None)
        ent['done'].set()
        return result

    def _execute_data(self, req, tenant=None, deadline_at=None):
        t0 = time.monotonic()
        deadline_ms = req.get('deadline_ms')
        if deadline_ms is None:
            deadline_ms = self.conf['deadline_ms']
        cap = _Capture()
        flags = {'coalesced': False, 'busy': False, 'deadline': False,
                 'draining': False, 'overloaded': False,
                 'tenant': tenant, 'deadline_at': deadline_at}
        scope_out = {}
        failed = []
        op = req.get('op')

        # observability context: the scoped metrics registry is
        # always on (merged into the global registry at request end);
        # the span tree exists only when the client's trace header or
        # this process's DN_TRACE / DN_SLOW_MS asked for one.  The
        # client-generated trace id joins the server's tree to its
        # client's.
        treq = req.get('trace') or {}
        want_trace = bool(treq.get('want')) or \
            obs_trace.tracing_requested()
        tctx = obs_trace.TraceContext('serve.' + str(op),
                                      trace_id=treq.get('id')) \
            if want_trace else None
        obs_ctx = obs_trace.ObsContext(
            trace=tctx, registry=obs_metrics.Registry())

        def job():
            # may run on the worker thread OR a deadline-armor
            # thread: stdio binding and the counter scope are
            # thread-local, so both bind in here
            with bound_stdio(cap), mod_vpipe.request_scope() as sc:
                sc.obs = obs_ctx
                try:
                    rc = self._run_data(req, flags)
                except mod_admission.OverloadedError as e:
                    # deadline-aware shed: retryable, with the retry
                    # hint derived from observed service time
                    flags['overloaded'] = True
                    flags['retry_after_ms'] = e.retry_after_ms
                    sys.stderr.write('%s: %s\n'
                                     % (mod_cli.ARG0, e.message))
                    rc = 1
                except mod_admission.BusyError as e:
                    flags['busy'] = True
                    flags['retry_after_ms'] = \
                        getattr(e, 'retry_after_ms', None)
                    sys.stderr.write('%s: %s\n'
                                     % (mod_cli.ARG0, e.message))
                    rc = 1
                except mod_admission.DrainingError as e:
                    flags['draining'] = True
                    sys.stderr.write('%s: %s\n'
                                     % (mod_cli.ARG0, e.message))
                    rc = 1
                except mod_admission.DeadlineError as e:
                    flags['deadline'] = True
                    sys.stderr.write('%s: %s\n'
                                     % (mod_cli.ARG0, e.message))
                    rc = 1
                except mod_cli.FatalError as e:
                    sys.stderr.write('%s: %s\n'
                                     % (mod_cli.ARG0, e.message))
                    rc = 1
                except DNError as e:
                    # cluster degraded responses ride the shared
                    # DNError contract but mark the header: a
                    # RouterPartitionError names the dead partitions
                    # and is retryable (another router may have live
                    # replicas); epoch mismatches are retryable too
                    mp = getattr(e, 'missing_partitions', None)
                    if mp is not None:
                        flags['missing'] = list(mp)
                    if getattr(e, 'epoch_mismatch', False):
                        # the rejection names OUR epoch so the peer
                        # can tell a stale map from a dead member
                        flags['epoch_mismatch'] = True
                        flags['current_epoch'] = \
                            getattr(e, 'current_epoch', None)
                    iroot = getattr(e, 'integrity_root', None)
                    if iroot is not None:
                        # a verified read detected corruption (or a
                        # catalogued shard is missing): the header
                        # names it so the router classifies the
                        # rejection, and the damaged member starts
                        # repairing itself in the background — the
                        # self-healing contract
                        flags['corrupt_shard'] = \
                            getattr(e, 'corrupt_shard', None)
                        shards = getattr(e, 'integrity_shards',
                                         None) or []
                        if shards:
                            try:
                                self.repair.schedule(
                                    req.get('ds'), iroot, shards)
                            except Exception:
                                pass
                    if getattr(e, 'disk_full', False):
                        # the read-only rejection (resources.py):
                        # the header names it so clients/routers can
                        # classify — and retry elsewhere or later
                        flags['disk_full'] = True
                    if getattr(e, 'retryable', False):
                        flags['retryable_error'] = True
                        # degraded-because-shedding: the members'
                        # retry hints ride up to the client
                        if getattr(e, 'retry_after_ms', None) \
                                is not None:
                            flags['retry_after_ms'] = \
                                e.retry_after_ms
                    sys.stderr.write('%s: %s\n'
                                     % (mod_cli.ARG0, e.message))
                    rc = 1
                except Exception as e:
                    # a device fault (CUDA, a kernel, a failed fold)
                    # fails THIS request; the server keeps serving
                    failed.append(e)
                    sys.stderr.write('%s: internal error: %r\n'
                                     % (mod_cli.ARG0, e))
                    rc = 1
                scope_out.update(sc)
            # logged outside the request's captured stderr: operator
            # telemetry, not response bytes
            for e in failed:
                self.log.error('request failed', err=repr(e),
                               op=req.get('op'))
            return rc

        def finish_obs(rc, extra):
            """Request-end accounting: merge the scoped registry,
            record the per-op end-to-end latency, and emit/attach the
            span tree.  The subtree travels in the response header
            only when the CLIENT's trace header asked (its tracer
            grafts it) — /stats and response bytes stay byte-identical
            with tracing off."""
            elapsed_ms = (time.monotonic() - t0) * 1000.0
            reg = obs_metrics.global_registry()
            reg.merge(obs_ctx.registry)
            reg.observe('serve_op_latency_ms', elapsed_ms,
                        op=str(op))
            if rc != 0:
                reg.inc('serve_errors_total', op=str(op))
            if tctx is not None:
                # never let telemetry replace a response: a
                # deadline-abandoned job thread may still be mutating
                # this tree while we serialize it
                try:
                    if rc != 0:
                        tctx.root.add_event('error', {'rc': rc})
                    if treq.get('want'):
                        extra['trace'] = tctx.to_doc()
                    obs_trace.emit_trace(tctx)
                except Exception as e:
                    extra.pop('trace', None)
                    self.log.error('trace emit failed', err=repr(e))
            return extra

        if deadline_ms and deadline_ms > 0:
            from ..device_scan import run_with_deadline
            status, rv = run_with_deadline(job, deadline_ms / 1000.0,
                                           'serve-request')
            if status == 'timeout':
                # the job thread is abandoned (there is no way to
                # cancel a wedged op), but its resources must not
                # degrade the server: free its admission slot now
                # (Slot.release is idempotent — the abandoned thread
                # releasing again later is a no-op) and retire its
                # coalescer registration so identical new requests
                # recompute instead of attaching to a dead execution.
                # A TreeLock held by an abandoned BUILD stays held on
                # purpose — the tree is mid-rewrite and must not be
                # served until the write actually finishes.
                slot = flags.get('slot')
                if slot is not None:
                    slot.release()
                self.coalescer.abandon(flags.get('key'),
                                       flags.get('ex'))
                self._bump('deadline_expired')
                self._bump('errors')
                if tctx is not None:
                    tctx.root.add_event('deadline_expired',
                                        {'deadline_ms': deadline_ms})
                msg = ('%s: request deadline (%d ms) exceeded\n'
                       % (mod_cli.ARG0, deadline_ms))
                return 1, b'', msg.encode(), finish_obs(
                    1, {'deadline_expired': True})
            rc = rv if status == 'ok' else 1
        else:
            rc = job()

        out, err = cap.finish()
        if rc != 0:
            self._bump('errors')
        elif op in ('scan', 'query', 'build', 'query_partial'):
            # feed the observed-service-time estimate (retry hints +
            # early shed) and the per-tenant fairness accounting.
            # The sample is EXECUTION time — measured from slot
            # acquisition, not request arrival — queue wait folded in
            # would double-count queueing and over-shed after bursts.
            # (Coalesced followers and routed queries never acquired
            # a slot here: no sample, correctly.)
            if flags.get('exec_t0') is not None:
                self.admission.note_service_ms(
                    (time.monotonic() - flags['exec_t0']) * 1000.0)
            self.admission.note_completed(tenant)
        if flags['overloaded']:
            self._bump('shed_overloaded')
        elif flags['busy']:
            self._bump('busy_rejected')
        if flags['deadline']:
            self._bump('deadline_expired')
        if flags['draining']:
            self._bump('draining_rejected')
        extra = {
            'coalesced': flags['coalesced'],
            'elapsed_ms': round((time.monotonic() - t0) * 1000, 3),
            'counters': scope_out,
        }
        if flags.get('cached'):
            extra['cached'] = True
        if flags['busy'] or flags['overloaded'] or \
                flags['draining'] or flags.get('retryable_error'):
            # the request was never admitted (or failed degraded /
            # pre-execution): nothing committed, a retry is always
            # safe — the client's backoff loop keys off this
            extra['retryable'] = True
        if flags.get('retry_after_ms') is not None:
            # the honest retry hint: roughly when a freed slot could
            # take this work (serve/client.py honors it in place of
            # blind exponential backoff)
            extra['retry_after_ms'] = flags['retry_after_ms']
        if flags.get('disk_full'):
            # the read-only signal: this member is out of disk and
            # rejecting write-shaped ops until space frees (queries
            # still serve) — retry against another member or later
            extra['disk_full'] = True
        if flags.get('missing') is not None:
            # the degraded-result contract: missing partitions are
            # NAMED in the header, in both DN_ROUTER_PARTIAL modes
            # (rc=0 partial merge under 'allow', rc=1 clean retryable
            # error under 'error')
            extra['missing_partitions'] = flags['missing']
            if rc == 0:
                extra['partial'] = True
        if flags.get('epoch_mismatch'):
            # the stale-router resync signal: the rejected peer
            # re-fetches the current map and retries
            extra['epoch_mismatch'] = True
            if flags.get('current_epoch') is not None:
                extra['current_epoch'] = flags['current_epoch']
        if flags.get('disk_full'):
            # the read-only signal: this member is out of disk and
            # rejecting write-shaped ops until space frees (queries
            # still serve) — retry against another member or later
            extra['disk_full'] = True
        if flags.get('corrupt_shard') is not None:
            # the self-healing signal: this member quarantined (or is
            # missing) the named shard and is repairing in the
            # background; the router fails the partial over meanwhile
            extra['corrupt_shard'] = flags['corrupt_shard']
        return rc, out, err, finish_obs(rc, extra)

    def _tree_lock(self, ds, dsname):
        # normalized, so '/data/idx' and '/data/idx/' (or a relative
        # spelling via a different config file) share ONE lock — two
        # locks for one tree would readmit the build/query race
        key = getattr(ds, 'ds_indexpath', None)
        key = os.path.abspath(key) if key else ('ds:' + str(dsname))
        with self._tree_locks_lock:
            return self._tree_locks.setdefault(
                key, mod_admission.TreeLock())

    def _run_data(self, req, flags):
        """The data-command body, mirroring the CLI's post-parse
        execution exactly (the client already did the parsing and
        ships the parsed documents).  Raises FatalError/DNError for
        the caller to frame as 'dn: <message>'."""
        op = req['op']
        if op == '_sleep':
            flags['slot'] = self.admission.acquire(
                tenant=flags.get('tenant'),
                deadline_at=flags.get('deadline_at'))
            flags['exec_t0'] = time.monotonic()
            try:
                time.sleep(float(req.get('ms', 0)) / 1000.0)
            finally:
                flags['slot'].release()
            return 0

        from .. import datasource_for_name, metrics_for_index
        cfg_path = req.get('config') or None
        if self.cluster is not None and \
                op in ('query_partial', 'shard_manifest',
                       'shard_fetch'):
            # per-member index trees: when the topology declares this
            # member's own config, partition-scoped work resolves
            # datasources through IT — the request's config names the
            # router's view of the world, not ours.  Without the
            # declaration, a query partial keeps the request's config
            # (byte-identical to the shared-tree contract), but
            # the handoff ops always resolve the DONOR's own view
            # (process default) — a joiner's request config points at
            # its empty tree, and enumerating that as the donor would
            # silently hand off nothing.
            override = self.cluster.member_config(self.member)
            if override is None and self.pending is not None:
                override = self.pending.member_config(self.member)
            if override:
                cfg_path = override
            elif op in ('shard_manifest', 'shard_fetch'):
                cfg_path = None
        backend = mod_config.ConfigBackendLocal(cfg_path)
        err, config = backend.load()
        if err is not None and not getattr(err, 'is_enoent', False):
            mod_cli.fatal(err)
        dsname = req.get('ds')
        ds = datasource_for_name(config, dsname)
        if isinstance(ds, DNError):
            mod_cli.fatal(ds)
        opts = _opts_shim(req)

        if op == 'build':
            return self._run_build(req, ds, config, dsname, opts,
                                   metrics_for_index, flags)
        if op == 'query_partial':
            return self._run_partial(req, ds, dsname, opts, backend,
                                     flags)
        if op == 'shard_manifest':
            return self._run_shard_manifest(req, ds, dsname, flags)
        if op == 'shard_fetch':
            return self._run_shard_fetch(req, ds, dsname, flags)
        if op == 'query' and self.router is not None and \
                not opts.dry_run:
            # cluster mode: this member routes — scatter the query to
            # the partition owners and merge the partial aggregates
            # (dry runs stay local: the plan shows this member's own
            # tree view)
            return self._run_routed_query(req, ds, dsname, opts,
                                          backend, flags)

        query = mod_cli.dn_query_config(opts)
        key = mod_admission.compute_key(
            req, _config_ident(backend.cbl_path))

        # result cache (serve/qcache.py): a valid hit skips the
        # lease, the admission slot, and the tree read entirely.
        # The epoch and validators are captured BEFORE the compute:
        # a write racing the execution stamps the entry already-stale
        # (a wasted put), never a stale hit.
        use_cache = op == 'query' and not opts.dry_run and \
            key is not None and self.qcache.enabled()
        cache_epoch = mod_iqmt.cache_epoch() if use_cache else 0
        if use_cache:
            cached = self.qcache.get(key, cache_epoch)
            if cached is not None:
                # no exec_t0: like a coalesced follower, a hit never
                # held a slot, so it must not feed the service-time
                # estimate the shed/retry hints key off
                flags['cached'] = True
                obs_metrics.inc('serve_result_cache_hits_total')
                mod_cli.dn_output(query, opts,
                                  cached.clone_for_output(), dsname)
                return 0
            obs_metrics.inc('serve_result_cache_misses_total')
        cache_validators = mod_qcache.tree_validators(
            getattr(ds, 'ds_indexpath', None)) if use_cache else None

        def compute():
            lease = self._admit_resources(op, ds)
            try:
                slot = flags['slot'] = self.admission.acquire(
                    tenant=flags.get('tenant'),
                    deadline_at=flags.get('deadline_at'))
            except BaseException:
                # a busy/draining/shed rejection must hand the
                # reserved footprint back — a leaked lease would
                # ratchet the budget shut for the process lifetime
                lease.release()
                raise
            flags['exec_t0'] = time.monotonic()
            try:
                with obs_trace.span('serve.execute', op=op):
                    if op == 'scan':
                        # raw-data scans never read the index tree,
                        # so they run unlocked alongside builds
                        return ds.scan(query, device=self.device,
                                       engine=mod_cli._engine(),
                                       dry_run=opts.dry_run,
                                       warn_func=None)
                    with self._tree_lock(ds, dsname).read():
                        return ds.query(query,
                                        req.get('interval') or 'day',
                                        dry_run=opts.dry_run,
                                        device=self.device,
                                        engine=mod_cli._engine())
            finally:
                slot.release()
                lease.release()

        try:
            result, shared = self.coalescer.run(key, compute,
                                                lease=flags)
        except (mod_admission.BusyError,
                mod_admission.DrainingError,
                mod_admission.DeadlineError):
            raise
        except DNError as e:
            if getattr(e, 'retryable', False):
                # integrity (and other retryable) rejections keep
                # their attributes: the job() handler frames the
                # message AND marks the header (retryable,
                # corrupt_shard) — fatal() would strip both
                raise
            mod_cli.fatal(e)
        flags['coalesced'] = shared
        if use_cache and not shared:
            # only the compute LEADER populates the cache: its epoch
            # and validators predate its own tree read, so a write
            # racing the execution stamps the entry already-stale.  A
            # coalesced follower captured them AFTER the leader began
            # computing — a write landing in between would let the
            # follower stamp the leader's pre-write result with
            # post-write validators, freezing a stale entry until the
            # next in-process epoch bump (forever, for a tree only
            # cross-process writers touch)
            self.qcache.put(key, cache_epoch, cache_validators,
                            result)
        # coalesced requests demux through private clones: the output
        # layer mutates the pipeline it formats
        mod_cli.dn_output(query, opts, result.clone_for_output(),
                          dsname)
        return 0

    def _run_routed_query(self, req, ds, dsname, opts, backend,
                          flags):
        """Cluster-mode index query: scatter-gather through the
        router, then the unmodified output layer over the merged
        points — byte-identical to a single-process run when every
        partition answered.  NO admission slot is held across the
        scatter wait (the router blocks on REMOTE members; two
        members routing at each other under full admission queues
        would deadlock) — the local partial acquires its own slot
        inside _local_partial."""
        query = mod_cli.dn_query_config(opts)
        key = mod_admission.compute_key(
            req, _config_ident(backend.cbl_path))
        interval = req.get('interval') or 'day'

        def compute():
            with obs_trace.span('serve.execute', op='query.routed'):
                # deadline propagation: the remaining budget rides
                # into every member partial (router.scatter derives
                # per-partial deadline_ms from it)
                return self.router.scatter(
                    ds, dsname, query, interval, req,
                    deadline_at=flags.get('deadline_at'))

        # degraded errors (RouterPartitionError) propagate as DNError
        # with their missing_partitions/retryable attrs intact — the
        # job() handler frames the message and marks the header
        from . import router as mod_router
        try:
            (result, missing), shared = self.coalescer.run(
                key, compute, lease=flags)
        except mod_router.TopologyEpochError:
            # a member rejected the scatter as stale: re-fetch the
            # current map (synchronously, when a watcher runs) and
            # retry ONCE under the refreshed topology — the straggler
            # self-heals instead of erroring to the client
            with self._topo_lock:
                self._topo_counters['resyncs'] += 1
            obs_metrics.inc('topo_resyncs_total')
            if obs_events.enabled():
                obs_events.emit('topo.resync',
                                epoch=self.cluster.epoch
                                if self.cluster is not None else None)
            if self.topo_watcher is not None:
                self.topo_watcher.poll_now()
            (result, missing), shared = self.coalescer.run(
                key, compute, lease=flags)
        flags['coalesced'] = shared
        if missing:
            flags['missing'] = list(missing)
            sys.stderr.write(
                'dn: warning: partial result: partition(s) %s '
                'unavailable\n' % ','.join(str(p) for p in missing))
        mod_cli.dn_output(query, opts, result.clone_for_output(),
                          dsname)
        return 0

    def _run_partial(self, req, ds, dsname, opts, backend, flags):
        """The member side of the scatter: execute the query over the
        requested partitions of THIS member's shard walk and return
        per-shard key items as JSON (the router merges them in global
        find order)."""
        if self.cluster is None:
            mod_cli.fatal(DNError(
                'not a cluster member (start with '
                '--cluster/--member)'))
        pids = req.get('partitions')
        if not isinstance(pids, list) or not pids or \
                not all(isinstance(p, int) and
                        not isinstance(p, bool) for p in pids):
            mod_cli.fatal(DNError(
                'bad "partitions" in query_partial request'))
        # a router running a different topology file must never merge
        # this member's partitions: the epoch gate accepts the
        # committed epoch (and the pending epoch during a handoff
        # window, once this member's shards for the partitions have
        # landed) and rejects anything else with a clean retryable
        # error carrying our current epoch — the stale side resyncs
        serving = self._serving_for_epoch(req.get('epoch'),
                                          pids=pids)
        known = set(serving.partition_ids())
        if not all(p in known for p in pids):
            mod_cli.fatal(DNError(
                'bad "partitions" in query_partial request'))
        query = mod_cli.dn_query_config(opts)
        key = mod_admission.compute_key(
            req, _config_ident(backend.cbl_path))
        interval = req.get('interval') or 'day'

        def compute():
            from . import router as mod_router
            lease = self._admit_resources('query_partial', ds)
            try:
                slot = flags['slot'] = self.admission.acquire(
                    tenant=flags.get('tenant'),
                    deadline_at=flags.get('deadline_at'))
            except BaseException:
                lease.release()
                raise
            flags['exec_t0'] = time.monotonic()
            try:
                with self._tree_lock(ds, dsname).read(), \
                        obs_trace.span('serve.execute',
                                       op='query_partial'):
                    return mod_router.partial_query(
                        ds, query, interval, serving, pids)
            finally:
                slot.release()
                lease.release()

        try:
            shards, shared = self.coalescer.run(key, compute,
                                                lease=flags)
        except (mod_admission.BusyError,
                mod_admission.DrainingError,
                mod_admission.DeadlineError):
            raise
        except DNError as e:
            if getattr(e, 'retryable', False):
                # a corrupt-detect (ShardIntegrityError) must reach
                # the job() handler with its attributes intact: the
                # router reads the corrupt_shard header to classify
                # the failover, and the repair schedule hangs off it
                raise
            mod_cli.fatal(e)
        flags['coalesced'] = shared
        body = json.dumps({'epoch': serving.epoch,
                           'member': self.member, 'shards': shards},
                          sort_keys=True, separators=(',', ':'))
        sys.stdout.write(body + '\n')
        return 0

    def _run_shard_manifest(self, req, ds, dsname, flags):
        """The donor side of partition handoff: enumerate this
        member's shards for the requested COMMITTED partitions as
        (relpath, size, crc32) triples (serve/rebalance.py).  Control
        plane: no admission slot (a handoff must not starve behind a
        query flood), but the tree read lock holds so a concurrent
        build cannot reshape the tree mid-enumeration."""
        from . import rebalance as mod_rebalance
        if self.cluster is None:
            mod_cli.fatal(DNError(
                'not a cluster member (start with '
                '--cluster/--member)'))
        serving = self._serving_for_epoch(req.get('epoch'))
        pids = req.get('partitions')
        known = set(serving.partition_ids())
        if not isinstance(pids, list) or not pids or \
                not all(isinstance(p, int) and
                        not isinstance(p, bool) and p in known
                        for p in pids):
            mod_cli.fatal(DNError(
                'bad "partitions" in shard_manifest request'))
        with self._tree_lock(ds, dsname).read(), \
                obs_trace.span('serve.execute', op='shard_manifest'):
            try:
                shards = mod_rebalance.shard_manifest(ds, serving,
                                                      pids)
            except DNError as e:
                mod_cli.fatal(e)
        body = json.dumps({'epoch': serving.epoch,
                           'member': self.member, 'shards': shards},
                          sort_keys=True, separators=(',', ':'))
        sys.stdout.write(body + '\n')
        return 0

    def _run_shard_fetch(self, req, ds, dsname, flags):
        """The donor side of one shard's stream: the raw shard bytes
        as the response payload (the joiner verifies size + crc
        against the manifest before landing them)."""
        from . import rebalance as mod_rebalance
        if self.cluster is None:
            mod_cli.fatal(DNError(
                'not a cluster member (start with '
                '--cluster/--member)'))
        self._serving_for_epoch(req.get('epoch'))
        offset = req.get('offset') or 0
        length = req.get('length')
        if not isinstance(offset, int) or isinstance(offset, bool) \
                or offset < 0 or \
                (length is not None and
                 (not isinstance(length, int) or
                  isinstance(length, bool) or length < 1)):
            mod_cli.fatal(DNError(
                'bad "offset"/"length" in shard_fetch request'))
        with self._tree_lock(ds, dsname).read(), \
                obs_trace.span('serve.execute', op='shard_fetch'):
            try:
                data = mod_rebalance.read_shard(ds, req.get('rel'),
                                                offset=offset,
                                                length=length)
            except DNError as e:
                mod_cli.fatal(e)
        # raw bytes, not text: write through the capture's underlying
        # binary buffer (this handler writes nothing else)
        sys.stdout.buffer.write(data)
        return 0

    def _local_partial(self, partition_ids, partial_req):
        """The router's in-process partial executor for partitions
        this member itself owns: same admission-slot + tree-read-lock
        discipline as a socket-delivered query_partial, without
        dialing our own socket (a self-dial under a full admission
        queue would deadlock the scatter)."""
        from .. import datasource_for_name
        from . import router as mod_router
        # same epoch + handoff gate as the socket path: the scatter
        # snapshot may be one epoch behind (or ahead of) a cutover
        # that landed between snapshot and execution — serving the
        # wrong map locally would mix epochs in the merge
        serving = self._serving_for_epoch(partial_req.get('epoch'),
                                          pids=partition_ids)
        cfg_path = partial_req.get('config') or None
        override = serving.member_config(self.member)
        if override:
            cfg_path = override
        backend = mod_config.ConfigBackendLocal(cfg_path)
        err, config = backend.load()
        if err is not None and not getattr(err, 'is_enoent', False):
            raise err
        dsname = partial_req.get('ds')
        ds = datasource_for_name(config, dsname)
        if isinstance(ds, DNError):
            raise ds
        opts = _opts_shim(partial_req)
        query = mod_cli.dn_query_config(opts)
        interval = partial_req.get('interval') or 'day'
        deadline_ms = partial_req.get('deadline_ms')
        deadline_at = time.monotonic() + deadline_ms / 1000.0 \
            if deadline_ms and deadline_ms > 0 else None
        lease = self._admit_resources('query_partial', ds)
        try:
            slot = self.admission.acquire(
                tenant=partial_req.get('tenant'),
                deadline_at=deadline_at)
        except BaseException:
            lease.release()
            raise
        try:
            with self._tree_lock(ds, dsname).read():
                return mod_router.partial_query(
                    ds, query, interval, serving, partition_ids)
        except DNError as e:
            # a corrupt/missing detect on OUR OWN partial propagates
            # to the router (which fails over to a replica), not
            # through the request error handler — so the self-repair
            # schedule hooks in right here
            iroot = getattr(e, 'integrity_root', None)
            shards = getattr(e, 'integrity_shards', None) or []
            if iroot is not None and shards:
                try:
                    self.repair.schedule(dsname, iroot, shards)
                except Exception:
                    pass
            raise
        finally:
            slot.release()
            lease.release()

    def _run_build(self, req, ds, config, dsname, opts,
                   metrics_for_index, flags):
        before, after = req.get('before'), req.get('after')
        if before is not None and after is not None and \
                before < after:
            mod_cli.fatal(DNError(
                '"before" time cannot be before "after" time'))
        interval = req.get('interval') or 'day'
        if interval not in ('hour', 'day', 'all'):
            mod_cli.fatal(DNError('interval not supported: "%s"'
                                  % interval))
        metrics = metrics_for_index(config, dsname,
                                    index_config=req.get(
                                        'index_config'))
        if len(metrics) == 0:
            mod_cli.fatal(DNError('no metrics defined for dataset '
                                  '"%s"' % dsname))
        # the read-only gate: a disk-critical member rejects builds
        # up front with the clean retryable disk_full DNError (the
        # job() handler marks the response header) — queries keep
        # serving byte-identically throughout
        if not opts.dry_run:
            self.governor.check_writable('build')
        lease = self._admit_resources('build', ds)
        try:
            slot = flags['slot'] = self.admission.acquire(
                tenant=flags.get('tenant'),
                deadline_at=flags.get('deadline_at'))
        except BaseException:
            lease.release()
            raise
        flags['exec_t0'] = time.monotonic()
        try:
            with self._tree_lock(ds, dsname).write(), \
                    obs_trace.span('serve.execute', op='build'):
                result = ds.build(metrics, interval,
                                  time_after=after,
                                  time_before=before,
                                  dry_run=opts.dry_run,
                                  device=self.device,
                                  engine=mod_cli._engine(),
                                  warn_func=None)
        except DNError as e:
            if getattr(e, 'retryable', False):
                # a mid-build pressure failure keeps its disk_full /
                # retryable attributes for the response header;
                # fatal() would strip both
                raise
            mod_cli.fatal(e)
        finally:
            slot.release()
            lease.release()
        if opts.dry_run:
            mod_cli.dn_output(None, opts, result, dsname)
            return 0
        sys.stderr.write('indexes for "%s" built\n' % dsname)
        if getattr(opts, 'counters', None):
            result.pipeline.dump_counters(sys.stderr)
        return 0


def _device_memory(device):
    """torch.cuda.memory_allocated of `device`, or None on the CPU."""
    if not str(device).startswith('cuda'):
        return None
    import torch
    return torch.cuda.memory_allocated(device)


# -- daemon entry (cmd_serve) -----------------------------------------------

def sweep_configured_trees(warn=None):
    """Crash-recovery sweep over every configured file datasource's
    index tree — `dn serve` runs this at startup so a builder that
    died while no server was resident is recovered before the first
    request.  Returns {indexpath: sweep result} for trees that needed
    work."""
    from .. import index_journal as mod_journal
    backend = mod_config.ConfigBackendLocal()
    err, config = backend.load()
    if err is not None:
        return {}
    acted = {}
    for dsname, ds in config.datasource_list():
        idx = (ds.get('ds_backend_config') or {}).get('indexPath')
        if not idx:
            continue
        res = mod_journal.sweep_index_tree(idx)
        if res['rollbacks'] or res['rollforwards'] or \
                res['quarantined']:
            acted[idx] = res
            if warn is not None:
                warn('recovered index tree "%s" (%d roll-forward(s), '
                     '%d rollback(s), %d tmp(s) quarantined)'
                     % (idx, res['rollforwards'], res['rollbacks'],
                        res['quarantined']))
    return acted


def serve_main(socket_path=None, port=None, pidfile=None,
               cluster=None, member=None, router_conf=None,
               pending=None, topo_conf=None):
    """Run the daemon until SIGTERM/SIGINT, then drain.  Returns the
    process exit code.  The device (DN_TORCH_DEVICE, CUDA unless it
    says cpu) is resolved before anything is swept, claimed or
    bound.  `cluster` (an already-loaded, validated topology.Topology)
    and `member` (this server's member name) start the scatter-gather
    cluster mode (serve/topology.py, serve/router.py); `pending` is the
    in-flight transition epoch when the topology file was mid-handoff
    at startup (a fresh joiner starts pulling immediately).  The CLI
    loads and validates the topology file and DN_ROUTER_*/DN_TOPO_*
    knobs exactly once and hands the results here — re-reading them
    would open a window where the state just validated differs from
    the state actually served."""
    from ..ops import resolve_device
    conf = mod_config.serve_config()
    if isinstance(conf, DNError):
        raise conf
    resolve_device(os.environ.get('DN_TORCH_DEVICE') or 'cuda')
    pidfile = mod_lifecycle.pidfile_for(socket_path, pidfile)

    def warn(msg):
        sys.stderr.write('dn serve: %s\n' % msg)

    sweep_configured_trees(warn=warn)
    mod_lifecycle.claim(socket_path=socket_path, port=port,
                        pidfile=pidfile, warn=warn)
    try:
        server = DnServer(socket_path=socket_path, port=port,
                          pidfile=pidfile, conf=conf, cluster=cluster,
                          member=member, router_conf=router_conf,
                          pending=pending, topo_conf=topo_conf)
        server.bind()
    except BaseException as e:
        mod_residency.deconfigure()
        mod_lifecycle.release(socket_path=None, pidfile=pidfile)
        if isinstance(e, OSError):
            raise DNError('cannot bind serve endpoint',
                          cause=DNError(str(e)))
        raise

    def on_signal(signo, frame):
        server.request_stop()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    where = socket_path if socket_path is not None \
        else '%s:%d' % (server.host, server.bound_port)
    aka = ' as member "%s" (epoch %d)' % (member, cluster.epoch) \
        if cluster is not None else ''
    sys.stderr.write('dn serve: listening on %s (pid %d, device %s)%s\n'
                     % (where, os.getpid(), server.device, aka))
    server.serve_forever()
    sys.stderr.write('dn serve: drained; exiting\n')
    return 0
