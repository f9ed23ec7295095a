"""`dn serve` of the port (dragnet_tpu_torch/serve/) on the CPU.

For every command shape of the JAX package's own serve suite
(tests/test_serve.py `_cases`: queries with --counters, --points and
time windows, scans, a build), over both index formats, three answers
are identical (rc, stdout, stderr): the port's server over `--remote`,
the port's local CLI, and the JAX package's local CLI.  Also: a
concurrent soak, coalescing, queue-full and deadline errors, drain,
pidfile/socket reclaim, `--validate`, the build idempotency replay,
the writer invalidation hook, the result cache, device residency and
the pre-warm through the server, and a device fault that fails one
request only.  The cluster ops and knobs are held in
tests/test_torch_serve_cluster.py, test_torch_topology_dynamic.py and
test_torch_scrub.py.
"""

import json
import os
import signal
import socket as mod_socket
import subprocess
import sys
import threading
import time

import pytest

from dragnet_tpu import cli as jcli
from dragnet_tpu.serve import server as jserver
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch import device_index as tdi
from dragnet_tpu_torch import vpipe as tvpipe
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.serve import admission as tadmission
from dragnet_tpu_torch.serve import client as tclient
from dragnet_tpu_torch.serve import lifecycle as tlifecycle
from dragnet_tpu_torch.serve import residency as tresidency
from dragnet_tpu_torch.serve import server as tserver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_port(args):
    """One in-process run of the port's CLI, its stdout/stderr captured
    as bytes through the port's thread-stdio router (safe from several
    threads at once)."""
    with tserver.thread_stdio() as cap:
        rc = tcli.main(list(args))
    out, err = cap.finish()
    return rc, out, err


def run_ref(args):
    """One in-process run of the JAX package's CLI under its own
    thread-stdio router.  The process streams are restored after it,
    so the two routers never stack on each other."""
    saved = sys.stdout, sys.stderr
    try:
        with jserver.thread_stdio() as cap:
            rc = jcli.main(list(args))
        out, err = cap.finish()
    finally:
        sys.stdout, sys.stderr = saved
    return rc, out, err


def _gen_corpus(path, n=400):
    """tests/test_serve.py's corpus: newline-JSON over 4 days of
    2014-01."""
    import datetime
    t0 = 1388534400
    with open(path, 'w') as f:
        for i in range(n):
            ts = datetime.datetime.fromtimestamp(
                t0 + i * 800, datetime.timezone.utc).strftime(
                    '%Y-%m-%dT%H:%M:%S.000Z')
            f.write(json.dumps({
                'time': ts,
                'host': 'host%d' % (i % 3),
                'operation': ('get', 'put', 'index')[i % 3],
                'req': {'method': ('GET', 'PUT')[i % 2]},
                'latency': (i * 7) % 230,
            }, separators=(',', ':')) + '\n')


def _cases(ds):
    return [
        ['query', '-b', 'host', ds],
        ['query', '-b', 'host,latency[aggr=quantize]', '--counters',
         ds],
        ['query', '--points', '-b', 'operation', '-f',
         '{"eq": ["req.method", "GET"]}', ds],
        ['query', '--raw', '-b', 'host,latency[aggr=quantize]',
         '-A', '2014-01-02', '-B', '2014-01-03', ds],
        ['scan', '-b', 'operation', '--raw', ds],
        ['scan', '-b', 'host,latency[aggr=quantize]', '--counters',
         ds],
        ['build', ds],
    ]


DSS = ('ds_dnc', 'ds_sq')
NCASES = len(_cases('x'))
ENGINES = ('auto', 'jax')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Two datasources over one corpus, ds_dnc and ds_sq, with trees
    built by the JAX package under each DN_INDEX_FORMAT, and the JAX
    package's local answer to every case.  The port runs on the CPU."""
    root = tmp_path_factory.mktemp('tserve_corpus')
    datafile = str(root / 'data.log')
    _gen_corpus(datafile)
    rc_path = str(root / 'dragnetrc.json')
    keys = ('DRAGNET_CONFIG', 'DN_INDEX_FORMAT', 'DN_TORCH_DEVICE',
            'DN_ENGINE')
    prior = {k: os.environ.get(k) for k in keys}
    os.environ['DRAGNET_CONFIG'] = rc_path
    os.environ['DN_TORCH_DEVICE'] = 'cpu'
    os.environ.pop('DN_ENGINE', None)
    try:
        for ds, fmt in (('ds_dnc', 'dnc'), ('ds_sq', 'sqlite')):
            idx = str(root / ('idx_' + fmt))
            for args in (['datasource-add', '--path', datafile,
                          '--index-path', idx, '--time-field', 'time',
                          ds],
                         ['metric-add', '-b',
                          'timestamp[date,field=time,aggr=lquantize,'
                          'step=86400],host,latency[aggr=quantize]', ds,
                          'm1'],
                         ['metric-add', '-b', 'operation', '-f',
                          '{"eq": ["req.method", "GET"]}', ds, 'm2']):
                rc, out, err = run_ref(args)
                assert rc == 0, err
            os.environ['DN_INDEX_FORMAT'] = fmt
            rc, out, err = run_ref(['build', ds])
            assert rc == 0, err
        os.environ.pop('DN_INDEX_FORMAT', None)
        expected = {}
        for ds in DSS:
            for case in _cases(ds):
                expected[tuple(case)] = run_ref(case)
                assert expected[tuple(case)][0] == 0, case
        yield {'root': root, 'rc_path': rc_path, 'datafile': datafile,
               'expected': expected}
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _conf(**over):
    base = {'max_inflight': 4, 'queue_depth': 16, 'deadline_ms': 0,
            'coalesce': True, 'drain_s': 10}
    base.update(over)
    return base


@pytest.fixture
def server(corpus, tmp_path):
    sock = str(tmp_path / 'dn.sock')
    srv = tserver.DnServer(socket_path=sock, conf=_conf()).start()
    try:
        yield srv
    finally:
        srv.stop()


def _req(ds, corpus, breakdowns=('host',), flt=None, interval='day',
         op='query', opts=None):
    bds = [{'name': b, 'field': b} for b in breakdowns]
    qc = {'breakdowns': bds}
    if flt is not None:
        qc['filter'] = flt
    doc = {'op': op, 'ds': ds, 'config': corpus['rc_path'],
           'queryconfig': qc, 'opts': opts or {}}
    if op == 'query':
        doc['interval'] = interval
    return doc


def _remote(case, sock):
    return case[:1] + ['--remote', sock] + case[1:]


# -- byte identity: port remote == port local == the JAX package local -------

@pytest.mark.parametrize('engine', ENGINES)
@pytest.mark.parametrize('ds', DSS)
@pytest.mark.parametrize('icase', range(NCASES))
def test_remote_byte_identical(corpus, tmp_path, monkeypatch, engine, ds,
                               icase):
    """Each command shape, on the port's default engine and on the
    forced device lane (the CPU device here): the server's answer over
    `--remote`, the port's local answer and the JAX package's local
    answer are identical."""
    monkeypatch.setenv('DN_ENGINE', engine)
    case = _cases(ds)[icase]
    expected = corpus['expected'][tuple(case)]
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock'),
                           conf=_conf()).start()
    try:
        assert run_port(case) == expected, case
        assert run_port(_remote(case, srv.socket_path)) == expected, case
    finally:
        srv.stop()


@pytest.mark.parametrize('engine', ENGINES)
def test_concurrent_soak_byte_identical(corpus, tmp_path, monkeypatch,
                                        engine):
    """8 client threads x mixed scan/index-query/build over both index
    formats: every response equals its serial answer, and coalescing
    shows in /stats."""
    monkeypatch.setenv('DN_ENGINE', engine)
    if engine == 'jax':
        monkeypatch.setenv('DN_DEVICE_RESIDENCY_MB', '64')
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock'),
                           conf=_conf()).start()
    sock = srv.socket_path
    work = [(case, corpus['expected'][tuple(case)])
            for ds in DSS for case in _cases(ds)]
    errors = []
    start = threading.Barrier(8)

    def client(tid):
        start.wait()
        for rep in range(3):
            for i, (case, expected) in enumerate(work):
                if (i + rep + tid) % 3 == 0:
                    continue     # vary the mix per thread
                got = run_port(_remote(case, sock))
                if got != expected:
                    errors.append((tid, case, got, expected))

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[0]
        st = tclient.stats(sock)
        assert st['requests']['requests'] > 0
        assert st['requests']['coalesced'] > 0
        assert st['requests']['errors'] == 0
        if engine == 'jax':
            assert st['device']['engaged']
            assert st['device']['residency']['hits'] > 0
    finally:
        srv.stop()


def test_coalescing_shares_one_execution(corpus, tmp_path, monkeypatch):
    """With the single execution slot held, identical concurrent
    queries attach to ONE leader: /stats shows followers, and every
    response is byte-identical."""
    monkeypatch.setenv('DN_SERVE_TEST_OPS', '1')
    sock = str(tmp_path / 'dn.sock')
    srv = tserver.DnServer(
        socket_path=sock,
        conf=_conf(max_inflight=1, queue_depth=8)).start()
    try:
        holder = threading.Thread(
            target=tclient.request_bytes,
            args=(sock, {'op': '_sleep', 'ms': 500}))
        holder.start()
        time.sleep(0.15)      # the sleeper owns the only slot
        req = _req('ds_dnc', corpus)
        results = []

        def fire():
            results.append(tclient.request_bytes(sock, req))

        threads = [threading.Thread(target=fire) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        holder.join()
        assert len(set((rc, out, err)
                       for rc, hd, out, err in results)) == 1
        assert results[0][0] == 0
        shared = [hd['stats']['coalesced'] for rc, hd, out, err in results]
        assert sum(1 for s in shared if s) == 3
        st = tclient.stats(sock)
        assert st['requests']['coalesced'] >= 3
        assert st['requests']['executions'] >= 1
    finally:
        srv.stop()


# -- admission + deadline DNError paths ---------------------------------------

def test_queue_full_fast_429(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv('DN_SERVE_TEST_OPS', '1')
    sock = str(tmp_path / 'dn.sock')
    srv = tserver.DnServer(
        socket_path=sock, conf=_conf(max_inflight=1, queue_depth=0)).start()
    try:
        holder = threading.Thread(
            target=tclient.request_bytes,
            args=(sock, {'op': '_sleep', 'ms': 800}))
        holder.start()
        time.sleep(0.2)
        t0 = time.monotonic()
        rc, hd, out, err = tclient.request_bytes(sock,
                                                 _req('ds_dnc', corpus))
        dt = time.monotonic() - t0
        holder.join()
        assert rc == 1
        assert err.startswith(b'dn: server busy:'), err
        assert b'DN_SERVE_MAX_INFLIGHT=1' in err
        assert dt < 0.5      # fast rejection, not a convoy
        assert tclient.stats(sock)['requests']['busy_rejected'] == 1
    finally:
        srv.stop()


def test_request_deadline_dnerror(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv('DN_SERVE_TEST_OPS', '1')
    sock = str(tmp_path / 'dn.sock')
    srv = tserver.DnServer(socket_path=sock,
                           conf=_conf(deadline_ms=150)).start()
    try:
        t0 = time.monotonic()
        rc, hd, out, err = tclient.request_bytes(
            sock, {'op': '_sleep', 'ms': 5000})
        assert rc == 1
        assert b'request deadline (150 ms) exceeded' in err
        assert time.monotonic() - t0 < 3.0
        assert tclient.stats(sock)['requests']['deadline_expired'] == 1
    finally:
        srv.stop()


def test_deadline_timeout_frees_admission_slot(corpus, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv('DN_SERVE_TEST_OPS', '1')
    sock = str(tmp_path / 'dn.sock')
    srv = tserver.DnServer(
        socket_path=sock,
        conf=_conf(max_inflight=1, queue_depth=0, deadline_ms=200)).start()
    try:
        rc, hd, out, err = tclient.request_bytes(
            sock, {'op': '_sleep', 'ms': 3000})
        assert rc == 1 and b'deadline' in err
        rc, hd, out, err = tclient.request_bytes(sock,
                                                 _req('ds_dnc', corpus))
        assert rc == 0, err
    finally:
        srv.stop()


@pytest.mark.parametrize('args', [['query', '--iq-threads', '2'],
                                  ['query', '--iq-stack', '0'],
                                  ['scan', '--parse', 'host'],
                                  ['scan', '--warnings', '-b', 'host'],
                                  ['build', '--build-threads', '2']])
def test_remote_rejects_execution_mode_flags(server, corpus, args):
    rc, out, err = run_port(args[:1] + ['--remote', server.socket_path] +
                            args[1:] + ['ds_dnc'])
    assert rc == 2, (args, err)
    assert b'cannot be combined with "--remote"' in err, args


# -- fallback + error framing -------------------------------------------------

def test_remote_unreachable_falls_back_local(corpus, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv('DN_REMOTE_BACKOFF_MS', '1')
    case = ['query', '-b', 'host', 'ds_dnc']
    rc, out, err = run_port(_remote(case, str(tmp_path / 'nope.sock')))
    assert rc == 0
    assert out == corpus['expected'][tuple(case)][1]
    assert b'unreachable after 3 attempt(s)' in err
    assert b'falling back' in err


def test_remote_fatal_error_framing(server, corpus):
    """Server-side fatal errors come back with the CLI's exact
    'dn: <message>' framing and exit code, as the JAX package's local
    CLI prints them."""
    case = ['query', '-b', 'host', 'no_such_ds']
    expected = run_ref(case)
    assert run_port(case) == expected
    remote = run_port(_remote(case, server.socket_path))
    assert remote == expected
    assert remote[0] == 1 and b'unknown datasource' in remote[2]


def test_unsupported_op(server):
    rc, hd, out, err = tclient.request_bytes(server.socket_path,
                                             {'op': 'shrug'})
    assert rc == 1 and b'unsupported request op' in err


def test_serve_without_cuda_fails_before_bind(tmp_path, monkeypatch):
    """CUDA asked for (DN_TORCH_DEVICE unset) on a machine without it:
    `dn serve` fails before it claims or binds anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    monkeypatch.delenv('DN_TORCH_DEVICE')
    sock = str(tmp_path / 'dn.sock')
    with pytest.raises(DNError, match='CUDA device'):
        tserver.DnServer(socket_path=sock, conf=_conf())
    for extra in ([], ['--validate']):
        rc, out, err = run_port(['serve', '--socket', sock] + extra)
        assert rc == 1 and b'CUDA is not available' in err
    assert not os.path.exists(sock)
    assert not os.path.exists(sock + '.pid')
    assert tresidency.active() is None


# -- request-scoped counters --------------------------------------------------

def test_request_scope_isolates_and_merges():
    tvpipe.reset_global_counters()
    seen = {}
    start = threading.Barrier(2)

    def worker(name, n):
        with tvpipe.request_scope() as sc:
            start.wait()
            for _ in range(n):
                tvpipe.counter_bump('soak counter')
            time.sleep(0.05)
            seen[name] = dict(sc)

    a = threading.Thread(target=worker, args=('a', 3))
    b = threading.Thread(target=worker, args=('b', 7))
    a.start()
    b.start()
    a.join()
    b.join()
    assert seen['a'] == {'soak counter': 3}
    assert seen['b'] == {'soak counter': 7}
    assert tvpipe.global_counters()['soak counter'] == 10
    tvpipe.counter_bump('soak counter')
    assert tvpipe.global_counters()['soak counter'] == 11


def test_request_counters_in_response_header(server, corpus):
    rc, hd, out, err = tclient.request_bytes(server.socket_path,
                                             _req('ds_dnc', corpus))
    assert rc == 0
    assert hd['stats']['counters'].get('index shards queried', 0) > 0


def test_request_counters_attribute_across_pool_threads(server, corpus,
                                                        monkeypatch):
    """On the per-shard pool path the handle cache is hit from worker
    threads, which adopt the request's counter scope."""
    monkeypatch.setenv('DN_IQ_STACK', '0')
    monkeypatch.setenv('DN_IQ_THREADS', '2')
    req = _req('ds_dnc', corpus, breakdowns=('operation',),
               flt={'eq': ['req.method', 'GET']})
    tclient.request_bytes(server.socket_path, req)  # warm
    rc, hd, out, err = tclient.request_bytes(server.socket_path, req)
    assert rc == 0, err
    counters = hd['stats']['counters']
    assert counters.get('index handle cache hits', 0) + \
        counters.get('index handle cache misses', 0) > 0


def test_scan_mt_workers_adopt_the_request_scope(corpus, monkeypatch):
    """The MT host engine's workers bump their hidden counters into the
    submitting request's scope, not the global store."""
    from dragnet_tpu_torch import scan_mt
    monkeypatch.setenv('DN_SCAN_THREADS', '2')
    seen = []
    orig = scan_mt.MTScanExecutor._worker_loop

    def spy(self, *a):
        seen.append(tvpipe.current_scope())
        return orig(self, *a)
    monkeypatch.setattr(scan_mt.MTScanExecutor, '_worker_loop', spy)
    with tvpipe.request_scope() as sc:
        rc, out, err = run_port(['scan', '-b', 'host', 'ds_dnc'])
    assert rc == 0, err
    assert seen and all(s is sc for s in seen)


def test_writer_invalidation_hook(server, corpus):
    """A build THROUGH the server fires the writer-invalidation hook
    and later queries still answer as the JAX package does."""
    before = tclient.stats(server.socket_path)['counters'].get(
        'index writer invalidations', 0)
    rc, hd, out, err = tclient.request_bytes(
        server.socket_path,
        {'op': 'build', 'ds': 'ds_dnc', 'config': corpus['rc_path'],
         'interval': 'day', 'opts': {}})
    assert rc == 0 and err == b'indexes for "ds_dnc" built\n'
    after = tclient.stats(server.socket_path)['counters'].get(
        'index writer invalidations', 0)
    assert after > before
    case = ['query', '-b', 'host', 'ds_dnc']
    assert run_port(_remote(case, server.socket_path)) == \
        corpus['expected'][tuple(case)]


def test_retry_recovers_from_transient_busy(corpus, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv('DN_SERVE_TEST_OPS', '1')
    monkeypatch.setenv('DN_REMOTE_RETRIES', '8')
    monkeypatch.setenv('DN_REMOTE_BACKOFF_MS', '60')
    sock = str(tmp_path / 'busy.sock')
    srv = tserver.DnServer(
        socket_path=sock, conf=_conf(max_inflight=1, queue_depth=0)).start()
    try:
        holder = threading.Thread(
            target=tclient.request_bytes,
            args=(sock, {'op': '_sleep', 'ms': 400}))
        holder.start()
        time.sleep(0.1)
        case = ['query', '-b', 'host', 'ds_dnc']
        got = run_port(_remote(case, sock))
        holder.join()
        assert got == corpus['expected'][tuple(case)]
        assert tclient.stats(sock)['requests']['busy_rejected'] >= 1
    finally:
        srv.stop()


def test_drain_rejects_queued_requests_cleanly(corpus, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv('DN_SERVE_TEST_OPS', '1')
    sock = str(tmp_path / 'drain.sock')
    srv = tserver.DnServer(
        socket_path=sock, conf=_conf(max_inflight=1, queue_depth=8)).start()
    results = {}

    def fire(name, req):
        results[name] = tclient.request_bytes(sock, req, timeout_s=30)

    holder = threading.Thread(
        target=fire, args=('held', {'op': '_sleep', 'ms': 800}))
    holder.start()
    time.sleep(0.2)
    queued = threading.Thread(target=fire,
                              args=('queued', _req('ds_dnc', corpus)))
    queued.start()
    time.sleep(0.2)
    srv.request_stop()
    holder.join(timeout=30)
    queued.join(timeout=30)
    srv.stop()
    assert results['held'][0] == 0
    rc, hd, out, err = results['queued']
    assert rc == 1 and b'draining' in err
    assert hd['retryable'] is True


def test_health_op(server, corpus):
    doc = tclient.health(server.socket_path)
    assert doc['ok'] is True and doc['draining'] is False
    assert doc['pid'] == os.getpid()
    assert 'inflight' in doc and 'uptime_s' in doc


def test_build_idempotency_key_replays_not_reruns(server, corpus):
    req = {'op': 'build', 'ds': 'ds_dnc', 'config': corpus['rc_path'],
           'interval': 'day', 'opts': {}, 'idempotency': 'soak-key-1'}
    first = tclient.request_bytes(server.socket_path, dict(req))
    assert first[0] == 0, first[3]
    before = tclient.stats(server.socket_path)
    second = tclient.request_bytes(server.socket_path, dict(req))
    after = tclient.stats(server.socket_path)
    assert second[0] == 0
    assert second[2] == first[2] and second[3] == first[3]
    assert second[1]['stats'].get('idempotent_replay') is True
    assert after['requests']['build_idem_replays'] == \
        before['requests']['build_idem_replays'] + 1
    assert after['counters'].get('index writer invalidations', 0) == \
        before['counters'].get('index writer invalidations', 0)


def test_stats_reports_faults_and_recovery(server, corpus):
    st = tclient.stats(server.socket_path)
    assert 'faults' in st
    assert set(st['recovery']) == {'index recovery rollbacks',
                                   'index recovery rollforwards',
                                   'index tmps quarantined',
                                   'quarantine_files',
                                   'quarantine_bytes'}
    assert st['draining'] is False
    integ = st['integrity']
    assert integ['verify'] in ('off', 'open', 'full')
    # the repair queue is always there; the scrub thread only under
    # DN_SCRUB_INTERVAL_S > 0
    assert integ['repair']['scheduled'] == integ['repair']['queued'] == 0
    assert integ['scrub'] is None and st['maintenance'] is None
    assert 'cluster' not in st and 'topology' not in st
    assert st['device']['device'] == 'cpu'
    assert st['metrics']['version'] == 1


def test_result_cache_answers_repeats(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv('DN_SERVE_CACHE_MB', '16')
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock')).start()
    try:
        case = ['query', '--counters', '-b', 'host', 'ds_sq']
        expected = run_ref(case)
        req = _req('ds_sq', corpus, opts={'counters': True})
        first = tclient.request_bytes(srv.socket_path, req)
        second = tclient.request_bytes(srv.socket_path, req)
        assert (first[0], first[2], first[3]) == expected
        assert (second[0], second[2], second[3]) == expected
        assert second[1]['stats'].get('cached') is True
        assert tclient.stats(srv.socket_path)['caches']['results'][
            'hits'] == 1
    finally:
        srv.stop()


# -- the device lane through the server ---------------------------------------

def test_prewarm_and_residency_through_the_server(corpus, tmp_path,
                                                  monkeypatch):
    """DN_ENGINE=jax on the CPU device with residency armed: the
    pre-warm runs K7a at its two shapes, a repeat query answers from
    its pinned accumulator without a dispatch, a repeat after the host
    pins are dropped from its pinned shard tensors, each answer equal
    to the JAX package's, and the drain drops every pin."""
    from dragnet_tpu_torch import index_query_stack as tiqs
    monkeypatch.setenv('DN_ENGINE', 'jax')
    monkeypatch.setenv('DN_DEVICE_RESIDENCY_MB', '64')
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock'),
                           conf=_conf()).start()
    try:
        doc = srv.wait_prewarm(60)
        assert doc['state'] == 'ok' and doc['programs'] == 2, doc
        assert doc['backend'] == 'torch/cpu'
        assert set(tiqs._SUMS_CACHE) >= set(tresidency._PREWARM_SHAPES)
        case = ['query', '-b', 'host,latency[aggr=quantize]',
                '--counters', 'ds_dnc']
        expected = corpus['expected'][tuple(case)]
        tdi._reset_engagement()
        assert run_port(_remote(case, srv.socket_path)) == expected
        e1 = tdi.stats_doc()
        assert e1['dispatches'] > 0 and e1['pinned_shard_hits'] == 0
        assert run_port(_remote(case, srv.socket_path)) == expected
        e2 = tdi.stats_doc()
        assert e2['dispatches'] == e1['dispatches']     # no fold
        st = tresidency.stats()
        assert st['hits'] >= 1 and st['d2h_saved_bytes'] > 0
        tresidency.active().drop_host_pins()
        assert run_port(_remote(case, srv.socket_path)) == expected
        e3 = tdi.stats_doc()
        assert e3['dispatches'] > e2['dispatches']
        assert e3['pinned_shard_hits'] == e1['shards']
        assert e3['h2d_saved_bytes'] > 0
        stats = tclient.stats(srv.socket_path)['device']
        assert stats['prewarm']['state'] == 'ok'
        assert stats['index_query']['pinned_shard_hits'] == \
            e3['pinned_shard_hits']
    finally:
        srv.stop()
    assert tresidency.active() is None
    assert tresidency.stats() == {'enabled': False}


def test_device_fault_fails_one_request(corpus, tmp_path, monkeypatch):
    """A fault in the K7 fold fails that request (rc 1, 'dn: ...'),
    nothing answers from the host, and the next request is served."""
    monkeypatch.setenv('DN_ENGINE', 'jax')
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock'),
                           conf=_conf()).start()
    real = tdi._fold_program
    planted = []

    def broken(*args):
        if not planted:
            planted.append(1)
            raise RuntimeError('planted K7 fault')
        return real(*args)
    monkeypatch.setattr(tdi, '_fold_program', broken)
    try:
        case = ['query', '-b', 'host', 'ds_dnc']
        rc, out, err = run_port(_remote(case, srv.socket_path))
        assert rc == 1 and out == b''
        assert err.startswith(b'dn: ') and b'planted K7 fault' in err
        assert run_port(_remote(case, srv.socket_path)) == \
            corpus['expected'][tuple(case)]
        assert tclient.stats(srv.socket_path)['requests']['errors'] == 1
    finally:
        srv.stop()


# -- stats / events commands --------------------------------------------------

def test_stats_command_remote_and_local(server, corpus):
    rc, out, err = run_port(['stats', '--remote', server.socket_path])
    assert rc == 0 and err == b''
    doc = json.loads(out)
    assert doc['socket'] == server.socket_path
    assert 'residency' in doc['device'] and 'index_query' in doc['device']
    rc, out, err = run_port(['stats', '--remote', server.socket_path,
                             '--prom'])
    assert rc == 0 and b'# TYPE dn_' in out
    rc, out, err = run_port(['stats'])
    assert rc == 0 and json.loads(out)['version'] == 1
    rc, out, err = run_port(['stats', '--prom'])
    assert rc == 0


def test_events_command(corpus, tmp_path, monkeypatch):
    from dragnet_tpu_torch.obs import events as tevents
    rc, out, err = run_port(['events'])
    assert rc == 1 and b'event journal disabled' in err
    monkeypatch.setenv('DN_EVENTS', '64')
    tevents.uninstall()
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock'),
                           conf=_conf()).start()
    try:
        tevents.emit('test.event', n=1)
        rc, out, err = run_port(['events', '--remote', srv.socket_path])
        assert rc == 0, err
        lines = [json.loads(x) for x in out.splitlines()]
        assert any(e['type'] == 'test.event' for e in lines), lines
        rc, out, err = run_port(['events'])
        assert rc == 0
    finally:
        srv.stop()
        tevents.uninstall()


# -- lifecycle hygiene --------------------------------------------------------

def test_stale_pidfile_and_orphan_socket_reclaim(tmp_path):
    sock = str(tmp_path / 'stale.sock')
    pidfile = sock + '.pid'
    s = mod_socket.socket(mod_socket.AF_UNIX, mod_socket.SOCK_STREAM)
    s.bind(sock)
    s.close()
    with open(pidfile, 'w') as f:
        f.write('999999999\n')
    notes = []
    tlifecycle.claim(socket_path=sock, pidfile=pidfile, warn=notes.append)
    assert any('stale pidfile' in m for m in notes)
    assert any('orphaned socket' in m for m in notes)
    assert not os.path.exists(sock)
    srv = tserver.DnServer(socket_path=sock, conf=_conf(),
                           pidfile=pidfile).start()
    try:
        assert tlifecycle.probe(socket_path=sock)
    finally:
        srv.stop()
    assert not os.path.exists(sock)
    assert not os.path.exists(pidfile)


def test_claim_refuses_live_server(tmp_path):
    sock = str(tmp_path / 'live.sock')
    srv = tserver.DnServer(socket_path=sock, conf=_conf()).start()
    try:
        with pytest.raises(DNError) as ei:
            tlifecycle.claim(socket_path=sock)
        assert 'already running' in str(ei.value)
    finally:
        srv.stop()


def test_sigterm_drain_completes_inflight(corpus, tmp_path):
    """The daemon (`python -m dragnet_tpu_torch serve`): SIGTERM
    mid-request stops accepting, FINISHES the in-flight request,
    unlinks the socket, and exits 0."""
    sock = str(tmp_path / 'daemon.sock')
    env = dict(os.environ, DN_SERVE_TEST_OPS='1', DN_TORCH_DEVICE='cpu')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'dragnet_tpu_torch', 'serve', '--socket',
         sock], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 90
        while not tlifecycle.probe(socket_path=sock):
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline
            time.sleep(0.1)
        result = {}

        def inflight():
            result['r'] = tclient.request_bytes(
                sock, {'op': '_sleep', 'ms': 1200}, timeout_s=30)

        t = threading.Thread(target=inflight)
        t.start()
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=30)
        assert 'r' in result, 'in-flight request was dropped'
        assert result['r'][0] == 0
        assert proc.wait(timeout=30) == 0
        assert not os.path.exists(sock)
        assert not os.path.exists(sock + '.pid')
        assert b'device cpu' in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- dn serve --validate ------------------------------------------------------

def test_serve_validate_ok(monkeypatch):
    monkeypatch.setenv('DN_SERVE_MAX_INFLIGHT', '3')
    monkeypatch.setenv('DN_SERVE_DEADLINE_MS', '2500')
    monkeypatch.setenv('DN_DEVICE_RESIDENCY_MB', '4096')
    monkeypatch.setenv('DN_INDEX_RESIDENCY_SHARE', '0.25')
    for k in ('DN_FAULTS', 'DN_ENGINE', 'DN_DEVICE_PIPELINE_DEPTH',
              'DN_INDEX_DEVICE', 'DN_INDEX_DEVICE_BATCH_ROWS',
              'DN_SUB_MAX', 'DN_SUB_COALESCE_MS', 'DN_SUB_QUEUE_DEPTH',
              'DN_SUB_DELTA_PCT'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('DN_AUDITION_CACHE', '0')
    monkeypatch.setenv('DN_SCAN_PARTITIONS', '4')
    monkeypatch.setenv('DN_SCAN_THREADS', '2')
    rc, out, err = run_port(['serve', '--validate', '--socket',
                             '/tmp/never-bound.sock'])
    assert rc == 0, err
    assert out == (b'serve config ok: max_inflight=3 queue_depth=16 '
                   b'deadline_ms=2500 coalesce=1 drain_s=30\n'
                   b'serve front-end ok: read_deadline_ms=10000 '
                   b'write_deadline_ms=60000 idle_ms=300000\n'
                   b'serve tenancy ok: quota=0 default_weight=1 '
                   b'weights=none\n'
                   b'remote config ok: retries=2 backoff_ms=50 '
                   b'connect_timeout_s=5 deadline_ms=0\n'
                   b'obs config ok: trace=off slow_ms=off buckets=14\n'
                   b'events ok: events=0 events_file=off\n'
                   b'subscribe config ok: max=64 coalesce_ms=250 '
                   b'queue_depth=4 delta_pct=50\n'
                   b'router config ok: probe_ms=500 failures=3 '
                   b'cooldown_ms=2000 hedge_ms=0 fetch_timeout_s=60 '
                   b'partial=error\n'
                   b'topo config ok: poll_ms=0 handoff_timeout_s=120 '
                   b'handoff_retries=2 max_moves=2\n'
                   b'integrity config ok: verify=off scrub_interval_s=0 '
                   b'scrub_rate_mb_s=64 quarantine_max_mb=0\n'
                   b'resources config ok: disk_low_pct=10 '
                   b'disk_critical_pct=5 poll_ms=2000 mem_budget_mb=0 '
                   b'fd_headroom=64 events_file_max_mb=64\n'
                   b'device lane ok: engine=auto device=cpu '
                   b'residency_mb=4096 prewarm=1 probe_timeout_s=420 '
                   b'audition_cache=off entries=0 wins=0\n'
                   b'index device lane ok: mode=auto batch_rows=1048576 '
                   b'residency_share=0.25\n'
                   b'scan pipeline ok: pipeline_depth=2 partitions=4 '
                   b'scan_threads=2\n')


def test_serve_validate_reports_armed_faults(monkeypatch):
    monkeypatch.setenv('DN_FAULTS',
                       'sink.flush:error:0.5:7,client.recv:delay:1.0')
    rc, out, err = run_port(['serve', '--validate', '--socket',
                             '/tmp/never-bound.sock'])
    assert rc == 0
    assert (b'faults armed: client.recv:delay:1:0 '
            b'sink.flush:error:0.5:7\n') in out


@pytest.mark.parametrize('knob,value,message', [
    ('DN_FAULTS', 'nope.where:error:0.5', 'DN_FAULTS: unknown site'),
    ('DN_REMOTE_RETRIES', 'many',
     'DN_REMOTE_RETRIES: expected an integer >= 0, got "many"'),
    ('DN_SERVE_MAX_INFLIGHT', 'lots',
     'DN_SERVE_MAX_INFLIGHT: expected an integer >= 1, got "lots"'),
    ('DN_DEVICE_RESIDENCY_MB', 'big',
     'DN_DEVICE_RESIDENCY_MB: expected an integer >= 0, got "big"'),
    ('DN_DEVICE_PREWARM', 'maybe',
     'DN_DEVICE_PREWARM: expected a boolean (0/1), got "maybe"'),
    ('DN_INDEX_RESIDENCY_SHARE', '2',
     'DN_INDEX_RESIDENCY_SHARE: expected a fraction in [0, 1], got "2"'),
    ('DN_VERIFY', 'always', 'DN_VERIFY: expected "off", "open" or'),
    ('DN_ROUTER_PARTIAL', 'maybe',
     'DN_ROUTER_PARTIAL: expected "error" or "allow", got "maybe"'),
    ('DN_TOPO_POLL_MS', '-1',
     'DN_TOPO_POLL_MS: expected an integer >= 0, got "-1"'),
    ('DN_SCRUB_INTERVAL_S', 'often',
     'DN_SCRUB_INTERVAL_S: expected 0 or an integer >= 1, got "often"')])
def test_serve_validate_rejects_bad_knob(monkeypatch, knob, value,
                                         message):
    monkeypatch.setenv(knob, value)
    rc, out, err = run_port(['serve', '--validate', '--socket',
                             '/tmp/never-bound.sock'])
    assert rc == 1 and out == b''
    assert err.startswith(b'dn: ' + message.encode()), err


def test_serve_requires_exactly_one_endpoint():
    rc, out, err = run_port(['serve'])
    assert rc == 2
    assert b'exactly one of "--socket" and "--port"' in err
    rc, out, err = run_port(['serve', '--socket', '/tmp/x.sock',
                             '--port', '123'])
    assert rc == 2


def test_serve_bad_port():
    rc, out, err = run_port(['serve', '--port', 'zzz'])
    assert rc == 2
    assert b'bad value for "port"' in err


def test_tcp_endpoint_roundtrip(corpus):
    srv = tserver.DnServer(port=0, conf=_conf()).start()
    try:
        case = ['query', '-b', 'host', 'ds_dnc']
        got = run_port(_remote(case, '127.0.0.1:%d' % srv.bound_port))
        assert got == corpus['expected'][tuple(case)]
    finally:
        srv.stop()


def test_admission_coalescer_abandon_retires_dead_execution():
    """After a leader's deadline expires, abandon() wakes followers
    with the deadline error and lets NEW identical requests recompute."""
    c = tadmission.Coalescer(True)
    started = threading.Event()
    release = threading.Event()
    lease = {}
    leader_result = {}

    def leader():
        def compute():
            started.set()
            release.wait(10)
            return 'stale'
        leader_result['v'] = c.run('k', compute, lease=lease)

    t = threading.Thread(target=leader)
    t.start()
    assert started.wait(5)
    follower_err = {}

    def follower():
        try:
            c.run('k', lambda: 'unused')
        except tadmission.DeadlineError as e:
            follower_err['e'] = e

    tf = threading.Thread(target=follower)
    tf.start()
    time.sleep(0.05)
    c.abandon(lease['key'], lease['ex'])
    tf.join(5)
    assert 'e' in follower_err
    v, shared = c.run('k', lambda: 'fresh')
    assert v == 'fresh' and shared is False
    release.set()
    t.join(5)
    assert leader_result['v'] == ('stale', False)
