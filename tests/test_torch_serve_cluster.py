"""The port's scatter-gather cluster on the CPU, held against the JAX
package: serve/topology.py (validate_doc, partition_of, load_topology),
serve/router.py (Breaker, partial_query, the Router's failover,
hedging, ranking and degraded modes), the server's cluster branches
(query_partial, the routed query, the `cluster` /stats section, the
health op's member and epoch), the cluster dry-run plan under
DN_SERVE_TOPOLOGY, `dn serve --cluster/--member --validate`, and the
subcommand and op tables of both packages.

Three in-process members `a`, `b`, `c` over one index tree (partitions
[a,b], [b,c], [c,a]), each on DN_TORCH_DEVICE=cpu; every routed byte is
held against the JAX package's single-process CLI.
"""

import ast
import json
import os
import sys
import threading

import pytest

from dragnet_tpu import cli as jcli
from dragnet_tpu.serve import router as jrouter
from dragnet_tpu.serve import server as jserver
from dragnet_tpu.serve import topology as jtopology
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch import faults as tfaults
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.serve import client as tclient
from dragnet_tpu_torch.serve import router as trouter
from dragnet_tpu_torch.serve import server as tserver
from dragnet_tpu_torch.serve import topology as ttopology

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_port(args):
    with tserver.thread_stdio() as cap:
        rc = tcli.main(list(args))
    out, err = cap.finish()
    return rc, out, err


def run_ref(args):
    saved = sys.stdout, sys.stderr
    try:
        with jserver.thread_stdio() as cap:
            rc = jcli.main(list(args))
        out, err = cap.finish()
    finally:
        sys.stdout, sys.stderr = saved
    return rc, out, err


def _gen_corpus(path, n=400):
    import datetime
    t0 = 1388534400  # 2014-01-01T00:00:00Z
    with open(path, 'w') as f:
        for i in range(n):
            ts = datetime.datetime.utcfromtimestamp(
                t0 + i * 800).strftime('%Y-%m-%dT%H:%M:%S.000Z')
            f.write(json.dumps({
                'time': ts,
                'host': 'host%d' % (i % 3),
                'operation': ('get', 'put', 'index')[i % 3],
                'req': {'method': ('GET', 'PUT')[i % 2]},
                'latency': (i * 7) % 230,
            }, separators=(',', ':')) + '\n')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The reference fixture's 400 records, indexed by the JAX package
    at both index formats (the port's builds are byte-identical to
    them: tests/test_torch_build.py)."""
    root = tmp_path_factory.mktemp('tcluster_corpus')
    datafile = str(root / 'data.log')
    _gen_corpus(datafile)
    rc_path = str(root / 'dragnetrc.json')
    saved = {k: os.environ.get(k) for k in ('DRAGNET_CONFIG',
                                            'DN_INDEX_FORMAT')}
    os.environ['DRAGNET_CONFIG'] = rc_path
    try:
        for ds, fmt in (('ds_dnc', 'dnc'), ('ds_sq', 'sqlite')):
            idx = str(root / ('idx_' + fmt))
            for args in (['datasource-add', '--path', datafile,
                          '--index-path', idx, '--time-field', 'time',
                          ds],
                         ['metric-add', '-b',
                          'timestamp[date,field=time,aggr=lquantize,'
                          'step=86400],host,latency[aggr=quantize]',
                          ds, 'm1'],
                         ['metric-add', '-b', 'operation', '-f',
                          '{"eq": ["req.method", "GET"]}', ds, 'm2']):
                rc, out, err = run_ref(args)
                assert rc == 0, err
            os.environ['DN_INDEX_FORMAT'] = fmt
            rc, out, err = run_ref(['build', ds])
            assert rc == 0, err
        yield {'root': root, 'rc_path': rc_path,
               'dss': ['ds_dnc', 'ds_sq']}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _conf(**over):
    base = {'max_inflight': 4, 'queue_depth': 16, 'deadline_ms': 0,
            'coalesce': True, 'drain_s': 10, 'fleet_timeout_s': 3}
    base.update(over)
    return base


def _topo_doc(socks, epoch=1, assign='hash'):
    return {
        'epoch': epoch,
        'assign': assign,
        'members': {m: {'endpoint': socks[m]} for m in socks},
        'partitions': [
            {'id': 0, 'replicas': ['a', 'b']},
            {'id': 1, 'replicas': ['b', 'c']},
            {'id': 2, 'replicas': ['c', 'a']},
        ],
    }


def _write_topo(tmp_path, doc, name='topo.json'):
    path = str(tmp_path / name)
    with open(path, 'w') as f:
        if isinstance(doc, str):
            f.write(doc)
        else:
            json.dump(doc, f)
    return path


def _member_env(tmp_path, monkeypatch, corpus=None):
    """What every test that starts members sets.  The disk reading is
    pinned at 50 % free: under DN_DISK_LOW_PCT (10 %) the governor
    reports `low`, which pauses handoff pulls and repairs and renders
    a member `disk-low` — the outcome would depend on the disk the
    tests run on.  The prober is quiesced (probe_once() drives member
    state when a test needs it) and client backoff is minimal so dials
    to a dead member fail fast."""
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    sim = tmp_path / 'disk_free_pct'
    sim.write_text('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))
    monkeypatch.setenv('DN_ROUTER_PROBE_MS', '60000')
    monkeypatch.setenv('DN_REMOTE_RETRIES', '0')
    monkeypatch.setenv('DN_REMOTE_BACKOFF_MS', '1')
    monkeypatch.setenv('DN_REMOTE_CONNECT_TIMEOUT_S', '1')
    if corpus is not None:
        monkeypatch.setenv('DRAGNET_CONFIG', corpus['rc_path'])


@pytest.fixture
def cluster(corpus, tmp_path, monkeypatch):
    """Three in-process port members over one index tree."""
    _member_env(tmp_path, monkeypatch, corpus)
    socks = {m: str(tmp_path / ('dn-%s.sock' % m)) for m in 'abc'}
    topo_path = _write_topo(tmp_path, _topo_doc(socks))
    servers = {}
    try:
        for m in 'abc':
            topo = ttopology.load_topology(topo_path, member=m)
            servers[m] = tserver.DnServer(
                socket_path=socks[m], conf=_conf(), cluster=topo,
                member=m).start()
        yield {'servers': servers, 'socks': socks,
               'topo_path': topo_path}
    finally:
        for srv in servers.values():
            srv.stop()


def _query_req(ds, corpus, epoch=None, partitions=None, op='query'):
    doc = {'op': op, 'ds': ds, 'config': corpus['rc_path'],
           'queryconfig': {'breakdowns': [
               {'name': 'host', 'field': 'host'}]},
           'interval': 'day', 'opts': {}}
    if epoch is not None:
        doc['epoch'] = epoch
    if partitions is not None:
        doc['partitions'] = partitions
    return doc


def _cases(ds):
    """The reference's routed query shapes
    (tests/test_serve_cluster.py `_cases`)."""
    return [
        ['query', '-b', 'host', ds],
        ['query', '-b', 'host,latency[aggr=quantize]', ds],
        ['query', '--points', '-b', 'operation', '-f',
         '{"eq": ["req.method", "GET"]}', ds],
        ['query', '--raw', '-b', 'host,latency[aggr=quantize]',
         '-A', '2014-01-02', '-B', '2014-01-03', ds],
        ['query', '-b',
         'timestamp[date,field=time,aggr=lquantize,step=86400],host',
         ds],
    ]


def _remote(case, sock):
    return case[:1] + ['--remote', sock] + case[1:]


# -- the command and op tables ----------------------------------------------

def _ops_of(path):
    """Every op name execute() compares `op` with, read from source."""
    tree = ast.parse(open(path).read())
    ops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in (
                'execute', '_run_data', '_execute_data'):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and \
                        isinstance(sub.left, ast.Name) and \
                        sub.left.id == 'op':
                    for comp in sub.comparators:
                        for c in ast.walk(comp):
                            if isinstance(c, ast.Constant) and \
                                    isinstance(c.value, str):
                                ops.add(c.value)
    return ops


def test_port_has_every_subcommand_and_op():
    """The JAX package's CLI command table and server op set, read as
    data: the port has each one (25 subcommands, the cluster and scrub
    ops among the ops)."""
    assert len(jcli.COMMANDS) == 25
    missing = sorted(set(jcli.COMMANDS) - set(tcli.COMMANDS))
    assert missing == []
    ref_ops = _ops_of(os.path.join(ROOT, 'dragnet_tpu', 'serve',
                                   'server.py'))
    port_ops = _ops_of(os.path.join(ROOT, 'dragnet_tpu_torch', 'serve',
                                    'server.py'))
    for op in ('query_partial', 'shard_manifest', 'shard_fetch',
               'scrub', 'topology', 'fleet_stats', 'health'):
        assert op in ref_ops
    assert sorted(ref_ops - port_ops) == []
    assert not hasattr(tserver, 'UNPORTED_OPS')


# -- topology: the same documents through both packages ---------------------

def _bad_docs():
    return [
        (lambda d: d.update(epoch=0), 'epoch'),
        (lambda d: d.update(epoch='one'), 'epoch'),
        (lambda d: d.update(assign='roundrobin'), 'assign'),
        (lambda d: d.update(members={}), 'members'),
        (lambda d: d['members'].update(a={'endpoint': ''}), 'endpoint'),
        (lambda d: d.update(partitions=[]), 'partitions'),
        (lambda d: d['partitions'].append(
            {'id': 0, 'replicas': ['a']}), 'overlapping'),
        (lambda d: d['partitions'][0].update(replicas=[]), 'replicas'),
        (lambda d: d['partitions'][0].update(replicas=['a', 'a']),
         'duplicate replica'),
        (lambda d: d['partitions'][0].update(replicas=['nope']),
         'unknown member'),
        (lambda d: d.update(partitions=[
            {'id': 0, 'replicas': ['b', 'c']}]), 'owns no partition'),
        (lambda d: d.update(state='pending'), 'prev'),
        (lambda d: d.update(assign='time-range') or
         d['partitions'][0].update(after='2014-01-01',
                                   before='2014-01-03') or
         d['partitions'][1].update(after='2014-01-02',
                                   before='2014-01-04'),
         'overlapping time ranges'),
        (lambda d: d.update(assign='time-range') or
         d['partitions'][0].update(after='2014-01-05',
                                   before='2014-01-04'),
         '"before" must be after "after"'),
        (lambda d: d.update(assign='time-range') or
         d['partitions'][0].update(after='not-a-date'),
         'not a valid date'),
        (lambda d: None, None),
    ]


@pytest.mark.parametrize('i', range(len(_bad_docs())))
def test_validate_doc_equals_the_jax_package(tmp_path, i):
    """validate_doc's accept/reject and message, and load_topology's,
    on the same document in both packages."""
    mutate, needle = _bad_docs()[i]
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'abc'}
    docs = []
    for _ in range(2):
        doc = _topo_doc(socks)
        mutate(doc)
        docs.append(doc)
    port_err = ttopology.validate_doc(docs[0])
    ref_err = jtopology.validate_doc(docs[1])
    assert (port_err is None) == (ref_err is None)
    if needle is None:
        assert port_err is None
    else:
        assert port_err == ref_err
        assert needle in port_err
    path = _write_topo(tmp_path, _topo_doc(socks) if needle is None
                       else docs[0])
    out = []
    for mod in (ttopology, jtopology):
        try:
            out.append(mod.load_topology(path, member='b').summary())
        except Exception as e:   # DNError of each package
            out.append(('error', e.message))
    assert out[0] == out[1]


@pytest.mark.parametrize('text,member', [('{nope', None),
                                         (None, 'zed'),
                                         ('missing', None)])
def test_load_topology_errors_equal_the_jax_package(tmp_path, text,
                                                    member):
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'abc'}
    if text == 'missing':
        path = str(tmp_path / 'missing.json')
    else:
        path = _write_topo(tmp_path, text if text is not None
                           else _topo_doc(socks))
    msgs = []
    for mod in (ttopology, jtopology):
        with pytest.raises(Exception) as ei:
            mod.load_topology(path, member=member)
        msgs.append(ei.value.message)
    assert msgs[0] == msgs[1]


def _shard_names():
    names = ['2014-01-%02d.sqlite' % d for d in range(1, 32)]
    names += ['2014-02-%02dT%02d.sqlite' % (d, h)
              for d in range(1, 6) for h in range(24)]
    names += ['all.sqlite', 'all', '/idx/by_day/2014-01-03.sqlite',
              'weird-name', '2013-12-31.dnc']
    return names


@pytest.mark.parametrize('assign', ['hash', 'time-range'])
def test_partition_of_equals_the_jax_package(tmp_path, assign):
    """partition_of over many shard names under both rules (time-range
    with windows, its hash fallback) in both packages."""
    socks = {m: {'endpoint': str(tmp_path / m)} for m in 'abcd'}
    doc = {'epoch': 1, 'assign': assign, 'members': socks,
           'partitions': [{'id': i, 'replicas': [m]}
                          for i, m in enumerate('abcd')]}
    if assign == 'time-range':
        doc['partitions'][0].update(after='2014-01-01',
                                    before='2014-01-10')
        doc['partitions'][1].update(after='2014-01-10',
                                    before='2014-02-02T12:00:00Z')
    tdoc, jdoc = json.loads(json.dumps(doc)), json.loads(json.dumps(doc))
    assert ttopology.validate_doc(tdoc) is None
    assert jtopology.validate_doc(jdoc) is None
    port, ref = ttopology.Topology(tdoc), jtopology.Topology(jdoc)
    for fmt in (None, '%Y-%m-%d.sqlite', '%Y-%m-%dT%H.sqlite'):
        got = [port.partition_of(n, fmt) for n in _shard_names()]
        assert got == [ref.partition_of(n, fmt) for n in _shard_names()]
        assert len(set(got)) > 1
    # crc32 of the file name, never the salted hash()
    import zlib
    assert port._hash_partition('2014-01-05.sqlite') == \
        zlib.crc32(b'2014-01-05.sqlite') % 4


def test_breaker_transitions_equal_the_jax_package():
    """The same failure/success/time sequence through both packages'
    Breaker under an injected clock: the same states, admissions and
    snapshot."""
    def drive(mod):
        clock = [0.0]
        b = mod.Breaker(3, 1000, clock=lambda: clock[0])
        trail = []
        steps = ['f', 'f', 'a', 'f', 'a', 't1', 'a', 'a', 'f', 't1',
                 'a', 's', 'a', 'f', 'f', 's', 'f', 'f', 'f', 't0.5',
                 'a', 't0.6', 'a', 's']
        for step in steps:
            if step == 'f':
                b.record_failure()
            elif step == 's':
                b.record_success()
            elif step == 'a':
                trail.append(b.allow())
            else:
                clock[0] += float(step[1:])
            trail.append(b.state)
        return trail, b.snapshot()
    port, ref = drive(trouter), drive(jrouter)
    assert port == ref
    trail, snap = port
    assert snap['transitions'][trouter.Breaker.OPEN] == 3


def test_cluster_plan_reports_serve_topology(tmp_path, monkeypatch):
    """The cluster backend's dry-run plan reports the serve layout
    DN_SERVE_TOPOLOGY names, as the JAX package's does, and a broken
    map in-plan."""
    from dragnet_tpu_torch.parallel import cluster as mod_cluster
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'abc'}
    topo_path = _write_topo(tmp_path, _topo_doc(socks))
    ds = mod_cluster.DatasourceCluster({
        'ds_backend': 'cluster',
        'ds_backend_config': {'path': str(tmp_path)},
        'ds_filter': None, 'ds_format': 'json',
    })
    monkeypatch.delenv('DN_SERVE_TOPOLOGY', raising=False)
    assert 'serve_topology' not in ds.execution_plan([], device='cpu')
    monkeypatch.setenv('DN_SERVE_TOPOLOGY', topo_path)
    topo = ds.execution_plan([], device='cpu')['serve_topology']
    assert topo == jtopology.load_topology(topo_path).summary()
    assert [p['id'] for p in topo['partitions']] == [0, 1, 2]
    monkeypatch.setenv('DN_SERVE_TOPOLOGY',
                       str(tmp_path / 'missing.json'))
    broken = ds.execution_plan([], device='cpu')['serve_topology']
    assert 'error' in broken and 'missing.json' in broken['error']


# -- the member side: partial_query against the JAX package -----------------

@pytest.mark.parametrize('pids', [[0], [1], [2], [0, 1, 2]])
def test_partial_query_equals_the_jax_package(corpus, tmp_path,
                                              monkeypatch, pids):
    """partial_query's per-shard key items for a partition set, on the
    same tree and topology, in both packages (both index formats)."""
    from dragnet_tpu import config as jconfig
    from dragnet_tpu import datasource_for_name as jds_for
    from dragnet_tpu_torch import config as tconfig
    from dragnet_tpu_torch import datasource_for_name as tds_for
    monkeypatch.setenv('DRAGNET_CONFIG', corpus['rc_path'])
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'abc'}
    path = _write_topo(tmp_path, _topo_doc(socks))
    nitems = 0
    for ds in corpus['dss']:
        for case in _cases(ds):
            out = []
            for cli, config, ds_for, topology, router in (
                    (tcli, tconfig, tds_for, ttopology, trouter),
                    (jcli, jconfig, jds_for, jtopology, jrouter)):
                err, conf = config.ConfigBackendLocal(
                    corpus['rc_path']).load()
                dso = ds_for(conf, ds)
                opts = cli.dn_parse_args(case[1:-1], [
                    'before', 'after', 'filter', 'breakdowns', 'raw',
                    'points', 'interval'])
                query = cli.dn_query_config(opts)
                topo = topology.load_topology(path)
                out.append(router.partial_query(dso, query, 'day', topo,
                                                pids))
            assert out[0] == out[1], (ds, case, pids)
            nitems += sum(len(items) for relpath, items in out[0])
            for relpath, items in out[0]:
                assert topo.partition_of(relpath, '%Y-%m-%d') in pids
    # the day shards of this corpus all hash outside partition 0
    assert (nitems > 0) == (pids != [0])


# -- routed bytes -----------------------------------------------------------

def test_routed_queries_byte_identical(cluster, corpus):
    """Every query shape x both index formats x every member as router:
    routed bytes == the JAX package's single-process CLI bytes (which
    the reference's own test holds equal to its routed bytes)."""
    for ds in corpus['dss']:
        for case in _cases(ds):
            expected = run_ref(case)
            assert expected[0] == 0
            for m in 'abc':
                got = run_port(_remote(case, cluster['socks'][m]))
                assert got == expected, (m, case)


def test_cluster_stats_section(cluster, corpus):
    sock = cluster['socks']['a']
    case = _cases(corpus['dss'][0])[0]
    assert run_port(_remote(case, sock))[0] == 0
    doc = tclient.stats(sock)
    cl = doc['cluster']
    assert cl['member'] == 'a'
    assert cl['epoch'] == 1
    assert cl['partitions'] == 3
    assert cl['partitions_owned'] == [0, 2]
    assert cl['counters']['scatters'] >= 1
    assert cl['counters']['partials_local'] >= 1
    for m in 'abc':
        assert cl['members'][m]['state'] == 'closed'
    assert doc['topology']['epoch'] == 1
    assert doc['topology']['partitions_owned'] == [0, 2]
    assert doc['integrity']['repair']['completed'] == 0
    h = tclient.health(sock)
    assert h['member'] == 'a' and h['epoch'] == 1


def test_failover_dead_member_byte_identical(cluster, corpus):
    """Partition 1's primary (b) dies without the prober noticing: the
    scatter dials b, fails, fails over to c — bytes still equal the
    JAX package's, failover counted."""
    cluster['servers']['b'].stop()
    for case in _cases(corpus['dss'][0]):
        expected = run_ref(case)
        got = run_port(_remote(case, cluster['socks']['a']))
        assert got == expected, case
    cl = tclient.stats(cluster['socks']['a'])['cluster']
    assert cl['counters']['failovers'] >= 1
    assert cl['counters']['degraded'] == 0


def test_degraded_error_mode(cluster, corpus):
    """Every replica of partition 1 (b, c) dead under the default
    DN_ROUTER_PARTIAL=error: a clean retryable rc=1 naming it."""
    cluster['servers']['b'].stop()
    cluster['servers']['c'].stop()
    rc, header, out, err = tclient.request_bytes(
        cluster['socks']['a'], _query_req(corpus['dss'][0], corpus),
        timeout_s=120.0)
    assert rc == 1
    assert header['retryable'] is True
    assert header['stats']['missing_partitions'] == [1]
    assert out == b''
    text = err.decode()
    assert text.startswith('dn: ')
    assert 'partition(s) unavailable: 1' in text
    assert 'Traceback' not in text
    cl = tclient.stats(cluster['socks']['a'])['cluster']
    assert cl['counters']['degraded'] >= 1


def test_degraded_allow_mode(corpus, tmp_path, monkeypatch):
    """DN_ROUTER_PARTIAL=allow: the live partitions merge, rc=0, the
    header carries partial=true and the missing ids, stderr warns."""
    _member_env(tmp_path, monkeypatch, corpus)
    monkeypatch.setenv('DN_ROUTER_PARTIAL', 'allow')
    socks = {m: str(tmp_path / ('dn-%s.sock' % m)) for m in 'abc'}
    topo = ttopology.load_topology(
        _write_topo(tmp_path, _topo_doc(socks)), member='a')
    srv = tserver.DnServer(socket_path=socks['a'], conf=_conf(),
                           cluster=topo, member='a').start()
    try:
        rc, header, out, err = tclient.request_bytes(
            socks['a'], _query_req(corpus['dss'][0], corpus),
            timeout_s=120.0)
        assert rc == 0
        assert header['stats']['partial'] is True
        assert header['stats']['missing_partitions'] == [1]
        assert b'VALUE' in out
        assert 'partition(s) 1 unavailable' in err.decode()
    finally:
        srv.stop()


def test_epoch_mismatch_is_clean_retryable(cluster, corpus):
    rc, header, out, err = tclient.request_bytes(
        cluster['socks']['b'],
        _query_req(corpus['dss'][0], corpus, epoch=999,
                   partitions=[1], op='query_partial'), timeout_s=60.0)
    assert rc == 1
    assert header['retryable'] is True
    assert header['stats']['epoch_mismatch'] is True
    assert header['stats']['current_epoch'] == 1
    assert 'epoch mismatch' in err.decode()


def test_query_partial_shape_and_validation(cluster, corpus):
    """The op's body is partial_query's key items, the same as the JAX
    package's function on the same tree; bad partitions are refused."""
    from dragnet_tpu import config as jconfig
    from dragnet_tpu import datasource_for_name as jds_for
    req = _query_req(corpus['dss'][0], corpus, epoch=1, partitions=[1],
                     op='query_partial')
    rc, header, out, err = tclient.request_bytes(
        cluster['socks']['b'], req, timeout_s=60.0)
    assert rc == 0, err
    doc = json.loads(out.decode())
    assert doc['member'] == 'b' and doc['epoch'] == 1
    err_, conf = jconfig.ConfigBackendLocal(corpus['rc_path']).load()
    query = jcli.dn_query_config(jserver._opts_shim(req))
    expected = jrouter.partial_query(
        jds_for(conf, corpus['dss'][0]), query, 'day',
        jtopology.load_topology(cluster['topo_path']), [1])
    assert doc['shards'] == expected
    for bad in ([7], [], ['x'], None):
        req['partitions'] = bad
        rc, header, out, err = tclient.request_bytes(
            cluster['socks']['b'], req, timeout_s=60.0)
        assert rc == 1 and 'bad "partitions"' in err.decode()


def test_non_member_rejects_query_partial(corpus, tmp_path, monkeypatch):
    _member_env(tmp_path, monkeypatch, corpus)
    srv = tserver.DnServer(socket_path=str(tmp_path / 'x.sock'),
                           conf=_conf()).start()
    try:
        for op in ('query_partial', 'shard_manifest', 'shard_fetch'):
            rc, header, out, err = tclient.request_bytes(
                srv.socket_path,
                _query_req(corpus['dss'][0], corpus, epoch=1,
                           partitions=[0], op=op), timeout_s=60.0)
            assert rc == 1
            assert 'not a cluster member' in err.decode()
    finally:
        srv.stop()


# -- the breaker under faults, hedging, ranking ------------------------------

def test_breaker_opens_under_injected_health_faults(cluster, monkeypatch):
    router = cluster['servers']['a'].router
    monkeypatch.setenv('DN_FAULTS', 'member.health:error:1.0')
    try:
        for _ in range(3):
            router.probe_once()
        for m in 'bc':
            assert router.states[m].breaker.state == \
                trouter.Breaker.OPEN
        assert router.states['a'].breaker.state == \
            trouter.Breaker.CLOSED
    finally:
        monkeypatch.delenv('DN_FAULTS')
        tfaults.reset()
    for st in router.states.values():
        st.breaker._opened_at = -10.0
    router.probe_once()
    for m in 'bc':
        assert router.states[m].breaker.state == trouter.Breaker.CLOSED


def _bare_router(tmp_path, hedge_ms=0, failures=3):
    socks = {m: {'endpoint': str(tmp_path / m)} for m in 'ab'}
    doc = {'epoch': 1, 'members': socks,
           'partitions': [{'id': 0, 'replicas': ['a', 'b']}]}
    assert ttopology.validate_doc(doc) is None
    conf = {'probe_ms': 60000, 'failures': failures,
            'cooldown_ms': 1000, 'hedge_ms': hedge_ms,
            'fetch_timeout_s': 30, 'partial': 'error'}
    return trouter.Router(ttopology.Topology(doc), 'router-under-test',
                          conf=conf)


@pytest.mark.parametrize('winner', ['hedge', 'primary'])
def test_hedge_accounting(tmp_path, monkeypatch, winner):
    """A primary slower than the hedge delay: the duplicate at the next
    replica wins (hedges_won), or the primary answers first and the
    duplicate was wasted (hedges_wasted)."""
    router = _bare_router(tmp_path, hedge_ms=30)
    hedge_started = threading.Event()
    release = threading.Event()

    def fake_fetch(name, pid, req, timeout_s, force=False):
        if name == 'a':
            if winner == 'hedge':
                release.wait(10.0)
            else:
                hedge_started.wait(10.0)
            return [['primary', []]]
        hedge_started.set()
        if winner == 'primary':
            release.wait(10.0)
        return [['hedge', []]]

    monkeypatch.setattr(router, '_fetch_one', fake_fetch)
    shards = router._fetch_partition(0, {'partitions': [0]}, None,
                                     router.topo)
    release.set()
    assert shards == [[winner, []]]
    with router._lock:
        counters = dict(router._counters)
    assert counters['hedges_fired'] == 1
    assert counters['hedges_won'] == (1 if winner == 'hedge' else 0)
    assert counters['hedges_wasted'] == (1 if winner == 'primary' else 0)


def test_hedge_disabled_and_failover_exhaustion(tmp_path, monkeypatch):
    router = _bare_router(tmp_path, hedge_ms=0)
    assert router._hedge_delay_s() is None

    def fake_fetch(name, pid, req, timeout_s, force=False):
        raise DNError('member "%s": connection refused' % name)

    monkeypatch.setattr(router, '_fetch_one', fake_fetch)
    with pytest.raises(DNError) as ei:
        router._fetch_partition(0, {'partitions': [0]}, None,
                                router.topo)
    assert 'all replicas failed' in ei.value.message
    assert 'tried a,b' in ei.value.message
    with router._lock:
        assert router._counters['failovers'] == 1


def test_draining_member_demoted(tmp_path):
    """Ranking: a draining member below a healthy one, an open breaker
    last; write-shaped ranking puts a read-only member behind — the
    same orders as the JAX package's Router after the same health
    notes."""
    router = _bare_router(tmp_path)
    assert router._rank(['a', 'b']) == ['a', 'b']
    router.states['a'].note_health({'ok': True, 'draining': True})
    assert router._rank(['a', 'b']) == ['b', 'a']
    for _ in range(3):
        router.states['b'].breaker.record_failure()
    assert router.states['b'].breaker.state == trouter.Breaker.OPEN
    assert router._rank(['a', 'b']) == ['a', 'b']

    def ranks(mod_topo, mod_router):
        socks = {m: {'endpoint': str(tmp_path / m)} for m in 'abc'}
        doc = {'epoch': 1, 'members': socks,
               'partitions': [{'id': 0, 'replicas': ['a', 'b', 'c']}]}
        assert mod_topo.validate_doc(doc) is None
        r = mod_router.Router(mod_topo.Topology(doc), 'x', conf={
            'probe_ms': 60000, 'failures': 3, 'cooldown_ms': 1000,
            'hedge_ms': 0, 'fetch_timeout_s': 30, 'partial': 'error'})
        out = [r._rank(['a', 'b', 'c']),
               r.rank_for_write(['a', 'b', 'c'])]
        r.states['a'].note_health({'ok': True, 'degraded_ro': True})
        out += [r._rank(['a', 'b', 'c']),
                r.rank_for_write(['a', 'b', 'c'])]
        r.states['b'].note_health({'ok': True, 'draining': True})
        out += [r._rank(['a', 'b', 'c']),
                r.rank_for_write(['a', 'b', 'c'])]
        return out
    port = ranks(ttopology, trouter)
    assert port == ranks(jtopology, jrouter)
    assert port[3][-1] == 'a'


def test_draining_member_demoted_integration(cluster, corpus):
    cluster['servers']['b'].draining = True
    router = cluster['servers']['a'].router
    router.probe_once()
    assert router.states['b'].draining is True
    assert router._rank(['b', 'c']) == ['c', 'b']
    case = _cases(corpus['dss'][0])[0]
    assert run_port(_remote(case, cluster['socks']['a'])) == run_ref(case)
    cl = tclient.stats(cluster['socks']['a'])['cluster']
    assert cl['members']['b']['draining'] is True


def test_merge_rejects_duplicate_shard(tmp_path, monkeypatch, corpus):
    router = _bare_router(tmp_path)
    router.topo.partitions.append(
        {'id': 1, 'replicas': ['b'], 'after_ms': None,
         'before_ms': None})
    router.topo._by_id[1] = router.topo.partitions[1]

    def fake_fetch_partition(pid, req, scope, topo):
        return [['2014-01-01.sqlite', [[['host0'], 3]]]]

    monkeypatch.setattr(router, '_fetch_partition', fake_fetch_partition)
    req = _query_req(corpus['dss'][0], corpus)
    query = tcli.dn_query_config(tserver._opts_shim(req))
    with pytest.raises(DNError) as ei:
        router.scatter(None, corpus['dss'][0], query, 'day', req)
    assert 'reported by two partitions' in ei.value.message


@pytest.mark.parametrize('site', ['router.dispatch', 'router.merge'])
def test_router_fault_seams_fail_cleanly(cluster, corpus, monkeypatch,
                                         site):
    monkeypatch.setenv('DN_FAULTS', '%s:error:1.0' % site)
    try:
        rc, header, out, err = tclient.request_bytes(
            cluster['socks']['a'], _query_req(corpus['dss'][0], corpus),
            timeout_s=120.0)
        assert rc == 1
        text = err.decode()
        assert text.startswith('dn: ') and 'Traceback' not in text
        if site == 'router.dispatch':
            assert header['retryable'] is True
            assert header['stats']['missing_partitions'] == [0, 1, 2]
    finally:
        monkeypatch.delenv('DN_FAULTS')
        tfaults.reset()


# -- the CLI surface ----------------------------------------------------------

def test_serve_validate_reports_cluster(tmp_path, monkeypatch):
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'abc'}
    topo_path = _write_topo(tmp_path, _topo_doc(socks))
    for env in ({}, {'DN_SERVE_TOPOLOGY': topo_path}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        args = ['serve', '--validate', '--socket',
                str(tmp_path / 's.sock'), '--member', 'a']
        if not env:
            args += ['--cluster', topo_path]
        rc, out, err = run_port(args)
        assert rc == 0, err
        text = out.decode()
        ref = run_ref(args)[1].decode()
        for prefix in ('router config ok:', 'topo config ok:',
                       'integrity config ok:', 'cluster topology ok:'):
            line = [ln for ln in text.splitlines()
                    if ln.startswith(prefix)]
            assert line and line == [ln for ln in ref.splitlines()
                                     if ln.startswith(prefix)], prefix
        assert 'cluster topology ok: member=a epoch=1' in text
        assert 'owns: 0,2' in text


@pytest.mark.parametrize('case', ['bad_json', 'no_member', 'knob'])
def test_serve_cluster_rejections_equal_the_jax_package(tmp_path,
                                                        monkeypatch,
                                                        case):
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    sock = str(tmp_path / 's.sock')
    if case == 'bad_json':
        args = ['serve', '--validate', '--socket', sock, '--cluster',
                _write_topo(tmp_path, '{nope'), '--member', 'a']
    elif case == 'no_member':
        args = ['serve', '--socket', sock, '--cluster',
                str(tmp_path / 't.json')]
    else:
        monkeypatch.setenv('DN_ROUTER_PARTIAL', 'maybe')
        args = ['serve', '--validate', '--socket', sock]
    port, ref = run_port(args), run_ref(args)
    assert port[0] != 0 and port[0] == ref[0]
    assert port[1] == ref[1] == b''
    first = port[2].split(b'\n')[0]
    assert first == ref[2].split(b'\n')[0]
    assert {'bad_json': b'invalid JSON', 'no_member': b'together',
            'knob': b'DN_ROUTER_PARTIAL'}[case] in first
    assert not os.path.exists(sock)


def test_timed_out_exchange_keeps_a_live_pooled_connection(tmp_path,
                                                           monkeypatch):
    """A short-timeout exchange (a router's health probe starved for a
    few seconds) that times out on a pooled connection which kept
    delivering other frames leaves the connection standing: a long
    exchange in flight on it still completes.  The JAX package's pool
    invalidates the connection there and fails every exchange in flight
    on it ("connection invalidated"), which broke a routed query on the
    card when three busy members shared one process."""
    import time
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_SERVE_TEST_OPS', '1')
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    sim = tmp_path / 'disk_free_pct'
    sim.write_text('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))
    srv = tserver.DnServer(socket_path=str(tmp_path / 'p.sock'),
                           conf=_conf(max_inflight=4)).start()
    sock = srv.socket_path
    out = {}

    def slow():
        try:
            out['slow'] = tclient.request_bytes(
                sock, {'op': '_sleep', 'ms': 3000}, timeout_s=30.0,
                pooled=True)
        except Exception as e:       # the outcome the test checks
            out['slow'] = e

    def pings():
        for _ in range(12):
            tclient.request_bytes(sock, {'op': 'ping'}, timeout_s=5.0,
                                  pooled=True)
            time.sleep(0.1)
    try:
        t = threading.Thread(target=slow)
        t.start()
        time.sleep(0.3)
        p = threading.Thread(target=pings)
        p.start()
        with pytest.raises(OSError) as ei:
            tclient.request_bytes(sock, {'op': '_sleep', 'ms': 1500},
                                  timeout_s=0.5, pooled=True)
        assert 'timed out' in str(ei.value)
        p.join(30)
        t.join(30)
        assert not isinstance(out['slow'], Exception), out['slow']
        assert out['slow'][0] == 0
    finally:
        srv.stop()
