"""The port's fleet view and metric history on the CPU, held against the
JAX package: obs/history.py (rings, windowed rates, the snapshotter),
serve/fleet.py (merge_fleet, fleet_prometheus_text, the one-member
`fleet_stats` of a single server), serve/top.py (`render_frame`,
`dn top --once`, against a dead socket too), `dn stats --cluster`
(with --prom) and the /stats `history` section of a server started
with DN_METRICS_HISTORY_S=1.
"""

import json
import os
import sys
import time

import pytest

from dragnet_tpu import cli as jcli
from dragnet_tpu.obs import export as jexport
from dragnet_tpu.obs import history as jhistory
from dragnet_tpu.obs import metrics as jmetrics
from dragnet_tpu.serve import fleet as jfleet
from dragnet_tpu.serve import server as jserver
from dragnet_tpu.serve import top as jtop
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch.obs import export as texport
from dragnet_tpu_torch.obs import history as thistory
from dragnet_tpu_torch.obs import metrics as tmetrics
from dragnet_tpu_torch.serve import client as tclient
from dragnet_tpu_torch.serve import fleet as tfleet
from dragnet_tpu_torch.serve import server as tserver
from dragnet_tpu_torch.serve import top as ttop

PKGS = {'port': (thistory, tmetrics, texport, tfleet, ttop),
        'jax': (jhistory, jmetrics, jexport, jfleet, jtop)}


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


def _wait(cond, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while True:
        value = cond()
        if value:
            return value
        assert time.monotonic() < deadline, 'timed out waiting: ' + what
        time.sleep(0.05)


# -- history rings: one sample sequence through both packages ---------------

def _both(feed):
    """feed(history_module) -> value, for both packages."""
    return feed(thistory), feed(jhistory)


def _docs(interval_s, samples):
    """MetricHistory(interval_s) fed `samples` [(name, kind, value,
    age_s)] in both packages; their series docs.  Ages avoid whole
    seconds so no sample sits on a window edge while the two docs are
    read a few microseconds apart."""
    def feed(mod):
        h = mod.MetricHistory(interval_s)
        now = time.monotonic()
        for name, kind, value, age in samples:
            kind = {'c': mod.COUNTER_KIND, 'g': mod.GAUGE_KIND}[kind]
            h.record(name, kind, value, t=now - age)
        return h
    return _both(feed)


def test_history_rates_and_averages_equal_the_jax_package():
    samples = []
    for i in range(121):
        samples.append(('reqs', 'c', i * 10, 120.5 - i))
        samples.append(('depth', 'g', 4.0 + (i % 3), 120.5 - i))
    port, ref = _docs(1, samples)
    doc = port.series_doc()
    assert doc == ref.series_doc()
    assert abs(doc['reqs']['rate_1m'] - 10.0) < 0.5
    assert abs(doc['reqs']['rate_15m'] - 10.0) < 0.5
    assert doc['reqs']['last'] == 1200.0
    assert port.rate('reqs', '5m') == ref.rate('reqs', '5m')


@pytest.mark.parametrize('case', ['too_few', 'reset', 'capacity'])
def test_history_edges_equal_the_jax_package(case):
    if case == 'too_few':
        port, ref = _docs(1, [('reqs', 'c', 100, 0.5)])
        assert port.series_doc()['reqs']['rate_1m'] is None
        assert port.rate('reqs') is None and port.rate('nope') is None
    elif case == 'reset':
        port, ref = _docs(1, [('reqs', 'c', 5000, 30.5),
                              ('reqs', 'c', 10, 0.5)])
        assert port.series_doc()['reqs']['rate_1m'] == 0.0
    else:
        port, ref = _docs(60, [('x', 'c', i, 0.5) for i in range(1000)])
        assert port.capacity == ref.capacity == int(900 // 60) + 2
        with port._lock:
            assert len(port._series['x'][1]) == port.capacity
    assert port.series_doc() == ref.series_doc()
    p, r = port.doc(), ref.doc()
    assert p == r


def test_history_snapshotter_equals_the_jax_package():
    """One registry pass plus a provider through each package's
    snapshotter: equal history documents."""
    def feed(mod):
        hist, metrics = {thistory: (thistory, tmetrics),
                         jhistory: (jhistory, jmetrics)}[mod]
        reg = metrics.Registry()
        reg.inc('widgets_total', 3)
        reg.observe('op_ms', 12.0)
        reg.set_gauge('depth', 2.0)
        snap = hist.HistorySnapshotter(1, registry=reg, provider=lambda: {
            'serve.requests': (hist.COUNTER_KIND, 7),
            'absent': (hist.GAUGE_KIND, None)})
        snap.sample_once()
        return snap.history.doc()
    port, ref = _both(feed)
    assert port == ref
    assert port['samples'] == 1
    assert port['series']['serve.requests']['last'] == 7.0
    assert 'op_ms:p50' in port['series'] and 'absent' not in port['series']


def test_disabled_docs_equal_the_jax_package():
    assert thistory.disabled_doc() == jhistory.disabled_doc()
    assert set(thistory.disabled_doc()) == \
        set(thistory.MetricHistory(1).doc())
    assert thistory.history_interval_s({'DN_METRICS_HISTORY_S': 'x'}) == \
        jhistory.history_interval_s({'DN_METRICS_HISTORY_S': 'x'}) == 0


# -- merge_fleet / render_frame / Prometheus on canned documents ------------

def _member_stats(pkg, latencies, **extra):
    _, metrics, export, _, _ = PKGS[pkg]
    reg = metrics.Registry()
    for v in latencies:
        reg.observe('serve_op_latency_ms', v, op='query')
    doc = {'pid': 7, 'uptime_s': 12.5, 'draining': False,
           'requests': {'requests': len(latencies), 'errors': 1,
                        'shed_overloaded': 2, 'busy_rejected': 1},
           'inflight': {'active': 1, 'queued': 0},
           'metrics': export.stats_section(reg)}
    doc.update(extra)
    return doc


def _canned(pkg):
    """Stats documents for a three-member fleet: one with residency, the
    device index lane, a result cache and subscriptions; one draining
    with history rates and a repair backlog; one dead."""
    a = _member_stats(pkg, [1.5] * 90, **{
        'device': {'residency': {'enabled': True, 'hit_rate': 0.5,
                                 'hits': 3, 'misses': 3, 'bytes': 4096},
                   'index_query': {'dispatches': 4, 'shards': 12,
                                   'pinned_shard_hits': 2,
                                   'shards_per_dispatch': 3.0,
                                   'h2d_saved_bytes': 1 << 20}},
        'caches': {'results': {'enabled': True, 'hit_rate': 0.25,
                               'hits': 1, 'misses': 3}},
        'subscriptions': {'enabled': True, 'active': 2,
                          'counters': {'pushes': 9}},
        'resources': {'mode': 'ok', 'free_pct': 40.0,
                      'read_only': False},
        'rollup': {'covered_shards': 2, 'shards_queried': 8,
                   'coverage_ratio': 0.25},
        'tenants': {'tenants': {'t1': {'requests': 5, 'admitted': 5,
                                       'completed': 5}}}})
    b = _member_stats(pkg, [700.0] * 10, **{
        'draining': True,
        'history': {'enabled': True, 'series': {
            'serve_op_latency_ms{op=query}:count': {'rate_1m': 2.5},
            'serve_shed_total{reason=busy}': {'rate_1m': 0.5}}},
        'integrity': {'verify': 'open',
                      'repair': {'queued': 2, 'completed': 1,
                                 'failed': 0, 'scheduled': 3}},
        'events': {'enabled': True}})

    class FakeServer(object):
        cluster = None
        router = None
        member = 'a'

    events = {'a': [{'seq': 1, 'ts': 1400000000.0,
                     'type': 'resource.mode', 'mode': 'low'}],
              'b': [{'seq': 1, 'ts': 1400000001.0,
                     'type': 'follow.publish', 'shards': 3}]}
    return (FakeServer(), ['a', 'b', 'c'], {'a': a, 'b': b}, events,
            {'c': 'connection refused'})


def test_merge_render_and_prometheus_equal_the_jax_package():
    port = tfleet.merge_fleet(*_canned('port'), timeout_s=3)
    ref = jfleet.merge_fleet(*_canned('jax'), timeout_s=3)
    port['ts'] = ref['ts'] = 1400000002.0
    assert port == ref
    assert port['members_up'] == 2 and port['unreachable'] == ['c']
    assert not port['complete']
    lat = port['aggregate']['latency']
    assert lat['count'] == 100 and lat['p50'] < 10 and lat['p99'] >= 500
    assert port['aggregate']['device_pinned_bytes'] == 4096
    frame = ttop.render_frame(port, ansi=False)
    assert frame == jtop.render_frame(ref, ansi=False)
    assert ttop.render_frame(port) == jtop.render_frame(ref)
    assert 'members 2/3 up' in frame and 'UNREACHABLE: c' in frame
    assert 'device resid hit' in frame and 'follow.publish' in frame
    text = tfleet.fleet_prometheus_text(port)
    assert text == jfleet.fleet_prometheus_text(ref)
    assert 'dn_fleet_member_up{member="c"} 0' in text


# -- a single server: the one-member fleet, dn top, stats --cluster ----------

def _conf(**over):
    base = {'max_inflight': 4, 'queue_depth': 16, 'deadline_ms': 0,
            'coalesce': True, 'drain_s': 10, 'fleet_timeout_s': 3}
    base.update(over)
    return base


def _fixed_disk(tmp_path, monkeypatch):
    """A fixed free-space reading (50 %): a member's state in the fleet
    view must not depend on the disk the tests run on (under 10 % free
    it renders `disk-low`, with a `disk:` line above the table)."""
    sim = tmp_path / 'disk_free_pct'
    sim.write_text('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))


@pytest.fixture
def server(tmp_path, monkeypatch):
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    _fixed_disk(tmp_path, monkeypatch)
    srv = tserver.DnServer(socket_path=str(tmp_path / 'solo.sock'),
                           conf=_conf()).start()
    try:
        yield srv
    finally:
        srv.stop()


def test_fleet_single_process_degrade(server):
    """`fleet_stats` on a bare server: the one-member fleet of itself,
    complete, no epoch, its row rendered by `dn top`."""
    rc, hd, out, err = tclient.request_bytes(
        server.socket_path, {'op': 'fleet_stats'}, timeout_s=30.0)
    assert rc == 0, err
    doc = json.loads(out.decode('utf-8'))
    assert doc['version'] == tfleet.FLEET_VERSION
    assert doc['members_total'] == 1 and doc['members_up'] == 1
    assert doc['complete'] and doc['epoch'] is None
    assert doc['aggregated_by'] is None and doc['breakers'] == {}
    assert list(doc['members']) == ['local']
    assert doc['members']['local']['ok'] is True
    assert doc['aggregate']['subscriptions'] == 0
    frame = ttop.render_frame(doc, ansi=False)
    assert 'members 1/1 up' in frame
    rows = [ln for ln in frame.splitlines() if ln.startswith('local ')]
    assert len(rows) == 1 and rows[0].startswith('local      up')
    assert 'disk:' not in frame
    rc, hd, out, err = tclient.request_bytes(
        server.socket_path, {'op': 'fleet_stats', 'events': -1})
    assert rc == 1 and b'bad "events"' in err


def test_fleet_device_rows_read_residency(tmp_path, monkeypatch):
    """With residency configured the member row and the aggregate carry
    the device rows (read from the port's /stats `device` section), and
    `dn top` renders its device line."""
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    monkeypatch.setenv('DN_DEVICE_RESIDENCY_MB', '16')
    _fixed_disk(tmp_path, monkeypatch)
    srv = tserver.DnServer(socket_path=str(tmp_path / 'r.sock'),
                           conf=_conf()).start()
    try:
        doc = ttop.fetch_fleet(srv.socket_path)
        row = doc['members']['local']
        assert row['device_residency_hit_rate'] is not None
        assert row['device_pinned_bytes'] == 0
        assert doc['aggregate']['device_pinned_bytes'] == 0
        assert 'device resid hit' in ttop.render_frame(doc, ansi=False)
    finally:
        srv.stop()


def test_dn_top_once_renders_fleet_frame(server):
    rc, out, err = run_port(['top', '--remote', server.socket_path,
                             '--once'])
    assert rc == 0, err
    text = out.decode('utf-8')
    assert '\x1b[' not in text
    assert 'members 1/1 up' in text
    assert any(line.startswith('local      up')
               for line in text.splitlines())


def test_dn_top_once_unreachable_is_clean(tmp_path):
    """A dead socket: rc 1, `fleet fetch failed`, no traceback — as
    bin/dn answers."""
    args = ['top', '--remote', str(tmp_path / 'nope.sock'), '--once']
    got = run_port(args)
    ref = run_ref(args)
    assert got[0] == ref[0] == 1 and got[1] == ref[1] == b''
    assert b'Traceback' not in got[2]
    assert b'fleet fetch failed' in got[2]
    assert got[2] == ref[2]


def test_dn_stats_cluster_cli_and_prom(server):
    rc, out, err = run_port(['stats', '--cluster', '--remote',
                             server.socket_path])
    assert rc == 0, err
    doc = json.loads(out.decode('utf-8'))
    assert doc['members_total'] == 1 and doc['complete'] is True
    rc, out, err = run_port(['stats', '--cluster', '--prom', '--remote',
                             server.socket_path])
    assert rc == 0, err
    text = out.decode('utf-8')
    assert 'dn_fleet_members_up 1' in text
    assert 'dn_fleet_member_up{member="local"} 1' in text
    assert 'dn_fleet_subscriptions 0' in text


def test_dn_stats_cluster_requires_remote():
    got = run_port(['stats', '--cluster'])
    assert got == run_ref(['stats', '--cluster'])
    assert got[0] == 1 and b'requires "--remote"' in got[2]


def test_stats_history_section(tmp_path, monkeypatch):
    """DN_METRICS_HISTORY_S=1 arms the snapshotter: /stats `history`
    has the qps series (the request counter and the latency
    histogram's count) and a rate once two samples are in."""
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_METRICS_HISTORY_S', '1')
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    data = tmp_path / 'data.log'
    data.write_text(''.join(
        json.dumps({'host': 'h%d' % (i % 3), 'latency': i}) + '\n'
        for i in range(20)))
    assert run_port(['datasource-add', '--path', str(data), 'hds'])[0] == 0
    srv = tserver.DnServer(socket_path=str(tmp_path / 'h.sock'),
                           conf=_conf()).start()
    try:
        # data requests feed serve_op_latency_ms, whose count is qps
        for _ in range(3):
            rc, out, err = run_port(['scan', '--remote', srv.socket_path,
                                     '-b', 'host', 'hds'])
            assert rc == 0 and b'h2' in out, err

        def sampled():
            hist = tclient.stats(srv.socket_path)['history']
            series = hist['series']
            return hist if hist['samples'] >= 2 and \
                series.get('serve.requests', {}).get('rate_1m') \
                is not None else None

        hist = _wait(sampled, 'two history samples')
        assert hist['enabled'] is True and hist['interval_s'] == 1
        assert set(hist) == set(jhistory.disabled_doc())
        assert hist['series']['serve.requests']['kind'] == 'counter'
        assert hist['series']['serve.inflight']['kind'] == 'gauge'
        assert any(k.startswith('serve_op_latency_ms') and
                   k.endswith(':count') for k in hist['series'])
        doc = ttop.fetch_fleet(srv.socket_path)
        assert doc['members']['local']['history'] is True
    finally:
        srv.stop()
    assert srv.history._thread is not None
    assert not srv.history._thread.is_alive()


def test_history_off_by_default(server):
    st = tclient.stats(server.socket_path)
    assert st['history'] == thistory.disabled_doc()
    assert server.history is None


def test_serve_validate_reports_subscribe_and_history(monkeypatch,
                                                      tmp_path):
    """`serve --validate` accepts DN_METRICS_HISTORY_S and prints the
    subscribe knobs as bin/dn does; a malformed DN_SUB_* is fatal."""
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_METRICS_HISTORY_S', '5')
    monkeypatch.setenv('DN_SUB_MAX', '3')
    sock = str(tmp_path / 'v.sock')
    rc, out, err = run_port(['serve', '--socket', sock, '--validate'])
    assert rc == 0, err
    jrc, jout, jerr = run_ref(['serve', '--socket', sock, '--validate'])
    assert jrc == 0, jerr
    line = [ln for ln in out.splitlines()
            if ln.startswith(b'subscribe config ok')]
    assert line == [ln for ln in jout.splitlines()
                    if ln.startswith(b'subscribe config ok')]
    assert line == [b'subscribe config ok: max=3 coalesce_ms=250 '
                    b'queue_depth=4 delta_pct=50']
    monkeypatch.setenv('DN_SUB_QUEUE_DEPTH', '0')
    got = run_port(['serve', '--socket', sock, '--validate'])
    ref = run_ref(['serve', '--socket', sock, '--validate'])
    assert got[0] == ref[0] == 1 and got[2] == ref[2]
    assert b'DN_SUB_QUEUE_DEPTH' in got[2]
    assert not os.path.exists(sock)


# -- three members: the fleet view of a cluster ------------------------------

def _gen_fleet_corpus(path, n=300):
    import datetime
    t0 = 1388534400
    with open(path, 'w') as f:
        for i in range(n):
            ts = datetime.datetime.fromtimestamp(
                t0 + i * 1100, datetime.timezone.utc).strftime(
                    '%Y-%m-%dT%H:%M:%S.000Z')
            f.write(json.dumps({
                'time': ts, 'host': 'host%d' % (i % 3),
                'latency': (i * 7) % 230,
            }, separators=(',', ':')) + '\n')


@pytest.fixture(scope='module')
def fleet_corpus(tmp_path_factory):
    """The reference fixture's 300 records, indexed by the JAX
    package."""
    root = tmp_path_factory.mktemp('tfleet_corpus')
    datafile = str(root / 'data.log')
    _gen_fleet_corpus(datafile)
    rc_path = str(root / 'dragnetrc.json')
    prior = os.environ.get('DRAGNET_CONFIG')
    os.environ['DRAGNET_CONFIG'] = rc_path
    try:
        for args in (['datasource-add', '--path', datafile,
                      '--index-path', str(root / 'idx'), '--time-field',
                      'time', 'fleetds'],
                     ['metric-add', '-b', 'host', 'fleetds', 'm1'],
                     ['build', 'fleetds']):
            rc, out, err = run_ref(args)
            assert rc == 0, err
        yield {'rc_path': rc_path, 'ds': 'fleetds'}
    finally:
        if prior is None:
            os.environ.pop('DRAGNET_CONFIG', None)
        else:
            os.environ['DRAGNET_CONFIG'] = prior


@pytest.fixture
def fleet(fleet_corpus, tmp_path, monkeypatch):
    """Three in-process port members with the journal and the history
    armed, fast-failing client knobs so a dead member costs
    milliseconds, and the disk reading pinned (_fixed_disk; the
    disk-low test below plants its own)."""
    from dragnet_tpu_torch.obs import events as tevents
    from dragnet_tpu_torch.serve import topology as ttopology
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DRAGNET_CONFIG', fleet_corpus['rc_path'])
    monkeypatch.setenv('DN_ROUTER_PROBE_MS', '60000')
    monkeypatch.setenv('DN_REMOTE_RETRIES', '0')
    monkeypatch.setenv('DN_REMOTE_BACKOFF_MS', '1')
    monkeypatch.setenv('DN_REMOTE_CONNECT_TIMEOUT_S', '1')
    monkeypatch.setenv('DN_EVENTS', '256')
    monkeypatch.setenv('DN_METRICS_HISTORY_S', '1')
    monkeypatch.setenv('DN_RESOURCE_POLL_MS', '50')
    _fixed_disk(tmp_path, monkeypatch)
    tevents.uninstall()
    socks = {m: str(tmp_path / ('dn-%s.sock' % m)) for m in 'abc'}
    topo_path = str(tmp_path / 'topo.json')
    with open(topo_path, 'w') as f:
        json.dump({'epoch': 1, 'assign': 'hash',
                   'members': {m: {'endpoint': socks[m]} for m in socks},
                   'partitions': [
                       {'id': 0, 'replicas': ['a', 'b']},
                       {'id': 1, 'replicas': ['b', 'c']},
                       {'id': 2, 'replicas': ['c', 'a']}]}, f)
    servers = {}
    try:
        for m in 'abc':
            servers[m] = tserver.DnServer(
                socket_path=socks[m], conf=_conf(),
                cluster=ttopology.load_topology(topo_path, member=m),
                member=m).start()
        yield {'servers': servers, 'socks': socks,
               'sim': tmp_path / 'disk_free_pct', 'events': tevents}
    finally:
        for srv in servers.values():
            srv.stop()
        tevents.uninstall()


def _fleet_query(fleet_corpus, sock):
    req = {'op': 'query', 'ds': fleet_corpus['ds'], 'interval': 'day',
           'config': fleet_corpus['rc_path'],
           'queryconfig': {'breakdowns': [
               {'name': 'host', 'field': 'host'}]},
           'opts': {}}
    return tclient.request_bytes(sock, req, timeout_s=120.0)


def test_fleet_doc_three_members_merged(fleet, fleet_corpus):
    rc, hd, out, err = _fleet_query(fleet_corpus, fleet['socks']['a'])
    assert rc == 0, err
    assert out == run_ref(['query', '-b', 'host', 'fleetds'])[1]
    rc, hd, out, err = tclient.request_bytes(
        fleet['socks']['a'], {'op': 'fleet_stats'}, timeout_s=60.0)
    assert rc == 0, err
    doc = json.loads(out.decode('utf-8'))
    assert doc['version'] == tfleet.FLEET_VERSION == jfleet.FLEET_VERSION
    assert doc['members_total'] == 3 and doc['members_up'] == 3
    assert doc['complete'] and doc['unreachable'] == []
    assert doc['epoch'] == 1 and doc['epoch_skew'] == 0
    assert set(doc['members']) == {'a', 'b', 'c'}
    for name, row in doc['members'].items():
        assert row['ok'] and row['epoch'] == 1, name
        assert row['history'] and row['events'], name
    assert set(doc['epochs']) == {'a', 'b', 'c'}
    agg = doc['aggregate']
    member_counts = 0
    for m in 'abc':
        hists = tclient.stats(fleet['socks'][m])['metrics']['histograms']
        member_counts += sum(ent['count'] for name, ent in hists.items()
                             if name.startswith('serve_op_latency_ms'))
    assert agg['latency']['count'] == member_counts
    assert agg['requests'] >= 3
    assert set(doc['breakers']) == {'a', 'b', 'c'}
    # the same document renders to the same frame in both packages
    assert ttop.render_frame(doc, ansi=False) == \
        jtop.render_frame(doc, ansi=False)


def test_fleet_doc_dead_member_unreachable_not_hang(fleet, fleet_corpus):
    rc, hd, out, err = _fleet_query(fleet_corpus, fleet['socks']['a'])
    assert rc == 0, err
    fleet['servers']['b'].stop()
    t0 = time.monotonic()
    rc, hd, out, err = tclient.request_bytes(
        fleet['socks']['a'], {'op': 'fleet_stats'}, timeout_s=60.0)
    assert rc == 0, err
    assert time.monotonic() - t0 < _conf()['fleet_timeout_s'] + 10
    doc = json.loads(out.decode('utf-8'))
    assert doc['members_up'] == 2 and doc['unreachable'] == ['b']
    assert not doc['complete']
    row = doc['members']['b']
    assert row == {'ok': False, 'unreachable': True,
                   'error': row['error']} and row['error']
    assert doc['members']['a']['ok'] and doc['members']['c']['ok']
    assert doc['aggregate']['latency'] is not None


def test_fleet_events_merged_and_deduped(fleet):
    fleet['events'].emit('router.failover', partition=9, to='c')
    rc, hd, out, err = tclient.request_bytes(
        fleet['socks']['a'], {'op': 'fleet_stats', 'events': 20},
        timeout_s=60.0)
    assert rc == 0, err
    doc = json.loads(out.decode('utf-8'))
    evs = [e for e in doc['events'] if e['type'] == 'router.failover'
           and e.get('partition') == 9]
    assert len(evs) == 1 and evs[0]['member'] == 'a'


def test_dn_stats_cluster_three_members_cli_and_prom(fleet):
    rc, out, err = run_port(['stats', '--cluster', '--remote',
                             fleet['socks']['b']])
    assert rc == 0, err
    doc = json.loads(out.decode('utf-8'))
    assert doc['members_total'] == 3 and doc['aggregated_by'] == 'b'
    rc, out, err = run_port(['stats', '--cluster', '--prom', '--remote',
                             fleet['socks']['b']])
    assert rc == 0, err
    text = out.decode('utf-8')
    assert 'dn_fleet_members_up 3' in text
    for m in 'abc':
        assert 'dn_fleet_member_up{member="%s"} 1' % m in text
    assert jfleet.fleet_prometheus_text(doc) == \
        tfleet.fleet_prometheus_text(doc)


def test_dn_top_once_renders_three_members(fleet, fleet_corpus):
    import re
    rc, hd, out, err = _fleet_query(fleet_corpus, fleet['socks']['a'])
    assert rc == 0, err
    fleet['events'].emit('topo.commit', epoch=1)
    rc, out, err = run_port(['top', '--remote', fleet['socks']['a'],
                             '--once'])
    assert rc == 0, err
    text = out.decode('utf-8')
    assert '\x1b[' not in text
    assert 'members 3/3 up' in text
    for m in 'abc':
        assert re.search(r'^%s +up' % m, text, re.M), m
    assert 'topo.commit' in text


def test_dn_top_renders_disk_low(fleet, fleet_corpus):
    """A planted `low` reading (7 % free, under DN_DISK_LOW_PCT): every
    member renders `disk-low` with the `disk:` line, as the JAX
    package's top renders the same document; back at 50 %, `up`."""
    import re
    fleet['sim'].write_text('7\n')
    for srv in fleet['servers'].values():
        _wait(lambda: srv.governor.mode() == 'low', 'governor low')
    doc = ttop.fetch_fleet(fleet['socks']['a'])
    frame = ttop.render_frame(doc, ansi=False)
    assert frame == jtop.render_frame(doc, ansi=False)
    for m in 'abc':
        assert re.search(r'^%s +disk-low' % m, frame, re.M), frame
    assert 'disk:' in frame
    fleet['sim'].write_text('50\n')
    for srv in fleet['servers'].values():
        _wait(lambda: srv.governor.mode() == 'ok', 'governor ok')
    rc, out, err = run_port(['top', '--remote', fleet['socks']['a'],
                             '--once'])
    assert rc == 0 and b'members 3/3 up' in out
    assert b'disk-low' not in out
