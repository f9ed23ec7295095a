"""The port's scrub, quarantine and self-repair on the CPU, held against
the JAX package: integrity.py's scrub walk (scrub_tree, RateLimiter,
iter_tree_shards, quarantine_clean), `dn scrub` and `dn quarantine`,
serve/scrub.py (the repair manager with its governor gate, the `scrub`
op with anti-entropy, the scrub and maintenance threads), and the
cluster's detect -> failover -> repair contract on private member trees.

Every fixture that starts members pins the disk reading through
DN_DISK_SIM_FILE (50 % free): under DN_DISK_LOW_PCT the governor reports
`low`, which holds the repair queue, and the outcome would depend on the
disk the tests run on.  test_repair_pauses_under_low_disk_and_resumes
plants a `low` reading to show that gate working.
"""

import json
import os
import shutil
import sys
import time

import pytest

from dragnet_tpu import cli as jcli
from dragnet_tpu import integrity as jintegrity
from dragnet_tpu import query as jquery
from dragnet_tpu.datasource_file import DatasourceFile as JDatasourceFile
from dragnet_tpu.serve import server as jserver
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch import index_journal as tjournal
from dragnet_tpu_torch import index_query_mt as tiqmt
from dragnet_tpu_torch import integrity as tintegrity
from dragnet_tpu_torch.serve import client as tclient
from dragnet_tpu_torch.serve import scrub as tscrub
from dragnet_tpu_torch.serve import server as tserver
from dragnet_tpu_torch.serve import topology as ttopology


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


def _make_data(path, n=1500, days=5):
    import datetime
    t0 = 1388534400  # 2014-01-01T00:00:00Z
    with open(path, 'w') as f:
        for i in range(n):
            ts = datetime.datetime.utcfromtimestamp(
                t0 + (i * 4999) % (days * 86400)).strftime(
                    '%Y-%m-%dT%H:%M:%S.000Z')
            f.write(json.dumps({
                'time': ts, 'host': 'host%d' % (i % 4),
                'latency': (i * 7) % 230,
            }, separators=(',', ':')) + '\n')


def _flip_byte(path, off=None):
    size = os.path.getsize(path)
    off = size // 2 if off is None else off
    with open(path, 'r+b') as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x5a]))


@pytest.fixture(autouse=True)
def fresh_state():
    tiqmt.shard_cache_clear()
    tintegrity.reset_memo()
    jintegrity.reset_memo()
    yield
    tiqmt.shard_cache_clear()
    tintegrity.reset_memo()
    jintegrity.reset_memo()


@pytest.fixture
def twin(tmp_path, monkeypatch):
    """One day-tree built by the JAX package (the reference fixture's
    1,500 records over 5 days), copied twice: one copy for each
    package's scrub."""
    monkeypatch.delenv('DN_VERIFY', raising=False)
    datafile = str(tmp_path / 'data.log')
    _make_data(datafile)
    idx = str(tmp_path / 'idx')
    ds = JDatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': datafile, 'timeField': 'time',
                              'indexPath': idx},
        'ds_filter': None, 'ds_format': 'json'})
    metric = jquery.metric_deserialize({'name': 'm', 'breakdowns': [
        {'name': 'ts', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 86400},
        {'name': 'host', 'field': 'host'},
        {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]})
    ds.build([metric], 'day')
    trees = {}
    for name in ('port', 'jax'):
        trees[name] = str(tmp_path / name / 'idx')
        shutil.copytree(idx, trees[name])
    return trees


def _damage(tree):
    """Flip a byte of the first catalogued shard and delete the
    second; returns the catalog's sorted relpaths."""
    rels = sorted(tintegrity.load_catalog(tree))
    _flip_byte(os.path.join(tree, rels[0]))
    os.unlink(os.path.join(tree, rels[1]))
    return rels


def test_iter_tree_shards_equals_the_jax_package(twin):
    assert [rel for rel, path in tintegrity.iter_tree_shards(
        twin['port'])] == [rel for rel, path in
                           jintegrity.iter_tree_shards(twin['jax'])]
    assert len(list(tintegrity.iter_tree_shards(twin['port']))) == 5


@pytest.mark.parametrize('steps', [
    [{}],
    [{'quarantine': False}, {}, {'forget_missing': True}],
    [{'forget_missing': True}, {}],
])
def test_scrub_tree_equals_the_jax_package(twin, steps):
    """The same sequence of scrub passes over twin damaged trees: the
    same summaries, the same tree left behind (shards, catalog,
    quarantined names)."""
    damaged = len(steps) > 1
    if damaged:
        for tree in twin.values():
            _damage(tree)
    for kw in steps:
        port = tintegrity.scrub_tree(twin['port'], **kw)
        ref = jintegrity.scrub_tree(twin['jax'], **kw)
        assert port == ref, kw
    assert tintegrity.load_catalog(twin['port']) == \
        jintegrity.load_catalog(twin['jax'])
    assert sorted(os.listdir(twin['port'])) == \
        sorted(os.listdir(twin['jax']))
    qdir = tjournal.QUARANTINE_DIR
    if damaged:
        assert sorted(n for n, s, a, p in tintegrity.quarantine_entries(
            twin['port'])) == sorted(
                n for n, s, a, p in jintegrity.quarantine_entries(
                    twin['jax']))
        assert os.listdir(os.path.join(twin['port'], qdir))
    else:
        assert port['corrupt'] == port['missing'] == 0
        assert port['verified'] == 5


def test_rate_limiter_bounds_the_read_rate(twin):
    """RateLimiter: a bounded pass reads at most its rate (plus one
    chunk of slack); an unbounded one never sleeps."""
    total = sum(os.path.getsize(p) for r, p in
                tintegrity.iter_tree_shards(twin['port']))
    rate = max(1, total // 2)
    t0 = time.monotonic()
    res = tintegrity.scrub_tree(twin['port'], rate_bytes_s=rate)
    took = time.monotonic() - t0
    assert res['bytes_read'] == total
    assert took >= (total - (1 << 20)) / float(rate) * 0.9
    lim = tintegrity.RateLimiter(0)
    t0 = time.monotonic()
    lim.consume(1 << 30)
    assert time.monotonic() - t0 < 0.1


@pytest.mark.parametrize('kw', [{}, {'older_than_s': 86400},
                                {'max_bytes': 0}, {'max_bytes': 1 << 30}])
def test_quarantine_clean_equals_the_jax_package(twin, kw):
    for name, integ in (('port', tintegrity), ('jax', jintegrity)):
        _damage(twin[name])
        integ.scrub_tree(twin[name])
    port = tintegrity.quarantine_clean(twin['port'], **kw)
    ref = jintegrity.quarantine_clean(twin['jax'], **kw)
    assert port == ref
    assert tintegrity.quarantine_stats(twin['port']) == \
        jintegrity.quarantine_stats(twin['jax'])


def test_scrub_and_quarantine_cli_equal_the_jax_package(twin):
    """`dn scrub --tree` (clean, damaged, --check, --forget-missing)
    and `dn quarantine list|clean` through both CLIs on twin trees:
    the same rc and bytes, paths aside."""
    def run_all(run, tree):
        outs = [run(['scrub', '--tree', tree])]
        rels = _damage(tree)
        for args in (['scrub', '--check', '--tree', tree],
                     ['scrub', '--tree', tree],
                     ['quarantine', 'list', '--tree', tree],
                     ['quarantine', 'clean', '--tree', tree,
                      '--older-than', '1d'],
                     ['scrub', '--forget-missing', '--tree', tree],
                     ['quarantine', 'clean', '--tree', tree],
                     ['quarantine', 'list', '--tree', tree],
                     ['quarantine', 'frob', '--tree', tree],
                     ['scrub', '--repair', '--tree', tree]):
            outs.append(run(args))
        return [(rc, out.replace(tree.encode(), b'<tree>'),
                 err.replace(tree.encode(), b'<tree>'))
                for rc, out, err in outs], rels
    port, rels = run_all(run_port, twin['port'])
    ref, _ = run_all(run_ref, twin['jax'])
    for i, (p, r) in enumerate(zip(port, ref)):
        if p[0] == 2:
            # usage errors: each CLI prints its own usage text
            assert r[0] == 2 and p[1] == r[1]
            assert p[2].split(b'\n')[0] == r[2].split(b'\n')[0]
        else:
            assert p == r, i
    assert port[0][0] == 0
    assert json.loads(port[0][1])['<tree>']['verified'] == 5
    assert port[1][0] == 1
    assert json.loads(port[1][1])['<tree>']['corrupt_shards'] == [rels[0]]
    assert os.path.basename(rels[0]).encode() in port[3][1]
    assert b'removed 0' in port[4][2] and b'removed 1' in port[6][2]
    assert port[7][1] == b''


def test_serve_validate_prints_integrity_line(tmp_path, monkeypatch):
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_VERIFY', 'open')
    monkeypatch.setenv('DN_SCRUB_INTERVAL_S', '45')
    monkeypatch.setenv('DN_QUARANTINE_MAX_MB', '7')
    args = ['serve', '--socket', str(tmp_path / 's.sock'), '--validate']
    rc, out, err = run_port(args)
    assert rc == 0, err
    line = [ln for ln in out.split(b'\n')
            if ln.startswith(b'integrity config ok:')]
    assert line == [ln for ln in run_ref(args)[1].split(b'\n')
                    if ln.startswith(b'integrity config ok:')]
    assert line == [b'integrity config ok: verify=open '
                    b'scrub_interval_s=45 scrub_rate_mb_s=64 '
                    b'quarantine_max_mb=7']
    for knob, bad in (('DN_VERIFY', 'bogus'),
                      ('DN_SCRUB_RATE_MB_S', '-1'),
                      ('DN_COMPACT_MIN_GENS', '-3')):
        monkeypatch.setenv(knob, bad)
        port, ref = run_port(args), run_ref(args)
        assert port[0] == ref[0] == 1
        assert port[2] == ref[2] and knob.encode() in port[2]
        monkeypatch.delenv(knob)


# -- the serve threads --------------------------------------------------------

def _solo(tmp_path, monkeypatch, twin):
    """A single server over the port's twin tree (its datasource in a
    private config)."""
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    sim = tmp_path / 'disk_free_pct'
    sim.write_text('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))
    rc_path = str(tmp_path / 'rc_solo.json')
    monkeypatch.setenv('DRAGNET_CONFIG', rc_path)
    rc, out, err = run_port(['datasource-add', '--path',
                             str(tmp_path / 'data.log'), '--index-path',
                             twin['port'], '--time-field', 'time', 'ds'])
    assert rc == 0, err
    return rc_path


def _wait(cond, what, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while True:
        value = cond()
        if value:
            return value
        assert time.monotonic() < deadline, 'timed out waiting: ' + what
        time.sleep(0.05)


def test_scrub_thread_and_scrub_op(tmp_path, monkeypatch, twin):
    """DN_SCRUB_INTERVAL_S starts the background scrub (its pass shows
    in /stats integrity.scrub), and the `scrub` op (`dn scrub --remote`)
    verifies the tree under the server: a damaged shard is reported,
    quarantined, and the rc says dirty."""
    _solo(tmp_path, monkeypatch, twin)
    monkeypatch.setenv('DN_SCRUB_INTERVAL_S', '1')
    sock = str(tmp_path / 'solo.sock')
    srv = tserver.DnServer(socket_path=sock).start()
    try:
        assert srv.scrubber is not None
        st = _wait(lambda: (tclient.stats(sock)['integrity']['scrub']
                            or {}).get('runs'), 'a scrub pass')
        assert st >= 1
        last = tclient.stats(sock)['integrity']['scrub']['last']
        assert last['trees']['ds']['verified'] == 5
        rc, out, err = run_port(['scrub', '--remote', sock])
        assert rc == 0, err
        doc = json.loads(out)
        assert doc['trees']['ds']['verified'] == 5
        assert doc['trees']['ds']['corrupt'] == 0
        rel = sorted(tintegrity.load_catalog(twin['port']))[0]
        _flip_byte(os.path.join(twin['port'], rel))
        rc, out, err = run_port(['scrub', '--remote', sock, '--check'])
        assert rc == 1
        assert json.loads(out)['trees']['ds']['corrupt_shards'] == [rel]
        assert os.path.exists(os.path.join(twin['port'], rel))
        rc, out, err = run_port(['scrub', '--remote', sock])
        assert rc == 1
        assert not os.path.exists(os.path.join(twin['port'], rel))
        # a single member has no co-replica: nothing repairs
        assert tclient.stats(sock)['integrity']['repair'][
            'scheduled'] == 0
    finally:
        srv.stop()


def test_maintenance_thread_runs_compaction_and_rollups(tmp_path,
                                                        monkeypatch,
                                                        twin):
    """DN_ROLLUP_INTERVAL_S / DN_COMPACT_INTERVAL_S start the
    maintenance thread: its passes show in /stats `maintenance`."""
    _solo(tmp_path, monkeypatch, twin)
    monkeypatch.setenv('DN_ROLLUP_INTERVAL_S', '1')
    monkeypatch.setenv('DN_COMPACT_INTERVAL_S', '1')
    sock = str(tmp_path / 'solo.sock')
    srv = tserver.DnServer(socket_path=sock).start()
    try:
        assert srv.maintainer is not None
        m = _wait(lambda: (lambda d: d if d and d.get('runs')
                           else None)(tclient.stats(sock)['maintenance']),
                  'a maintenance pass')
        assert m['runs'] >= 1 and m['last_error'] is None
        assert m['rollup_interval_s'] == m['compact_interval_s'] == 1
    finally:
        srv.stop()


# -- cluster self-healing -----------------------------------------------------

@pytest.fixture
def healing_cluster(tmp_path, monkeypatch):
    """Three in-process port members with PRIVATE byte-identical trees
    (members[].config), DN_VERIFY=open: detect -> failover ->
    background repair.  The tree is built by the JAX package."""
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    sim = tmp_path / 'disk_free_pct'
    sim.write_text('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))
    monkeypatch.setenv('DN_ROUTER_PROBE_MS', '60000')
    monkeypatch.setenv('DN_REMOTE_RETRIES', '1')
    monkeypatch.setenv('DN_REMOTE_BACKOFF_MS', '1')
    monkeypatch.setenv('DN_REMOTE_CONNECT_TIMEOUT_S', '2')
    monkeypatch.setenv('DN_RESOURCE_POLL_MS', '50')
    monkeypatch.delenv('DN_VERIFY', raising=False)
    root = tmp_path
    datafile = str(root / 'data.log')
    _make_data(datafile, n=1200)
    rc_path = str(root / 'dragnetrc.json')
    monkeypatch.setenv('DRAGNET_CONFIG', rc_path)
    idx = str(root / 'idx')
    for args in (['datasource-add', '--path', datafile, '--index-path',
                  idx, '--time-field', 'time', 'ds1'],
                 ['metric-add', '-b', 'host', 'ds1', 'm1'],
                 ['build', 'ds1']):
        rc, out, err = run_ref(args)
        assert rc == 0, err
    rc, gold_ref, err = run_ref(['query', '-b', 'host', 'ds1'])
    assert rc == 0, err
    doc = json.load(open(rc_path))
    member_rc = {}
    for m in 'abc':
        shutil.copytree(idx, str(root / ('idx_' + m)))
        d2 = json.loads(json.dumps(doc))
        d2['datasources'][0]['backend_config']['indexPath'] = \
            str(root / ('idx_' + m))
        p = str(root / ('rc_%s.json' % m))
        with open(p, 'w') as f:
            json.dump(d2, f)
        member_rc[m] = p
    socks = {m: str(root / ('dn-%s.sock' % m)) for m in 'abc'}
    topo_path = str(root / 'topo.json')
    with open(topo_path, 'w') as f:
        json.dump({
            'epoch': 1, 'assign': 'hash',
            'members': {m: {'endpoint': socks[m],
                            'config': member_rc[m]} for m in 'abc'},
            'partitions': [
                {'id': 0, 'replicas': ['a', 'b']},
                {'id': 1, 'replicas': ['b', 'c']},
                {'id': 2, 'replicas': ['c', 'a']},
            ]}, f)
    conf = {'max_inflight': 4, 'queue_depth': 16, 'deadline_ms': 0,
            'coalesce': True, 'drain_s': 10, 'fleet_timeout_s': 3}
    servers = {}
    try:
        for m in 'abc':
            topo = ttopology.load_topology(topo_path, member=m)
            servers[m] = tserver.DnServer(
                socket_path=socks[m], conf=dict(conf), cluster=topo,
                member=m).start()
        monkeypatch.setenv('DN_VERIFY', 'open')
        tintegrity.reset_memo()
        yield {'servers': servers, 'socks': socks, 'sim': sim,
               'rc_path': rc_path, 'root': str(root),
               'topo_path': topo_path, 'member_rc': member_rc,
               'gold': gold_ref}
    finally:
        for srv in servers.values():
            srv.stop()


def _routed_query(cluster, via='a'):
    req = {'op': 'query', 'ds': 'ds1', 'config': cluster['rc_path'],
           'queryconfig': {'breakdowns': [{'name': 'host',
                                           'field': 'host'}]},
           'interval': 'day', 'opts': {}}
    return tclient.request_bytes(cluster['socks'][via], req,
                                 timeout_s=30)


def _shard_of(cluster, member, pids):
    idx = os.path.join(cluster['root'], 'idx_' + member)
    topo = cluster['servers']['a'].cluster
    catalog = tintegrity.load_catalog(idx)
    for rel in sorted(catalog):
        if topo.partition_of(os.path.join(idx, rel),
                             tscrub.rel_timeformat(rel)) in pids:
            return idx, rel, catalog[rel]
    raise AssertionError('no shard of %s in %s' % (pids, idx))


def _wait_healed(path, expected, timeout_s=25.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            if tintegrity.file_crc(path) == expected:
                return True
        except OSError:
            pass
        time.sleep(0.1)
    return False


def test_cluster_detect_failover_and_self_heal(healing_cluster):
    """A corrupt shard on member b (partition 1, which the router a
    does not replicate): b rejects retryably, a fails over to c — the
    routed bytes equal the JAX package's CLI — and b repairs itself
    from its co-replica, byte-equal to the donor's shard."""
    cl = healing_cluster
    rc, hdr, gold, err = _routed_query(cl)
    assert rc == 0, err
    assert gold == cl['gold']
    idx_b, rel, expected = _shard_of(cl, 'b', {1})
    shard = os.path.join(idx_b, rel)
    _flip_byte(shard)
    tiqmt.shard_cache_clear()
    rc, hdr, out, err = _routed_query(cl)
    assert rc == 0, err
    assert out == cl['gold']
    assert _wait_healed(shard, expected), 'repair never landed'
    with open(shard, 'rb') as f, \
            open(os.path.join(cl['root'], 'idx_c', rel), 'rb') as g:
        assert f.read() == g.read()
    assert tintegrity.load_catalog(idx_b)[rel] == expected
    doc_b = tclient.stats(cl['socks']['b'], timeout_s=10)
    rep = doc_b['integrity']['repair']
    assert rep['completed'] >= 1 and rep['scheduled'] >= 1
    assert doc_b['integrity']['corrupt_shards'] >= 1
    assert doc_b['recovery']['quarantine_files'] >= 1
    doc_a = tclient.stats(cl['socks']['a'], timeout_s=10)
    assert doc_a['cluster']['counters']['corrupt_failovers'] >= 1
    rc, hdr, out, err = _routed_query(cl)
    assert rc == 0 and out == cl['gold']
    # the forensics stay until an operator cleans them
    rc, out, err = run_port(['quarantine', 'list', '--tree', idx_b])
    assert rc == 0 and os.path.basename(rel).encode() in out


def test_cluster_local_detect_self_heals(healing_cluster):
    """The router's OWN partial hitting a corrupt shard schedules the
    repair too (the detect-time hook in _local_partial)."""
    cl = healing_cluster
    rc, hdr, gold, err = _routed_query(cl)
    assert rc == 0, err
    topo = cl['servers']['a'].cluster
    idx_a, rel, expected = _shard_of(cl, 'a', set(topo.partitions_of('a')))
    shard = os.path.join(idx_a, rel)
    _flip_byte(shard)
    tiqmt.shard_cache_clear()
    rc, hdr, out, err = _routed_query(cl)
    assert rc == 0 and out == cl['gold']
    assert _wait_healed(shard, expected), 'repair never landed'


def test_repair_pauses_under_low_disk_and_resumes(healing_cluster):
    """A `low` reading on b holds its queued repair (the shard stays
    quarantined, routed bytes still equal through failover); a reading
    back above the watermark lands it, as the JAX package's gate
    does."""
    cl = healing_cluster
    cl['sim'].write_text('7\n')
    srv_b = cl['servers']['b']
    _wait(lambda: srv_b.governor.mode() == 'low', 'governor low')
    idx_b, rel, expected = _shard_of(cl, 'b', {1})
    shard = os.path.join(idx_b, rel)
    _flip_byte(shard)
    tiqmt.shard_cache_clear()
    rc, hdr, out, err = _routed_query(cl)
    assert rc == 0 and out == cl['gold']
    _wait(lambda: srv_b.repair.stats()['scheduled'] >= 1, 'scheduled')
    time.sleep(1.5)
    st = srv_b.repair.stats()
    assert st['completed'] == 0 and st['queued'] == 1
    assert not os.path.exists(shard)
    cl['sim'].write_text('50\n')
    assert _wait_healed(shard, expected), 'repair never resumed'
    assert srv_b.repair.stats()['completed'] == 1


def test_remote_scrub_clean_cluster_reports_zero_diffs(healing_cluster):
    cl = healing_cluster
    rc, out, err = run_port(['scrub', '--remote', cl['socks']['c']])
    assert rc == 0, err
    doc = json.loads(out)
    t = doc['trees']['ds1']
    assert t['corrupt'] == 0 and t['missing'] == 0
    assert t['verified'] == len(tintegrity.load_catalog(
        os.path.join(cl['root'], 'idx_c')))
    ae = doc['anti_entropy']['ds1']
    assert ae['pulled'] == 0 and ae['diverged'] == 0
    assert ae['checked'] > 0


def test_anti_entropy_pulls_lost_shard(healing_cluster):
    """A member that lost a shard AND its catalog entry gets it back
    from a co-replica's manifest through the scrub op."""
    cl = healing_cluster
    idx_b, rel, expected = _shard_of(cl, 'b', {1})
    shard = os.path.join(idx_b, rel)
    os.unlink(shard)
    tintegrity.update_catalog(idx_b, remove=[rel])
    tiqmt.shard_cache_clear()
    tintegrity.reset_memo()
    rc, out, err = run_port(['scrub', '--remote', cl['socks']['b'],
                             '--repair'])
    doc = json.loads(out)
    assert doc['anti_entropy']['ds1']['pulled'] >= 1
    assert tintegrity.file_crc(shard) == expected
    assert tintegrity.load_catalog(idx_b)[rel] == expected


def test_offline_scrub_repair_from_co_replicas(healing_cluster,
                                               monkeypatch):
    """`dn scrub --repair --cluster T --member b` (the offline leg):
    the corrupt and the missing shard are pulled from the running
    co-replicas, byte-equal, rc 0."""
    cl = healing_cluster
    monkeypatch.setenv('DRAGNET_CONFIG', cl['member_rc']['b'])
    idx_b = os.path.join(cl['root'], 'idx_b')
    catalog = tintegrity.load_catalog(idx_b)
    topo = cl['servers']['a'].cluster
    mine = [r for r in sorted(catalog)
            if topo.partition_of(os.path.join(idx_b, r),
                                 tscrub.rel_timeformat(r)) in (0, 1)]
    _flip_byte(os.path.join(idx_b, mine[0]))
    os.unlink(os.path.join(idx_b, mine[-1]))
    rc, out, err = run_port(['scrub', '--repair', '--cluster',
                             cl['topo_path'], '--member', 'b'])
    assert rc == 0, err
    res = json.loads(out)[idx_b]
    assert res['repaired'] == 2
    for rel in (mine[0], mine[-1]):
        assert tintegrity.file_crc(os.path.join(idx_b, rel)) == \
            catalog[rel]
    rc, out, err = run_port(['scrub', '--repair', '--tree', idx_b])
    assert rc == 2 and b'needs donors' in err
