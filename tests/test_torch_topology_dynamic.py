"""The port's dynamic topology on the CPU, held against the JAX package:
serve/coordinator.py (publish, begin/commit/abort, wait_ready, the
watcher), serve/rebalance.py (shard_manifest, the handoff puller and its
governor gate, propose_moves), the server's live epoch bump, the
mid-handoff gate, the stale-router resync, the fetch faults and `dn
topo`.

Every member fixture pins the disk reading through DN_DISK_SIM_FILE
(50 % free): under DN_DISK_LOW_PCT the governor reports `low`, which
holds a handoff pull, and the outcome would depend on the disk the
tests run on.  test_handoff_pauses_under_low_disk_and_resumes plants
a `low` reading to show that gate working.
"""

import json
import os
import shutil
import sys
import time

import pytest

from dragnet_tpu import cli as jcli
from dragnet_tpu.serve import coordinator as jcoord
from dragnet_tpu.serve import rebalance as jrebalance
from dragnet_tpu.serve import server as jserver
from dragnet_tpu.serve import topology as jtopology
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch import faults as tfaults
from dragnet_tpu_torch import index_journal as tjournal
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.serve import client as tclient
from dragnet_tpu_torch.serve import coordinator as tcoord
from dragnet_tpu_torch.serve import pool as tpool
from dragnet_tpu_torch.serve import rebalance as trebalance
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
                'latency': (i * 7) % 230,
            }, separators=(',', ':')) + '\n')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The reference fixture's tree (dnc format), built once by the
    JAX package."""
    root = tmp_path_factory.mktemp('ttopo_corpus')
    datafile = str(root / 'data.log')
    _gen_corpus(datafile)
    rc_path = str(root / 'dragnetrc.json')
    saved = {k: os.environ.get(k) for k in ('DRAGNET_CONFIG',
                                            'DN_INDEX_FORMAT')}
    os.environ['DRAGNET_CONFIG'] = rc_path
    os.environ['DN_INDEX_FORMAT'] = 'dnc'
    try:
        idx = str(root / 'idx')
        for args in (['datasource-add', '--path', datafile,
                      '--index-path', idx, '--time-field', 'time', 'ds'],
                     ['metric-add', '-b', 'host,latency[aggr=quantize]',
                      'ds', 'm1'],
                     ['build', 'ds']):
            rc, out, err = run_ref(args)
            assert rc == 0, err
        yield {'root': root, 'rc_path': rc_path, 'idx': idx,
               'datafile': datafile}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _conf(**over):
    base = {'max_inflight': 4, 'queue_depth': 16, 'deadline_ms': 0,
            'coalesce': True, 'drain_s': 10}
    base.update(over)
    return base


QUERY = ['query', '-b', 'host', 'ds']


def _golden():
    rc, out, err = run_ref(QUERY)
    assert rc == 0, err
    return out


def _routed(sock):
    rc, out, err = run_port(QUERY[:1] + ['--remote', sock] + QUERY[1:])
    assert rc == 0, err
    return out


def _topo_doc(socks, epoch=1, parts=None):
    if parts is None:
        names = sorted(socks)
        parts = [{'id': i, 'replicas':
                  [names[i % len(names)], names[(i + 1) % len(names)]]}
                 for i in range(3)]
    return {'epoch': epoch, 'assign': 'hash',
            'members': {m: {'endpoint': socks[m]} for m in socks},
            'partitions': parts}


def _disk(tmp_path, monkeypatch, pct=50):
    """Pin the governor's free-space reading (see the module note)."""
    sim = tmp_path / 'disk_free_pct'
    sim.write_text('%s\n' % pct)
    monkeypatch.setenv('DN_DISK_SIM_FILE', str(sim))
    return sim


@pytest.fixture
def member_env(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DRAGNET_CONFIG', corpus['rc_path'])
    monkeypatch.setenv('DN_ROUTER_PROBE_MS', '60000')
    monkeypatch.setenv('DN_REMOTE_RETRIES', '0')
    monkeypatch.setenv('DN_REMOTE_BACKOFF_MS', '1')
    monkeypatch.setenv('DN_REMOTE_CONNECT_TIMEOUT_S', '1')
    monkeypatch.setenv('DN_TOPO_POLL_MS', '60000')
    _disk(tmp_path, monkeypatch)
    yield
    tpool.get().reset()


# -- documents and the transition lifecycle, side by side --------------------

def test_pending_doc_validation_equals_the_jax_package(tmp_path):
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'ab'}

    def docs():
        base = _topo_doc(socks)
        bad_cfg = _topo_doc(socks)
        bad_cfg['members']['a']['config'] = ''
        return [
            dict(base, epoch=2, state='pending'),
            dict(_topo_doc(socks, epoch=1), state='pending',
                 prev=_topo_doc(socks, epoch=1)),
            dict(_topo_doc(socks, epoch=3), state='pending',
                 prev=dict(_topo_doc(socks, epoch=2), state='pending',
                           prev=_topo_doc(socks, epoch=1))),
            dict(base, state='limbo'),
            dict(base, prev=_topo_doc(socks)),
            bad_cfg,
            dict(_topo_doc(socks, epoch=2), state='pending',
                 prev=_topo_doc(socks, epoch=1)),
        ]
    port = [ttopology.validate_doc(d) for d in docs()]
    ref = [jtopology.validate_doc(d) for d in docs()]
    assert port == ref
    assert port[-1] is None and all(e is not None for e in port[:-1])
    for needle, err in zip(('prev', 'exceed', 'prev', 'state', 'prev',
                            'config'), port):
        assert needle in err


def test_transition_lifecycle_equals_the_jax_package(tmp_path):
    """publish / begin / abort / begin / commit through both packages
    write the same topology file bytes at every step, and refuse the
    same steps with the same messages."""
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'ab'}
    files = {}
    for name, coord, topology in (('port', tcoord, ttopology),
                                  ('jax', jcoord, jtopology)):
        path = str(tmp_path / ('topo_%s.json' % name))
        steps = []
        coord.publish_topology(path, _topo_doc(socks))
        steps.append(open(path, 'rb').read())
        new = _topo_doc(socks)
        del new['epoch']          # auto-bumps to committed + 1
        committed, pending = coord.begin_transition(path, new)
        assert (committed.epoch, pending.epoch) == (1, 2)
        assert pending.state == 'pending'
        steps.append(open(path, 'rb').read())
        try:
            coord.begin_transition(path, _topo_doc(socks, epoch=9))
        except Exception as e:
            steps.append(e.message.replace(path, '<path>'))
        assert topology.load_topology(path).epoch == 1
        assert coord.abort_transition(path).epoch == 1
        steps.append(open(path, 'rb').read())
        coord.begin_transition(path, new)
        assert coord.commit_transition(path).epoch == 2
        steps.append(open(path, 'rb').read())
        c3, p3 = topology.load_topology_state(path)
        assert c3.epoch == 2 and p3 is None
        try:
            coord.commit_transition(path)
        except Exception as e:
            steps.append(e.message.replace(path, '<path>'))
        files[name] = steps
    assert files['port'] == files['jax']
    assert 'already pending' in files['port'][2]
    assert len(files['port']) == 6


def _loads_cases():
    return [({'a': 100.0, 'b': 10.0, 'c': 50.0}, 1),
            ({'a': 100.0, 'b': 10.0, 'c': 50.0}, None),
            ({'a': 10.0, 'b': 9.0, 'c': 11.0}, None),
            ({'a': 100.0, 'b': None, 'c': 1.0}, 1),
            ({'a': 0.0, 'b': 0.0, 'c': 0.0}, None),
            ({'a': 300.0, 'b': 1.0, 'c': 1.0}, 3)]


@pytest.mark.parametrize('i', range(len(_loads_cases())))
def test_propose_moves_equals_the_jax_package(tmp_path, i):
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'abc'}
    parts = [{'id': 0, 'replicas': ['a', 'b']},
             {'id': 1, 'replicas': ['a', 'c']},
             {'id': 2, 'replicas': ['a', 'b']}]
    loads, max_moves = _loads_cases()[i]
    out = []
    for topology, rebalance in ((ttopology, trebalance),
                                (jtopology, jrebalance)):
        doc = json.loads(json.dumps(_topo_doc(socks, parts=parts)))
        out.append(rebalance.propose_moves(topology.Topology(doc),
                                           dict(loads),
                                           max_moves=max_moves))
    assert out[0] == out[1]
    new_doc, decisions = out[0]
    if i == 0:
        assert decisions == [{'partition': 1, 'from': 'a', 'to': 'b',
                              'load_from': 100.0, 'load_to': 10.0}] \
            or (decisions[0]['from'], decisions[0]['to'],
                decisions[0]['partition']) == ('a', 'b', 1)
        assert [p for p in new_doc['partitions']
                if p['id'] == 1][0]['replicas'] == ['b', 'c']
    if i == 2:
        assert new_doc is None and decisions == []


def test_member_load_score_equals_the_jax_package(member_env, tmp_path,
                                                  corpus):
    """A live member's /stats scored by both packages' planners."""
    sock = str(tmp_path / 'solo.sock')
    srv = tserver.DnServer(socket_path=sock, conf=_conf()).start()
    try:
        _routed(sock)
        doc = tclient.stats(sock)
        assert trebalance.member_load_score(doc) == \
            jrebalance.member_load_score(doc)
        assert trebalance.member_load_score({}) == \
            jrebalance.member_load_score({})
    finally:
        srv.stop()


@pytest.mark.parametrize('pids', [[0], [1], [2], [0, 2]])
def test_shard_manifest_equals_the_jax_package(corpus, tmp_path,
                                               monkeypatch, pids):
    """The donor's (relpath, size, crc32) triples for a partition set,
    on the same tree, in both packages."""
    from dragnet_tpu import config as jconfig
    from dragnet_tpu import datasource_for_name as jds_for
    from dragnet_tpu_torch import config as tconfig
    from dragnet_tpu_torch import datasource_for_name as tds_for
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'abc'}
    doc = _topo_doc(socks)
    out = []
    for config, ds_for, topology, rebalance in (
            (tconfig, tds_for, ttopology, trebalance),
            (jconfig, jds_for, jtopology, jrebalance)):
        err, conf = config.ConfigBackendLocal(corpus['rc_path']).load()
        ds = ds_for(conf, 'ds')
        topo = topology.Topology(json.loads(json.dumps(doc)))
        out.append(rebalance.shard_manifest(ds, topo, pids))
        assert [r for r, p, f in rebalance.iter_shards(ds)] == \
            [r for r, p, f in trebalance.iter_shards(ds)]
    assert out[0] == out[1]
    if pids == [0, 2]:
        assert out[0]


# -- a live epoch bump on a serving cluster (shared tree) ---------------------

@pytest.fixture
def cluster(member_env, corpus, tmp_path):
    socks = {m: str(tmp_path / ('dn-%s.sock' % m)) for m in 'abc'}
    topo_path = str(tmp_path / 'topo.json')
    tcoord.publish_topology(topo_path, _topo_doc(socks))
    servers = {}
    try:
        for m in 'abc':
            topo = ttopology.load_topology(topo_path, member=m)
            servers[m] = tserver.DnServer(
                socket_path=socks[m], conf=_conf(), cluster=topo,
                member=m).start()
        yield {'servers': servers, 'socks': socks,
               'topo_path': topo_path, 'tmp': tmp_path}
    finally:
        for srv in servers.values():
            srv.stop()


def _poll_all(cluster, members=None):
    for m, srv in cluster['servers'].items():
        if members is not None and m not in members:
            continue
        if srv.topo_watcher is not None:
            srv.topo_watcher.poll_now()


def test_live_member_add_and_remove(cluster, corpus):
    golden = _golden()
    socks = dict(cluster['socks'])
    topo_path = cluster['topo_path']
    assert _routed(socks['a']) == golden
    socks['d'] = str(cluster['tmp'] / 'dn-d.sock')
    new = _topo_doc(socks, parts=[
        {'id': 0, 'replicas': ['a', 'b']},
        {'id': 1, 'replicas': ['b', 'c']},
        {'id': 2, 'replicas': ['d', 'a']},
    ])
    del new['epoch']
    committed, pending = tcoord.begin_transition(topo_path, new)
    assert pending.epoch == 2
    _poll_all(cluster)
    topo_d, pend_d = ttopology.load_topology_state(topo_path, member='d')
    srv_d = tserver.DnServer(
        socket_path=socks['d'], conf=_conf(), cluster=topo_d,
        member='d', pending=pend_d).start()
    cluster['servers']['d'] = srv_d
    # a shared tree streams nothing: every shard is already present
    assert srv_d.puller is not None and srv_d.puller.wait(20)
    assert srv_d.puller.ready
    assert srv_d.puller.counters['shards_streamed'] == 0
    status = tcoord.wait_ready(topo_path, timeout_s=20)
    assert status['ready'], status
    tcoord.commit_transition(topo_path)
    _poll_all(cluster)
    for m in 'abcd':
        assert cluster['servers'][m].cluster.epoch == 2
    for via in ('a', 'd'):
        assert _routed(socks[via]) == golden
    doc = tclient.stats(socks['a'], timeout_s=10.0)
    assert doc['topology']['epoch'] == 2
    assert doc['topology']['state'] == 'committed'
    assert doc['cluster']['epoch'] == 2
    # epoch 3: c leaves; its prober stops and its pooled conn evicts
    router_a = cluster['servers']['a'].router
    st_c = router_a.states['c']
    evicted_before = tpool.get().counters.get('evicted', 0)
    del socks['c']
    newer = _topo_doc(socks, parts=[
        {'id': 0, 'replicas': ['a', 'b']},
        {'id': 1, 'replicas': ['b', 'd']},
        {'id': 2, 'replicas': ['d', 'a']},
    ])
    del newer['epoch']
    tcoord.begin_transition(topo_path, newer)
    _poll_all(cluster)
    h = tclient.health(cluster['socks']['c'], timeout_s=5.0)
    assert h['ok'] and h['draining']
    status = tcoord.wait_ready(topo_path, timeout_s=20)
    assert status['ready'], status
    tcoord.commit_transition(topo_path)
    _poll_all(cluster)
    assert 'c' not in router_a.states
    assert st_c.gone.is_set()
    assert tpool.get().counters.get('evicted', 0) > evicted_before
    assert _routed(socks['a']) == golden


def test_stale_router_resyncs_on_epoch_mismatch(cluster, corpus):
    golden = _golden()
    socks = cluster['socks']
    topo_path = cluster['topo_path']
    new = _topo_doc(socks)
    del new['epoch']
    tcoord.begin_transition(topo_path, new)
    _poll_all(cluster)
    assert tcoord.wait_ready(topo_path, timeout_s=20)['ready']
    tcoord.commit_transition(topo_path)
    _poll_all(cluster, members='bc')
    assert cluster['servers']['b'].cluster.epoch == 2
    assert cluster['servers']['a'].cluster.epoch == 1
    assert _routed(socks['a']) == golden
    srv_a = cluster['servers']['a']
    assert srv_a.cluster.epoch == 2
    assert srv_a._topo_counters['resyncs'] >= 1
    assert sum(s._topo_counters['mismatch_rejections']
               for s in cluster['servers'].values()) >= 1


def test_mismatch_rejection_names_current_epoch(cluster, corpus):
    req = {'op': 'query_partial', 'ds': 'ds', 'config': corpus['rc_path'],
           'queryconfig': {'breakdowns': [
               {'name': 'host', 'field': 'host'}]},
           'interval': 'day', 'opts': {}, 'epoch': 99, 'partitions': [0]}
    rc, header, out, err = tclient.request_bytes(
        cluster['socks']['a'], req, timeout_s=10.0)
    assert rc != 0 and header['retryable']
    assert header['stats']['epoch_mismatch']
    assert header['stats']['current_epoch'] == \
        cluster['servers']['a'].cluster.epoch
    assert b'epoch mismatch' in err


# -- shard streaming between private trees ------------------------------------

def _write_member_rc(tmp_path, name, template_rc):
    """A per-member dragnetrc: same datasource, private index tree."""
    with open(template_rc, 'r') as f:
        doc = json.load(f)
    idx = str(tmp_path / ('idx_%s' % name))
    for ds in doc.get('datasources', []):
        bc = ds.get('backend_config') or ds.get('ds_backend_config')
        if bc and bc.get('indexPath'):
            bc['indexPath'] = idx
    path = str(tmp_path / ('rc_%s.json' % name))
    with open(path, 'w') as f:
        json.dump(doc, f)
    return path, idx


def _tree_files(idx):
    got = {}
    for r, dirs, names in os.walk(idx):
        dirs[:] = [d for d in dirs if not tjournal.is_index_litter(d)]
        for n in names:
            if tjournal.is_index_litter(n):
                continue
            path = os.path.join(r, n)
            with open(path, 'rb') as f:
                got[os.path.relpath(path, idx)] = f.read()
    return got


def _donor_and_joiner(corpus, tmp_path):
    socks = {m: str(tmp_path / ('dn-%s.sock' % m)) for m in 'ab'}
    rc_a, idx_a = _write_member_rc(tmp_path, 'a', corpus['rc_path'])
    rc_b, idx_b = _write_member_rc(tmp_path, 'b', corpus['rc_path'])
    shutil.copytree(corpus['idx'], idx_a)
    topo_path = str(tmp_path / 'topo.json')
    tcoord.publish_topology(topo_path, {
        'epoch': 1, 'assign': 'hash',
        'members': {'a': {'endpoint': socks['a'], 'config': rc_a}},
        'partitions': [{'id': 0, 'replicas': ['a']},
                       {'id': 1, 'replicas': ['a']}]})
    doc2 = {'assign': 'hash',
            'members': {'a': {'endpoint': socks['a'], 'config': rc_a},
                        'b': {'endpoint': socks['b'], 'config': rc_b}},
            'partitions': [{'id': 0, 'replicas': ['a']},
                           {'id': 1, 'replicas': ['b', 'a']}]}
    return socks, topo_path, doc2, idx_a, idx_b


def test_handoff_streams_shards_to_empty_joiner(member_env, corpus,
                                                tmp_path, monkeypatch):
    """Member b joins with an EMPTY private tree and takes partition 1:
    its shards stream from a (in 512-byte range fetches) before the
    commit; b's tree is byte-equal to a's shards of that partition, and
    routed queries through either member equal the JAX package's."""
    monkeypatch.setattr(trebalance, 'FETCH_CHUNK_BYTES', 512)
    golden = _golden()
    socks, topo_path, doc2, idx_a, idx_b = _donor_and_joiner(corpus,
                                                             tmp_path)
    srv_a = tserver.DnServer(
        socket_path=socks['a'], conf=_conf(),
        cluster=ttopology.load_topology(topo_path, member='a'),
        member='a').start()
    srv_b = None
    try:
        assert _routed(socks['a']) == golden
        tcoord.begin_transition(topo_path, doc2)
        srv_a.topo_watcher.poll_now()
        topo_b, pend_b = ttopology.load_topology_state(topo_path,
                                                       member='b')
        srv_b = tserver.DnServer(
            socket_path=socks['b'], conf=_conf(), cluster=topo_b,
            member='b', pending=pend_b).start()
        assert srv_b.puller is not None and srv_b.puller.wait(30)
        assert srv_b.puller.ready, srv_b.puller.status()
        streamed = srv_b.puller.counters
        assert streamed['shards_streamed'] > 0
        assert streamed['bytes_streamed'] > 0
        got = _tree_files(idx_b)
        have = _tree_files(idx_a)
        pend = ttopology.load_topology_state(topo_path)[1]
        want = {rel for rel in have
                if pend.partition_of(rel, '%Y-%m-%d') == 1}
        assert got and set(got) == want
        for rel, data in got.items():
            assert data == have[rel], rel
        assert streamed['bytes_streamed'] == sum(len(v)
                                                 for v in got.values())
        assert tcoord.wait_ready(topo_path, timeout_s=20)['ready']
        tcoord.commit_transition(topo_path)
        srv_a.topo_watcher.poll_now()
        srv_b.topo_watcher.poll_now()
        assert srv_a.cluster.epoch == srv_b.cluster.epoch == 2
        for via in 'ab':
            assert _routed(socks[via]) == golden, via
        doc = tclient.stats(socks['b'], timeout_s=10.0)
        assert doc['topology']['epoch'] == 2
        assert doc['topology']['handoff']['counters'][
            'shards_streamed'] > 0
        assert doc['metrics']['counters'].get(
            'handoff_shards_streamed_total', 0) > 0
    finally:
        srv_a.stop()
        if srv_b is not None:
            srv_b.stop()


def test_handoff_pauses_under_low_disk_and_resumes(member_env, corpus,
                                                   tmp_path, monkeypatch):
    """A `low` disk reading (7 % free, under DN_DISK_LOW_PCT) holds the
    joiner's pull with nothing landed; a reading back above the
    watermark resumes it to ready, as the JAX package's gate does."""
    monkeypatch.setenv('DN_RESOURCE_POLL_MS', '50')
    sim = _disk(tmp_path, monkeypatch, pct=7)
    socks, topo_path, doc2, idx_a, idx_b = _donor_and_joiner(corpus,
                                                             tmp_path)
    srv_a = tserver.DnServer(
        socket_path=socks['a'], conf=_conf(),
        cluster=ttopology.load_topology(topo_path, member='a'),
        member='a').start()
    srv_b = None
    try:
        tcoord.begin_transition(topo_path, doc2)
        srv_a.topo_watcher.poll_now()
        topo_b, pend_b = ttopology.load_topology_state(topo_path,
                                                       member='b')
        srv_b = tserver.DnServer(
            socket_path=socks['b'], conf=_conf(), cluster=topo_b,
            member='b', pending=pend_b).start()
        assert srv_b.governor.mode() == 'low'
        assert not srv_b.puller.wait(1.5)
        assert not srv_b.puller.ready and not srv_b.puller.failed
        assert srv_b.puller.counters['shards_streamed'] == 0
        assert not _tree_files(idx_b)
        assert not tcoord.transition_status(topo_path)['ready']
        sim.write_text('50\n')
        assert srv_b.puller.wait(30)
        assert srv_b.puller.ready, srv_b.puller.status()
        assert srv_b.puller.counters['shards_streamed'] > 0
        have = _tree_files(idx_a)
        for rel, data in _tree_files(idx_b).items():
            assert data == have[rel]
    finally:
        srv_a.stop()
        if srv_b is not None:
            srv_b.stop()


def test_mid_handoff_partials_gate(member_env, corpus, tmp_path):
    golden = _golden()
    socks = {m: str(tmp_path / ('dn-%s.sock' % m)) for m in 'ab'}
    topo_path = str(tmp_path / 'topo.json')
    tcoord.publish_topology(topo_path, _topo_doc(socks, parts=[
        {'id': 0, 'replicas': ['a']},
        {'id': 1, 'replicas': ['a', 'b']},
        {'id': 2, 'replicas': ['b', 'a']}]))
    servers = {}
    try:
        for m in 'ab':
            servers[m] = tserver.DnServer(
                socket_path=socks[m], conf=_conf(),
                cluster=ttopology.load_topology(topo_path, member=m),
                member=m).start()
        committed, pending = tcoord.begin_transition(
            topo_path, _topo_doc(socks, epoch=2, parts=[
                {'id': 0, 'replicas': ['b', 'a']},
                {'id': 1, 'replicas': ['a', 'b']},
                {'id': 2, 'replicas': ['b', 'a']}]))
        srv_b = servers['b']
        puller = trebalance.HandoffPuller(committed, pending, 'b')
        puller.affected_pids = {0}
        with srv_b._topo_lock:
            srv_b.pending = pending
            srv_b.puller = puller
        req = {'op': 'query_partial', 'ds': 'ds',
               'config': corpus['rc_path'],
               'queryconfig': {'breakdowns': [
                   {'name': 'host', 'field': 'host'}]},
               'interval': 'day', 'opts': {}}
        rc, header, out, err = tclient.request_bytes(
            socks['b'], dict(req, epoch=2, partitions=[0]),
            timeout_s=10.0)
        assert rc != 0 and header['retryable']
        assert b'handoff incomplete' in err
        for epoch, pids in ((2, [2]), (1, [2])):
            rc, header, out, err = tclient.request_bytes(
                socks['b'], dict(req, epoch=epoch, partitions=pids),
                timeout_s=10.0)
            assert rc == 0, err
        assert _routed(socks['a']) == golden
        puller.ready = True
        rc, header, out, err = tclient.request_bytes(
            socks['b'], dict(req, epoch=2, partitions=[0]),
            timeout_s=10.0)
        assert rc == 0, err
    finally:
        for srv in servers.values():
            srv.stop()


def test_reapplied_same_epoch_restarts_handoff(member_env, tmp_path):
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'ab'}
    topo_path = str(tmp_path / 'topo.json')
    tcoord.publish_topology(topo_path, _topo_doc(socks, parts=[
        {'id': 0, 'replicas': ['a', 'b']},
        {'id': 1, 'replicas': ['b', 'a']}]))
    srv = tserver.DnServer(
        socket_path=socks['a'], conf=_conf(),
        cluster=ttopology.load_topology(topo_path, member='a'),
        member='a').start()

    def pending_of(parts, prev_parts):
        doc = _topo_doc(socks, epoch=2, parts=parts)
        return ttopology.Topology(json.loads(json.dumps(dict(
            doc, state='pending',
            prev=_topo_doc(socks, parts=prev_parts)))))
    try:
        parts_a = [{'id': 0, 'replicas': ['a']},
                   {'id': 1, 'replicas': ['b', 'a']}]
        srv.apply_topology(srv.cluster, pending_of(parts_a, parts_a))
        first = srv.puller
        assert first is not None
        parts_b = [{'id': 0, 'replicas': ['b', 'a']},
                   {'id': 1, 'replicas': ['a']}]
        pend_b = pending_of(parts_b, parts_a)
        srv.apply_topology(srv.cluster, pend_b)
        assert srv.puller is not first
        second = srv.puller
        srv.apply_topology(srv.cluster, pend_b)
        assert srv.puller is second
    finally:
        srv.stop()


def test_handoff_fetch_faults_surface_as_failed_pull(member_env, corpus,
                                                     tmp_path,
                                                     monkeypatch):
    socks, topo_path, doc2, idx_a, idx_b = _donor_and_joiner(corpus,
                                                             tmp_path)
    doc2['partitions'] = [{'id': 0, 'replicas': ['b', 'a']},
                          {'id': 1, 'replicas': ['b', 'a']}]
    srv_a = tserver.DnServer(
        socket_path=socks['a'], conf=_conf(),
        cluster=ttopology.load_topology(topo_path, member='a'),
        member='a').start()
    try:
        committed, pending = tcoord.begin_transition(topo_path, doc2)
        monkeypatch.setenv('DN_FAULTS', 'handoff.fetch:error:1.0')
        monkeypatch.setenv('DN_TOPO_HANDOFF_RETRIES', '0')
        tfaults.reset()
        puller = trebalance.HandoffPuller(committed, pending, 'b').start()
        assert puller.wait(30)
        assert not puller.ready and puller.failed
        assert puller.counters['fetch_failures'] > 0
        assert not _tree_files(idx_b)
        topo_b, pend_b = ttopology.load_topology_state(topo_path,
                                                       member='b')
        srv_b = tserver.DnServer(
            socket_path=socks['b'], conf=_conf(), cluster=topo_b,
            member='b', pending=pend_b).start()
        try:
            assert srv_b.puller.wait(30) and srv_b.puller.failed
            failed_puller = srv_b.puller
            srv_b.topo_watcher.poll_now()
            assert srv_b.topo_watcher.poll_now() is False
            assert srv_b.puller is not failed_puller
            assert srv_b.puller.wait(30) and srv_b.puller.failed
            monkeypatch.delenv('DN_FAULTS')
            tfaults.reset()
            srv_b.topo_watcher.poll_now()
            assert srv_b.puller.wait(30)
            assert srv_b.puller.ready, srv_b.puller.status()
            assert srv_b._topo_counters['handoff_retries'] >= 2
            have = _tree_files(idx_a)
            got = _tree_files(idx_b)
            assert got == have
        finally:
            srv_b.stop()
    finally:
        srv_a.stop()


def test_watcher_survives_poll_faults(member_env, tmp_path, monkeypatch):
    sock = str(tmp_path / 'dn-a.sock')
    topo_path = str(tmp_path / 'topo.json')

    def doc(epoch):
        return {'epoch': epoch, 'assign': 'hash',
                'members': {'a': {'endpoint': sock}},
                'partitions': [{'id': 0, 'replicas': ['a']}]}
    tcoord.publish_topology(topo_path, doc(1))
    srv = tserver.DnServer(
        socket_path=sock, conf=_conf(),
        cluster=ttopology.load_topology(topo_path, member='a'),
        member='a').start()
    try:
        watcher = srv.topo_watcher
        assert watcher is not None
        monkeypatch.setenv('DN_FAULTS', 'topo.poll:error:1.0')
        tfaults.reset()
        assert watcher.poll_now() is False
        assert watcher.counters['errors'] >= 1
        assert srv.cluster.epoch == 1
        monkeypatch.delenv('DN_FAULTS')
        tfaults.reset()
        with open(topo_path, 'w') as f:
            f.write('{nope')
        assert watcher.poll_now() is False
        assert srv.cluster.epoch == 1
        tcoord.publish_topology(topo_path, doc(2))
        assert watcher.poll_now() is True
        assert srv.cluster.epoch == 2
        assert srv.topology_doc()['watcher'] == watcher.stats()
    finally:
        srv.stop()


# -- dn topo ------------------------------------------------------------------

def test_cli_topo_lifecycle_equals_the_jax_package(tmp_path,
                                                   monkeypatch):
    """show / apply / status / commit / commit --force / abort through
    both CLIs on twin topology files: the same rc, stdout and stderr
    (members unreachable, so status is not ready)."""
    monkeypatch.setenv('DN_REMOTE_RETRIES', '0')
    monkeypatch.setenv('DN_REMOTE_CONNECT_TIMEOUT_S', '1')
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'ab'}
    new_path = str(tmp_path / 'new.json')
    new = _topo_doc(socks)
    del new['epoch']
    with open(new_path, 'w') as f:
        json.dump(new, f)
    results = {}
    for name, run, coord in (('port', run_port, tcoord),
                             ('jax', run_ref, jcoord)):
        path = str(tmp_path / 'topo.json')
        coord.publish_topology(path, _topo_doc(socks))
        outs = []
        for args in (['show'], ['apply', new_path], ['status'],
                     ['commit'], ['commit', '--force'], ['show'],
                     ['abort'], ['rebalance'], ['frob']):
            rc, out, err = run(['topo'] + args + ['--topology', path])
            outs.append((rc, out, err))
        results[name] = outs
        os.unlink(path)
    port, ref = results['port'], results['jax']
    for i, (p, r) in enumerate(zip(port, ref)):
        if i == 2:
            # status carries per-member dial errors: the same shape
            pd, rd = json.loads(p[1]), json.loads(r[1])
            assert p[0] == r[0] == 1
            assert pd['pending_epoch'] == rd['pending_epoch'] == 2
            assert pd['ready'] is rd['ready'] is False
            assert sorted(pd['members']) == sorted(rd['members'])
        elif i == 7:
            assert p[0] == r[0] and json.loads(p[1])['decisions'] == \
                json.loads(r[1])['decisions']
        elif i == 8:
            # a usage error: each CLI prints its own usage text after
            # the same first line
            assert p[0] == r[0] == 2 and p[1] == r[1] == b''
            assert p[2].split(b'\n')[0] == r[2].split(b'\n')[0]
        else:
            assert p == r, i
    assert b'pending epoch 2' in port[1][2]
    assert port[3][0] != 0 and b'not ready' in port[3][2]
    assert b'epoch 2 committed' in port[4][2]
    assert json.loads(port[5][1])['committed']['epoch'] == 2
    assert port[6][0] != 0 and b'dn:' in port[6][2]
    assert port[8][0] == 2


def test_cli_topo_requires_topology_path(monkeypatch):
    monkeypatch.delenv('DN_SERVE_TOPOLOGY', raising=False)
    port, ref = run_port(['topo', 'status']), run_ref(['topo', 'status'])
    assert port[0] == ref[0] == 2
    assert port[2].split(b'\n')[0] == ref[2].split(b'\n')[0]


def test_wait_ready_times_out_cleanly(tmp_path, monkeypatch):
    monkeypatch.setenv('DN_REMOTE_RETRIES', '0')
    monkeypatch.setenv('DN_REMOTE_CONNECT_TIMEOUT_S', '1')
    socks = {m: str(tmp_path / (m + '.sock')) for m in 'ab'}
    path = str(tmp_path / 'topo.json')
    tcoord.publish_topology(path, _topo_doc(socks))
    t0 = time.monotonic()
    status = tcoord.wait_ready(path, timeout_s=0.5)
    assert time.monotonic() - t0 < 10
    assert status['ready'] is True and status.get('pending_epoch') is None
    new = _topo_doc(socks)
    del new['epoch']
    tcoord.begin_transition(path, new)
    status = tcoord.wait_ready(path, timeout_s=0.5)
    assert status['ready'] is False
    with pytest.raises(DNError):
        tcoord.begin_transition(path, new)
