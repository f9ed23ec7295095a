"""The port's cluster backend (dragnet_tpu_torch.parallel, on the CPU)
against the JAX package's (dragnet_tpu.parallel, on its 8-device virtual
CPU mesh, tests/conftest.py) and the port's file backend: the sharded
aggregation (psum and the tiled reduce-scatter), the cluster scan over a
mesh of 8 CPU shards (the sharded device body, first occurrence across
shards, padded batches, the host sparse fallback), the dry-run plan, the
CLI, and two-process runs over a gloo process group.  Tolerance: exact.
Sums are integers and points compare with ==, in emission order."""

import contextlib
import io
import json
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dragnet_tpu import native as jnative
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import engine as tengine
from dragnet_tpu_torch import native as tnative
from dragnet_tpu_torch.ops import cuda_kernels
from dragnet_tpu_torch.parallel import cluster as tcluster
from dragnet_tpu_torch.parallel import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'helpers', 'torch_cluster_worker.py')
JAX_WORKER = os.path.join(ROOT, 'tests', 'helpers', 'cluster_worker.py')

NDEV = 8
BATCH = 512


def _cpu_mesh(n=NDEV):
    return tmesh.make_mesh(devices=['cpu'] * n)


def _reference_dense(codes, radices, weights, alive):
    num = 1
    for r in radices:
        num *= r
    fused = np.zeros(codes.shape[1], dtype=np.int64)
    for i, r in enumerate(radices):
        fused = fused * r + codes[i]
    return np.bincount(fused, weights=np.where(alive, weights, 0.0),
                       minlength=num)


def _random_problem(rng, n, radices, integer=True):
    codes = np.stack([rng.integers(0, r, size=n) for r in radices]) \
        .astype(np.int64)
    weights = rng.integers(1, 5, size=n).astype(np.float64)
    if not integer:
        weights = weights + 0.25
    alive = rng.random(n) < 0.8
    return codes, weights, alive


# ---------------------------------------------------------------------------
# sharded_aggregate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('radices', [(5, 7), (64, 80)],
                         ids=['kernel', 'index_add'])
@pytest.mark.parametrize('n', [64, 1000])
def test_sharded_psum_matches_jax(n, radices):
    """psum over 8 shards equals the JAX mesh's and the numpy sums, on
    both local steps: K1's gate (35 segments) and index_add_ (5,120)."""
    from dragnet_tpu.parallel.mesh import sharded_aggregate as jagg
    rng = np.random.default_rng(42 + n)
    codes, weights, alive = _random_problem(rng, n, radices)
    ns = radices[0] * radices[1]
    assert cuda_kernels.should_use(ns, weights.sum()) == (ns <= 4096)
    before = dict(tmesh.launches)
    got = tmesh.sharded_aggregate(codes, radices, weights, alive,
                                  mesh=_cpu_mesh())
    assert tmesh.launches['aggregate_merge'] == \
        before['aggregate_merge'] + 1
    expected = _reference_dense(codes, radices, weights, alive)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, jagg(codes, radices, weights,
                                            alive))


def test_sharded_reduce_scatter_matches_jax():
    from dragnet_tpu.parallel.mesh import sharded_aggregate as jagg
    rng = np.random.default_rng(7)
    radices = (4, 16)   # 64 segments: 8 slices of 8
    codes, weights, alive = _random_problem(rng, 512, radices)
    got = tmesh.sharded_aggregate(codes, radices, weights, alive,
                                  scatter=True, mesh=_cpu_mesh())
    np.testing.assert_array_equal(
        got, _reference_dense(codes, radices, weights, alive))
    np.testing.assert_array_equal(
        got, jagg(codes, radices, weights, alive, scatter=True))


def test_sharded_float_weights_take_the_host_bincount():
    """The reference's guard: non-integer weights merge exactly in f64
    on the host, and the scatter contract refuses them."""
    from dragnet_tpu.parallel.mesh import sharded_aggregate as jagg
    rng = np.random.default_rng(9)
    radices = (3, 5)
    codes, weights, alive = _random_problem(rng, 300, radices,
                                            integer=False)
    before = dict(tmesh.launches)
    got = tmesh.sharded_aggregate(codes, radices, weights, alive,
                                  mesh=_cpu_mesh())
    assert tmesh.launches == before
    np.testing.assert_array_equal(got, jagg(codes, radices, weights,
                                            alive))
    with pytest.raises(AssertionError):
        tmesh.sharded_aggregate(codes, radices, weights, alive,
                                scatter=True, mesh=_cpu_mesh(3))


def test_merge_partials_sums_and_takes_the_min():
    parts = [(torch.tensor([1, 0, 2], dtype=torch.int64),
              torch.tensor([5, 2 ** 31 - 1, 7], dtype=torch.int32),
              torch.tensor([3, 1], dtype=torch.int32)),
             (torch.tensor([4, 1, 0], dtype=torch.int64),
              torch.tensor([9, 12, 2 ** 31 - 1], dtype=torch.int32),
              torch.tensor([2, 0], dtype=torch.int32))]
    dense, first, cvec = tmesh.merge_partials(parts, torch.device('cpu'))
    assert dense.tolist() == [5, 1, 2]
    assert first.tolist() == [5, 12, 7]
    assert cvec.tolist() == [5, 1] and cvec.dtype == torch.int64


# the tagged partials of two processes: (disjoint buckets), (shared
# buckets, with a value that is 1 on one process and 1.0 on the other,
# equal under JS semantics), and an 'all' build (no __dn_ts)
TAGGED_CASES = {
    'disjoint': [
        [({'__dn_ts': 0, 'host': 'a', '__dn_metric': 0}, 3),
         ({'__dn_ts': 3600, 'host': 'b', '__dn_metric': 0}, 1)],
        [({'__dn_ts': 7200, 'host': 'a', '__dn_metric': 0}, 2),
         ({'__dn_ts': 7200, 'host': 'c', '__dn_metric': 1}, 5)]],
    'shared': [
        [({'__dn_ts': 0, 'host': 'a', 'c': 1, '__dn_metric': 0}, 3),
         ({'__dn_ts': 3600, 'host': 'b', 'c': 2, '__dn_metric': 0}, 1)],
        [({'__dn_ts': 3600, 'host': 'x"y', 'c': 2, '__dn_metric': 0}, 4),
         ({'__dn_ts': 0, 'host': 'a', 'c': 1.0, '__dn_metric': 0}, 2),
         ({'__dn_ts': 7200, 'host': 'b', 'c': 2, '__dn_metric': 0}, 6)]],
    'all': [
        [({'host': 'a', '__dn_metric': 0}, 3),
         ({'host': 'b', '__dn_metric': 1}, 1)],
        [({'host': 'b', '__dn_metric': 1}, 2),
         ({'host': 'é', '__dn_metric': 0}, 7)]],
}


@pytest.mark.parametrize('case', sorted(TAGGED_CASES))
def test_tagged_merge_matches_jax(monkeypatch, case):
    """The build's cross-process merge against the JAX package's, on the
    same gathered partials (each package's exchange replaced by the two
    processes' payloads): the same points in the same order, however
    many buckets the processes share."""
    from jax.experimental import multihost_utils
    from dragnet_tpu.parallel import cluster as jcluster
    procs = TAGGED_CASES[case]
    payloads = [json.dumps([[f, v] for f, v in pts]).encode()
                for pts in procs]
    calls = []

    def process_allgather(x):
        calls.append(x)
        if len(calls) % 2:
            return np.array([[len(p)] for p in payloads], dtype=np.int64)
        out = np.zeros((len(payloads), int(x.shape[0])), dtype=np.uint8)
        for i, p in enumerate(payloads):
            out[i, :len(p)] = np.frombuffer(p, dtype=np.uint8)
        return out
    monkeypatch.setattr(multihost_utils, 'process_allgather',
                        process_allgather)
    monkeypatch.setattr(tcluster, '_allgather_bytes', lambda p: payloads)
    want = jcluster._allgather_merge_tagged(procs[0])
    got = tcluster._allgather_merge_tagged(procs[0])
    assert json.dumps(got) == json.dumps(want)


def test_cuda_asked_for_and_absent_raises(tmp_path):
    """No silent CPU: the default mesh is CUDA's, and without CUDA the
    mesh, the aggregation and a cluster scan raise."""
    from dragnet_tpu_torch.errors import DNError
    if torch.cuda.is_available():
        pytest.skip('CUDA is present')
    with pytest.raises(DNError, match='CUDA'):
        tmesh.make_mesh()
    with pytest.raises(DNError, match='CUDA'):
        tmesh.make_mesh(devices=['cpu', 'cuda:0'])
    with pytest.raises(DNError, match='CUDA'):
        tmesh.sharded_aggregate(np.zeros((1, 4), dtype=np.int64), (2,),
                                np.ones(4), np.ones(4, dtype=bool))
    datadir = tmp_path / 'data'
    datadir.mkdir()
    (datadir / 'a.log').write_text('{"host":"a"}\n')
    ds = tcluster.DatasourceCluster(_dsconfig(datadir, time=False))
    with pytest.raises(DNError, match='CUDA'):
        ds.scan(tquery.query_load({'breakdowns': [{'name': 'host'}]}))


# ---------------------------------------------------------------------------
# the cluster scan in one process
# ---------------------------------------------------------------------------

def _dsconfig(datadir, time=True, indexdir=None):
    bc = {'path': str(datadir)}
    if time:
        bc['timeField'] = 'time'
    if indexdir is not None:
        bc['indexPath'] = str(indexdir)
    return {'ds_backend': 'cluster', 'ds_backend_config': bc,
            'ds_filter': None, 'ds_format': 'json'}


def _counters(result):
    out = io.StringIO()
    result.pipeline.dump_counters(out)
    return out.getvalue()


def _hidden(result):
    st = [s for s in result.pipeline.stages if s.name == 'Aggregator'][0]
    return dict(st.counters)


@pytest.fixture
def small_batches(monkeypatch):
    """BATCH-record batches in both packages, one scan thread."""
    if jnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    import dragnet_tpu.engine as jeng
    from dragnet_tpu import device_scan as jds

    def setb(n):
        monkeypatch.setattr(jeng, 'BATCH_SIZE', n)
        monkeypatch.setattr(jds, 'BATCH_SIZE', n)
        monkeypatch.setattr(tdf, 'BATCH_SIZE', n)
    setb(BATCH)
    monkeypatch.setenv('DN_READ_SIZE', '65536')
    monkeypatch.setenv('DN_SCAN_THREADS', '0')
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    return setb


def _three_ways(monkeypatch, dsconfig, qconf, nshards=NDEV):
    """(port cluster, JAX cluster, port file) results of one query; the
    JAX side under its default engine (the cluster backend runs its mesh
    scan whatever DN_ENGINE says), the port's file backend on its host
    engine."""
    from dragnet_tpu import query as jquery
    from dragnet_tpu.parallel import cluster as jcluster
    monkeypatch.delenv('DN_ENGINE', raising=False)
    jres = jcluster.DatasourceCluster(dsconfig).scan(
        jquery.query_load(qconf))
    fcfg = dict(dsconfig, ds_backend='file')
    fres = tdf.DatasourceFile(fcfg).scan(tquery.query_load(qconf),
                                         device='cpu', engine='vector')
    scans = []
    orig = tcluster.MeshDeviceScan.__init__

    def record_init(self, *a, **kw):
        orig(self, *a, **kw)
        scans.append(self)
    monkeypatch.setattr(tcluster.MeshDeviceScan, '__init__', record_init)
    tres = tcluster.DatasourceCluster(
        dsconfig, mesh=_cpu_mesh(nshards)).scan(
        tquery.query_load(qconf), device='cpu', engine='auto')
    monkeypatch.setattr(tcluster.MeshDeviceScan, '__init__', orig)
    assert len(scans) == 1 and scans[0].mesh.size == nshards
    return tres, jres, fres


def _write_records(path, n, seed):
    rng = random.Random(seed)
    with open(path, 'w') as f:
        for _ in range(n):
            f.write(json.dumps({
                'time': '2014-05-%02dT%02d:00:0%dZ'
                        % (rng.choice([1, 2, 3]), rng.randrange(24),
                           rng.randrange(10)),
                'host': rng.choice(['a', 'b', 'c']),
                'latency': rng.choice([1, 5, 80, 3000]),
                'res': {'statusCode': rng.choice([200, 404, 500])},
                'req': {'method': rng.choice(['GET', 'PUT'])},
            }) + '\n')


SCAN_QUERIES = {
    'filtered': {'breakdowns': [{'name': 'host'}, {'name': 'req.method'},
                                {'name': 'latency', 'aggr': 'quantize'}],
                 'filter': {'ne': ['res.statusCode', 500]}},
    'timestamp': {'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 60},
        {'name': 'res.statusCode'}],
        'filter': {'ge': ['res.statusCode', 404]}},
    'total': {},
}


@pytest.mark.parametrize('case', sorted(SCAN_QUERIES))
def test_cluster_scan_matches_jax_and_file(tmp_path, monkeypatch,
                                           small_batches, case):
    """Mirror of tests/test_parallel.py's full-pipeline test: every
    batch through the sharded device body (ndevicebatches), nothing
    spilled, points and --counters equal to the JAX cluster scan and to
    the port's file backend."""
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_records(datadir / 'a.log', 4000, 11)
    before = tmesh.launches['scan_merge']
    tres, jres, fres = _three_ways(monkeypatch, _dsconfig(datadir),
                                   SCAN_QUERIES[case])
    assert tres.points == jres.points == fres.points
    assert _counters(tres) == _counters(jres) == _counters(fres)
    hidden = _hidden(tres)
    assert hidden.get('ndevicebatches', 0) >= 4000 // BATCH
    assert hidden.get('nspillrecords', 0) == 0
    assert tmesh.launches['scan_merge'] - before == \
        hidden['ndevicebatches']


def test_cluster_mesh_pipeline_off(tmp_path, monkeypatch, small_batches):
    """DN_MESH_PIPELINE=0: the device body runs on the mesh's first
    device alone (no K9 merge), with the same points and counters."""
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_records(datadir / 'a.log', 2000, 13)
    monkeypatch.setenv('DN_MESH_PIPELINE', '0')
    before = tmesh.launches['scan_merge']
    tres, jres, fres = _three_ways(monkeypatch, _dsconfig(datadir),
                                   SCAN_QUERIES['filtered'])
    assert tres.points == jres.points == fres.points
    assert _counters(tres) == _counters(fres)
    assert _hidden(tres)['ndevicebatches'] >= 2000 // BATCH
    assert tmesh.launches['scan_merge'] == before


def test_cluster_first_occurrence_across_shards(tmp_path, monkeypatch,
                                                small_batches):
    """A key whose first row lies in the last shard of a batch, behind a
    key first seen late in shard 0: only global row indices keep the
    host engine's first-occurrence order under the cross-shard min."""
    # one batch (the file is one read): shard s holds rows
    # [s*bn, (s+1)*bn)
    n = 2 * BATCH
    bn = n // NDEV
    rows = [{'host': 'common'} for _ in range(n)]
    rows[bn - 4] = {'host': 'late_in_shard0'}
    rows[(NDEV - 1) * bn + 2] = {'host': 'early_in_shard7'}
    rows[(NDEV - 1) * bn + 5] = {'host': 'late_in_shard0'}
    datadir = tmp_path / 'data'
    datadir.mkdir()
    with open(datadir / 'a.log', 'w') as f:
        for r in rows:
            f.write(json.dumps(r) + '\n')
    qconf = {'breakdowns': [{'name': 'host'}]}
    tres, jres, fres = _three_ways(monkeypatch,
                                   _dsconfig(datadir, time=False), qconf)
    order = [p[0]['host'] for p in tres.points]
    assert order == ['common', 'late_in_shard0', 'early_in_shard7']
    assert tres.points == jres.points == fres.points
    assert _hidden(tres)['ndevicebatches'] == 1


@pytest.mark.parametrize('nshards', [3, 8])
def test_cluster_padded_batches_gen_alive(tmp_path, monkeypatch,
                                          small_batches, nshards):
    """Batches whose length is not a multiple of the shard count: the
    staging pads them with rows past nvalid, which the synthesized
    alive mask kills (no datasource filter: alive is generated)."""
    small_batches(509)
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_records(datadir / 'a.log', 1523, 5)
    staged = []
    orig = tds.DeviceScan._fold_staged

    def spy(self, st, args):
        staged.append((st[0], st[1][1],
                       {k: int(args[k].shape[0]) for k in self._mesh_rows}))
        return orig(self, st, args)
    monkeypatch.setattr(tds.DeviceScan, '_fold_staged', spy)
    qconf = {'breakdowns': [{'name': 'host'},
                            {'name': 'latency', 'aggr': 'quantize'}]}
    tres, jres, fres = _three_ways(monkeypatch,
                                   _dsconfig(datadir, time=False), qconf,
                                   nshards=nshards)
    assert tres.points == jres.points == fres.points
    assert _counters(tres) == _counters(jres) == _counters(fres)
    assert sum(n for n, _, _ in staged) == 1523 and len(staged) > 1
    assert any(n % nshards for n, _, _ in staged)
    for n, gen_alive, lens in staged:
        assert gen_alive
        assert set(lens.values()) == {-(-n // nshards) * nshards}


def test_cluster_highcard_falls_back_to_host_sparse(tmp_path,
                                                    monkeypatch,
                                                    small_batches):
    """Mirror of tests/test_parallel.py's high-cardinality test: key
    spaces past the dense budget leave the mesh program (a sparse set
    has no sum/min merge) for the host sparse merge, equal to the JAX
    cluster scan, with the spill in the counters."""
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    for mod in (jengine, jds, tengine, tds):
        monkeypatch.setattr(mod, 'MAX_DENSE_SEGMENTS', 64)
    small_batches(256)
    datadir = tmp_path / 'data'
    datadir.mkdir()
    rng = random.Random(17)
    with open(datadir / 'a.log', 'w') as f:
        for _ in range(1500):
            f.write(json.dumps({'host': 'h%d' % rng.randrange(60),
                                'latency': rng.randrange(0, 4000)}) + '\n')
    folds = tds.sparse_folds['fold_sparse']
    qconf = {'breakdowns': [{'name': 'host'}, {'name': 'latency'}]}
    tres, jres, fres = _three_ways(monkeypatch,
                                   _dsconfig(datadir, time=False), qconf)
    assert tres.points == jres.points == fres.points
    assert len(tres.points) > 64
    assert _counters(tres) == _counters(jres)
    assert 'nspillrecords' in _counters(tres)
    assert tds.sparse_folds['fold_sparse'] == folds
    assert _hidden(tres).get('ndevicebatches', 0) == 0


def test_cluster_dry_run_plan(tmp_path, capsys, monkeypatch):
    """--dry-run prints the execution plan, equal to the JAX package's
    but for the mesh's device names, then the inputs; no CUDA is
    initialized."""
    from dragnet_tpu import query as jquery
    from dragnet_tpu import ops as jops
    from dragnet_tpu.parallel import cluster as jcluster
    from dragnet_tpu_torch import cli as tcli
    datadir = tmp_path / 'data'
    datadir.mkdir()
    (datadir / 'a.log').write_text('{"host":"a"}\n')
    cfg = _dsconfig(datadir, time=False)
    qconf = {'breakdowns': [{'name': 'host'}]}
    jops.backend_ready()
    jplan = jcluster.DatasourceCluster(cfg).scan(
        jquery.query_load(qconf), dry_run=True).dry_run_plan
    r = tcluster.DatasourceCluster(cfg, mesh=_cpu_mesh()).scan(
        tquery.query_load(qconf), device='cpu', dry_run=True)
    plan = r.dry_run_plan
    assert plan['partition'] == [str(datadir / 'a.log')]
    assert plan['mesh'] == {'axis': 'd', 'local_devices': ['cpu'] * NDEV}
    assert len(jplan['mesh']['local_devices']) == NDEV
    assert {k: v for k, v in plan.items() if k != 'mesh'} == \
        {k: v for k, v in jplan.items() if k != 'mesh'}
    # the default mesh is listed without a CUDA context
    r0 = tcluster.DatasourceCluster(cfg).scan(tquery.query_load(qconf),
                                             dry_run=True)
    assert r0.dry_run_plan['mesh']['local_devices'] == \
        ['cuda:%d' % i for i in range(torch.cuda.device_count())]
    assert not torch.cuda.is_initialized()

    class Opts(object):
        pass
    tcli.dn_output(tquery.query_load(qconf), Opts(), r, 'ds')
    err = capsys.readouterr().err
    head, _, inputs = err.partition('\nInputs:\n')
    parsed = json.loads(head)
    assert parsed['backend'] == 'cluster' and 'partition' not in parsed
    assert inputs.splitlines() == [str(datadir / 'a.log')]


def test_cluster_build_index_scan_query_match_file(tmp_path, monkeypatch,
                                                   small_batches):
    """One process: the cluster build writes the file backend's tree
    byte for byte (the JAX cluster build's too), and index-scan and
    query answer as the file backend does."""
    from dragnet_tpu import query as jquery
    from dragnet_tpu.parallel import cluster as jcluster
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_records(datadir / 'a.log', 3000, 23)
    trees = {k: tmp_path / k for k in ('port', 'file', 'jax')}
    metric = _metric_conf()
    tcluster.DatasourceCluster(
        _dsconfig(datadir, indexdir=trees['port']), mesh=_cpu_mesh()).build(
        [tquery.metric_deserialize(metric)], 'hour', device='cpu')
    tdf.DatasourceFile(dict(_dsconfig(datadir, indexdir=trees['file']),
                            ds_backend='file')).build(
        [tquery.metric_deserialize(metric)], 'hour', device='cpu',
        engine='vector')
    monkeypatch.delenv('DN_ENGINE', raising=False)
    jcluster.DatasourceCluster(
        _dsconfig(datadir, indexdir=trees['jax'])).build(
        [jquery.metric_deserialize(metric)], 'hour')
    port = _tree_bytes(trees['port'])
    assert port and port == _tree_bytes(trees['file']) == \
        _tree_bytes(trees['jax'])

    cds = tcluster.DatasourceCluster(
        _dsconfig(datadir, indexdir=trees['port']), mesh=_cpu_mesh())
    fds = tdf.DatasourceFile(dict(
        _dsconfig(datadir, indexdir=trees['port']), ds_backend='file'))
    m = [tquery.metric_deserialize(metric)]
    assert cds.index_scan(m, 'hour', device='cpu').points == \
        fds.index_scan(m, 'hour', device='cpu', engine='vector').points
    q = {'breakdowns': [{'name': 'host'}, {'name': 'req.method'}]}
    assert cds.query(tquery.query_load(q), 'hour', device='cpu').points \
        == fds.query(tquery.query_load(q), 'hour', device='cpu').points


def _metric_conf():
    return {'name': 'm', 'datasource': 'd', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 3600},
        {'name': 'host', 'field': 'host'},
        {'name': 'req.method', 'field': 'req.method'},
        {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]}


def _tree_bytes(root):
    out = {}
    for dirpath, dirnames, files in os.walk(str(root)):
        for fn in files:
            if fn.startswith('.dn_integrity'):
                continue    # the catalog records wall times
            p = os.path.join(dirpath, fn)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, str(root))] = f.read()
    return out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('radices', [(5, 7), (64, 80)],
                         ids=['kernel', 'index_add'])
def test_sharded_aggregate_two_shards_on_the_card(cuda, radices):
    """Two shards on one card: K1 (or index_add_) on each half, the
    psum on the card; exact against numpy."""
    rng = np.random.default_rng(3)
    codes, weights, alive = _random_problem(rng, 100001, radices)
    k0 = cuda_kernels.launches['onehot_dense']
    got = tmesh.sharded_aggregate(codes, radices, weights, alive,
                                  mesh=tmesh.make_mesh(devices=[cuda] * 2))
    np.testing.assert_array_equal(
        got, _reference_dense(codes, radices, weights, alive))
    kernel = radices[0] * radices[1] <= cuda_kernels.MAX_SEGMENTS
    assert cuda_kernels.launches['onehot_dense'] - k0 == \
        (2 if kernel else 0)


@pytest.mark.cuda
@pytest.mark.parametrize('nshards', [1, 2, 3])
def test_cluster_scan_shards_on_the_card(tmp_path, monkeypatch, cuda,
                                         nshards):
    """The sharded device body on the card: points and --counters equal
    to the port's file backend on its host engine, K1 once per shard
    and device batch, one K9 merge per batch."""
    if tnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    monkeypatch.setenv('DN_READ_SIZE', '65536')
    monkeypatch.setenv('DN_SCAN_THREADS', '0')
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_records(datadir / 'a.log', 4000, 11)
    qconf = {'breakdowns': [{'name': 'host'},
                            {'name': 'latency', 'aggr': 'quantize'}],
             'filter': {'ne': ['res.statusCode', 500]}}
    fres = tdf.DatasourceFile(dict(_dsconfig(datadir), ds_backend='file')
                              ).scan(tquery.query_load(qconf),
                                     device='cpu', engine='vector')
    k0 = cuda_kernels.launches['onehot_dense']
    m0 = tmesh.launches['scan_merge']
    tres = tcluster.DatasourceCluster(
        _dsconfig(datadir), mesh=tmesh.make_mesh(devices=[cuda] * nshards)
    ).scan(tquery.query_load(qconf), device=cuda, engine='device')
    assert tres.points == fres.points
    assert _counters(tres) == _counters(fres)
    nb = _hidden(tres)['ndevicebatches']
    assert nb >= 4000 // BATCH
    assert tmesh.launches['scan_merge'] - m0 == nb
    assert cuda_kernels.launches['onehot_dense'] - k0 == nshards * nb


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run_cli(pkg, monkeypatch, env, args):
    if pkg == 'port':
        from dragnet_tpu_torch import cli
        monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    else:
        from dragnet_tpu import cli
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize('backend', ['cluster', 'manta'])
def test_cli_cluster_backend_matches_bin_dn(tmp_path, monkeypatch,
                                            backend):
    """`datasource-add --backend=cluster` (and its `manta` alias) no
    longer fails: scan and scan --counters print what bin/dn's cluster
    backend prints, and what the port's file backend prints."""
    if jnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_records(datadir / 'a.log', 2000, 31)
    env = {'DRAGNET_CONFIG': str(tmp_path / 'rc'), 'DN_READ_SIZE': '65536',
           'DN_PARSE_THREADS': '1'}
    monkeypatch.delenv('DN_ENGINE', raising=False)
    for name, be in (('cl', backend), ('fl', 'file')):
        rc, _, err = _run_cli('port', monkeypatch, env, [
            'datasource-add', name, '--backend=' + be,
            '--path=%s' % datadir, '--time-field=time'])
        assert rc in (0, None), err
    args = ['scan', '--counters', '-b', 'host,latency[aggr=quantize]',
            '-f', '{"ne": ["res.statusCode", 404]}']
    got = _run_cli('port', monkeypatch, env, args + ['cl'])
    ref = _run_cli('jax', monkeypatch, env, args + ['cl'])
    fil = _run_cli('port', monkeypatch, env, args + ['fl'])
    assert got[1] and got[1] == ref[1] == fil[1]
    assert 'Aggregator' in got[2] and got[2] == ref[2] == fil[2]
    _, _, usage = _run_cli('port', monkeypatch, env, ['nosuchcommand'])
    assert '[--backend=file|cluster]' in usage


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

DAYS = ('2014-05-01', '2014-05-02', '2014-05-03')


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_mp_data(datadir):
    rng = random.Random(11)
    for fn in ('a.log', 'b.log'):
        with open(datadir / fn, 'w') as f:
            for _ in range(200):
                f.write(json.dumps({
                    'time': '%sT%02d:00:%02dZ'
                            % (rng.choice(DAYS), rng.randrange(24),
                               rng.randrange(60)),
                    'host': rng.choice(['x', 'y', 'z']),
                    'latency': rng.choice([1, 7, 90, 2500]),
                }) + '\n')


def _spawn_pair(cmd, env, timeout=120):
    """Run `cmd` as processes 0 and 1 of a 2-process gloo group; a hang
    kills both and FAILS (the barrier contract)."""
    env = dict(env, DN_COORDINATOR='127.0.0.1:%d' % _free_port(),
               DN_NUM_PROCESSES='2')
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              env=dict(env, DN_PROCESS_ID=str(pid)))
             for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail('worker hung (barrier not released?)')
        outs.append((p.returncode, out, err))
    return outs


def _run_workers(args, worker=WORKER, env=None, timeout=120):
    outs = _spawn_pair([sys.executable, worker] + args,
                       dict(os.environ, **(env or {})), timeout=timeout)
    for rc, out, err in outs:
        assert rc == 0, err.decode()[-2000:]
    return [json.loads(out.decode().strip().splitlines()[-1])
            for rc, out, err in outs]


def _run_jax_workers(args):
    """The JAX package's own worker pair (jax.distributed on the CPU,
    4 virtual devices per process) on the same operation."""
    return _run_workers(args, worker=JAX_WORKER, env={
        'JAX_PLATFORMS': 'cpu',
        'XLA_FLAGS': '--xla_force_host_platform_device_count=4'})


def _file_ds(datadir, indexdir=None):
    bc = {'path': str(datadir), 'timeField': 'time'}
    if indexdir is not None:
        bc['indexPath'] = str(indexdir)
    return tdf.DatasourceFile({'ds_backend': 'file',
                               'ds_backend_config': bc,
                               'ds_filter': None, 'ds_format': 'json'})


def _worker_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location('tcw', WORKER)
    cw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cw)
    return cw


def test_two_process_cluster_scan(tmp_path):
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_mp_data(datadir)
    results = _run_workers(['scan', str(datadir)])
    assert [(r['pid'], r['nprocs']) for r in results] == [(0, 2), (1, 2)]
    cw = _worker_module()
    expected = [[f, v] for f, v in _file_ds(datadir).scan(
        tquery.query_load(cw.QUERY), device='cpu').points]
    for r in results:
        assert sorted(map(json.dumps, r['points'])) == \
            sorted(map(json.dumps, expected))
    # the allgather merge's process order: the JAX pair's points, in
    # the order they are emitted
    jax_results = _run_jax_workers(['scan', str(datadir)])
    for r, j in zip(results, jax_results):
        assert r['points'] == j['points']


def test_two_process_build_byte_identical(tmp_path):
    """Allgather-merge + process-0 write: index files byte-identical to
    a one-process file build of the port and of the JAX package."""
    from dragnet_tpu import query as jquery
    from dragnet_tpu import datasource_file as jdf
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_mp_data(datadir)
    idx_multi = tmp_path / 'idx_multi'
    results = _run_workers(['build', str(datadir), str(idx_multi)])
    assert results[0]['built'] == results[1]['built']
    cw = _worker_module()
    _file_ds(datadir, tmp_path / 'idx_single').build(
        [tquery.metric_deserialize(cw.METRIC)], 'day', device='cpu')
    jdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': str(datadir), 'timeField': 'time',
                              'indexPath': str(tmp_path / 'idx_jax')},
        'ds_filter': None, 'ds_format': 'json'}).build(
        [jquery.metric_deserialize(cw.METRIC)], 'day')
    multi = _tree_bytes(idx_multi)
    assert len(multi) == len(DAYS)
    assert multi == _tree_bytes(tmp_path / 'idx_single') == \
        _tree_bytes(tmp_path / 'idx_jax')


def test_build_write_failure_releases_barrier(tmp_path):
    """The index write fails on process 0: both processes reach the
    barrier, and both report the failure instead of hanging."""
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_mp_data(datadir)
    badparent = tmp_path / 'notadir'
    badparent.write_text('x')
    results = _run_workers(['build_fail', str(datadir),
                            str(badparent / 'idx')])
    by_pid = {r['pid']: r for r in results}
    assert set(by_pid) == {0, 1}
    assert 'NotADirectoryError' in by_pid[0]['error']
    assert by_pid[1]['error'] == \
        'DNError: index write failed on process 0'


def test_build_slow_write_outlasts_two_minutes(tmp_path):
    """Process 0's index write takes longer than two minutes while
    process 1 waits in the barrier's collective: a sound build, however
    long its write, must not time out there.  Both processes exit 0 with
    the one-process tree."""
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_mp_data(datadir)
    idx_multi = tmp_path / 'idx_multi'
    results = _run_workers(['build_slow', str(datadir), str(idx_multi),
                            '125'], timeout=300)
    assert results[0]['built'] == results[1]['built']
    cw = _worker_module()
    _file_ds(datadir, tmp_path / 'idx_single').build(
        [tquery.metric_deserialize(cw.METRIC)], 'day', device='cpu')
    assert _tree_bytes(idx_multi) == _tree_bytes(tmp_path / 'idx_single')


@pytest.mark.slow
def test_two_process_index_scan_merged(tmp_path):
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_mp_data(datadir)
    results = _run_workers(['index_scan', str(datadir)])
    cw = _worker_module()
    expected = [[f, v] for f, v in _file_ds(datadir).index_scan(
        [tquery.metric_deserialize(cw.METRIC)], 'day',
        device='cpu').points]
    assert expected
    jax_results = _run_jax_workers(['index_scan', str(datadir)])
    for r, j in zip(results, jax_results):
        assert r['points'] == expected == j['points']


@pytest.mark.slow
def test_two_process_distributed_query(tmp_path):
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_mp_data(datadir)
    indexdir = tmp_path / 'idx'
    cw = _worker_module()
    _file_ds(datadir, indexdir).build(
        [tquery.metric_deserialize(cw.METRIC)], 'day', device='cpu')
    results = _run_workers(['query', str(datadir), str(indexdir)])
    expected = [[f, v] for f, v in _file_ds(datadir, indexdir).query(
        tquery.query_load(cw.QUERY), 'day', device='cpu').points]
    for r in results:
        assert sorted(map(json.dumps, r['points'])) == \
            sorted(map(json.dumps, expected))
    jax_results = _run_jax_workers(['query', str(datadir), str(indexdir)])
    for r, j in zip(results, jax_results):
        assert r['points'] == j['points']


@pytest.mark.slow
def test_two_process_cli_scan(tmp_path):
    """The CLI on both processes: process 0 prints the one-process
    output byte for byte, process 1 prints nothing."""
    datadir = tmp_path / 'data'
    datadir.mkdir()
    _write_mp_data(datadir)
    env = dict(os.environ, DRAGNET_CONFIG=str(tmp_path / 'rc'),
               DN_TORCH_DEVICE='cpu')
    cmd = [sys.executable, '-m', 'dragnet_tpu_torch']
    subprocess.run(cmd + ['datasource-add', 'cl', '--backend=cluster',
                          '--path=%s' % datadir, '--time-field=time'],
                   check=True, env=env, capture_output=True, cwd=ROOT)
    scan = ['scan', '-b', 'host,latency[aggr=quantize]', 'cl']
    single = subprocess.run(cmd + scan, check=True, env=env,
                            capture_output=True, cwd=ROOT)
    outs = _spawn_pair(cmd + scan, dict(env, PYTHONPATH=ROOT))
    for rc, out, err in outs:
        assert rc == 0, err.decode()[-2000:]
    assert outs[0][1] == single.stdout
    assert outs[1][1] == b''
