"""The port's forced-device scan (dragnet_tpu_torch, device='cpu')
against the JAX package's forced DeviceScan (DN_ENGINE=jax on XLA:CPU)
and its host engine, over data that forces batch-level host fallbacks
(arrays in filter fields, non-integral values, out-of-i32 numbers, bad
JSON), dictionary growth and time-window growth.  Points (in emission
order) and non-hidden counters must be identical: the sums are integer
and the order is part of the result."""

import json
import random

import numpy as np

import pytest
import torch

from dragnet_tpu import native as jnative
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import device_scan as tds

from helpers.scan_differential import scan_points_counters

DS_FILTER = {'ne': ['host', 'zzz']}


def _mklines(rng, n):
    hosts = ['a', 'b', 'c', 'host-%d', None, True, 17]
    methods = ['GET', 'PUT', 'DELETE', None]
    lines = []
    for i in range(n):
        rec = {}
        h = rng.choice(hosts)
        if h == 'host-%d':
            h = 'host-%d' % rng.randrange(40)
        if rng.random() < 0.95:
            rec['host'] = h
        if rng.random() < 0.9:
            rec['req'] = {'method': rng.choice(methods)}
        if rng.random() < 0.95:
            rec['latency'] = rng.choice(
                [0, 1, 3, 17, 200, 4096, 123456, -2, '26', 'x', None])
        if rng.random() < 0.95:
            rec['code'] = rng.choice([200, 204, 404, 500, '500'])
        if rng.random() < 0.95:
            # time-window growth: later records move to later days
            day = 1 + (i * 3 // n)
            rec['time'] = '2014-05-%02dT%02d:%02d:%02dZ' % (
                day, rng.randrange(24), rng.randrange(60),
                rng.randrange(60))
        elif rng.random() < 0.5:
            rec['time'] = 'invalid'
        lines.append(json.dumps(rec))
    return lines


EDGE_LINES = [
    # array value in a filter/key field -> batch fallback
    '{"host":[1,"two"],"latency":3,"code":200,'
    '"time":"2014-05-01T01:00:00Z"}',
    # non-integral latency -> batch fallback for quantize queries
    '{"host":"a","latency":2.5,"code":200,'
    '"time":"2014-05-01T02:00:00Z"}',
    # out-of-i32 number in a field
    '{"host":"a","latency":3,"code":123456789012345,'
    '"time":"2014-05-01T03:00:00Z"}',
    '{"host":{"x":1},"latency":4,"code":204,'
    '"time":"2014-05-01T04:00:00Z"}',
    'not json',
    '{"latency":9}',
]

QUERIES = [
    {},
    {'breakdowns': [{'name': 'host'}]},
    {'breakdowns': [{'name': 'req.method'}, {'name': 'host'}]},
    {'breakdowns': [{'name': 'latency', 'aggr': 'quantize'}]},
    {'breakdowns': [{'name': 'host'},
                    {'name': 'latency', 'aggr': 'lquantize',
                     'step': 100}]},
    {'breakdowns': [{'name': 'code'}],
     'filter': {'eq': ['req.method', 'GET']}},
    {'breakdowns': [{'name': 'host'}],
     'filter': {'or': [{'eq': ['code', '200']},
                       {'and': [{'gt': ['latency', 100]},
                                {'ne': ['host', 'a']}]}]}},
    {'breakdowns': [{'name': 'code'}],
     'filter': {'le': ['latency', 17]}},
    {'breakdowns': [{'name': 'ts', 'field': 'time', 'date': '',
                     'aggr': 'lquantize', 'step': 3600},
                    {'name': 'req.method'}]},
    {'timeAfter': '2014-05-01T06:00:00Z',
     'timeBefore': '2014-05-02T12:00:00Z',
     'breakdowns': [{'name': 'host'}]},
]

# small batches, and reads small enough that batches split mid-file
BATCH = 128
READ_SIZE = 2048


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    if jnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_READ_SIZE', str(READ_SIZE))


def _write(tmp_path, lines):
    path = str(tmp_path / 'data.log')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def _jax_scan(monkeypatch, datafile, qconf, engine):
    return scan_points_counters(monkeypatch, datafile, qconf, engine,
                                batch=BATCH, read_size=READ_SIZE,
                                time_field='time',
                                ds_filter=DS_FILTER)


def _port_scan(monkeypatch, datafile, qconf, engine='device'):
    """(points, non-hidden counters, hidden aggregator counters)."""
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    ds = tdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': datafile, 'timeField': 'time'},
        'ds_filter': DS_FILTER,
        'ds_format': 'json',
    })
    r = ds.scan(tquery.query_load(json.loads(json.dumps(qconf))),
                device='cpu', engine=engine)
    counters = {(s.name, k): v for s in r.pipeline.stages
                for k, v in s.counters.items()
                if v and k not in s.hidden}
    aggr = [s for s in r.pipeline.stages if s.name == 'Aggregator'][0]
    hidden = {k: aggr.counters[k] for k in aggr.hidden}
    return r.points, counters, hidden


SPILL = ('Aggregator', 'nspillrecords')


def _differential(monkeypatch, datafile, qconf, spill_straddles=False):
    """The port's device scan against the JAX package's device and host
    engines and the port's host engine.  `spill_straddles`: the key
    space crosses the dense budget between batches, where the device's
    pow2 caps and the host engine's exact radices decide dense vs
    sparse differently, so the nspillrecords count is held to the JAX
    device engine only (the reference documents this difference in
    DeviceScan._build_static)."""
    jdev_points, jdev_counters = _jax_scan(monkeypatch, datafile, qconf,
                                           'jax')
    jhost_points, jhost_counters = _jax_scan(monkeypatch, datafile,
                                             qconf, 'vector')
    points, counters, hidden = _port_scan(monkeypatch, datafile, qconf)
    hpoints, hcounters, _ = _port_scan(monkeypatch, datafile, qconf,
                                       engine='vector')
    assert points == jdev_points, qconf
    assert counters == jdev_counters, qconf
    assert points == jhost_points == hpoints, qconf
    assert hcounters == jhost_counters, qconf
    if spill_straddles:
        assert counters.get(SPILL) != hcounters.get(SPILL)
        counters = {k: v for k, v in counters.items() if k != SPILL}
        hcounters = {k: v for k, v in hcounters.items() if k != SPILL}
    assert counters == hcounters, qconf
    return hidden


@pytest.mark.parametrize('qi', range(len(QUERIES)))
def test_port_scan_matches_jax(tmp_path, monkeypatch, qi):
    rng = random.Random(99 + qi)
    lines = _mklines(rng, 700)
    # interleave edge lines so some batches fall back mid-stream
    for i, el in enumerate(EDGE_LINES):
        lines.insert((i + 1) * 90, el)
    hidden = _differential(monkeypatch, _write(tmp_path, lines),
                           QUERIES[qi])
    assert hidden.get('ndevicebatches', 0) > 0


@pytest.mark.parametrize('qi', range(len(QUERIES)))
def test_port_scan_clean_runs_every_batch_on_device(tmp_path, monkeypatch,
                                                    qi):
    """Clean input: every batch takes the device path (no vacuous pass
    via the host fallback)."""
    ran = []
    orig = tds.DeviceScan._try_device

    def spy(self, provider, weights, alive):
        rv = orig(self, provider, weights, alive)
        ran.append(rv)
        return rv
    monkeypatch.setattr(tds.DeviceScan, '_try_device', spy)
    rng = random.Random(7 + qi)
    lines = [ln for ln in _mklines(rng, 500)
             if '"x"' not in ln and '"26"' not in ln]
    hidden = _differential(monkeypatch, _write(tmp_path, lines),
                           QUERIES[qi])
    assert ran and all(ran)
    assert hidden['ndevicebatches'] == len(ran)


KERNEL_QUERIES = [
    {'breakdowns': [{'name': 'req.method'},
                    {'name': 'latency', 'aggr': 'quantize'}],
     'filter': {'ne': ['code', 404]}},
    QUERIES[8],
]


@pytest.mark.parametrize('qconf', KERNEL_QUERIES)
def test_port_scan_kernel_path_matches_pallas(tmp_path, monkeypatch,
                                              qconf):
    """The one-hot route (ns <= 4096) against the JAX DeviceScan running
    its Pallas kernel in interpret mode."""
    monkeypatch.setenv('DN_PALLAS', 'force')
    rng = random.Random(21)
    lines = [ln for ln in _mklines(rng, 300)
             if '"x"' not in ln and '"26"' not in ln]
    datafile = _write(tmp_path, lines)
    used = []
    orig = tds.cuda_kernels.should_use

    def spy(ns, total):
        rv = orig(ns, total)
        used.append(rv)
        return rv
    monkeypatch.setattr(tds.cuda_kernels, 'should_use', spy)
    jpoints, jcounters = _jax_scan(monkeypatch, datafile, qconf, 'jax')
    points, counters, _ = _port_scan(monkeypatch, datafile, qconf)
    assert points == jpoints
    assert counters == jcounters
    assert used and all(used)


@pytest.mark.parametrize('qconf', KERNEL_QUERIES)
def test_port_scan_kernel_route_adds_into_accumulator(tmp_path, monkeypatch,
                                                      qconf):
    """The kernel route hands the body's i32 fused key (dead rows at ns)
    and the resident accumulator itself to onehot_dense_into: no codes
    stack, no per-batch dense, and the codes entry is never called.
    The output stays identical to the JAX package's Pallas route."""
    monkeypatch.setenv('DN_PALLAS', 'force')
    rng = random.Random(23)
    lines = [ln for ln in _mklines(rng, 300)
             if '"x"' not in ln and '"26"' not in ln]
    datafile = _write(tmp_path, lines)
    calls = []
    orig_fold = tds.DeviceScan._fold
    orig_into = tds.cuda_kernels.onehot_dense_into
    acc = []

    def fold(self, args, n, profile, caps, ns, use_kernel, base):
        acc.append((self._acc[0], n, ns, use_kernel))
        return orig_fold(self, args, n, profile, caps, ns, use_kernel,
                         base)

    def into(out, fused, weights):
        calls.append((out, fused.dtype, int(fused.shape[0]),
                      int(fused[(fused >= 0) & (fused < out.shape[0])]
                          .numel())))
        return orig_into(out, fused, weights)

    def codes_entry(*a):
        raise AssertionError('the device scan called the codes entry')
    monkeypatch.setattr(tds.DeviceScan, '_fold', fold)
    monkeypatch.setattr(tds.cuda_kernels, 'onehot_dense_into', into)
    monkeypatch.setattr(tds.cuda_kernels, 'onehot_dense', codes_entry)
    jpoints, jcounters = _jax_scan(monkeypatch, datafile, qconf, 'jax')
    points, counters, _ = _port_scan(monkeypatch, datafile, qconf)
    assert points == jpoints
    assert counters == jcounters
    assert acc and all(k for _, _, _, k in acc)
    assert len(calls) == len(acc)
    for (out, dtype, n, live), (resident, bn, ns, _) in zip(calls, acc):
        assert out is resident and out.shape[0] == ns
        assert dtype == torch.int32 and n == bn and 0 < live <= n


def test_port_scan_compact_flush(tmp_path, monkeypatch):
    """An accumulator of >= 16384 segments is compacted on device before
    the fetch, in the port as in the reference."""
    rng = random.Random(3)
    lines = [ln for ln in _mklines(rng, 600)
             if '"x"' not in ln and '"26"' not in ln]
    datafile = _write(tmp_path, lines)
    qconf = {'breakdowns': [{'name': 'host'}, {'name': 'req.method'},
                            {'name': 'latency', 'aggr': 'quantize'}]}
    hidden = _differential(monkeypatch, datafile, qconf)
    assert hidden.get('ncompactflush', 0) > 0
    assert hidden['ndevicebatches'] > 0


def _force_sparse(monkeypatch, max_dense, cap0=None, cap_max=None):
    """The same dense budget and sparse capacities in both packages."""
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    from dragnet_tpu_torch import engine as tengine
    for mod in (jengine, jds, tengine, tds):
        monkeypatch.setattr(mod, 'MAX_DENSE_SEGMENTS', max_dense)
    for mod in (jds, tds):
        if cap0 is not None:
            monkeypatch.setattr(mod, 'SPARSE_CAP0', cap0)
        if cap_max is not None:
            monkeypatch.setattr(mod, 'SPARSE_CAP_MAX', cap_max)


def _sparse_folds():
    return tds.sparse_folds['fold_sparse']


# (dense budget, SPARSE_CAP0, query): the forced-tiny budget at the
# default-ish and at a tiny capacity (the guard flushes and grows the
# set mid-stream), and a key space past the real 2^24 budget
SPARSE_CASES = {
    'cap0_2e18': (64, 1 << 18,
                  {'breakdowns': [{'name': 'host'}, {'name': 'latency'}]}),
    'cap0_64': (64, 64,
                {'breakdowns': [{'name': 'host'}, {'name': 'latency'}]}),
    'past_2e24': (None, None,
                  {'breakdowns': [{'name': 'time'}, {'name': 'host'},
                                  {'name': 'latency'}, {'name': 'code'},
                                  {'name': 'req.method'}]}),
}


@pytest.mark.parametrize('case', sorted(SPARSE_CASES))
def test_port_scan_sparse_differential(tmp_path, monkeypatch, case):
    """High-cardinality scans run the sparse program on the device and
    match the JAX package's forced device and host engines exactly —
    points, emission order, counters (nspillrecords included)."""
    max_dense, cap0, qconf = SPARSE_CASES[case]
    if max_dense is not None:
        _force_sparse(monkeypatch, max_dense, cap0, max(cap0, 1024))
    rng = random.Random(77)
    lines = _mklines(rng, 900)
    for i, el in enumerate(EDGE_LINES):
        lines.insert((i + 1) * 120, el)
    datafile = _write(tmp_path, lines)
    folds0 = _sparse_folds()
    hidden = _differential(monkeypatch, datafile, qconf,
                           spill_straddles=case == 'past_2e24')
    assert _sparse_folds() > folds0
    assert hidden['ndevicebatches'] > 0
    if case == 'cap0_64':
        assert hidden.get('nsparsegrow', 0) > 0


def test_port_scan_sparse_engages_every_batch(tmp_path, monkeypatch):
    """Clean input: every batch folds through the sparse program, one
    fold per batch, and the epoch's spill count is every aggregated
    record."""
    _force_sparse(monkeypatch, 64)
    rng = random.Random(78)
    lines = [ln for ln in _mklines(rng, 600)
             if '"x"' not in ln and '"26"' not in ln]
    datafile = _write(tmp_path, lines)
    qconf = {'breakdowns': [{'name': 'host'}, {'name': 'latency'}]}
    folds0 = _sparse_folds()
    hidden = _differential(monkeypatch, datafile, qconf)
    nbatches = hidden['ndevicebatches']
    assert nbatches == (len(lines) + BATCH - 1) // BATCH
    assert _sparse_folds() - folds0 == nbatches
    assert hidden.get('nsparseceiling', 0) == 0


def test_port_scan_sparse_ceiling_hands_over(tmp_path, monkeypatch):
    """At SPARSE_CAP_MAX the guard flushes, disables the device and the
    host engine takes over for the rest of the scan: the output is
    identical to the reference's (which hands over the same way)."""
    _force_sparse(monkeypatch, 64, cap0=64, cap_max=256)
    rng = random.Random(79)
    lines = _mklines(rng, 900)
    datafile = _write(tmp_path, lines)
    qconf = {'breakdowns': [{'name': 'host'}, {'name': 'latency'},
                            {'name': 'code'}]}
    hidden = _differential(monkeypatch, datafile, qconf)
    assert hidden['nsparseceiling'] == 1
    assert hidden['nsparsegrow'] == 1     # 64 -> 256, then the ceiling
    assert 0 < hidden['ndevicebatches'] < (len(lines) + BATCH - 1) // BATCH


def test_port_scan_sparse_cap_overflow_falls_back(tmp_path, monkeypatch):
    """A single bucketized column whose ordinal span exceeds 2^31
    cannot use the device (codes are i32 there): host path, identical
    results."""
    _force_sparse(monkeypatch, 32)
    rng = random.Random(91)
    lines = [json.dumps({'v': rng.choice([-2100000000, -5, 0, 7,
                                          2100000000]) + i,
                         'host': 'h%d' % (i % 7),
                         'time': '2014-05-01T00:00:00Z'})
             for i in range(300)]
    datafile = _write(tmp_path, lines)
    qconf = {'breakdowns': [{'name': 'v', 'aggr': 'lquantize',
                             'step': 1}]}
    folds0 = _sparse_folds()
    hidden = _differential(monkeypatch, datafile, qconf)
    assert hidden.get('ndevicebatches', 0) == 0
    assert _sparse_folds() == folds0


def test_port_scan_sparse_weight_overflow_refetch(tmp_path, monkeypatch):
    """json-skinner points whose per-key weight sums pass i32 (each
    batch's total stays below 2^31, so every batch runs on the device):
    the narrowed i32 fetch flags the overflow and refetches in i64."""
    _force_sparse(monkeypatch, 16)
    lines = [json.dumps({'fields': {'host': 'h%d' % (i % 4),
                                    'code': 200 + i % 3},
                         'value': 14000000 + i})
             for i in range(3000)]
    datafile = _write(tmp_path, lines)
    qconf = {'breakdowns': [{'name': 'host'}, {'name': 'code'}]}
    full = []
    orig = tds._sparse_program_full

    def spy(acc, k):
        full.append(k)
        return orig(acc, k)
    monkeypatch.setattr(tds, '_sparse_program_full', spy)
    ran = []
    orig_try = tds.DeviceScan._try_device

    def try_device(self, provider, weights, alive):
        rv = orig_try(self, provider, weights, alive)
        ran.append(rv)
        return rv
    monkeypatch.setattr(tds.DeviceScan, '_try_device', try_device)
    jpoints, jcounters = scan_points_counters(
        monkeypatch, datafile, qconf, 'jax', batch=BATCH,
        read_size=READ_SIZE, fmt='json-skinner')
    hpoints, hcounters = scan_points_counters(
        monkeypatch, datafile, qconf, 'vector', batch=BATCH,
        read_size=READ_SIZE, fmt='json-skinner')
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    ds = tdf.DatasourceFile({'ds_backend': 'file',
                             'ds_backend_config': {'path': datafile},
                             'ds_filter': None,
                             'ds_format': 'json-skinner'})
    r = ds.scan(tquery.query_load(qconf), device='cpu')
    counters = {(s.name, k): v for s in r.pipeline.stages
                for k, v in s.counters.items() if v and k not in s.hidden}
    assert max(v for _, v in r.points) > 2 ** 31
    assert r.points == jpoints == hpoints
    assert counters == jcounters == hcounters
    assert full
    aggr = [s for s in r.pipeline.stages if s.name == 'Aggregator'][0]
    assert ran and all(ran)
    assert aggr.counters['ndevicebatches'] == len(ran)


def test_port_scan_dense_to_sparse_flip(tmp_path, monkeypatch):
    """A per-minute breakdown whose time window grows: the scan starts
    dense and turns sparse once the key space passes the dense budget,
    flushing at the epoch flip.  Emission order across the epochs (and
    nspillrecords, counted in the sparse epochs only) equals the
    reference's."""
    _force_sparse(monkeypatch, 1 << 16)
    lines = []
    for i in range(1500):
        lines.append(json.dumps({
            'time': '2014-05-01T%02d:%02d:%02dZ' % (
                i // 300, (i // 5) % 60, i % 60),
            'host': 'h%d' % (i % 9), 'latency': (i * 37) % 5000,
            'req': {'method': 'GET'}, 'code': 200}))
    datafile = _write(tmp_path, lines)
    qconf = {'breakdowns': [{'name': 'ts', 'field': 'time', 'date': '',
                             'aggr': 'lquantize', 'step': 60},
                            {'name': 'host'},
                            {'name': 'latency', 'aggr': 'quantize'}]}
    routes = []
    orig_fold = tds.DeviceScan._fold
    orig_sparse = tds.DeviceScan._fold_sparse

    def fold(self, *a):
        routes.append('dense')
        return orig_fold(self, *a)

    def fold_sparse(self, *a):
        routes.append('sparse')
        return orig_sparse(self, *a)
    monkeypatch.setattr(tds.DeviceScan, '_fold', fold)
    monkeypatch.setattr(tds.DeviceScan, '_fold_sparse', fold_sparse)
    _differential(monkeypatch, datafile, qconf, spill_straddles=True)
    dev = routes[:(len(lines) + BATCH - 1) // BATCH]
    assert dev[0] == 'dense' and dev[-1] == 'sparse'
    assert dev == sorted(dev)     # one flip, dense then sparse


def _sparse_fold_inputs(device, cap, nbatch, nkeys, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, nkeys, size=nbatch, dtype=np.int64) * 977
    dead = rng.random(nbatch) < 0.1
    keys[dead] = tds.I64MAX
    w = np.where(dead, 0, rng.integers(1, 5, size=nbatch)).astype(np.int64)
    first = np.where(dead, tds.I64MAX, np.arange(nbatch) + (3 << 32))
    t = [torch.from_numpy(a).to(device) for a in (keys, w, first)]
    acc = (torch.full((cap,), tds.I64MAX, dtype=torch.int64, device=device),
           torch.zeros(cap, dtype=torch.int64, device=device),
           torch.full((cap,), tds.I64MAX, dtype=torch.int64, device=device),
           torch.zeros(2, dtype=torch.int64, device=device),
           torch.zeros(2, dtype=torch.int64, device=device))
    cvec = torch.ones(2, dtype=torch.int32, device=device)
    return acc, cvec, t


def _fold_twice(device, cap, nkeys, occupied):
    acc, cvec, (k, w, f) = _sparse_fold_inputs(device, cap, 3000, nkeys, 5)
    acc = tds.fold_sparse(acc, cvec, k, w, f)
    acc2, _, (k2, w2, f2) = _sparse_fold_inputs(device, cap, 3000, nkeys, 6)
    acc = tds.fold_sparse(acc, cvec, k2, w2, f2 + (1 << 32),
                          occupied=occupied(acc))
    return [a.cpu().numpy() for a in acc]


@pytest.mark.parametrize('nkeys', [500, 20000])
def test_sparse_fold_matches_numpy(nkeys):
    """fold_sparse (two batches, the second merged over the occupied
    prefix only) against a numpy group-by: sorted unique keys in the
    prefix, summed weights, min first occurrence, the unique count and
    the sticky overflow flag at cap + 1 routing."""
    cap = 4096
    got = _fold_twice('cpu', cap, nkeys, lambda acc: int(acc[4][0]))
    keys = []
    w = []
    f = []
    for seed, off in ((5, 0), (6, 1 << 32)):
        _, _, (k, ww, ff) = _sparse_fold_inputs('cpu', cap, 3000, nkeys,
                                                seed)
        keys.append(k.numpy())
        w.append(ww.numpy())
        f.append(np.where(ff.numpy() == tds.I64MAX, tds.I64MAX,
                          ff.numpy() + off))
    keys, w, f = (np.concatenate(a) for a in (keys, w, f))
    live = keys != tds.I64MAX
    uk, inv = np.unique(keys[live], return_inverse=True)
    nuniq = len(uk)
    assert got[4][0] == nuniq
    assert got[4][1] == int(nuniq > cap)
    m = min(nuniq, cap)
    assert (got[0][:m] == uk[:m]).all()
    assert (got[0][m:] == tds.I64MAX).all()
    if nuniq <= cap:
        wsum = np.zeros(nuniq, dtype=np.int64)
        np.add.at(wsum, inv, w[live])
        fmin = np.full(nuniq, tds.I64MAX, dtype=np.int64)
        np.minimum.at(fmin, inv, f[live])
        assert (got[1][:m] == wsum).all() and (got[1][m:] == 0).all()
        assert (got[2][:m] == fmin).all()
    assert (got[3] == 2).all()


@pytest.mark.cuda
@pytest.mark.parametrize('nkeys', [500, 20000])
def test_sparse_fold_cuda_matches_cpu(nkeys):
    """The sparse fold on the card equals the same fold on the CPU,
    including an overflow batch (more uniques than the capacity): run
    ids past cap land in the extra slot, so no device assert fires and
    the overflow flag is set."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    def occ(acc):
        return int(acc[4][0])
    cpu = _fold_twice('cpu', 4096, nkeys, occ)
    cuda = _fold_twice('cuda', 4096, nkeys, occ)
    for a, b in zip(cpu, cuda):
        assert (a == b).all()
    if nkeys > 4096:
        assert cuda[4][1] == 1
    torch.cuda.synchronize()
