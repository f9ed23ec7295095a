"""The port's forced-device scan (dragnet_tpu_torch, device='cpu')
against the JAX package's forced DeviceScan (DN_ENGINE=jax on XLA:CPU)
and its host engine, over data that forces batch-level host fallbacks
(arrays in filter fields, non-integral values, out-of-i32 numbers, bad
JSON), dictionary growth and time-window growth.  Points (in emission
order) and non-hidden counters must be identical: the sums are integer
and the order is part of the result."""

import json
import random

import pytest
import torch

from dragnet_tpu import native as jnative
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch.errors import DNError

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


def _differential(monkeypatch, datafile, qconf):
    jdev_points, jdev_counters = _jax_scan(monkeypatch, datafile, qconf,
                                           'jax')
    jhost_points, jhost_counters = _jax_scan(monkeypatch, datafile,
                                             qconf, 'vector')
    points, counters, hidden = _port_scan(monkeypatch, datafile, qconf)
    assert points == jdev_points, qconf
    assert counters == jdev_counters, qconf
    assert points == jhost_points, qconf
    assert counters == jhost_counters, qconf
    hpoints, hcounters, _ = _port_scan(monkeypatch, datafile, qconf,
                                       engine='vector')
    assert hpoints == points and hcounters == counters, qconf
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


def test_port_scan_sparse_not_yet_ported(tmp_path, monkeypatch):
    """A key space beyond the dense accumulator needs the sparse device
    program: the port refuses it loudly instead of running it on the
    host."""
    lines = [json.dumps({'time': '2014-05-01T00:00:%02d.%03dZ'
                         % (i // 1000, i % 1000),
                         'host': 'h%d' % (i % 50), 'latency': i % 13,
                         'code': 200 + i % 7,
                         'req': {'method': 'M%d' % (i % 5)}})
             for i in range(1000)]
    datafile = _write(tmp_path, lines)
    qconf = {'breakdowns': [{'name': 'time'}, {'name': 'host'},
                            {'name': 'latency'}, {'name': 'code'},
                            {'name': 'req.method'}]}
    with pytest.raises(DNError, match='not yet ported'):
        _port_scan(monkeypatch, datafile, qconf)
    # the host engine still answers it, as the JAX package does
    points, _, _ = _port_scan(monkeypatch, datafile, qconf,
                              engine='vector')
    jpoints, _ = _jax_scan(monkeypatch, datafile, qconf, 'jax')
    assert points == jpoints
