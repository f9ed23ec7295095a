"""The port's kernel-resident microbenchmark (dragnet_tpu_torch/devbench.py)
on the CPU, with the data writer and sizes of tests/test_devbench.py:
its fields, `records` and `segments` equal to the JAX package's
kernel_bench on the same file and query, the resident accumulator
equal to iters + 1 folds of one batch (and its points to the host
engine's on that batch, times iters + 1), the profiler trace, the
device rules; and both legs of chip_smoke.py's phase 16 on the card."""

import json
import os
import random

import numpy as np
import pytest
import torch

from dragnet_tpu import native as jnative
from dragnet_tpu_torch import devbench
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import engine as tengine
from dragnet_tpu_torch import native as tnative
from dragnet_tpu_torch.errors import DNError

from helpers.scan_differential import scan_points_counters

HOST_LATENCY = {'breakdowns': [{'name': 'host'},
                               {'name': 'latency', 'aggr': 'quantize'}]}

# name: (records written, query, iters, max_records, sparse): the three
# shapes of tests/test_devbench.py, and the second key space forced
# past a tiny dense budget in both packages (the sparse fold)
CASES = {
    'fields': (600, dict(HOST_LATENCY, filter={'ne': ['code', 500]}), 3,
               512, False),
    'max_records': (300, {'breakdowns': [{'name': 'host'}]}, 2, 128,
                    False),
    'trace_shape': (400, {'breakdowns': [{'name': 'host'}]}, 2, 128,
                    False),
    'sparse': (400, HOST_LATENCY, 2, 128, True),
}

KEYS = ('records', 'padded_records', 'segments', 'onehot_kernel',
        'kernel_launches', 'body_kernel', 'body_launches',
        'kernel_records_per_sec', 'kernel_ms_per_batch',
        'device_ms_per_batch', 'hbm_gb_per_sec', 'h2d_gb_per_sec',
        'h2d_bytes_per_record', 'd2h_mb_per_sec',
        'reupload_records_per_sec', 'residency_speedup', 'bound_ms',
        'bound_share', 'device_kind', 'platform')


@pytest.fixture(autouse=True)
def _native():
    if jnative.get_lib() is None or tnative.get_lib() is None:
        pytest.skip('native parser unavailable')


def _write_data(path, n, fractional=False):
    rng = random.Random(3)
    with open(path, 'w') as f:
        for _ in range(n):
            lat = rng.choice([1, 5, 40, 900])
            f.write(json.dumps({
                'host': 'h%d' % rng.randrange(8),
                'latency': lat + 0.5 if fractional else lat,
                'code': rng.choice([200, 404, 500]),
            }) + '\n')


def _force_sparse(monkeypatch):
    from dragnet_tpu import device_scan as jds
    from dragnet_tpu import engine as jengine
    for mod in (jengine, jds, tengine, tds):
        monkeypatch.setattr(mod, 'MAX_DENSE_SEGMENTS', 16)
    for mod in (jds, tds):
        monkeypatch.setattr(mod, 'SPARSE_CAP0', 1 << 10)


def _case(tmp_path, monkeypatch, name):
    n, qconf, iters, max_records, sparse = CASES[name]
    datafile = str(tmp_path / 'd.log')
    _write_data(datafile, n)
    if sparse:
        _force_sparse(monkeypatch)
    return datafile, qconf, iters, max_records


@pytest.mark.parametrize('name', sorted(CASES))
def test_kernel_bench_matches_jax_package(tmp_path, monkeypatch, name):
    """The port's fields on the CPU; records and segments equal to the
    JAX package's kernel_bench on the same file and query."""
    from dragnet_tpu import devbench as jdevbench
    datafile, qconf, iters, max_records = _case(tmp_path, monkeypatch,
                                                name)
    r = devbench.kernel_bench(datafile, qconf, iters=iters,
                              max_records=max_records, device='cpu')
    ref = jdevbench.kernel_bench(datafile, qconf, iters=iters,
                                 max_records=max_records)
    assert r is not None and ref is not None
    assert set(r) == set(KEYS)
    assert r['records'] == r['padded_records'] == max_records
    assert (r['records'], r['segments']) == \
        (ref['records'], ref['segments'])
    for k in ('kernel_records_per_sec', 'kernel_ms_per_batch',
              'hbm_gb_per_sec', 'h2d_gb_per_sec', 'h2d_bytes_per_record',
              'd2h_mb_per_sec', 'reupload_records_per_sec',
              'residency_speedup'):
        assert r[k] > 0, k
    # no kernel, no device clock and no bandwidth bound on the CPU
    assert r['onehot_kernel'] is False and r['kernel_launches'] == 0
    assert r['body_kernel'] is False and r['body_launches'] == 0
    assert r['device_ms_per_batch'] is None
    assert r['bound_ms'] is None and r['bound_share'] is None
    assert r['platform'] == 'cpu' and r['device_kind'] == 'cpu'
    # no padding floor: fewer bytes a record than the reference's
    assert r['h2d_bytes_per_record'] <= ref['h2d_bytes_per_record']


@pytest.mark.parametrize('name', sorted(CASES))
def test_kernel_bench_resident_accumulator(tmp_path, monkeypatch, name):
    """The resident loop folds real work: its accumulator equals iters +
    1 plain folds of the batch, and its points equal the host engine's
    on the same records with every weight times iters + 1."""
    datafile, qconf, iters, max_records = _case(tmp_path, monkeypatch,
                                                name)
    cap = {}
    r = devbench.kernel_bench(datafile, qconf, iters=iters,
                              max_records=max_records, device='cpu',
                              capture=cap)
    assert r is not None
    if CASES[name][4]:
        assert cap['plain'] is None and len(cap['resident']) == 5
    else:
        dense, first, cvec = cap['resident']
        pdense, pfirst, pcvec = cap['plain']
        assert pdense.sum() > 0
        assert np.array_equal(dense, (iters + 1) * pdense)
        assert np.array_equal(cvec, (iters + 1) * pcvec)
        assert np.array_equal(first, pfirst)
    head = str(tmp_path / 'head.log')
    with open(datafile) as f, open(head, 'w') as g:
        g.writelines(f.readlines()[:max_records])
    points, _ = scan_points_counters(monkeypatch, head, qconf, 'vector')
    assert points
    assert cap['points'] == [(fields, (iters + 1) * w)
                             for fields, w in points]


def test_kernel_bench_records_profiler_trace(tmp_path, monkeypatch):
    """DN_BENCH_TRACE=dir wraps the resident loop in torch.profiler; a
    Chrome trace naming the loop's ops lands in dir."""
    datafile, qconf, iters, max_records = _case(tmp_path, monkeypatch,
                                                'trace_shape')
    tracedir = str(tmp_path / 'trace')
    monkeypatch.setenv('DN_BENCH_TRACE', tracedir)
    r = devbench.kernel_bench(datafile, qconf, iters=iters,
                              max_records=max_records, device='cpu')
    assert r is not None
    found = [os.path.join(d, f) for d, _, fs in os.walk(tracedir)
             for f in fs]
    assert len(found) == 1 and found[0].endswith('.json')
    with open(found[0]) as f:
        doc = json.load(f)
    names = {e.get('name') for e in doc['traceEvents']}
    assert 'aten::index_add_' in names


def test_kernel_bench_refusals(tmp_path, monkeypatch):
    """None, as the JAX package's, when the staging refuses the batch
    (non-integral values in a breakdown column) or the native parser is
    missing; CUDA asked for, by default, without it raises."""
    from dragnet_tpu import devbench as jdevbench
    datafile = str(tmp_path / 'frac.log')
    _write_data(datafile, 200, fractional=True)
    assert jdevbench.kernel_bench(datafile, HOST_LATENCY, iters=2,
                                  max_records=128) is None
    assert devbench.kernel_bench(datafile, HOST_LATENCY, iters=2,
                                 max_records=128, device='cpu') is None
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setattr(tnative, 'get_lib', lambda: None)
    assert devbench.kernel_bench(datafile, HOST_LATENCY) is None
    if torch.cuda.is_available():
        return
    monkeypatch.delenv('DN_TORCH_DEVICE')
    with pytest.raises(DNError, match='CUDA'):
        devbench.kernel_bench(datafile, HOST_LATENCY)


@pytest.mark.parametrize('kind,peak', [
    ('NVIDIA H100 80GB HBM3', 3.35e12), ('NVIDIA H100 PCIe', 2.0e12),
    ('NVIDIA H100 NVL', 3.9e12), ('NVIDIA A100-SXM4-80GB', None),
    ('cpu', None), ('', None)])
def test_peak_bandwidth_by_device_name(kind, peak):
    assert devbench.peak_hbm_bytes_per_s(kind) == peak


# chip_smoke.py phase 16's two legs (bench.py's QUERY and PALLAS_QUERY)
QUERY = {'breakdowns': [{'name': 'host'}, {'name': 'req.method'},
                        {'name': 'operation'},
                        {'name': 'latency', 'aggr': 'quantize'}],
         'filter': {'ne': ['res.statusCode', 599]}}


@pytest.mark.cuda
def test_kernel_bench_legs_on_card(tmp_path):
    """Both legs on the card over one 65,536-record batch: K1 carries
    the 256-segment loop, launching once a fold, and never the
    32,768-segment one; each accumulator is iters + 1 plain folds."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    datafile = str(tmp_path / 'muskie.log')
    tnative.gen_to_file(70000, datafile, seed=5)
    iters = 8
    for qconf, kernel in ((QUERY, False), (HOST_LATENCY, True)):
        cap = {}
        before = torch.cuda.memory_allocated()
        r = devbench.kernel_bench(datafile, qconf, iters=iters,
                                  capture=cap)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() <= before
        assert r['records'] == tengine.BATCH_SIZE
        assert r['onehot_kernel'] is kernel
        assert r['kernel_launches'] == (iters if kernel else 0)
        assert r['body_kernel'] and r['body_launches'] == iters
        assert r['platform'] == 'gpu'
        assert r['bound_share'] is None or r['bound_share'] < 1.05
        dense, first, cvec = cap['resident']
        pdense, pfirst, pcvec = cap['plain']
        assert np.array_equal(dense, (iters + 1) * pdense)
        assert np.array_equal(cvec, (iters + 1) * pcvec)
        assert np.array_equal(first, pfirst)
