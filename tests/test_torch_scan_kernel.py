"""The scan program's Hopper kernel (K2, ops/csrc/scan_body.cu) against
its plain version (scan_program.scan_body_ref) on the card: captured
batches uploaded at each width (u8, i16, i32), every output mode,
whole and as mesh shards, exactly; the deepest filter chain and a
filter past the inline slots through a device scan on the card; a
failed build or launch raises and is never answered by the plain
version.  The tests marked `cuda` skip without a card; the wrapper's
own checks run on the CPU too."""

import ctypes
import json
import random
import types

import numpy as np
import pytest
import torch

from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import devbench
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import native as tnative
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import scan_program as sp
from dragnet_tpu_torch.engine import NativeColumns
from dragnet_tpu_torch.ops import cuda_kernels
from dragnet_tpu_torch.vpipe import Pipeline

from helpers.scan_records import records, write

LAT_P2 = {'name': 'latency', 'aggr': 'quantize'}
FILTER = {'or': [
    {'and': [{'or': [{'eq': ['host', 'a']},
                     {'and': [{'eq': ['host', 17]},
                              {'ne': ['code', '500']}]}]},
             {'ne': ['latency', 0]}]},
    {'and': [{'eq': ['req.method', 'GET']},
             {'or': [{'lt': ['latency', 'Infinity']},
                     {'eq': ['code', 200]}]}]}]}
QUERIES = [
    {'breakdowns': [{'name': 'host'}, LAT_P2], 'filter': FILTER},
    {'timeAfter': '2014-05-01T06:00:00Z',
     'timeBefore': '2014-05-02T12:00:00Z',
     'breakdowns': [{'name': 'ts', 'field': 'time', 'date': '',
                     'aggr': 'lquantize', 'step': 60}, {'name': 'code'},
                    {'name': 'delta', 'aggr': 'lquantize', 'step': 7}]},
    {'filter': {'ge': ['latency', 17]}},
]
# latency values of each upload width
WIDTHS = {'u8': (0, 250), 'i16': (-30000, 30000),
          'i32': (-2000000000, 2000000000)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    if tnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    return torch.device('cuda')


def _capture(datafile, qconf, weights, device, time_field='time',
             max_records=4096):
    scan = tds.DeviceScan(tquery.query_load(json.loads(json.dumps(qconf))),
                          time_field, Pipeline(), device=device)
    parser = devbench._one_batch_parser(datafile, scan, max_records)
    n = parser.batch_size()
    scan.capture_next = True
    assert scan._try_device(NativeColumns(parser), weights(n), None)
    torch.cuda.synchronize()
    inputs, staged, _ = scan.captured
    args = {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in inputs.items()}
    return scan, inputs, args, staged


def _accs(ns, ncounters, device):
    return [torch.zeros(ns, dtype=torch.int64, device=device),
            torch.full((ns,), sp.I64MAX, dtype=torch.int64, device=device),
            torch.zeros(ncounters, dtype=torch.int64, device=device)]


def _compare(scan, args, staged, device):
    """Every mode, whole and as two mesh shards where alive is
    synthesized: the kernel's outputs equal the plain version's."""
    n, profile, caps, ns, _ = staged
    nsb = max(ns, 1)
    ran = 0
    for mode in (sp.MODE_K1, sp.MODE_DENSE, sp.MODE_SPARSE):
        if mode != sp.MODE_SPARSE and nsb > tds.MAX_DENSE_SEGMENTS:
            continue
        prog = scan._program(profile, caps, ns, mode)
        rowkeys = {prog.slot_keys[i] for i in prog.rows}
        shards = [(0, n, None)]
        if mode != sp.MODE_SPARSE and profile[1]:
            shards += [(0, n // 2, n - 5), (n // 2, n - n // 2, n - 5)]
        for row0, sn, nvalid in shards:
            sargs = {k: args[k][row0:row0 + sn].contiguous()
                     if k in rowkeys else args[k] for k in prog.slot_keys}
            got, want = _accs(nsb, prog.ncounters, device), \
                _accs(nsb, prog.ncounters, device)
            kout = [torch.empty(sn, dtype=torch.int32, device=device)
                    for _ in range(2)]
            l0 = cuda_kernels.launches['scan_body']
            a = sp.scan_body(prog, sargs, sn, *got, base=5 << 32,
                             row0=row0, nvalid=nvalid, key_out=kout[0])
            assert cuda_kernels.launches['scan_body'] == l0 + 1
            b = sp.scan_body_ref(prog, sargs, sn, *want, base=5 << 32,
                                 row0=row0, nvalid=nvalid,
                                 key_out=kout[1])
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                assert torch.equal(x, y), (mode, row0)
            if mode == sp.MODE_K1:
                assert torch.equal(a, b)
            elif mode == sp.MODE_SPARSE:
                for x, y in zip(a, b):
                    assert torch.equal(x, y)
            ran += 1
    return ran


@pytest.mark.cuda
@pytest.mark.parametrize('width', sorted(WIDTHS))
@pytest.mark.parametrize('qi', range(len(QUERIES)))
def test_kernel_matches_plain_version(tmp_path, cuda, width, qi):
    """Random batches whose values upload at `width`, signed weights:
    K2 and scan_body_ref agree in every mode, exactly."""
    datafile = write(tmp_path, records(31 + qi, 3000,
                                       latencies=WIDTHS[width]))
    rng = np.random.default_rng(qi)
    scan, inputs, args, staged = _capture(
        datafile, QUERIES[qi],
        lambda n: rng.integers(-3, 9, n).astype(np.float64), cuda)
    if 'num_latency' in inputs:
        want = {'u8': np.uint8, 'i16': np.int16, 'i32': np.int32}[width]
        assert inputs['num_latency'].dtype == want
    assert _compare(scan, args, staged, cuda) >= 1


@pytest.mark.cuda
def test_kernel_on_generated_muskie_batch(tmp_path, cuda):
    """A 65,536-record batch of the generated request log for the main
    path's small-accumulator query, every mode."""
    datafile = str(tmp_path / 'muskie.log')
    tnative.gen_to_file(70000, datafile, seed=4)
    scan, _, args, staged = _capture(
        datafile, {'breakdowns': [{'name': 'host'}, LAT_P2],
                   'filter': {'ne': ['res.statusCode', 599]}},
        np.ones, cuda, time_field=None, max_records=65536)
    assert staged[0] == 65536
    assert _compare(scan, args, staged, cuda) == 7


def _port_scan(monkeypatch, datafile, qconf, engine, device):
    monkeypatch.setattr(tdf, 'BATCH_SIZE', 256)
    ds = tdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': datafile, 'timeField': 'time'},
        'ds_filter': None, 'ds_format': 'json'})
    r = ds.scan(tquery.query_load(json.loads(json.dumps(qconf))),
                device=device, engine=engine)
    counters = {(s.name, k): v for s in r.pipeline.stages
                for k, v in s.counters.items()
                if v and k not in s.hidden}
    return r.points, counters


def _chain(depth):
    f = {'eq': ['host', 'a']}
    for i in range(depth):
        f = {'and' if i % 2 else 'or': [{'ne': ['latency', i]}, f]}
    return f


@pytest.mark.cuda
def test_deep_and_wide_filters_on_card(tmp_path, monkeypatch, cuda):
    """A filter chain 600 deep (2 stack entries), a balanced filter of
    1,024 leaves (11) and one over 40 fields (more slots than the launch
    holds inline): the device scan on the card equals the host engine,
    K2 once per batch."""
    datafile = write(tmp_path, records(8, 1500))
    rng = random.Random(2)
    wide_lines = []
    for _ in range(800):
        rec = {'f%d' % j: rng.choice(['a', 'b', 1, 2, None, True])
               for j in range(40)}
        rec['host'] = rng.choice(['h0', 'h1', 'h2'])
        wide_lines.append(json.dumps(rec))
    widefile = write(tmp_path, wide_lines, 'wide.log')
    leaves = [{'ne': ['latency', i]} for i in range(1024)]
    while len(leaves) > 1:
        leaves = [{'and' if len(leaves) % 3 else 'or': leaves[i:i + 2]}
                  for i in range(0, len(leaves), 2)]
    cases = [(datafile, {'breakdowns': [{'name': 'host'}],
                         'filter': _chain(600)}),
             (datafile, {'breakdowns': [{'name': 'host'}],
                         'filter': leaves[0]}),
             (widefile, {'breakdowns': [{'name': 'host'}],
                         'filter': {'or': [
                             {'eq': ['f%d' % j, 'a' if j % 2 else 1]}
                             for j in range(40)]}})]
    for path, qconf in cases:
        l0 = cuda_kernels.launches['scan_body']
        dev = _port_scan(monkeypatch, path, qconf, 'device', 'cuda')
        torch.cuda.synchronize()
        assert cuda_kernels.launches['scan_body'] > l0
        assert dev == _port_scan(monkeypatch, path, qconf, 'vector',
                                 'cpu')


class _FailingLib(object):
    def dn_scan_body(self, *a):
        return 700      # cudaErrorIllegalAddress


@pytest.mark.cuda
def test_failed_launch_or_build_raises(tmp_path, monkeypatch, cuda):
    """A launch the CUDA entry refuses raises RuntimeError, a build that
    fails raises, and neither is answered by the plain version: the
    device scan fails instead of taking it."""
    datafile = write(tmp_path, records(3, 600))
    qconf = {'breakdowns': [{'name': 'host'}, LAT_P2], 'filter': FILTER}
    scan, _, args, staged = _capture(datafile, qconf, np.ones, cuda)
    n, profile, caps, ns, _ = staged
    prog = scan._program(profile, caps, ns, sp.MODE_DENSE)
    plain = []
    monkeypatch.setattr(sp, 'scan_body_ref',
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(sp, '_lib', None)
    monkeypatch.setattr(cuda_kernels, 'load_library',
                        lambda name, setup: _FailingLib())
    with pytest.raises(RuntimeError, match='scan kernel launch failed'):
        sp.scan_body(prog, args, n, *_accs(ns, prog.ncounters, cuda))

    def no_build(name, setup):
        raise RuntimeError('nvcc failed building %s' % name)
    monkeypatch.setattr(sp, '_lib', None)
    monkeypatch.setattr(cuda_kernels, 'load_library', no_build)
    with pytest.raises(Exception, match='nvcc failed'):
        _port_scan(monkeypatch, datafile, qconf, 'device', 'cuda')
    assert plain == []


def test_wrapper_checks_its_arguments():
    """The ctypes mirror's size is checked against the library's at
    load; an unsupported device raises; CPU tensors take the plain
    version."""
    def launch_bytes():
        return ctypes.sizeof(sp.DnScanLaunch) + 8
    lib = types.SimpleNamespace(dn_scan_body=types.SimpleNamespace(),
                                dn_scan_launch_bytes=launch_bytes)
    with pytest.raises(RuntimeError, match='ctypes mirror'):
        sp._setup(lib)
    meta = torch.zeros(3, dtype=torch.int64, device='meta')
    prog = sp.ScanProgram(sp.MODE_DENSE, 1, 3, {}, [], [], [])
    with pytest.raises(ValueError, match='unsupported device'):
        sp.scan_body(prog, {}, 0, meta, meta, meta)
