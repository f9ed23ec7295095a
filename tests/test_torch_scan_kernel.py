"""The scan program's Hopper kernel (K2, ops/csrc/scan_body.cu) against
its plain version (scan_program.scan_body_ref) on the card: captured
batches uploaded at each width (u8, i16, i32), every output mode,
whole and as mesh shards, exactly; the deepest filter chain and a
filter past the inline slots through a device scan on the card; a
failed build or launch raises and is never answered by the plain
version; the dense route's accumulation on adversarial batches; a
batch of many tiles a block; programs past the block's slot map (300
fields, 4,500 string leaves); the prepared launch across staging-ring
slots, a cleared program memo and grown tables.  The tests marked
`cuda` skip without a card; the wrapper's own checks run on the CPU
too."""

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


def _accumulation_batches(args, keys, ns, rowkeys, device):
    """The accumulation batches of a captured batch with alive and
    weights columns (its rows' keys `keys`, ns where dead): (name,
    args, n) for one hot bin, all keys distinct, weights summing to 0
    per key, one hot bin with every other row dead, and n - 37 rows."""
    rng = np.random.default_rng(3)
    n = len(keys)

    def gather(rows, **cols):
        idx = torch.as_tensor(rows, device=device)
        out = {k: args[k][idx] if k in rowkeys else args[k] for k in args}
        for k, v in cols.items():
            out[k] = torch.as_tensor(v, device=device)
        return out
    live = np.flatnonzero(keys < ns)
    hot = gather(np.full(n, live[0]),
                 weights=rng.integers(-9, 10, n).astype(np.int32),
                 alive=np.ones(n, dtype=bool))
    uniq, first = np.unique(keys[live], return_index=True)
    zero = rng.integers(-5, 6, n).astype(np.int64)
    for k in np.unique(keys):
        rows = np.flatnonzero(keys == k)
        zero[rows[-1]] -= zero[rows].sum()
    dead = dict(hot, alive=hot['alive'].clone())
    dead['alive'][1::2] = False
    return [('one hot bin', hot, n),
            ('distinct keys', gather(np.sort(live[first])), len(uniq)),
            ('zero-sum weights', gather(np.arange(n),
                                        weights=zero.astype(np.int32)), n),
            ('hot, every other row dead', dead, n),
            ('n - 37', args, n - 37)]


@pytest.mark.cuda
def test_accumulation_batches(tmp_path, cuda):
    """The dense route's warp-aggregated accumulation and K1's first
    occurrences on adversarial batches, in K1 and dense modes, whole and
    as two mesh shards split at an odd row: one hot bin, all keys
    distinct, signed weights summing to 0 per key (a key of one row gets
    weight 0 and still has its first occurrence), every other row dead,
    a ragged n: K2 equals scan_body_ref exactly."""
    datafile = str(tmp_path / 'muskie.log')
    tnative.gen_to_file(9000, datafile, seed=6)
    rng = np.random.default_rng(1)
    scan = tds.DeviceScan(tquery.query_load(json.loads(json.dumps({
        'breakdowns': [{'name': 'host'}, {'name': 'req.method'},
                       {'name': 'operation'}, LAT_P2],
        'filter': {'ne': ['res.statusCode', 599]}}))), None, Pipeline(),
        device=cuda)
    parser = devbench._one_batch_parser(datafile, scan, 8192)
    n = parser.batch_size()
    scan.capture_next = True
    assert scan._try_device(NativeColumns(parser),
                            rng.integers(-3, 9, n).astype(np.float64),
                            np.ones(n, dtype=bool))
    torch.cuda.synchronize()
    inputs, (_, profile, caps, ns, _), _ = scan.captured
    args = {k: (torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
                if isinstance(v, np.ndarray) else v)
            for k, v in inputs.items()}
    args['weights'] = args['weights'].to(torch.int32)
    progs = [scan._program(profile, caps, ns, m)
             for m in (sp.MODE_K1, sp.MODE_DENSE)]
    rowkeys = {progs[0].slot_keys[i] for i in progs[0].rows}
    assert {'weights', 'alive'} <= rowkeys
    kout = torch.empty(n, dtype=torch.int32, device=cuda)
    sp.scan_body_ref(progs[0], args, n, None,
                     *_accs(ns, progs[0].ncounters, cuda)[1:],
                     key_out=kout)
    batches = _accumulation_batches(args, kout.cpu().numpy(), ns, rowkeys,
                                    cuda)
    for name, bargs, bn in batches:
        half = (bn // 2) | 1
        for prog in progs:
            for row0, sn in ((0, bn), (0, half), (half, bn - half)):
                sargs = {k: bargs[k][row0:row0 + sn] if k in rowkeys
                         else bargs[k] for k in prog.slot_keys}
                got, want = _accs(ns, prog.ncounters, cuda), \
                    _accs(ns, prog.ncounters, cuda)
                kouts = [torch.empty(sn, dtype=torch.int32, device=cuda)
                         for _ in range(2)]
                a = sp.scan_body(prog, sargs, sn, *got, base=7 << 32,
                                 row0=row0, key_out=kouts[0])
                b = sp.scan_body_ref(prog, sargs, sn, *want, base=7 << 32,
                                     row0=row0, key_out=kouts[1])
                torch.cuda.synchronize()
                where = (name, prog.mode, row0)
                for x, y in zip(got, want):
                    assert torch.equal(x, y), where
                if prog.mode == sp.MODE_K1:
                    assert torch.equal(a, b), where
                assert int(want[2][-3]) > 0, where   # ninputs


@pytest.mark.cuda
def test_large_batches(tmp_path, cuda):
    """A generated batch tiled to 2^20 + 37 records (some 8 tiles a
    persistent block, each staged while the one before is evaluated,
    and a ragged last tile), and the same with every row on one key, in
    K1 and dense modes: equal to scan_body_ref."""
    datafile = str(tmp_path / 'muskie.log')
    tnative.gen_to_file(9000, datafile, seed=8)
    scan, _, args, staged = _capture(
        datafile, {'breakdowns': [{'name': 'host'}, {'name': 'operation'},
                                  LAT_P2],
                   'filter': {'ne': ['res.statusCode', 599]}},
        lambda n: np.random.default_rng(2).integers(-3, 9, n).astype(
            np.float64), cuda, time_field=None, max_records=8192)
    n, profile, caps, ns, _ = staged
    big = (1 << 20) + 37
    reps = -(-big // n)
    k1 = scan._program(profile, caps, ns, sp.MODE_K1)
    kout = torch.empty(n, dtype=torch.int32, device=cuda)
    sp.scan_body_ref(k1, args, n, None, *_accs(ns, k1.ncounters, cuda)[1:],
                     key_out=kout)
    first_alive = int(torch.nonzero(kout < ns)[0])
    for hot in (False, True):
        for mode in (sp.MODE_K1, sp.MODE_DENSE):
            prog = scan._program(profile, caps, ns, mode)
            rowkeys = {prog.slot_keys[i] for i in prog.rows}
            bargs = {k: (args[k][first_alive:first_alive + 1] if hot
                         else args[k]).repeat(reps * (n if hot else 1))[:big]
                     if k in rowkeys else args[k] for k in prog.slot_keys}
            got, want = _accs(ns, prog.ncounters, cuda), \
                _accs(ns, prog.ncounters, cuda)
            kout = [torch.empty(big, dtype=torch.int32, device=cuda)
                    for _ in range(2)]
            a = sp.scan_body(prog, bargs, big, *got, base=3 << 32,
                             key_out=kout[0])
            b = sp.scan_body_ref(prog, bargs, big, *want, base=3 << 32,
                                 key_out=kout[1])
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                assert torch.equal(x, y), (hot, mode)
            if mode == sp.MODE_K1:
                assert torch.equal(a, b), (hot, mode)


@pytest.mark.cuda
def test_programs_past_the_slot_map_on_card(tmp_path, monkeypatch, cuda):
    """A filter over 300 fields (600 per-record slots, 300 tables) and an
    `or` of 4,500 string equalities on one field (a table a leaf): past
    the block's slot map (MAP_SLOTS) and the inline slots, read through
    the launch's pointers; the device scan on the card equals the host
    engine, K2 once per batch."""
    rng = random.Random(12)
    lines = []
    for _ in range(600):
        rec = {'f%d' % j: rng.choice(['a', 'b', 1, None])
               for j in range(300)}
        rec['host'] = rng.choice(['h0', 'h1', 'h2'])
        lines.append(json.dumps(rec))
    fields = write(tmp_path, lines, 'fields.log')
    hosts = ['h%d' % i for i in range(9000)]
    leaves = write(tmp_path, [
        json.dumps({'host': rng.choice(hosts[::500] + hosts[1::997]),
                    'time': '2014-05-01T00:00:00Z'})
        for _ in range(2000)], 'leaves.log')
    cases = [(fields, {'breakdowns': [{'name': 'host'}],
                       'filter': {'or': [{'eq': ['f%d' % j, 'a']}
                                         for j in range(300)]}}),
             (leaves, {'breakdowns': [{'name': 'host'}],
                       'filter': {'or': [{'eq': ['host', h]}
                                         for h in hosts[::2]]}})]
    for path, qconf in cases:
        l0 = cuda_kernels.launches['scan_body']
        dev = _port_scan(monkeypatch, path, qconf, 'device', 'cuda')
        torch.cuda.synchronize()
        assert cuda_kernels.launches['scan_body'] > l0
        assert dev == _port_scan(monkeypatch, path, qconf, 'vector',
                                 'cpu')
        assert dev[0]


@pytest.mark.cuda
def test_prepared_launch_across_slots_memo_and_tables(tmp_path,
                                                      monkeypatch, cuda):
    """A device scan of many small batches on the card: each program's
    launch is prepared once and serves batch after batch from the
    staging ring's alternating slots; a program memo cleared every
    third program lookup (new programs, new launches) and tables that
    grow as new strings arrive (a new launch for the new tables) leave
    the output equal to the host engine's."""
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_READ_SIZE', '4096')
    datafile = write(tmp_path, records(21, 3000))
    qconf = {'breakdowns': [{'name': 'host'}, LAT_P2], 'filter': FILTER}
    made = []
    orig_init = sp._Launch.__init__

    def init(self, *a, **k):
        made.append(1)
        return orig_init(self, *a, **k)
    monkeypatch.setattr(sp._Launch, '__init__', init)
    l0 = cuda_kernels.launches['scan_body']
    dev = _port_scan(monkeypatch, datafile, qconf, 'device', 'cuda')
    torch.cuda.synchronize()
    folds = cuda_kernels.launches['scan_body'] - l0
    assert folds >= 10 and 0 < len(made) < folds
    assert dev == _port_scan(monkeypatch, datafile, qconf, 'vector', 'cpu')
    made.clear()
    calls = [0]
    orig_program = tds.DeviceScan._program

    def program(self, *a):
        calls[0] += 1
        if calls[0] % 3 == 0:
            self._programs.clear()
        return orig_program(self, *a)
    monkeypatch.setattr(tds.DeviceScan, '_program', program)
    assert dev == _port_scan(monkeypatch, datafile, qconf, 'device',
                             'cuda')
    torch.cuda.synchronize()
    assert len(made) >= calls[0] // 3


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
