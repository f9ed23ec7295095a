"""The scan program (dragnet_tpu_torch/scan_program.py, K2) on the CPU:
its plain version, scan_body_ref, which every CPU device scan runs,
against the JAX package's device scan on XLA:CPU and the host engines
(points in emission order and --counters), one case per descriptor
feature; random filter trees; the deepest filter the CLI takes; the
kernel's own per-record evaluator (ops/csrc/scan_body.cuh) built for
the host with g++ (tests/helpers/scan_body_host.cc) against
scan_body_ref on captured batches in every output mode and upload
width, with the descriptor structs' layout held to their ctypes
mirror; and the finished scan's staged inputs freed without the
collector.  Every comparison is exact."""

import ctypes
import gc
import json
import os
import random
import subprocess
import weakref

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from dragnet_tpu import engine as jengine
from dragnet_tpu import device_scan as jds
from dragnet_tpu import native as jnative
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import devbench
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import engine as tengine
from dragnet_tpu_torch import native as tnative
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import scan_program as sp
from dragnet_tpu_torch.engine import NativeColumns
from dragnet_tpu_torch.vpipe import Pipeline

from helpers.scan_differential import scan_points_counters
from helpers.scan_records import records as _records, write as _write

HERE = os.path.dirname(os.path.abspath(__file__))
HOST_SRC = os.path.join(HERE, 'helpers', 'scan_body_host.cc')
BATCH = 128
READ_SIZE = 2048
DS_FILTER = {'ne': ['host', 'zzz']}


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    if jnative.get_lib() is None or tnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_READ_SIZE', str(READ_SIZE))


def _port_scan(monkeypatch, datafile, qconf, engine='device', fmt='json'):
    """(points, non-hidden counters, hidden aggregator counters)."""
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    ds = tdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': datafile, 'timeField': 'time'},
        'ds_filter': DS_FILTER, 'ds_format': fmt})
    r = ds.scan(tquery.query_load(json.loads(json.dumps(qconf))),
                device='cpu', engine=engine)
    counters = {(s.name, k): v for s in r.pipeline.stages
                for k, v in s.counters.items()
                if v and k not in s.hidden}
    aggr = [s for s in r.pipeline.stages if s.name == 'Aggregator'][0]
    return r.points, counters, {k: aggr.counters[k] for k in aggr.hidden}


def _jax_scan(monkeypatch, datafile, qconf, engine, fmt='json'):
    return scan_points_counters(monkeypatch, datafile, qconf, engine,
                                batch=BATCH, read_size=READ_SIZE,
                                time_field='time', ds_filter=DS_FILTER,
                                fmt=fmt)


def _force_sparse(monkeypatch, max_dense):
    for mod in (jengine, jds, tengine, tds):
        monkeypatch.setattr(mod, 'MAX_DENSE_SEGMENTS', max_dense)


def _spy_modes(monkeypatch):
    modes = []
    orig = tds.scan_program.scan_body

    def spy(prog, *a, **k):
        modes.append(prog.mode)
        return orig(prog, *a, **k)
    monkeypatch.setattr(tds.scan_program, 'scan_body', spy)
    return modes


LAT_P2 = {'name': 'latency', 'aggr': 'quantize'}
TS60 = {'name': 'ts', 'field': 'time', 'date': '', 'aggr': 'lquantize',
        'step': 60}

# (name, query, json-skinner, dense budget or None, modes that must run)
CASES = [
    ('num-eq-ne', {'breakdowns': [{'name': 'host'}],
                   'filter': {'and': [{'ne': ['latency', 3]},
                                      {'eq': ['code', 200]}]}},
     False, None, {sp.MODE_K1}),
    ('num-lt-ge-float', {'breakdowns': [{'name': 'req.method'}],
                         'filter': {'or': [{'lt': ['latency', 16.5]},
                                           {'ge': ['latency', 4095.5]}]}},
     False, None, {sp.MODE_K1}),
    ('num-le-gt', {'breakdowns': [LAT_P2],
                   'filter': {'and': [{'le': ['latency', 4096]},
                                      {'gt': ['latency', -2]}]}},
     False, None, {sp.MODE_K1}),
    ('num-nan-inf-strings', {
        'breakdowns': [{'name': 'code'}],
        'filter': {'or': [{'eq': ['latency', 'abc']},
                          {'and': [{'ne': ['latency', 'abc']},
                                   {'lt': ['latency', 'Infinity']},
                                   {'ge': ['latency', '-Infinity']},
                                   {'gt': ['latency', '16']}]}]}},
     False, None, {sp.MODE_K1}),
    ('num-outside-i32', {
        'breakdowns': [{'name': 'host'}],
        'filter': {'and': [{'lt': ['latency', 1e20]},
                           {'gt': ['latency', -1e20]},
                           {'ne': ['latency', 1e20]},
                           {'or': [{'eq': ['latency', 3e9]},
                                   {'le': ['latency', 2147483647]}]}]}},
     False, None, {sp.MODE_K1}),
    ('tag-kinds', {'breakdowns': [{'name': 'code'}],
                   'filter': {'or': [{'eq': ['host', 'a']},
                                     {'eq': ['host', True]},
                                     {'eq': ['host', 17]},
                                     {'ne': ['host', 'b']}]}},
     False, None, {sp.MODE_K1}),
    ('nested-and-or', {
        'breakdowns': [{'name': 'host'}, {'name': 'req.method'}],
        'filter': {'or': [
            {'and': [{'or': [{'eq': ['host', 'a']},
                             {'and': [{'eq': ['host', 17]},
                                      {'ne': ['code', '500']}]}]},
                     {'ne': ['latency', 0]}]},
            {'and': [{'eq': ['req.method', 'GET']},
                     {'or': [{'lt': ['latency', 5]},
                             {'eq': ['code', '500']}]}]}]}},
     False, None, {sp.MODE_K1}),
    ('bad-dates', {'breakdowns': [dict(TS60, step=3600), {'name': 'host'}]},
     False, None, {sp.MODE_K1}),
    ('bad-dates-dense', {'breakdowns': [TS60, {'name': 'host'}]},
     False, None, {sp.MODE_DENSE}),
    ('time-bounds', {'timeAfter': '2014-05-01T06:00:00Z',
                     'timeBefore': '2014-05-02T12:00:00Z',
                     'breakdowns': [{'name': 'host'}]},
     False, None, {sp.MODE_K1}),
    ('time-bounds-outside-i32', {'timeAfter': '1800-01-01T00:00:00Z',
                                 'timeBefore': '2200-01-01T00:00:00Z',
                                 'breakdowns': [{'name': 'code'}]},
     False, None, {sp.MODE_K1}),
    ('time-bounds-never', {'timeAfter': '2100-01-01T00:00:00Z',
                           'timeBefore': '2200-01-01T00:00:00Z',
                           'breakdowns': [{'name': 'host'}]},
     False, None, set()),
    ('p2-edges', {'breakdowns': [LAT_P2]}, False, None, {sp.MODE_K1}),
    ('linear-negative', {'breakdowns': [{'name': 'delta',
                                         'aggr': 'lquantize', 'step': 7}]},
     False, None, {sp.MODE_K1}),
    ('linear-negative-dense', {'breakdowns': [
        {'name': 'host'}, {'name': 'req.method'},
        {'name': 'delta', 'aggr': 'lquantize', 'step': 1}]},
     False, None, {sp.MODE_DENSE}),
    ('host-translated-and-kvalid', {
        'breakdowns': [{'name': 'code'}, LAT_P2],
        'filter': {'ne': ['req.method', 'PUT']}},
     False, None, {sp.MODE_K1}),
    ('signed-weights', {'breakdowns': [{'name': 'host'}, LAT_P2],
                        'filter': {'ge': ['latency', 0]}},
     True, None, {sp.MODE_K1}),
    ('signed-weights-dense', {'breakdowns': [
        {'name': 'host'}, {'name': 'code'}, {'name': 'delta',
                                             'aggr': 'lquantize',
                                             'step': 3}]},
     True, None, {sp.MODE_DENSE}),
    ('no-breakdowns', {'filter': {'eq': ['req.method', 'GET']}},
     True, None, {sp.MODE_DENSE}),
    ('sparse', {'breakdowns': [{'name': 'host'}, LAT_P2, {'name': 'code'}],
                'filter': {'or': [{'ne': ['host', 'a']},
                                  {'lt': ['latency', 100]}]}},
     True, 16, {sp.MODE_SPARSE}),
    ('sparse-dates', {'breakdowns': [TS60, {'name': 'req.method'}]},
     False, 16, {sp.MODE_SPARSE}),
]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_scan_body_ref_matches_jax_package(tmp_path, monkeypatch, case):
    """The port's device scan on the CPU, which runs every batch through
    scan_body_ref, against the JAX package's device and host engines and
    the port's host engine; the output modes the case is for ran."""
    name, qconf, skinner, max_dense, modes = case
    fmt = 'json-skinner' if skinner else 'json'
    if max_dense is not None:
        _force_sparse(monkeypatch, max_dense)
    datafile = _write(tmp_path, _records(hash(name) & 0xffff, 600,
                                         skinner))
    jpoints, jcounters = _jax_scan(monkeypatch, datafile, qconf, 'jax',
                                   fmt)
    hpoints, hcounters = _jax_scan(monkeypatch, datafile, qconf,
                                   'vector', fmt)
    ran = _spy_modes(monkeypatch)
    points, counters, hidden = _port_scan(monkeypatch, datafile, qconf,
                                          fmt=fmt)
    vpoints, vcounters, _ = _port_scan(monkeypatch, datafile, qconf,
                                       'vector', fmt)
    assert points == jpoints
    assert counters == jcounters
    assert points == hpoints == vpoints
    spill = ('Aggregator', 'nspillrecords')
    assert {k: v for k, v in counters.items() if k != spill} == \
        {k: v for k, v in vcounters.items() if k != spill}
    assert hcounters == vcounters
    assert hidden.get('ndevicebatches', 0) > 0
    assert modes <= set(ran), (name, set(ran))


# -- random filter trees -------------------------------------------------

LEAF_POOL = [('host', 'eq', 'a'), ('host', 'ne', 'b'), ('host', 'eq', 17),
             ('host', 'eq', True), ('latency', 'lt', 17),
             ('latency', 'ge', 4096), ('latency', 'le', -2),
             ('latency', 'gt', 16.5), ('latency', 'eq', '26'),
             ('latency', 'ne', 'x'), ('code', 'eq', '500'),
             ('code', 'ge', 404), ('req.method', 'eq', 'GET'),
             ('req.method', 'ne', 'PUT')]


def _tree(draw_leaf, draw_op, depth):
    if depth == 0:
        return draw_leaf()
    kids = [_tree(draw_leaf, draw_op, depth - 1)
            for _ in range(draw_op[1])]
    return {draw_op[0]: kids}


@st.composite
def filters(draw, depth=4):
    def node(d):
        if d == 0 or draw(st.booleans()):
            f, op, c = draw(st.sampled_from(LEAF_POOL))
            return {op: [f, c]}
        k = draw(st.integers(1, 4))
        return {draw(st.sampled_from(['and', 'or'])):
                [node(d - 1) for _ in range(k)]}
    return node(depth)


@pytest.fixture(scope='module')
def tree_data(tmp_path_factory):
    d = tmp_path_factory.mktemp('trees')
    return _write(d, _records(77, 300))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(flt=filters())
def test_random_filter_trees(tree_data, monkeypatch, flt):
    """Random and/or trees over every leaf kind: the port's device scan
    (scan_body_ref) against the port's host engine, points and
    counters; the program's operand stack within its Sethi-Ullman
    bound."""
    qconf = {'breakdowns': [{'name': 'host'}], 'filter': flt}
    points, counters, hidden = _port_scan(monkeypatch, tree_data, qconf)
    vpoints, vcounters, _ = _port_scan(monkeypatch, tree_data, qconf,
                                       'vector')
    assert points == vpoints
    assert counters == vcounters
    assert hidden.get('ndevicebatches', 0) > 0


def _leaves(ast):
    op = next(iter(ast))
    if op in ('and', 'or'):
        return sum(_leaves(s) for s in ast[op])
    return 1


@settings(max_examples=200, deadline=None)
@given(flt=filters(depth=7))
def test_stack_need_within_log_bound(flt):
    """Heaviest operand first: a filter of L leaves needs at most
    floor(log2 L) + 1 stack entries, so 32 hold any filter below 2^31
    leaves."""
    need = sp._need(flt, {})
    assert need <= _leaves(flt).bit_length()


def _chain(depth):
    f = {'eq': ['host', 'a']}
    for i in range(depth):
        f = {'and' if i % 2 else 'or': [{'ne': ['latency', i]}, f]}
    return f


def _cli_scan(monkeypatch, capsys, datafile, flt, engine):
    from dragnet_tpu_torch import cli
    monkeypatch.setenv('DN_ENGINE', engine)
    try:
        rc = cli.main(['scan', '--counters', '-b', 'host', '-f',
                       json.dumps(flt), 'trees'])
    except RecursionError:
        rc = 'too deep'
    out, err = capsys.readouterr()
    return rc, out, err


def test_deepest_cli_filter(tmp_path, monkeypatch, capsys):
    """The deepest filter chain the CLI's scan takes on the host engine
    is also taken by the device lane, with the same output (its program
    needs 2 stack entries), and a 4,096-leaf balanced filter needs 13."""
    from dragnet_tpu_torch import cli
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_SCAN_THREADS', '0')
    datafile = _write(tmp_path, _records(5, 60))
    assert cli.main(['datasource-add', 'trees', '--path=' + datafile]) \
        == 0
    capsys.readouterr()

    def deepest(engine):
        lo, hi = 1, 1200
        while lo + 1 < hi:
            m = (lo + hi) // 2
            rc, _, _ = _cli_scan(monkeypatch, capsys, datafile, _chain(m),
                                 engine)
            lo, hi = (m, hi) if rc == 0 else (lo, m)
        return lo
    d = deepest('vector')
    assert d > 200
    assert deepest('jax') >= d
    host = _cli_scan(monkeypatch, capsys, datafile, _chain(d), 'vector')
    dev = _cli_scan(monkeypatch, capsys, datafile, _chain(d), 'jax')
    assert host == dev and host[0] == 0
    assert sp._need(_chain(d), {}) == 2
    wide = {'eq': ['host', 'a']}
    leaves = [{'ne': ['latency', i]} for i in range(4096)]
    while len(leaves) > 1:
        leaves = [{'and' if len(leaves) % 3 else 'or': leaves[i:i + 2]}
                  for i in range(0, len(leaves), 2)]
    wide = leaves[0]
    assert sp._need(wide, {}) == 13
    host = _cli_scan(monkeypatch, capsys, datafile, wide, 'vector')
    dev = _cli_scan(monkeypatch, capsys, datafile, wide, 'jax')
    assert host == dev and host[0] == 0


# -- the kernel's evaluator, built for the host --------------------------

@pytest.fixture(scope='module')
def hostlib(tmp_path_factory):
    """tests/helpers/scan_body_host.cc built with g++ (the evaluator of
    ops/csrc/scan_body.cuh as host code)."""
    out = str(tmp_path_factory.mktemp('sbh') / 'libscanbodyhost.so')
    subprocess.run(['g++', '-O1', '-std=c++17', '-shared', '-fPIC',
                    '-Wall', '-Werror', '-o', out, HOST_SRC], check=True)
    lib = ctypes.CDLL(out)
    lib.dn_scan_body_host.restype = ctypes.c_int
    lib.dn_scan_body_host.argtypes = [ctypes.c_void_p]
    lib.dn_scan_body_host_tiled.restype = ctypes.c_int
    lib.dn_scan_body_host_tiled.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
    lib.dn_stage_copy_host.restype = ctypes.c_int
    lib.dn_stage_copy_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_int]
    lib.dn_scan_layout.restype = ctypes.c_int
    lib.dn_scan_layout.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.dn_floordiv_host, lib.dn_p2_host):
        fn.restype = ctypes.c_int64
    lib.dn_floordiv_host.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.dn_p2_host.argtypes = [ctypes.c_int32]
    return lib


def test_descriptor_layout_matches_ctypes(hostlib):
    buf = ctypes.create_string_buffer(8192)
    n = hostlib.dn_scan_layout(buf, len(buf))
    layout = dict(kv.split('=') for kv in
                  buf.value[:n].decode().split(';') if kv)
    structs = {'DnOp': sp.DnOp, 'DnScanProgram': sp.DnScanProgram,
               'DnScanLaunch': sp.DnScanLaunch}
    seen = 0
    for key, v in layout.items():
        if '.' in key:
            sname, field = key.split('.')
            assert getattr(structs[sname], field).offset == int(v), key
        else:
            assert ctypes.sizeof(structs[key]) == int(v), key
        seen += 1
    assert seen == 3 + sum(len(s._fields_) for s in structs.values())


def test_integer_helpers_on_host(hostlib):
    """The evaluator's floor division and bit length, as compiled, at
    the edges (C's / truncates toward zero; __clz(0) is never taken)."""
    vals = [0, 1, -1, 2, -2, 6, 7, -7, -8, 59, 60, -59, -60, -61,
            2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1, 123456789, -123456789]
    for v in vals:
        for step in (1, 2, 3, 7, 60, 3600, 2 ** 31 - 1):
            assert hostlib.dn_floordiv_host(v, step) == v // step, (v,
                                                                    step)
        want = 0 if v < 1 else v.bit_length()
        assert hostlib.dn_p2_host(v) == want, v
        assert int(sp._ref_p2(torch.tensor([v], dtype=torch.int64))[0]) \
            == want


def _capture(datafile, qconf, weights, device='cpu', time_field='time',
             max_records=BATCH):
    """A DeviceScan's staged first batch of `datafile`: (scan, host
    inputs, staged), its fold run and discarded."""
    scan = tds.DeviceScan(tquery.query_load(json.loads(json.dumps(qconf))),
                          time_field, Pipeline(), device=device)
    parser = devbench._one_batch_parser(datafile, scan, max_records)
    n = parser.batch_size()
    scan.capture_next = True
    assert scan._try_device(NativeColumns(parser), weights(n), None)
    inputs, staged, _ = scan.captured
    return scan, inputs, staged


def _widen(arr, width):
    """A per-record integer input widened to `width` (an upload is
    narrowed to the least width that holds its values, so any wider one
    holds them too)."""
    if arr.dtype == np.bool_ or width is None or \
            np.dtype(width).itemsize <= arr.dtype.itemsize:
        return arr
    return arr.astype(width)


def _host_run(lib, prog, arrays, n, dense, first, cvec, base, row0,
              nvalid, tiles=None):
    """The host-built evaluator over numpy `arrays` (slot key -> array)
    into numpy accumulators; returns what the mode writes.  With
    `tiles` (threads a block, one record each, and whether to take the
    staged loader where every slot is staged), the kernel's block
    (dn_scan_body_host_tiled) with the tables staged as the wrapper
    stages them."""
    dts = tuple(sp.DTYPE_CODES[torch.from_numpy(arrays[k][:0]).dtype]
                for k in prog.slot_keys)
    hdr, opbytes, _ = prog.encoded(dts)
    opbuf = ctypes.create_string_buffer(opbytes, len(opbytes))
    L = sp.DnScanLaunch()
    L.prog = hdr
    L.ops = ctypes.addressof(opbuf)
    L.n, L.base, L.row0 = n, base, row0
    L.nvalid = row0 + n if nvalid is None else nvalid
    ptrs = [arrays[k].ctypes.data for k in prog.slot_keys]
    inline = min(len(ptrs), sp.INLINE_SLOTS)
    L.slot[:inline] = ptrs[:inline]
    if len(ptrs) > sp.INLINE_SLOTS:
        extra = np.array(ptrs[sp.INLINE_SLOTS:], dtype=np.uint64)
        L.slot_extra = extra.ctypes.data
    out = None
    if prog.mode == sp.MODE_K1:
        out = np.full(n, -7, dtype=np.int32)
        L.out_key32 = out.ctypes.data
    elif prog.mode == sp.MODE_SPARSE:
        out = tuple(np.zeros(n, dtype=np.int64) for _ in range(3))
        L.out_key64, L.out_w64, L.out_first64 = [o.ctypes.data
                                                 for o in out]
    if dense is not None:
        L.acc_dense = dense.ctypes.data
    if first is not None:
        L.acc_first = first.ctypes.data
    L.acc_cvec = cvec.ctypes.data
    if tiles is None:
        assert lib.dn_scan_body_host(ctypes.byref(L)) == 0
        return out
    rows = set(prog.rows)
    sp.stage_tables(L, [(i, dts[i], arrays[k].size)
                        for i, k in enumerate(prog.slot_keys)
                        if i not in rows])
    loader = lib.dn_scan_body_host_tiled(ctypes.byref(L), *tiles)
    assert loader in (0, 1)
    _host_run.loaders.append(loader)
    return out


_host_run.loaders = []


MODES = [sp.MODE_K1, sp.MODE_DENSE, sp.MODE_SPARSE]
WIDTHS = [None, np.int16, np.int32, np.int64]

DIRECT = [
    ('tags-and-dates', {'breakdowns': [TS60, {'name': 'code'}, LAT_P2],
                        'filter': CASES[6][1]['filter']}, False),
    ('weights-bounds', {'timeAfter': '2014-05-01T06:00:00Z',
                        'timeBefore': '2014-05-02T12:00:00Z',
                        'breakdowns': [{'name': 'host'},
                                       {'name': 'delta',
                                        'aggr': 'lquantize', 'step': 7}],
                        'filter': CASES[3][1]['filter']}, True),
    ('keyless', {'filter': CASES[4][1]['filter']}, True),
]


@pytest.mark.parametrize('case', DIRECT, ids=[c[0] for c in DIRECT])
@pytest.mark.parametrize('width', WIDTHS, ids=['staged', 'i16', 'i32',
                                               'i64'])
def test_host_evaluator_matches_ref(tmp_path, hostlib, case, width):
    """One captured batch in every output mode, at every upload width,
    whole and as two mesh shards (row0, nvalid): the kernel's evaluator
    (host build) and scan_body_ref give the same counters, first
    occurrences, dense sums, fused keys and sparse rows."""
    name, qconf, weighted = case
    datafile = _write(tmp_path, _records(11, 400))
    rng = np.random.default_rng(5)

    def weights(n):
        if not weighted:
            return np.ones(n)
        return rng.integers(-4, 9, n).astype(np.float64)
    scan, inputs, staged = _capture(datafile, qconf, weights)
    n, profile, caps, ns, _ = staged
    arrays = {}
    args = {}
    for k, v in inputs.items():
        if isinstance(v, np.ndarray):
            a = np.ascontiguousarray(_widen(v, width))
        else:
            a = v.numpy()
        arrays[k] = a
        args[k] = torch.from_numpy(a)
    for mode in MODES:
        prog = scan._program(profile, caps, ns, mode)
        shards = [(0, n, None)] if mode == sp.MODE_SPARSE or \
            not profile[1] else [(0, n, None), (0, 70, n - 9),
                                 (70, n - 70, n - 9)]
        for row0, sn, nvalid in shards:
            rowkeys = {prog.slot_keys[i] for i in prog.rows}
            sargs = {k: args[k][row0:row0 + sn] if k in rowkeys
                     else args[k] for k in prog.slot_keys}
            sarr = {k: np.ascontiguousarray(sargs[k].numpy())
                    for k in sargs}
            nsb = max(ns, 1)
            acc = [torch.zeros(nsb, dtype=torch.int64),
                   torch.full((nsb,), sp.I64MAX, dtype=torch.int64),
                   torch.zeros(prog.ncounters, dtype=torch.int64)]
            hacc = [a.numpy().copy() for a in acc]
            base = 3 << 32
            key_out = torch.empty(sn, dtype=torch.int32)
            got = sp.scan_body_ref(prog, sargs, sn, *acc, base=base,
                                   row0=row0, nvalid=nvalid,
                                   key_out=key_out)
            hgot = _host_run(hostlib, prog, sarr, sn, *hacc, base, row0,
                             nvalid)
            assert np.array_equal(acc[2].numpy(), hacc[2]), (name, mode)
            if mode == sp.MODE_SPARSE:
                for a, b in zip(got, hgot):
                    assert np.array_equal(a.numpy(), b), (name, mode)
                continue
            assert np.array_equal(acc[1].numpy(), hacc[1]), (name, mode)
            if mode == sp.MODE_K1:
                assert np.array_equal(got.numpy(), hgot), (name, mode)
            else:
                assert np.array_equal(acc[0].numpy(), hacc[0]), (name,
                                                                 mode)
        assert acc[2].numpy().sum() > 0


def test_host_evaluator_past_inline_slots(tmp_path, hostlib):
    """A filter over 40 fields (tags, string and number slots each):
    more slots than the launch passes inline, the rest read through
    slot_extra, equal to scan_body_ref."""
    rng = random.Random(9)
    lines = []
    for i in range(300):
        rec = {'f%d' % j: rng.choice(['a', 'b', 1, 2, None, True])
               for j in range(40)}
        rec['host'] = rng.choice(['h0', 'h1', 'h2'])
        lines.append(json.dumps(rec))
    datafile = _write(tmp_path, lines)
    flt = {'or': [{'eq': ['f%d' % j, 'a' if j % 2 else 1]}
                  for j in range(40)]}
    qconf = {'breakdowns': [{'name': 'host'}], 'filter': flt}
    scan, inputs, staged = _capture(datafile, qconf, np.ones,
                                    time_field=None)
    n, profile, caps, ns, _ = staged
    prog = scan._program(profile, caps, ns, sp.MODE_DENSE)
    assert len(prog.slot_keys) > sp.INLINE_SLOTS
    arrays = {k: (v if isinstance(v, np.ndarray) else v.numpy())
              for k, v in inputs.items()}
    args = {k: torch.from_numpy(np.ascontiguousarray(a))
            for k, a in arrays.items()}
    acc = [torch.zeros(ns, dtype=torch.int64),
           torch.full((ns,), sp.I64MAX, dtype=torch.int64),
           torch.zeros(prog.ncounters, dtype=torch.int64)]
    hacc = [a.numpy().copy() for a in acc]
    sp.scan_body_ref(prog, args, n, *acc)
    _host_run(hostlib, prog, {k: np.ascontiguousarray(a)
                              for k, a in arrays.items()}, n, *hacc, 0,
              0, None)
    for a, b in zip(acc, hacc):
        assert np.array_equal(a.numpy(), b)
    assert acc[0].sum() > 0


# (threads a block, the staged loader where it applies): the kernel's
# blocks are 128 threads
TILES = [(1, 0), (3, 0), (48, 1), (128, 1)]


@pytest.mark.parametrize('case', DIRECT, ids=[c[0] for c in DIRECT])
@pytest.mark.parametrize('tiles', TILES, ids=['%d%s' % (t, 's' * s)
                                              for t, s in TILES])
@pytest.mark.parametrize('width', WIDTHS, ids=['staged', 'i16', 'i32',
                                               'i64'])
def test_host_tiles_match_ref(tmp_path, hostlib, case, tiles, width):
    """The kernel's blocks on the host (dn_scan_body_host_tiled): the
    op array and the tables staged, each tile's columns staged by
    dn_stage_copy and run by the evaluator through the slot map, a
    record a thread, through the general loader or the staged one, at
    every upload width, on a 397-record batch (a ragged last tile at
    every tile size), whole and as two mesh shards that are views of
    the batch split at row 131 (columns off their alignment): equal to
    scan_body_ref in every mode; at the narrowest widths every slot is
    staged and the staged loader runs where it was asked for."""
    name, qconf, weighted = case
    _host_run.loaders.clear()
    datafile = _write(tmp_path, _records(13, 420))
    rng = np.random.default_rng(7)

    def weights(n):
        if not weighted:
            return np.ones(n)
        return rng.integers(-4, 9, n).astype(np.float64)
    scan, inputs, staged = _capture(datafile, qconf, weights,
                                    max_records=397)
    n, profile, caps, ns, _ = staged
    assert n == 397
    arrays = {k: (np.ascontiguousarray(_widen(v, width))
                  if isinstance(v, np.ndarray) else v.numpy())
              for k, v in inputs.items()}
    for mode in MODES:
        prog = scan._program(profile, caps, ns, mode)
        rowkeys = {prog.slot_keys[i] for i in prog.rows}
        nvalid = n - 9 if profile[1] else None
        shards = [(0, n, None)] if mode == sp.MODE_SPARSE else \
            [(0, n, None), (0, 131, nvalid), (131, n - 131, nvalid)]
        for row0, sn, nv in shards:
            # views: a shard's columns start where its rows do
            sarr = {k: arrays[k][row0:row0 + sn] if k in rowkeys
                    else arrays[k] for k in prog.slot_keys}
            sargs = {k: torch.from_numpy(v) for k, v in sarr.items()}
            nsb = max(ns, 1)
            acc = [torch.zeros(nsb, dtype=torch.int64),
                   torch.full((nsb,), sp.I64MAX, dtype=torch.int64),
                   torch.zeros(prog.ncounters, dtype=torch.int64)]
            hacc = [a.numpy().copy() for a in acc]
            key_out = torch.empty(sn, dtype=torch.int32)
            got = sp.scan_body_ref(prog, sargs, sn, *acc, base=3 << 32,
                                   row0=row0, nvalid=nv, key_out=key_out)
            hgot = _host_run(hostlib, prog, sarr, sn, *hacc, 3 << 32, row0,
                             nv, tiles=tiles)
            where = (name, mode, row0, tiles)
            assert np.array_equal(acc[2].numpy(), hacc[2]), where
            if mode == sp.MODE_SPARSE:
                for a, b in zip(got, hgot):
                    assert np.array_equal(a.numpy(), b), where
                continue
            assert np.array_equal(acc[1].numpy(), hacc[1]), where
            if mode == sp.MODE_K1:
                assert np.array_equal(got.numpy(), hgot), where
            else:
                assert np.array_equal(acc[0].numpy(), hacc[0]), where
        assert acc[2].numpy().sum() > 0
    if width is None and tiles[1]:
        assert set(_host_run.loaders) == {1}


def test_host_tiles_past_the_staging_budget(tmp_path, hostlib):
    """The 40-field filter: more per-record slots than a tile stages
    (the rest read in place) and more tables than a block stages; the
    per-record slots are numbered first, and the staging plan takes
    each at most once, in order, within its budget; the kernel's tiles
    on the host equal scan_body_ref."""
    rng = random.Random(4)
    lines = []
    for i in range(333):
        rec = {'f%d' % j: rng.choice(['a', 'b', 'c', 1, 2, None, True])
               for j in range(40)}
        rec['host'] = rng.choice(['h0', 'h1', 'h2'])
        lines.append(json.dumps(rec))
    datafile = _write(tmp_path, lines)
    flt = {'or': [{'eq': ['f%d' % j, 'a' if j % 2 else 1]}
                  for j in range(40)]}
    qconf = {'breakdowns': [{'name': 'host'}], 'filter': flt}
    scan, inputs, staged = _capture(datafile, qconf, np.ones,
                                    time_field=None, max_records=333)
    n, profile, caps, ns, _ = staged
    prog = scan._program(profile, caps, ns, sp.MODE_DENSE)
    arrays = {k: np.ascontiguousarray(v if isinstance(v, np.ndarray)
                                      else v.numpy())
              for k, v in inputs.items()}
    dts = tuple(sp.DTYPE_CODES[torch.from_numpy(arrays[k][:0]).dtype]
                for k in prog.slot_keys)
    hdr, _, _ = prog.encoded(dts)
    staged_refs = list(hdr.stage_ref[:hdr.nstage])
    assert prog.rows == list(range(hdr.nrows)) and \
        hdr.nrows < hdr.nslots <= sp.MAP_SLOTS
    staged_idx = [r & 0xffffff for r in staged_refs]
    assert staged_idx == sorted(set(staged_idx))
    assert 0 < hdr.nstage < hdr.nrows and set(staged_idx) <= set(prog.rows)
    sizes = [sp.CODE_BYTES[r >> 24] for r in staged_refs]
    assert list(hdr.stage_pre[:hdr.nstage]) == list(np.cumsum([0] +
                                                              sizes[:-1]))
    assert hdr.stage_bpr == sum(sizes) <= sp.STAGE_BYTES
    acc = [torch.zeros(ns, dtype=torch.int64),
           torch.full((ns,), sp.I64MAX, dtype=torch.int64),
           torch.zeros(prog.ncounters, dtype=torch.int64)]
    hacc = [a.numpy().copy() for a in acc]
    sp.scan_body_ref(prog, {k: torch.from_numpy(a)
                            for k, a in arrays.items()}, n, *acc)
    _host_run.loaders.clear()
    _host_run(hostlib, prog, arrays, n, *hacc, 0, 0, None, tiles=(32, 1))
    assert _host_run.loaders == [0]
    for a, b in zip(acc, hacc):
        assert np.array_equal(a.numpy(), b)
    assert acc[0].sum() > 0


def _wide_program_case(tmp_path, name, lines, qconf, nrecords):
    """A captured batch of `lines` under `qconf`: (scan, numpy arrays by
    slot key, staged)."""
    datafile = _write(tmp_path, lines, name + '.log')
    scan, inputs, staged = _capture(datafile, qconf, np.ones,
                                    time_field=None, max_records=nrecords)
    arrays = {k: np.ascontiguousarray(v if isinstance(v, np.ndarray)
                                      else v.numpy())
              for k, v in inputs.items()}
    return scan, arrays, staged


def _host_tiles_equal_ref(hostlib, scan, arrays, staged, tiles):
    """The kernel's tiles on the host equal scan_body_ref in every mode
    the key space allows, through the general loader (the program is
    not all staged); returns the dense mode's program."""
    _host_run.loaders.clear()
    n, profile, caps, ns, _ = staged
    args = {k: torch.from_numpy(a) for k, a in arrays.items()}
    for mode in MODES:
        prog = scan._program(profile, caps, ns, mode)
        nsb = max(ns, 1)
        acc = [torch.zeros(nsb, dtype=torch.int64),
               torch.full((nsb,), sp.I64MAX, dtype=torch.int64),
               torch.zeros(prog.ncounters, dtype=torch.int64)]
        hacc = [a.numpy().copy() for a in acc]
        key_out = torch.empty(n, dtype=torch.int32)
        got = sp.scan_body_ref(prog, args, n, *acc, base=1 << 32,
                               key_out=key_out)
        hgot = _host_run(hostlib, prog, arrays, n, *hacc, 1 << 32, 0, None,
                         tiles=tiles)
        assert np.array_equal(acc[2].numpy(), hacc[2]), mode
        if mode == sp.MODE_SPARSE:
            for a, b in zip(got, hgot):
                assert np.array_equal(a.numpy(), b)
            continue
        assert np.array_equal(acc[1].numpy(), hacc[1]), mode
        if mode == sp.MODE_K1:
            assert np.array_equal(got.numpy(), hgot)
        else:
            assert np.array_equal(acc[0].numpy(), hacc[0])
            assert acc[0].sum() > 0
            dense = prog
    assert set(_host_run.loaders) == {0}
    return dense


@pytest.mark.parametrize('tiles', [(3, 1), (128, 1)])
def test_host_tiles_past_the_slot_map(tmp_path, hostlib, tiles):
    """A filter over 300 fields: 600 per-record slots and 300 tables,
    past the block's slot map (MAP_SLOTS), so the loader reads the slots
    past it through the launch's pointers (a per-record one at its
    tile's rows) and only what lies below it is staged; the kernel's
    tiles on the host equal scan_body_ref in every mode."""
    rng = random.Random(12)
    lines = []
    for i in range(150):
        rec = {'f%d' % j: rng.choice(['a', 'b', 1, None])
               for j in range(300)}
        rec['host'] = rng.choice(['h0', 'h1', 'h2'])
        lines.append(json.dumps(rec))
    qconf = {'breakdowns': [{'name': 'host'}],
             'filter': {'or': [{'eq': ['f%d' % j, 'a']}
                               for j in range(300)]}}
    scan, arrays, staged = _wide_program_case(tmp_path, 'fields', lines,
                                              qconf, 150)
    prog = _host_tiles_equal_ref(hostlib, scan, arrays, staged, tiles)
    dts = tuple(sp.DTYPE_CODES[torch.from_numpy(arrays[k][:0]).dtype]
                for k in prog.slot_keys)
    hdr, _, _ = prog.encoded(dts)
    assert sp.MAP_SLOTS < hdr.nrows < hdr.nslots
    assert all(r & 0xffffff < sp.MAP_SLOTS
               for r in hdr.stage_ref[:hdr.nstage])
    assert hdr.nstage > 0


def test_host_tiles_past_4096_string_leaves(tmp_path, monkeypatch,
                                            hostlib):
    """An `or` of 4,500 string equalities on one field: a table a leaf,
    4,500 tables past the slot map and past the inline slots; the
    kernel's tiles on the host equal scan_body_ref in every mode, and
    the port's CPU device scan (scan_body_ref a batch) equals the JAX
    package's host engine and the port's."""
    rng = random.Random(13)
    hosts = ['h%d' % i for i in range(9000)]
    lines = [json.dumps({'host': rng.choice(hosts[::500] + hosts[1::997]),
                         'op': rng.choice(['get', 'put'])})
             for _ in range(400)]
    flt = {'or': [{'eq': ['host', h]} for h in hosts[::2]]}
    qconf = {'breakdowns': [{'name': 'op'}], 'filter': flt}
    scan, arrays, staged = _wide_program_case(tmp_path, 'leaves', lines,
                                              qconf, 400)
    prog = _host_tiles_equal_ref(hostlib, scan, arrays, staged, (128, 1))
    assert len(prog.slot_keys) > 4500 > len(prog.rows)
    datafile = str(tmp_path / 'leaves.log')
    hpoints, hcounters = _jax_scan(monkeypatch, datafile, qconf, 'vector')
    points, counters, hidden = _port_scan(monkeypatch, datafile, qconf)
    vpoints, vcounters, _ = _port_scan(monkeypatch, datafile, qconf,
                                       'vector')
    assert points == hpoints == vpoints and len(points) == 2
    assert counters == hcounters == vcounters
    assert hidden.get('ndevicebatches', 0) > 0


@pytest.mark.parametrize('nthreads', [1, 3, 8])
def test_stage_copy_masked_tail(hostlib, nthreads):
    """dn_stage_copy, a tile's column into shared memory: 16-byte
    chunks where source and destination are 16-byte aligned, 4-byte
    where both are 4-byte aligned, else bytes, the last chunk cut to
    what remains (nothing past the source's nbytes is read): every byte
    below nbytes lands, the rest of the last chunk is zero (as cp.async
    fills it on the card), nothing past that chunk is written."""
    rng = np.random.default_rng(nthreads)
    src_buf = np.frombuffer(rng.bytes(640), dtype=np.uint8)
    dst_buf = np.empty(640, dtype=np.uint8)
    s0 = (-src_buf.ctypes.data) % 16
    d0 = (-dst_buf.ctypes.data) % 16
    for soff in (0, 1, 2, 4, 8, 12, 16, 17):
        for doff in (0, 4, 16, 3):
            for nbytes in (0, 1, 3, 4, 15, 16, 17, 33, 100, 257):
                src = src_buf[s0 + soff:]
                dst = dst_buf[d0 + doff:d0 + doff + 300]
                dst[:] = 0xAB
                a = src.ctypes.data | dst.ctypes.data
                csz = hostlib.dn_stage_copy_host(
                    dst.ctypes.data, src.ctypes.data, nbytes, nthreads)
                assert csz == (16 if a % 16 == 0 else 4 if a % 4 == 0
                               else 1), (soff, doff)
                assert np.array_equal(dst[:nbytes], src[:nbytes])
                end = -(-nbytes // csz) * csz
                assert (dst[nbytes:end] == 0).all(), (soff, doff, nbytes)
                assert (dst[end:] == 0xAB).all(), (soff, doff, nbytes)


# -- the cycle repair ------------------------------------------------------

def test_finished_scan_frees_staged_inputs(tmp_path, monkeypatch):
    """With the collector off, a finished CPU device scan leaves none of
    its staged per-record input tensors alive: nothing holds a batch's
    inputs in a reference cycle."""
    refs = []
    orig = tds._StagingRing.stage

    def stage(self, inputs, cap0, compute):
        args, nbytes, slot = orig(self, inputs, cap0, compute)
        refs.extend(weakref.ref(args[k]) for k, v in inputs.items()
                    if isinstance(v, np.ndarray))
        return args, nbytes, slot
    monkeypatch.setattr(tds._StagingRing, 'stage', stage)
    datafile = _write(tmp_path, _records(3, 500))
    qconf = {'breakdowns': [{'name': 'host'}, LAT_P2],
             'filter': CASES[6][1]['filter']}
    gc.collect()
    gc.disable()
    try:
        points, _, hidden = _port_scan(monkeypatch, datafile, qconf)
        alive = sum(1 for r in refs if r() is not None)
    finally:
        gc.enable()
    assert points and hidden.get('ndevicebatches', 0) > 1
    assert refs and alive == 0, '%d of %d staged inputs alive' % (
        alive, len(refs))
