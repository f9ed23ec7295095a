"""The port's byte lane (dragnet_tpu_torch/byteparse.py) and its
quote-parity kernel (K8, ops/byteparse_kernels.py) against the JAX
package's, all exact (tolerance 0: bytes, columns and counters equal).

- The parity: the port's plain torch version and its copied numpy one
  against the reference's `parity_numpy` and its jitted `parity_device`
  (XLA:CPU), at lengths 0 to 2^20 + 1 and quote densities from none to
  all, on buffers that are not JSON.
- `ByteParser`: columns, dictionaries, batch statistics,
  `lane_counters` and `force_fallback`, the port's against the
  reference's on the same fuzzed buffers (the reference's adversarial
  corpus, tests/test_byteparse.py), the device lane on device='cpu'.
- Through both CLIs in-process (`python -m dragnet_tpu_torch` with
  DN_TORCH_DEVICE=cpu against bin/dn's entry point), at DN_PARSE=vector
  and device: scans over CRLF input, a truncated last line, small
  DN_READ_SIZE chunks, DN_SCAN_THREADS workers and the forced lane;
  `scan --dry-run`'s `parse lane:` line; a dotted query's hidden
  `parse lane ineligible` counter; build trees at both lanes.
- The raises: a hung first kernel call under DN_DEVICE_PROBE_TIMEOUT=1,
  and DN_PARSE=device with CUDA asked for and absent.
- `cuda`-marked: the kernel against its plain version on the card.
"""

import contextlib
import io
import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from dragnet_tpu import byteparse as jbp
from dragnet_tpu.ops import byteparse_kernels as jbk
from dragnet_tpu_torch import byteparse as tbp
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.ops import byteparse_kernels as tbk
from dragnet_tpu_torch.ops import cuda_kernels as tck

from test_byteparse import gen_lines, write_corpus

LENGTHS = [0, 1, 7, 8, 9, 31, 32, 33, 1 << 19, (1 << 19) + (1 << 17),
           (1 << 20) - 1, 1 << 20, (1 << 20) + 1]
DENSITIES = [0.0, 0.001, 0.05, 0.5, 1.0]


def _bytes(n, density, seed):
    """n random bytes over all 256 values (not JSON), quotes at the
    given density and nowhere else."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, n, dtype=np.uint8)
    quote = rng.random(n) < density
    arr[(arr == tbk.QUOTE) & ~quote] = ord('#')
    arr[quote] = tbk.QUOTE
    return arr


def _unpacked(packed, n):
    return np.unpackbits(packed.cpu().numpy())[:n]


@pytest.mark.parametrize('n', LENGTHS)
def test_parity_plain_matches_reference(n):
    for i, density in enumerate(DENSITIES):
        arr = _bytes(n, density, seed=n * 10 + i)
        want = jbk.parity_numpy(arr)
        packed = tbk.quote_parity(torch.from_numpy(arr.copy()))
        assert packed.dtype == torch.uint8
        assert tuple(packed.shape) == ((n + 7) // 8,)
        assert np.array_equal(_unpacked(packed, n), want), density
        assert np.array_equal(tbk.parity_numpy(arr), want), density
        # into a dirty buffer: every byte is written
        out = torch.full(((n + 7) // 8,), 0xA5, dtype=torch.uint8)
        tbk.quote_parity_into(out, torch.from_numpy(arr.copy()))
        assert torch.equal(out, packed)
    # the reference's device kernel (jitted XLA, padded to its quantum)
    arr = _bytes(n, 0.5, seed=n + 1)
    assert np.array_equal(np.asarray(jbk.parity_device(arr)),
                          tbk.parity_numpy(arr))


def test_parity_device_lane_cpu_matches_reference():
    """The device lane's per-block call on device='cpu' (the plain
    version) against parity_numpy, on a JSON buffer whose malformed
    lines carry odd quote counts across lines."""
    data = b'\n'.join(gen_lines(71)) + b'\n'
    arr = np.frombuffer(data, dtype=np.uint8)
    call = tbk.DeviceParity('cpu')
    before = tck.launches['quote_parity']
    assert np.array_equal(call(arr), jbk.parity_numpy(arr))
    assert np.array_equal(call(arr[:0]), jbk.parity_numpy(arr[:0]))
    assert tck.launches['quote_parity'] == before      # no kernel here
    assert np.array_equal(tbk.device_parity(torch.device('cpu'))(arr),
                          jbk.parity_numpy(arr))


def test_parity_wrapper_contract():
    with pytest.raises(ValueError, match='unsupported device'):
        tbk.quote_parity_into(torch.empty(1, dtype=torch.uint8,
                                          device='meta'),
                              torch.empty(8, dtype=torch.uint8,
                                          device='meta'))
    assert tbk.packed_len(0) == 0 and tbk.packed_len(9) == 2


# -- ByteParser -------------------------------------------------------------

PATHS = ['host', 'latency', 'time', 'pad0', 'pad1']
HINTS = [False, False, True, False, False]
DICTS = [True, True, False, True, True]


def _parsers(lane):
    kw = dict(force_fallback=lane == 'fallback')
    ref = jbp.ByteParser(PATHS, HINTS, DICTS, device=lane == 'device',
                         **kw)
    port = tbp.ByteParser(PATHS, HINTS, DICTS,
                          device=torch.device('cpu') if lane == 'device'
                          else None, **kw)
    return ref, port


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _assert_batch_equal(ref, port):
    assert ref.batch_size() == port.batch_size()
    assert ref.counters() == port.counters()
    assert ref.lane_counters() == port.lane_counters()
    for f, hint in zip(PATHS, HINTS):
        for a, b in zip(ref.columns(f), port.columns(f)):
            assert _same(a, b), f
        assert list(ref.dictionary(f)) == list(port.dictionary(f)), f
        assert ref.field_stats(f) == port.field_stats(f), f
        assert _same(ref.nums_i32(f), port.nums_i32(f)), f
        assert _same(ref.tags_col(f), port.tags_col(f)), f
        assert _same(ref.strcodes_col(f), port.strcodes_col(f)), f
        if hint:
            for a, b in zip(ref.date_columns(f), port.date_columns(f)):
                assert _same(a, b), f
            assert ref.date_stats(f) == port.date_stats(f), f
            assert _same(ref.date_i32(f), port.date_i32(f)), f
            assert _same(ref.date_err(f), port.date_err(f)), f


@pytest.mark.parametrize('lane', ['vector', 'device', 'fallback'])
@pytest.mark.parametrize('seed', [61, 62])
def test_byteparser_matches_reference(lane, seed):
    """Three parse() calls a batch, blocks of 4 KiB so every call runs
    several structural blocks, CRLF lines in the second batch and a
    truncated last line."""
    ref, port = _parsers(lane)
    ref.BLOCK = port.BLOCK = 4096
    lines = gen_lines(seed, count=1500)
    rng = np.random.default_rng(seed)
    bufs = []
    for k, part in enumerate(np.array_split(np.arange(len(lines)), 6)):
        sep = b'\r\n' if k == 2 else b'\n'
        bufs.append(sep.join(lines[i] for i in part) + sep)
    bufs.append(b'{"host":"trunc","latency":')
    for k, buf in enumerate(bufs):
        assert ref.parse(buf) == port.parse(buf)
        if k % 3 == 2 or rng.random() < 0.2:
            _assert_batch_equal(ref, port)
            ref.reset_batch()
            port.reset_batch()
    _assert_batch_equal(ref, port)
    assert port.nlines == ref.nlines and port.lines_fb == ref.lines_fb
    if lane == 'fallback':
        assert port.lines_fast == 0
    else:
        assert port.lines_fast > 0 and port.lines_fb > 0


# -- lane selection ---------------------------------------------------------

FLAT = {'breakdowns': [{'name': 'host'},
                       {'name': 'latency', 'aggr': 'quantize'}]}
DOTTED = {'breakdowns': [{'name': 'req.method'}, {'name': 'host'}]}


def test_choose_lane_matches_reference(monkeypatch):
    """Every mode x projection x native availability picks the
    reference's lane, except that a forced device lane stays the device
    lane (the reference turns it into the vector lane when its kernel
    is unavailable; the port's first kernel call raises instead)."""
    from dragnet_tpu import query as jquery
    for mode in ('auto', 'host', 'vector', 'device', 'bogus'):
        monkeypatch.setenv('DN_PARSE', mode)
        for conf in (FLAT, DOTTED):
            for dsf in (None, {'eq': ['res.statusCode', 200]}):
                for fmt in ('json', 'json-skinner'):
                    for native in (True, False):
                        a = jbp.choose_lane([jquery.query_load(conf)],
                                            'time', dsf, fmt, native)
                        b = tbp.choose_lane([tquery.query_load(conf)],
                                            'time', dsf, fmt, native)
                        assert (a.lane, a.reason) == (b.lane, b.reason)
    monkeypatch.setattr(jbk, 'device_parity_available', lambda: False)
    monkeypatch.setenv('DN_PARSE', 'device')
    assert jbp.choose_lane([jquery.query_load(FLAT)], 'time', None,
                           'json', True).lane == 'vector'
    assert tbp.choose_lane([tquery.query_load(FLAT)], 'time', None,
                           'json', True).lane == 'device'


# -- through both CLIs ------------------------------------------------------

def _run(main, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return subprocess.CompletedProcess(args, rc, out.getvalue(),
                                       err.getvalue())


def _both(monkeypatch, args, env=None):
    """(bin/dn's result, the port's) for one command under `env`."""
    from dragnet_tpu import cli as jcli
    from dragnet_tpu_torch import cli as tcli
    with monkeypatch.context() as m:
        for k, v in (env or {}).items():
            m.setenv(k, v)
        ref = _run(jcli.main, args)
        got = _run(tcli.main, args)
    return ref, got


@pytest.fixture
def corpus_env(tmp_path, monkeypatch):
    """A DRAGNET_CONFIG with datasources over the reference's
    adversarial corpus: plain, CRLF and with a truncated last line."""
    from dragnet_tpu_torch import cli as tcli
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_SCAN_THREADS', '0')
    for k in ('DN_ENGINE', 'DN_PARSE', 'DN_READ_SIZE', 'DN_NATIVE',
              'DN_COUNTERS_ALL'):
        monkeypatch.delenv(k, raising=False)
    for name, kw in (('plain', {}), ('crlf', {'crlf': True}),
                     ('trunc', {'truncate': True})):
        data = tmp_path / (name + '.log')
        write_corpus(data, 81, tame_numbers=True, **kw)
        got = _run(tcli.main, ['datasource-add', name,
                               '--path=' + str(data), '--time-field=time',
                               '--index-path=' + str(tmp_path / name)])
        assert got.returncode == 0, got.stderr
    return tmp_path


SCANS = [
    ['scan', '--counters', '-b', 'host,latency[aggr=quantize]'],
    ['scan', '--points', '-f', '{"gt": ["latency", 50]}', '-b', 'host'],
    ['scan', '--counters', '--after', '2014-05-05', '--before',
     '2014-05-20', '-b', 'host,timestamp[field=time,date,aggr=lquantize,'
     'step=86400]'],
]


@pytest.mark.parametrize('engine', ['vector', 'mt', 'jax'])
@pytest.mark.parametrize('ds', ['plain', 'crlf', 'trunc'])
@pytest.mark.parametrize('parse', ['vector', 'device'])
def test_cli_scan_lanes_match_bin_dn(corpus_env, monkeypatch, parse, ds,
                                     engine):
    # the hidden lane counters (fast-path and fallback lines) too: a
    # wrong parity sends lines to the fallback parser, whose output is
    # right by construction
    env = {'DN_PARSE': parse, 'DN_READ_SIZE': '4096',
           'DN_COUNTERS_ALL': '1',
           'DN_ENGINE': 'vector' if engine == 'mt' else engine}
    if engine == 'mt':
        env['DN_SCAN_THREADS'] = '3'
    scans = SCANS if engine != 'jax' else SCANS[:1]
    for args in scans:
        ref, got = _both(monkeypatch, args + [ds], env)
        assert ref.returncode == 0, ref.stderr
        assert (got.returncode, got.stdout, got.stderr) == \
            (ref.returncode, ref.stdout, ref.stderr), args


@pytest.mark.parametrize('size', ['17', '97'])
def test_cli_scan_chunk_boundaries(corpus_env, monkeypatch, size):
    """Tiny reads: the line joiner repairs a split at every boundary."""
    for parse in ('vector', 'device'):
        ref, got = _both(monkeypatch, SCANS[0] + ['crlf'],
                         {'DN_PARSE': parse, 'DN_READ_SIZE': size,
                          'DN_ENGINE': 'vector'})
        assert ref.returncode == 0 and (got.stdout, got.stderr) == \
            (ref.stdout, ref.stderr)


def test_cli_scan_parse_flag_and_dry_run(corpus_env, monkeypatch):
    """--parse scopes DN_PARSE for one command; the dry run names the
    lane when a lane was asked for (or under DN_COUNTERS_ALL=1), and
    stays silent about it otherwise."""
    for extra, env in ((['--parse=vector'], {}),
                       (['--parse', 'device'], {}),
                       ([], {'DN_PARSE': 'host'}),
                       ([], {'DN_COUNTERS_ALL': '1'}),
                       ([], {'DN_COUNTERS_ALL': '1', 'DN_NATIVE': '0'}),
                       ([], {})):
        for q in (['-b', 'host'], ['-b', 'req.method']):
            args = ['scan', '--dry-run'] + extra + q + ['plain']
            ref, got = _both(monkeypatch, args, env)
            assert ref.returncode == got.returncode == 0, got.stderr
            assert (got.stdout, got.stderr) == (ref.stdout, ref.stderr)
            assert got.stderr.startswith('would scan files:\n')
            assert ('parse lane:' in got.stderr) == bool(extra or env)
    ref, got = _both(monkeypatch, ['scan', '--dry-run', '--parse=device',
                                   '-b', 'host', 'plain'])
    assert got.stderr.endswith('parse lane: device (forced device)\n')
    ref, got = _both(monkeypatch, ['scan', '--parse=bogus', '-b', 'host',
                                   'plain'])
    assert ref.returncode == got.returncode == 2
    assert got.stderr.startswith('dn: bad value for "parse": "bogus"\n')


@pytest.mark.parametrize('native', ['1', '0'])
def test_cli_dotted_query_ineligible_counter(corpus_env, monkeypatch,
                                             native):
    """A dotted projection under a forced byte lane keeps the host lane
    with the hidden `parse lane ineligible` counter (with the native
    parser, and without it on the record path)."""
    env = {'DN_PARSE': 'vector', 'DN_NATIVE': native,
           'DN_COUNTERS_ALL': '1', 'DN_ENGINE': 'vector'}
    args = ['scan', '--counters', '-b', 'req.method,host', 'plain']
    ref, got = _both(monkeypatch, args, env)
    assert ref.returncode == 0 and got.stdout == ref.stdout
    assert got.stderr == ref.stderr
    assert 'parse lane ineligible:' in got.stderr
    assert 'fast-path' not in got.stderr


def test_cli_lane_counters_shown_under_counters_all(corpus_env,
                                                    monkeypatch):
    for parse in ('vector', 'device'):
        ref, got = _both(monkeypatch, SCANS[0] + ['plain'],
                         {'DN_PARSE': parse, 'DN_COUNTERS_ALL': '1',
                          'DN_ENGINE': 'vector'})
        assert got.stderr == ref.stderr
        for name in ('parse lines fast-path:', 'parse lines fallback:',
                     'parse bytes projected:'):
            assert name in got.stderr


BUILD_METRICS = [
    ['metric-add', '-b',
     'timestamp[field=time,date,aggr=lquantize,step=3600],host',
     'plain', 'byhour'],
    ['metric-add', '-b', 'timestamp[field=time,date,aggr=lquantize,'
     'step=86400],latency[aggr=quantize]', '-f',
     '{"ne": ["host", "janey"]}', 'plain', 'bylat'],
]


def _tree(root):
    from dragnet_tpu_torch import index_journal as tjournal
    out = {}
    for dirpath, dirs, files in os.walk(root):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root)
            if tjournal.is_durable_metadata(rel) and \
                    os.path.basename(rel).startswith(
                        tjournal.EVENTS_PREFIX):
                continue
            with open(p, 'rb') as f:
                out[rel] = f.read()
    return out


def build_both(monkeypatch, tmp, args, env, ds='plain'):
    """Build with bin/dn, move its tree aside, build with the port:
    (ref, got, ref tree, port tree)."""
    from dragnet_tpu import cli as jcli
    from dragnet_tpu_torch import cli as tcli
    idx = tmp / ds
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        ref = _run(jcli.main, args)
        os.rename(idx, str(idx) + '.ref')
        got = _run(tcli.main, args)
    ref_tree = _tree(str(idx) + '.ref')
    got_tree = _tree(idx)
    os.rename(idx, str(idx) + '.port.%d' % time.monotonic_ns())
    os.rename(str(idx) + '.ref', str(idx) + '.ref.%d'
              % time.monotonic_ns())
    return ref, got, ref_tree, got_tree


@pytest.mark.parametrize('parse', ['vector', 'device'])
def test_cli_build_lanes_match_bin_dn(corpus_env, monkeypatch, parse):
    from dragnet_tpu_torch import cli as tcli
    for args in BUILD_METRICS:
        assert _run(tcli.main, args).returncode == 0
    for extra, env in (([], {'DN_PARSE': parse}),
                       (['--parse=' + parse], {'DN_SCAN_THREADS': '2'})):
        args = ['build', '--interval=hour', '--counters'] + extra + \
            ['plain']
        env = dict(env, DN_ENGINE='vector', DN_COUNTERS_ALL='1')
        ref, got, rt, gt = build_both(monkeypatch, corpus_env, args, env)
        assert ref.returncode == got.returncode == 0, got.stderr
        assert (got.stdout, got.stderr) == (ref.stdout, ref.stderr)
        assert 'parse lines fast-path:' in got.stderr
        assert rt == gt and len(rt) > 2
    # index-scan through the lane
    args = ['index-scan', '--interval=hour', '--counters', 'plain']
    ref, got = _both(monkeypatch, args, {'DN_PARSE': parse,
                                         'DN_ENGINE': 'vector'})
    assert ref.returncode == got.returncode == 0
    assert (got.stdout, got.stderr) == (ref.stdout, ref.stderr)


# -- the raises -------------------------------------------------------------

def _ds(datafile):
    return tdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': str(datafile), 'timeField': 'time'},
        'ds_filter': None, 'ds_format': 'json'})


def test_device_lane_hung_kernel_raises(tmp_path, monkeypatch):
    """A hung first parity call raises DNError under the probe deadline
    (the reference warns and pins numpy); later calls on that device
    raise the same error at once."""
    datafile = tmp_path / 'hang.log'
    write_corpus(datafile, 91)
    release = threading.Event()

    def hang(self, arr):
        release.wait(60)
        return tbk.parity_numpy(arr)
    monkeypatch.setattr(tbk.DeviceParity, '__call__', hang)
    monkeypatch.setenv('DN_DEVICE_PROBE_TIMEOUT', '1')
    monkeypatch.setenv('DN_PARSE', 'device')
    tbk.reset_device_state()
    try:
        t0 = time.monotonic()
        with pytest.raises(DNError, match='device parse kernel probe '
                           'timed out on cpu'):
            _ds(datafile).scan(tquery.query_load(dict(FLAT)),
                               device='cpu', engine='vector')
        assert time.monotonic() - t0 < 30
        t0 = time.monotonic()
        with pytest.raises(DNError, match='timed out'):
            _ds(datafile).scan(tquery.query_load(dict(FLAT)),
                               device='cpu', engine='vector')
        assert time.monotonic() - t0 < 5
    finally:
        release.set()
        tbk.reset_device_state()


def test_device_lane_failed_kernel_raises(tmp_path, monkeypatch):
    datafile = tmp_path / 'fail.log'
    write_corpus(datafile, 92)

    def fail(self, arr):
        raise RuntimeError('planted')
    monkeypatch.setattr(tbk.DeviceParity, '__call__', fail)
    monkeypatch.setenv('DN_PARSE', 'device')
    tbk.reset_device_state()
    try:
        with pytest.raises(DNError, match=r'device parse kernel failed '
                           r'\(planted\)'):
            _ds(datafile).scan(tquery.query_load(dict(FLAT)),
                               device='cpu', engine='vector')
    finally:
        tbk.reset_device_state()


def test_device_lane_without_cuda_raises(corpus_env, monkeypatch):
    """DN_PARSE=device with CUDA asked for and absent is an error (the
    reference turns the lane into the vector lane)."""
    from dragnet_tpu_torch import cli as tcli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('DN_PARSE', 'device')
    with pytest.raises(DNError, match='CUDA is not available'):
        _ds(corpus_env / 'plain.log').scan(
            tquery.query_load(dict(FLAT)), engine='vector')
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cuda')
    monkeypatch.setenv('DN_ENGINE', 'vector')
    got = _run(tcli.main, SCANS[0] + ['plain'])
    assert got.returncode == 1 and not got.stdout
    assert got.stderr.startswith('dn: CUDA device "cuda" requested but '
                                 'CUDA is not available')
    # the vector lane never touches the device
    monkeypatch.setenv('DN_PARSE', 'vector')
    got = _run(tcli.main, SCANS[0] + ['plain'])
    assert got.returncode == 0, got.stderr


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_dev):
    for n in LENGTHS:
        for i, density in enumerate(DENSITIES):
            arr = _bytes(n, density, seed=n * 10 + i)
            host = torch.from_numpy(arr.copy())
            want = tbk.quote_parity_ref(host)
            before = tck.launches['quote_parity']
            got = tbk.quote_parity(host.to(cuda_dev))
            torch.cuda.synchronize()
            assert tck.launches['quote_parity'] == before + (n > 0)
            assert np.array_equal(_unpacked(got, n), _unpacked(want, n))
            assert np.array_equal(_unpacked(got, n),
                                  jbk.parity_numpy(arr))


@pytest.mark.cuda
def test_kernel_unaligned_and_device_lane_on_card(cuda_dev):
    arr = _bytes((1 << 20) + 13, 0.3, seed=5)
    dev = torch.from_numpy(arr.copy()).to(cuda_dev)
    for off in (1, 3, 16, 33):
        got = tbk.quote_parity(dev[off:])
        assert np.array_equal(_unpacked(got, arr.size - off),
                              jbk.parity_numpy(arr[off:]))
    call = tbk.DeviceParity(cuda_dev)
    before = tck.launches['quote_parity']
    for n in (5, 1 << 19, 100, (1 << 20) + 13):
        assert np.array_equal(call(arr[:n]), jbk.parity_numpy(arr[:n]))
    assert tck.launches['quote_parity'] == before + 4


@pytest.mark.cuda
def test_scan_device_lane_on_card(cuda_dev, tmp_path, monkeypatch):
    datafile = tmp_path / 'card.log'
    write_corpus(datafile, 93)
    monkeypatch.setenv('DN_PARSE', 'device')
    tbk.reset_device_state()
    q = tquery.query_load(dict(FLAT))
    before = tck.launches['quote_parity']
    card = _ds(datafile).scan(q, device='cuda', engine='device')
    assert tck.launches['quote_parity'] > before
    monkeypatch.setenv('DN_PARSE', 'vector')
    host = _ds(datafile).scan(q, device='cpu', engine='vector')
    assert card.points == host.points
