"""The port's `dn build` and `dn index-scan` (dragnet_tpu_torch,
device='cpu') against the JAX package's: the stacked multi-metric
device build (DeviceScanStack) must write index trees byte-identical to
the JAX package's forced device build (DN_ENGINE=jax on XLA:CPU) and
host build (DN_ENGINE=vector), for every interval and index format, and
index-scan must emit the same tagged points in the same order.  The
metrics cover the three fold routes: the one-hot kernel (small dense),
index_add_ (large dense) and the sparse program (a key space past the
dense budget, forced low in both packages)."""

import contextlib
import io
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from dragnet_tpu import native as jnative
from dragnet_tpu import query as jquery
from dragnet_tpu.datasource_file import DatasourceFile as JDatasourceFile
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import index_journal as tjournal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

METRICS = [
    # shared columns across metrics: time (all), host (3), latency (3);
    # the dense key spaces grow with the interval's __dn_ts window
    {'name': 'byday', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 86400}]},
    {'name': 'byhost', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 86400},
        {'name': 'host', 'field': 'host'}]},
    {'name': 'bymethod', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 86400},
        {'name': 'method', 'field': 'req.method'},
        {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}],
     'filter': {'ne': ['host', 'b']}},
    {'name': 'bylat', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 86400},
        {'name': 'host', 'field': 'host'},
        {'name': 'latency', 'field': 'latency', 'aggr': 'lquantize',
         'step': 50}]},
    # past the (forced) dense budget: the sparse program
    {'name': 'byminute', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 60},
        {'name': 'host', 'field': 'host'},
        {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]},
]

# the dense budget both packages run with here: byminute's key space
# (pow2 minute window x 32 hosts x 32 quantize buckets) is past it
MAX_DENSE = 1 << 16
BATCH = 256


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    if jnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    from dragnet_tpu_torch import engine as tengine
    for mod in (jengine, jds, tengine, tds):
        monkeypatch.setattr(mod, 'MAX_DENSE_SEGMENTS', MAX_DENSE)
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_SCAN_THREADS', '0')
    monkeypatch.delenv('DN_STACK', raising=False)


def _write_data(path, n, with_edges=False):
    rng = random.Random(7)
    lines = []
    for i in range(n):
        day = 1 + (i * 3 // n)
        lines.append(json.dumps({
            'time': '2014-05-%02dT%02d:%02d:%02dZ' % (
                day, rng.randrange(24), rng.randrange(60),
                rng.randrange(60)),
            'host': rng.choice(['a', 'b', 'c', 'host-%d'
                                % rng.randrange(20)]),
            'req': {'method': rng.choice(['GET', 'PUT', 'DELETE'])},
            'latency': rng.choice([0, 1, 3, 17, 200, 4096]),
        }))
    if with_edges:
        # array-valued key field and non-integral latency force
        # per-batch staging failures mid-stream
        lines.insert(n // 3, json.dumps({
            'time': '2014-05-01T05:00:00Z', 'host': [1, 'two'],
            'req': {'method': 'GET'}, 'latency': 3}))
        lines.insert(2 * n // 3, json.dumps({
            'time': '2014-05-02T05:00:00Z', 'host': 'a',
            'req': {'method': 'PUT'}, 'latency': 2.5}))
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _dsconfig(datafile, indexdir):
    return {'ds_backend': 'file',
            'ds_backend_config': {'path': str(datafile),
                                  'indexPath': str(indexdir),
                                  'timeField': 'time'},
            'ds_filter': None, 'ds_format': 'json'}


def _tree_bytes(root):
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


def _hidden(result, name):
    return sum(s.counters.get(name, 0) for s in result.pipeline.stages)


def _jax_build(monkeypatch, datafile, indexdir, engine, interval='day',
               batch=BATCH):
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    monkeypatch.setenv('DN_ENGINE', engine)
    monkeypatch.setattr(jengine, 'BATCH_SIZE', batch)
    monkeypatch.setattr(jds, 'BATCH_SIZE', batch)
    monkeypatch.setenv('DN_READ_SIZE', str(batch * 64))
    metrics = [jquery.metric_deserialize(m) for m in METRICS]
    return JDatasourceFile(_dsconfig(datafile, indexdir)).build(
        metrics, interval)


def _port_ds(monkeypatch, datafile, indexdir, batch=BATCH):
    monkeypatch.setattr(tdf, 'BATCH_SIZE', batch)
    monkeypatch.setenv('DN_READ_SIZE', str(batch * 64))
    return tdf.DatasourceFile(_dsconfig(datafile, indexdir))


def _port_metrics():
    return [tquery.metric_deserialize(m) for m in METRICS]


def _port_build(monkeypatch, datafile, indexdir, interval='day',
                engine='device', batch=BATCH):
    return _port_ds(monkeypatch, datafile, indexdir, batch).build(
        _port_metrics(), interval, device='cpu', engine=engine)


def _spy_routes(monkeypatch):
    """{scan input prefix: [fold route per batch]}."""
    routes = {}
    orig_fold = tds.DeviceScan._fold
    orig_sparse = tds.DeviceScan._fold_sparse

    def fold(self, args, n, profile, caps, ns, use_kernel, base):
        routes.setdefault(self._pfx, []).append(
            'kernel' if use_kernel else 'index_add')
        return orig_fold(self, args, n, profile, caps, ns, use_kernel,
                         base)

    def fold_sparse(self, *a):
        routes.setdefault(self._pfx, []).append('sparse')
        return orig_sparse(self, *a)
    monkeypatch.setattr(tds.DeviceScan, '_fold', fold)
    monkeypatch.setattr(tds.DeviceScan, '_fold_sparse', fold_sparse)
    return routes


def _assert_same_tree(a, b):
    ta, tb = _tree_bytes(a), _tree_bytes(b)
    assert ta.keys() == tb.keys()
    for rel in ta:
        assert ta[rel] == tb[rel], 'index file %s differs' % rel
    return ta


@pytest.mark.parametrize('fmt', ['dnc', 'sqlite'])
@pytest.mark.parametrize('interval', ['hour', 'day', 'all'])
def test_port_stacked_build_byte_identical(tmp_path, monkeypatch,
                                           interval, fmt):
    monkeypatch.setenv('DN_INDEX_FORMAT', fmt)
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 3000)
    _jax_build(monkeypatch, datafile, tmp_path / 'jdev', 'jax', interval)
    _jax_build(monkeypatch, datafile, tmp_path / 'jhost', 'vector',
               interval)
    routes = _spy_routes(monkeypatch)
    r = _port_build(monkeypatch, datafile, tmp_path / 'port', interval)
    nbatches = _hidden(r, 'ndevicebatches')
    stacked = _hidden(r, 'nstackedbatches')
    assert stacked > 0 and stacked == nbatches
    # one fold per metric per stacked batch, and every route ran: the
    # kernel (byday always), index_add_ and the sparse fold (byminute
    # always; the others by the interval's __dn_ts window)
    assert sorted(routes) == ['m%d_' % i for i in range(len(METRICS))]
    assert all(len(r) * len(METRICS) == stacked for r in routes.values())
    assert set(routes['m0_']) == {'kernel'}
    assert set(routes['m4_']) == {'sparse'}
    assert {'kernel', 'index_add', 'sparse'} == \
        set(sum(routes.values(), []))
    tree = _assert_same_tree(tmp_path / 'port', tmp_path / 'jdev')
    _assert_same_tree(tmp_path / 'port', tmp_path / 'jhost')
    shards = [p for p in tree if not tjournal.is_durable_metadata(p)]
    assert len(shards) == {'hour': 72, 'day': 3, 'all': 1}[interval]


def test_port_stacked_build_with_fallback_batches(tmp_path, monkeypatch):
    """Batches a metric cannot stage (array key values, non-integral
    quantize values) drop the whole batch to the per-scan paths; the
    tree still equals the JAX package's byte for byte."""
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 1500, with_edges=True)
    _jax_build(monkeypatch, datafile, tmp_path / 'jhost', 'vector')
    _jax_build(monkeypatch, datafile, tmp_path / 'jdev', 'jax', batch=128)
    r = _port_build(monkeypatch, datafile, tmp_path / 'port', batch=128)
    stacked = _hidden(r, 'nstackedbatches')
    assert 0 < stacked < _hidden(r, 'ndevicebatches')
    _assert_same_tree(tmp_path / 'port', tmp_path / 'jdev')
    _assert_same_tree(tmp_path / 'port', tmp_path / 'jhost')


def test_port_index_scan_points_identical(tmp_path, monkeypatch):
    """index-scan (tagged points, insertion order) through the stack
    equals the JAX package's device and host engines exactly, with the
    same counters."""
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 2000)
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    monkeypatch.setattr(jengine, 'BATCH_SIZE', BATCH)
    monkeypatch.setattr(jds, 'BATCH_SIZE', BATCH)
    ds = _port_ds(monkeypatch, datafile, tmp_path / 'p')
    jmetrics = [jquery.metric_deserialize(m) for m in METRICS]
    results = []
    for engine in ('jax', 'vector'):
        monkeypatch.setenv('DN_ENGINE', engine)
        results.append(JDatasourceFile(_dsconfig(
            datafile, tmp_path / 'j')).index_scan(jmetrics, 'hour'))
    got = ds.index_scan(_port_metrics(), 'hour', device='cpu')
    assert _hidden(got, 'nstackedbatches') > 0
    for ref in results:
        assert got.points == ref.points

    def visible(r):
        return [(s.name, sorted((k, v) for k, v in s.counters.items()
                                if v and k not in s.hidden))
                for s in r.pipeline.stages]
    assert visible(got) == visible(results[0])


def test_port_stack_disable_env(tmp_path, monkeypatch):
    """DN_STACK=0 keeps the per-scan device folds: same tree, no
    stacked batches."""
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 1200)
    r_on = _port_build(monkeypatch, datafile, tmp_path / 'i1')
    assert _hidden(r_on, 'nstackedbatches') > 0
    monkeypatch.setenv('DN_STACK', '0')
    r_off = _port_build(monkeypatch, datafile, tmp_path / 'i2')
    assert _hidden(r_off, 'nstackedbatches') == 0
    assert _hidden(r_off, 'ndevicebatches') == \
        _hidden(r_on, 'ndevicebatches')
    _assert_same_tree(tmp_path / 'i1', tmp_path / 'i2')


def test_port_host_engine_build_identical(tmp_path, monkeypatch):
    """The port's host engine (engine='vector') writes the same tree as
    its device build: the smoke's reference on the card."""
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 1500)
    r = _port_build(monkeypatch, datafile, tmp_path / 'host',
                    engine='vector')
    assert _hidden(r, 'ndevicebatches') == 0
    _port_build(monkeypatch, datafile, tmp_path / 'dev')
    _assert_same_tree(tmp_path / 'dev', tmp_path / 'host')


def test_port_index_write_matches_build(tmp_path, monkeypatch):
    """index-scan's tagged points written through the streaming writer
    (the index-read path) land the same tree as the columnar build."""
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 1500)
    _port_build(monkeypatch, datafile, tmp_path / 'built', 'hour')
    ds = _port_ds(monkeypatch, datafile, tmp_path / 'streamed')
    pts = ds.index_scan(_port_metrics(), 'hour', device='cpu').points
    ds._index_write(_port_metrics(), 'hour', pts)
    _assert_same_tree(tmp_path / 'built', tmp_path / 'streamed')


def test_port_build_numpy_index_writer(tmp_path, monkeypatch):
    """Without libdnindex.so (DN_NATIVE=0) the DNC shards come from the
    numpy writer, byte-identical to the native one."""
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 1500)
    _port_build(monkeypatch, datafile, tmp_path / 'native')
    from dragnet_tpu_torch import native_index
    monkeypatch.setenv('DN_NATIVE', '0')
    assert native_index.get_lib() is None
    _port_build(monkeypatch, datafile, tmp_path / 'numpy')
    _assert_same_tree(tmp_path / 'native', tmp_path / 'numpy')


def test_port_build_argument_errors(tmp_path, monkeypatch):
    from dragnet_tpu_torch.errors import DNError
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 10)
    ds = _port_ds(monkeypatch, datafile, tmp_path / 'i')
    with pytest.raises(DNError, match='--after without --before'):
        ds.build(_port_metrics(), 'day', time_after=1, device='cpu')
    cfg = _dsconfig(datafile, tmp_path / 'i')
    cfg['ds_backend_config'].pop('indexPath')
    with pytest.raises(DNError, match='missing "indexpath"'):
        tdf.DatasourceFile(cfg).build(_port_metrics(), 'day',
                                      device='cpu')
    with pytest.raises(DNError, match='unknown scan engine'):
        ds.build(_port_metrics(), 'day', device='cpu', engine='auto')
    dry = ds.build(_port_metrics(), 'day', dry_run=True, device='cpu')
    assert dry.dry_run_files == [str(datafile)]
    assert not os.path.exists(tmp_path / 'i')


# -- the CLI ----------------------------------------------------------------

CLI_METRICS = [
    ['metric-add', '-b',
     'timestamp[field=time,date,aggr=lquantize,step=3600],host',
     'muskie', 'byhour'],
    ['metric-add', '-b',
     'timestamp[field=time,date,aggr=lquantize,step=60],host,'
     'req.method,res.statusCode,latency[aggr=quantize]',
     '-f', '{"ne": ["res.statusCode", 599]}', 'muskie', 'requests'],
    ['metric-add', '-b',
     'timestamp[field=time,date,aggr=lquantize,step=60],host,req.url,'
     'latency[aggr=quantize]', 'muskie', 'byurl'],
]


def _port_cli(monkeypatch, env, args, subproc=False):
    """The port's CLI on the CPU: in-process (its entry point), or as
    `python -m dragnet_tpu_torch` when `subproc`."""
    if subproc:
        return subprocess.run(
            [sys.executable, '-m', 'dragnet_tpu_torch'] + args, cwd=ROOT,
            env=dict(env, DN_TORCH_DEVICE='cpu'), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, timeout=300)
    from dragnet_tpu_torch import cli
    for k in ('DRAGNET_CONFIG', 'DN_PARSE_THREADS', 'DN_READ_SIZE'):
        monkeypatch.setenv(k, env[k])
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return subprocess.CompletedProcess(args, rc, out.getvalue(),
                                       err.getvalue())


def _bin_dn(monkeypatch, env, args):
    from dragnet_tpu import cli
    for k in ('DRAGNET_CONFIG', 'DN_PARSE_THREADS', 'DN_READ_SIZE'):
        monkeypatch.setenv(k, env[k])
    monkeypatch.setenv('DN_ENGINE', 'jax')
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return subprocess.CompletedProcess(args, rc, out.getvalue(),
                                       err.getvalue())


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    from dragnet_tpu_torch import native as tnative
    from dragnet_tpu_torch import engine as tengine
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    # the CLIs run with the real dense budget
    for mod in (jengine, jds, tengine, tds):
        monkeypatch.setattr(mod, 'MAX_DENSE_SEGMENTS', 1 << 24)
    data = str(tmp_path / 'muskie.log')
    tnative.gen_to_file(4000, data, seed=11)
    env = dict(os.environ)
    env.update(DRAGNET_CONFIG=str(tmp_path / 'dragnetrc'),
               JAX_PLATFORMS='cpu', DN_PARSE_THREADS='1',
               DN_READ_SIZE='65536')
    env.pop('DN_ENGINE', None)
    proc = _port_cli(monkeypatch, env,
                     ['datasource-add', 'muskie', '--path=' + data,
                      '--time-field=time',
                      '--index-path=' + str(tmp_path / 'idx')])
    assert proc.returncode == 0, proc.stderr
    return env, tmp_path


def test_port_cli_metric_build_index_scan(cli_env, monkeypatch):
    """metric-add / metric-list / build / index-scan through
    `python -m dragnet_tpu_torch` against bin/dn's entry point on the
    same config: identical stdout, stderr (--counters) and index
    trees."""
    env, tmp = cli_env
    for args in CLI_METRICS:
        got = _port_cli(monkeypatch, env, args)
        assert got.returncode == 0 and not got.stdout, got.stderr
    for args in (['metric-list', 'muskie'], ['metric-list', '-v', 'muskie'],
                 ['index-scan', '--interval=hour', '--counters',
                  'muskie'],
                 ['build', '--dry-run', 'muskie']):
        ref = _bin_dn(monkeypatch, env, args)
        got = _port_cli(monkeypatch, env, args)
        assert ref.returncode == got.returncode == 0, got.stderr
        assert got.stdout == ref.stdout and got.stderr == ref.stderr, args
    assert len(got.stderr.splitlines()) == 2       # would scan files

    cfg_port = _port_cli(monkeypatch, env, ['index-config', 'muskie'])
    cfg_ref = _bin_dn(monkeypatch, env, ['index-config', 'muskie'])
    a, b = json.loads(cfg_port.stdout), json.loads(cfg_ref.stdout)
    a.pop('mtime'), b.pop('mtime')
    assert a == b and len(a['metrics']) == 3

    args = ['build', '--interval=hour', '--counters', 'muskie']
    got = _port_cli(monkeypatch, env, args, subproc=True)
    assert got.returncode == 0, got.stderr
    os.rename(tmp / 'idx', tmp / 'port')
    ref = _bin_dn(monkeypatch, env, args)
    assert ref.returncode == 0
    assert got.stderr == ref.stderr and not got.stdout
    assert got.stderr.startswith('indexes for "muskie" built\n')
    tree = _assert_same_tree(tmp / 'port', tmp / 'idx')
    assert len([p for p in tree
                if not tjournal.is_durable_metadata(p)]) == 3


@pytest.mark.parametrize('bad', [['--warnings'], ['--remote', 'x'],
                                 ['--iq-stack', '0'],
                                 ['--parse', 'host'], ['--trace']])
def test_port_cli_build_unsupported_options(cli_env, monkeypatch, bad):
    """Options the port cannot honour yet are usage errors (exit 2),
    as is a `query` option given to `build`."""
    env, tmp = cli_env
    got = _port_cli(monkeypatch, env, ['build'] + bad + ['muskie'])
    assert got.returncode == 2
    assert 'unknown option' in got.stderr
    assert not os.path.exists(tmp / 'idx')


def test_port_cli_metric_remove(cli_env, monkeypatch):
    env, tmp = cli_env
    for args in CLI_METRICS[:2]:
        assert _port_cli(monkeypatch, env, args).returncode == 0
    assert _port_cli(monkeypatch, env, ['metric-remove', 'muskie',
                                        'byhour']).returncode == 0
    ref = _bin_dn(monkeypatch, env, ['metric-list', 'muskie'])
    got = _port_cli(monkeypatch, env, ['metric-list', 'muskie'])
    assert got.stdout == ref.stdout
    assert 'byhour' not in got.stdout and 'requests' in got.stdout
    bad = _port_cli(monkeypatch, env, ['metric-remove', 'muskie', 'nosuch'])
    ref = _bin_dn(monkeypatch, env, ['metric-remove', 'muskie', 'nosuch'])
    assert bad.returncode == ref.returncode == 1
    assert bad.stderr == ref.stderr


@pytest.mark.cuda
def test_port_stacked_build_cuda_matches_cpu(tmp_path, monkeypatch):
    """One stacked build on the card against the same build on the
    CPU: byte-identical trees."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    datafile = tmp_path / 'data.log'
    _write_data(datafile, 3000)
    _port_build(monkeypatch, datafile, tmp_path / 'cpu', 'hour')
    ds = _port_ds(monkeypatch, datafile, tmp_path / 'cuda')
    r = ds.build(_port_metrics(), 'hour', device='cuda')
    assert _hidden(r, 'nstackedbatches') > 0
    _assert_same_tree(tmp_path / 'cpu', tmp_path / 'cuda')
