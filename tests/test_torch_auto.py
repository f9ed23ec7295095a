"""The port's default engine on the CPU: DN_ENGINE=auto|jax|vector, the
multithreaded host executor (scan_mt), auto mode's background probe,
shadow audition, takeover and hand-back, probation, the persisted
verdict cache and the query's `iq:` audition family.

Every route is held against the JAX package's host engine
(DN_ENGINE=vector at DN_SCAN_THREADS=0) on the same generated file:
points and the visible --counters byte for byte.  Auto's eager
subclasses and small batches (512 records, as the reference's own auto
tests use) make every transition happen inside a 40,000-record stream;
the device here is the CPU (torch eager), so the takeover tests pin
REQUIRE_ACCELERATOR off, as the reference's tests do on XLA:CPU, and
wait for a started probe and a fed audition instead of racing them
against the stream.  Two tests, marked `cuda`, run on the card: the
eager takeover, and K1's stream lookup from a second thread.

The conftest pins DN_AUDITION_CACHE=0; the cache tests opt back in with
a temporary DN_TORCH_CACHE_DIR, so nothing here writes under ~/.cache.
"""

import contextlib
import io
import json
import os
import threading
import time

import pytest
import torch

from dragnet_tpu import query as jquery
from dragnet_tpu import native as jnative
from dragnet_tpu.datasource_file import DatasourceFile as JDatasourceFile

from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import device_index as tdi
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import scan_mt as tmt
from dragnet_tpu_torch.datasource_file import DatasourceFile
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.vpipe import Pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(jnative.get_lib() is None,
                                reason='native parser unavailable')

QUERY = {
    'breakdowns': [
        {'name': 'host'},
        {'name': 'req.method'},
        {'name': 'latency', 'aggr': 'quantize'},
    ],
    'filter': {'ne': ['res.statusCode', 599]},
}
NRECORDS = 40000
SMALL_BATCH = 512

METRICS = [
    {'name': 'a', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 3600},
        {'name': 'host', 'field': 'host'}]},
    {'name': 'b', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 3600},
        {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]},
]
DS_FILTER = {'ne': ['req.method', 'DELETE']}


def _gen_file(path):
    import importlib.machinery
    import importlib.util
    src = os.path.join(ROOT, 'tools', 'mktestdata')
    spec = importlib.util.spec_from_file_location(
        'mktestdata', src,
        loader=importlib.machinery.SourceFileLoader('mktestdata', src))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.random.seed(5)
    mindate_ms = int(mod.MINDATE.timestamp() * 1000)
    maxdate_ms = int(mod.MAXDATE.timestamp() * 1000)
    with open(path, 'w') as f:
        for i in range(NRECORDS):
            f.write(json.dumps(
                mod.make_record(i, NRECORDS, mindate_ms, maxdate_ms),
                separators=(',', ':')) + '\n')
    return str(path)


def _dsconfig(datafile, indexdir=None, ds_filter=None):
    bc = {'path': datafile, 'timeField': 'time'}
    if indexdir is not None:
        bc['indexPath'] = str(indexdir)
    return {'ds_backend': 'file', 'ds_backend_config': bc,
            'ds_filter': ds_filter, 'ds_format': 'json'}


def _visible(result):
    return [(s.name, {c: v for c, v in s.counters.items()
                      if c not in s.hidden and v})
            for s in result.pipeline.stages]


@pytest.fixture(scope='module')
def datafile(tmp_path_factory):
    return _gen_file(tmp_path_factory.mktemp('auto') / 'auto.log')


def _jax_host(fn):
    """Run `fn` under the JAX package's single-threaded host engine."""
    saved = {k: os.environ.get(k) for k in ('DN_ENGINE',
                                            'DN_SCAN_THREADS')}
    os.environ.update(DN_ENGINE='vector', DN_SCAN_THREADS='0')
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope='module')
def expected(datafile):
    r = _jax_host(lambda: JDatasourceFile(_dsconfig(datafile)).scan(
        jquery.query_load(dict(QUERY))))
    return r.points, _visible(r)


@pytest.fixture
def small(monkeypatch):
    """Small batches and reads: many flush points in a short stream."""
    monkeypatch.setattr(tdf, 'BATCH_SIZE', SMALL_BATCH)
    monkeypatch.setenv('DN_READ_SIZE', '65536')
    monkeypatch.delenv('DN_ENGINE', raising=False)


def _scan(datafile, cls, monkeypatch, threads='2', engine='auto'):
    """A port scan on the CPU with the scan class pinned to `cls` (a
    recorder subclass keeps the instance)."""
    monkeypatch.setenv('DN_SCAN_THREADS', threads)
    instances = []

    class Recorder(cls):
        def __init__(self, *args, **kwargs):
            cls.__init__(self, *args, **kwargs)
            instances.append(self)

    ds = DatasourceFile(_dsconfig(datafile))
    ds._scan_cls = lambda engine, device: Recorder
    result = ds.scan(tquery.query_load(dict(QUERY)), device='cpu',
                     engine=engine)
    return result, instances


class _Eager(tds.AutoDeviceScan):
    ESCALATE_RECORDS = 1024
    REQUIRE_ACCELERATOR = False     # the CPU stands in for the card
    MIN_REMAINING_SECONDS = 0.0
    UNKNOWN_SIZE_RECORDS = 0
    SHADOW_MARGIN = 0.0             # audition always passes
    # deterministic for a short stream on a loaded machine
    AWAIT_DECISION = True


class _Unwinnable(_Eager):
    SHADOW_MARGIN = 1e9             # a live audition can never pass


# -- the multithreaded host executor -----------------------------------------

@pytest.mark.parametrize('threads', ['0', '1', '3', '5'])
def test_scan_mt_identical(datafile, expected, small, monkeypatch,
                           threads):
    """The host engine at 0, 1, 3 and 5 workers: points in emission
    order and --counters identical to the JAX package's host engine."""
    monkeypatch.setenv('DN_SCAN_THREADS', threads)
    r = DatasourceFile(_dsconfig(datafile)).scan(
        tquery.query_load(dict(QUERY)), engine='vector')
    assert r.points == expected[0]
    assert _visible(r) == expected[1]


@pytest.mark.parametrize('threads', ['1', '3'])
def test_scan_mt_radix_merge(datafile, monkeypatch, threads):
    """A high-cardinality scan whose batches pass DEFER_UNIQUE uniques
    merges through RadixMerge's partitions: points and counters equal
    to the JAX package's single-threaded host engine at the same batch
    size (nspillrecords depends on it)."""
    from dragnet_tpu import engine as jengine
    q = {'breakdowns': [{'name': 'req.url'}, {'name': 'latency'},
                        {'name': 'host'}]}
    monkeypatch.setattr(jengine, 'BATCH_SIZE', 8192)
    monkeypatch.setattr(tdf, 'BATCH_SIZE', 8192)
    monkeypatch.setenv('DN_READ_SIZE', '65536')
    ref = _jax_host(lambda: JDatasourceFile(_dsconfig(datafile)).scan(
        jquery.query_load(dict(q))))
    monkeypatch.setenv('DN_SCAN_THREADS', threads)
    tmt.reset_merge_stats()
    r = DatasourceFile(_dsconfig(datafile)).scan(tquery.query_load(dict(q)),
                                                engine='vector')
    assert tmt.merge_stats()['engaged'] == 1
    assert tmt.merge_stats()['rows'] > 0
    assert r.points == ref.points
    assert _visible(r) == _visible(ref)


def test_scan_mt_stress(datafile, expected, small, monkeypatch):
    """More workers than cores and a short switch interval: a lost
    update or an out-of-order merge would change the points or the
    summed counters."""
    import sys
    monkeypatch.setenv('DN_SCAN_THREADS', str(2 * (os.cpu_count() or 1)
                                              + 4))
    monkeypatch.setenv('DN_SCAN_PARTITIONS', '3')
    prior = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.monotonic()
        r = DatasourceFile(_dsconfig(datafile)).scan(
            tquery.query_load(dict(QUERY)), engine='vector')
        assert time.monotonic() - t0 < 120
    finally:
        sys.setswitchinterval(prior)
    assert r.points == expected[0]
    assert _visible(r) == expected[1]


@pytest.fixture(scope='module')
def expected_build(datafile, tmp_path_factory):
    d = tmp_path_factory.mktemp('jbuild')
    metrics = [jquery.metric_deserialize(m) for m in METRICS]

    def run():
        r = JDatasourceFile(_dsconfig(datafile, d / 'idx', DS_FILTER)) \
            .build(metrics, 'hour')
        pts = JDatasourceFile(_dsconfig(datafile, d / 'idx')) \
            .index_scan(metrics, 'hour', filter=DS_FILTER)
        return r, pts
    r, pts = _jax_host(run)
    return _tree(d / 'idx'), _visible(r), pts.points, _visible(pts)


def _tree(root):
    from dragnet_tpu_torch import index_journal as tjournal
    out = {}
    for dirpath, _, files in os.walk(str(root)):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, str(root))
            if tjournal.is_durable_metadata(rel) and \
                    os.path.basename(rel).startswith(
                        tjournal.EVENTS_PREFIX):
                continue
            with open(p, 'rb') as f:
                out[rel] = f.read()
    return out


@pytest.mark.parametrize('threads', ['0', '1', '3', '5'])
def test_build_mt_identical(datafile, expected_build, small, monkeypatch,
                            tmp_path, threads):
    """`build` and `index-scan` on the host engine at 0, 1, 3 and 5
    workers, with a datasource filter: the index tree, the tagged points
    and the counters identical to the JAX package's host engine."""
    monkeypatch.setenv('DN_SCAN_THREADS', threads)
    metrics = [tquery.metric_deserialize(m) for m in METRICS]
    r = DatasourceFile(_dsconfig(datafile, tmp_path / 'idx', DS_FILTER)) \
        .build(metrics, 'hour', engine='vector')
    tree, counters, pts, pcounters = expected_build
    assert _tree(tmp_path / 'idx') == tree
    assert _visible(r) == counters
    got = DatasourceFile(_dsconfig(datafile, tmp_path / 'idx')) \
        .index_scan(metrics, 'hour', filter=DS_FILTER, engine='vector')
    assert got.points == pts and _visible(got) == pcounters


def test_executor_worker_error_surfaces():
    """A worker's exception re-raises at submit or finish, and the
    executor still drains (no leaked threads)."""
    pl = Pipeline()

    def build_worker(wp):
        def process(snap):
            raise ValueError('boom')
        return process

    ex = tmt.MTScanExecutor(2, build_worker, lambda r: None, pl, 0)
    ex.submit(object())
    with pytest.raises(ValueError, match='boom'):
        for _ in range(50):
            time.sleep(0.01)
            ex.submit(object())
        ex.finish()
    assert ex.closed and not ex.threads


def test_scan_threads_env(monkeypatch):
    monkeypatch.setenv('DN_SCAN_THREADS', '3')
    assert tmt.scan_threads() == 3
    monkeypatch.setenv('DN_SCAN_THREADS', 'junk')
    assert tmt.scan_threads() == 0
    monkeypatch.setenv('DN_SCAN_THREADS', 'auto')
    assert 1 <= tmt.scan_threads() <= 6
    monkeypatch.setenv('DN_SCAN_PARTITIONS', '4')
    assert tmt.scan_partitions() == 4


# -- auto: takeover, audition, probation -------------------------------------

def test_mt_takeover_identical_results(datafile, expected, small,
                                       monkeypatch):
    """The device path auditions, takes over mid-stream from the MT
    executor, and the output is identical to the JAX package's host
    engine.  The audition races a short stream, so retry; every
    attempt must be correct."""
    s = None
    for attempt in range(4):
        result, instances = _scan(datafile, _Eager, monkeypatch)
        assert result.points == expected[0]
        assert _visible(result) == expected[1]
        assert len(instances) == 1
        s = instances[0]
        assert s._acc is None      # flushed by finish()
        if s._escalated:
            break
    assert s._escalated, 'device path never took over the stream'
    assert s._shadow is not None and s._shadow.done
    doc = s.route_doc()
    assert doc['escalated'] and doc['device_batches'] > 0
    assert doc['audition']['won'] and doc['audition']['device_rate'] > 0
    assert 1024 < doc['escalated_at'] < NRECORDS


def test_audition_fault_fails_the_scan(datafile, small, monkeypatch):
    """A fold that raises inside the audition is a fault of the device
    path: the scan fails with it, and does not answer from the host."""
    def planted(self, *args, **kwargs):
        raise RuntimeError('planted device fault')
    monkeypatch.setattr(tds._ShadowProbe, 'COLLECT', 2)
    monkeypatch.setattr(tds.DeviceScan, '_try_device', planted)
    with pytest.raises(DNError, match='device audition failed: '
                                      'planted device fault'):
        _scan(datafile, _Eager, monkeypatch)


def test_audition_fault_after_the_stream_raises_at_finish(monkeypatch):
    """An audition that faults after the last takeover check still
    fails the scan: finish() raises it."""
    def fault():
        raise RuntimeError('planted device fault')
    monkeypatch.setattr(tds._ShadowProbe, 'COLLECT', 2)
    s = _auto_scan()
    sp = tds._ShadowProbe(fault, lambda snap: None, lambda snap, n: None)
    sp.feed(object(), 1)
    sp.feed(object(), 1)
    sp.join(10.0)
    assert sp.failed and isinstance(sp.error, RuntimeError)
    s._shadow = sp
    with pytest.raises(DNError, match='device audition failed'):
        s.finish()


def test_audition_cut_by_the_stream_end_stays_on_host(monkeypatch):
    """A stream that ends before the audition's batches are in only
    fails the audition: no fault, the host answer stands."""
    sp = tds._ShadowProbe(lambda: [], lambda snap: None,
                          lambda snap, n: None)
    sp.feed(object(), 1)
    sp.close()
    sp.join(10.0)
    assert sp.failed and sp.error is None
    s = _auto_scan()
    s._shadow = sp
    s.finish()


def test_audition_loss_never_disturbs_stream(datafile, expected, small,
                                             monkeypatch):
    result, instances = _scan(datafile, _Unwinnable, monkeypatch)
    assert result.points == expected[0]
    assert _visible(result) == expected[1]
    s = instances[0]
    assert not s._escalated and s.route['device_batches'] == 0
    assert s._acc is None
    if s.route['audition'] is not None:
        assert s.route['audition']['won'] is False


def test_deescalation_returns_to_mt(datafile, expected, small,
                                    monkeypatch):
    """A device slower than the host rate loses probation and the scan
    returns to a fresh MT executor: output identical."""

    class Losing(_Eager):
        PROBATION_RECORDS = 1
        PROBATION_SECONDS = 0.0

        def take_over_now(self):
            rv = _Eager.take_over_now(self)
            if rv:
                # an unbeatable host rate before the switch
                self._host_records = 10 ** 12
            return rv

    s = None
    for attempt in range(4):
        result, instances = _scan(datafile, Losing, monkeypatch)
        assert result.points == expected[0]
        assert _visible(result) == expected[1]
        s = instances[0]
        if s._escalated:
            break
    assert s._escalated
    assert s._disabled and s.route['probation']['won'] is False
    assert s.route['device_batches'] >= 2


def test_small_scan_never_switches(datafile, expected, small,
                                   monkeypatch):
    class Reluctant(tds.AutoDeviceScan):
        ESCALATE_RECORDS = 1024
        REQUIRE_ACCELERATOR = False
        MIN_REMAINING_SECONDS = 1e9
        UNKNOWN_SIZE_RECORDS = 1 << 60

    result, instances = _scan(datafile, Reluctant, monkeypatch)
    assert result.points == expected[0]
    assert _visible(result) == expected[1]
    s = instances[0]
    assert not s._escalated
    assert s._shadow is None and s._probe_thread is None
    assert s._records_seen >= NRECORDS


def test_nonmt_async_escalation(datafile, expected, small, monkeypatch):
    """DN_SCAN_THREADS=0: the scanner escalates through its async probe
    without blocking the stream, and with no shadow audition."""
    s = None
    for attempt in range(4):
        result, instances = _scan(datafile, _Eager, monkeypatch,
                                  threads='0')
        assert result.points == expected[0]
        assert _visible(result) == expected[1]
        s = instances[0]
        assert s._shadow is None
        if s._escalated:
            break
    assert s._escalated and s.route['device_batches'] > 0


def test_auto_build_takeover_uses_stack(datafile, expected_build, small,
                                        monkeypatch, tmp_path):
    """An auto build whose device wins the audition folds the batches
    after the takeover through DeviceScanStack, with the datasource
    filter's mask as the replay's alive (make_alive); the index tree
    equals the JAX package's host build."""
    monkeypatch.setenv('DN_SCAN_THREADS', '2')
    monkeypatch.setattr(tds._ShadowProbe, 'COLLECT', 2)
    metrics = [tquery.metric_deserialize(m) for m in METRICS]
    stacked = 0
    for attempt in range(6):
        idx = tmp_path / ('i%d' % attempt)
        ds = DatasourceFile(_dsconfig(datafile, idx, DS_FILTER))
        ds._scan_cls = lambda engine, device: _Eager
        r = ds.build(metrics, 'hour', device='cpu', engine='auto')
        assert _tree(idx) == expected_build[0]
        assert _visible(r) == expected_build[1]
        stacked = sum(s.counters.get('nstackedbatches', 0)
                      for s in r.pipeline.stages)
        if stacked:
            break
    assert stacked > 0, 'stack never engaged after auto takeover'
    assert all(d['escalated'] for d in ds.last_route)


def test_auto_on_cpu_is_the_host_engine(datafile, expected, small):
    """auto with the CPU asked for is the host engine (the reference's
    no-accelerator branch): nothing probes, nothing escalates."""
    assert tds.scan_class('auto', 'cpu') is tds.VectorScan
    assert tds.scan_class('auto', None) is tds.AutoDeviceScan
    assert tds.scan_class('device', 'cpu') is tds.DeviceScan
    assert tds.scan_class('vector', 'cuda') is tds.VectorScan
    ds = DatasourceFile(_dsconfig(datafile))
    r = ds.scan(tquery.query_load(dict(QUERY)), device='cpu',
                engine='auto')
    assert r.points == expected[0] and _visible(r) == expected[1]
    assert ds.last_route == [{'engine': 'VectorScan', 'escalated': False,
                              'device_batches': 0}]


def test_auto_on_cuda_without_cuda_raises(datafile, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    ds = DatasourceFile(_dsconfig(datafile))
    with pytest.raises(DNError, match='CUDA'):
        ds.scan(tquery.query_load(dict(QUERY)), engine='auto')


@pytest.mark.cuda
def test_eager_takeover_on_cuda(datafile, expected, small, monkeypatch):
    """On the card: the eager auto scan takes the stream over and the
    one-hot kernel launches after the takeover; output identical."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from dragnet_tpu_torch.ops import cuda_kernels as tck
    monkeypatch.setenv('DN_SCAN_THREADS', '2')
    q = {'breakdowns': [{'name': 'host'},
                        {'name': 'latency', 'aggr': 'quantize'}]}
    ref = _jax_host(lambda: JDatasourceFile(_dsconfig(datafile)).scan(
        jquery.query_load(dict(q))))
    # pre-warm CUDA and the kernel's build with a forced scan, and
    # shorten the audition, so that it concludes inside this short
    # stream (as the reference's auto tests pre-warm their backend)
    DatasourceFile(_dsconfig(datafile)).scan(
        tquery.query_load(dict(q)), device='cuda', engine='device')
    monkeypatch.setattr(tds._ShadowProbe, 'COLLECT', 2)
    # K1's count when the stream is taken over: the audition's own
    # launches come before it
    at = []

    class Counted(_Eager):
        def _note_escalated(self):
            if self.route['escalated_at'] is None:
                at.append(tck.launches['onehot_dense'])
            _Eager._note_escalated(self)

    s = None
    for attempt in range(6):
        tck.reset_launches()
        del at[:]
        ds = DatasourceFile(_dsconfig(datafile))
        ds._scan_cls = lambda engine, device: Counted
        r = ds.scan(tquery.query_load(dict(q)), device='cuda',
                    engine='auto')
        assert r.points == ref.points and _visible(r) == _visible(ref)
        s = ds.last_route[0]
        if s['escalated']:
            break
    assert s['escalated'] and s['device_batches'] > 0
    assert tck.launches['onehot_dense'] - at[0] == s['device_batches']


@pytest.mark.cuda
def test_stream_handle_is_the_calling_threads(monkeypatch):
    """The audition's scratch scans launch K1 from a background thread:
    the wrapper's raw stream lookup must give THAT thread's current
    stream (torch's current stream is per thread)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from dragnet_tpu_torch.ops import cuda_kernels as tck
    side = torch.cuda.Stream()
    seen = {}

    def work():
        seen['default'] = (tck.current_stream_handle(0),
                           torch.cuda.current_stream(0).cuda_stream)
        with torch.cuda.stream(side):
            seen['side'] = (tck.current_stream_handle(0),
                            torch.cuda.current_stream(0).cuda_stream)
            out = torch.zeros(256, dtype=torch.int64, device='cuda')
            keys = torch.arange(1000, dtype=torch.int32,
                                device='cuda') % 256
            tck.onehot_dense_into(out, keys, None)
            side.synchronize()
            seen['sum'] = int(out.sum())
    with torch.cuda.stream(torch.cuda.Stream()):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert seen['default'][0] == seen['default'][1]
    assert seen['side'] == (side.cuda_stream, side.cuda_stream)
    assert seen['sum'] == 1000


# -- the verdict cache --------------------------------------------------------

@pytest.fixture
def cachedir(tmp_path, monkeypatch):
    """An isolated audition cache per test."""
    d = tmp_path / 'torchcache'
    monkeypatch.setenv('DN_TORCH_CACHE_DIR', str(d))
    monkeypatch.setenv('DN_AUDITION_CACHE', '1')
    monkeypatch.delenv('DN_AUDITION_TTL_S', raising=False)
    return str(d)


def _cache_path(cachedir):
    return os.path.join(cachedir, tds.AUDITION_FILE)


def test_audition_cache_roundtrip(cachedir):
    assert tds.audition_cache_get('k') is None
    tds.audition_cache_put('k', True, device_rate=1e6, host_rate=5e5)
    assert tds.audition_cache_get('k') is True
    tds.audition_cache_put('k', False)
    assert tds.audition_cache_get('k') is False
    assert tds.audition_cache_get('other') is None


def test_audition_cache_ttl(cachedir, monkeypatch):
    tds.audition_cache_put('k', True)
    monkeypatch.setenv('DN_AUDITION_TTL_S', '0.05')
    time.sleep(0.1)
    assert tds.audition_cache_get('k') is None
    tds.audition_cache_put('k2', False)      # prunes the expired entry
    with open(_cache_path(cachedir)) as f:
        data = json.load(f)
    assert 'k' not in data and 'k2' in data


def test_audition_cache_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv('DN_AUDITION_CACHE', '0')
    monkeypatch.setenv('DN_TORCH_CACHE_DIR', str(tmp_path / 'c'))
    tds.audition_cache_put('k', True)
    assert tds.audition_cache_get('k') is None
    assert tds.audition_cache_entries() == (None, 0, 0)
    assert not os.path.exists(str(tmp_path / 'c'))


def test_audition_cache_corrupt_file_reads_as_empty(cachedir):
    os.makedirs(cachedir, exist_ok=True)
    with open(_cache_path(cachedir), 'w') as f:
        f.write('{torn json')
    assert tds.audition_cache_get('k') is None
    tds.audition_cache_put('k', True)        # rewrites cleanly
    assert tds.audition_cache_get('k') is True


def test_cache_never_touches_the_jax_package_file(cachedir, monkeypatch):
    """The port's verdicts live in a file of their own: pointed at the
    JAX package's directory, it neither reads its wins nor overwrites
    them."""
    from dragnet_tpu import device_scan as jds
    monkeypatch.setenv('DN_XLA_CACHE_DIR', cachedir)
    jds.audition_cache_put('shape@cpu/', True)
    jfile = jds._audition_cache_file()
    with open(jfile) as f:
        before = f.read()
    assert tds._audition_cache_file() != jfile
    assert tds.audition_cache_get('shape@cpu/') is None
    assert tds.audition_cache_shape_hint('shape') is None
    tds.audition_cache_put('shape@torch/cpu', False)
    with open(jfile) as f:
        assert f.read() == before
    assert tds.audition_cache_shape_hint('shape') is False


def test_concurrent_puts_lose_no_verdicts(cachedir):
    nwriters = 8
    barrier = threading.Barrier(nwriters)

    def put(i):
        barrier.wait()
        tds.audition_cache_put('shape-%d@torch/cpu' % i, True,
                               device_rate=1.0, host_rate=0.5)

    threads = [threading.Thread(target=put, args=(i,))
               for i in range(nwriters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(_cache_path(cachedir)) as f:
        assert len(json.load(f)) == nwriters
    path, entries, wins = tds.audition_cache_entries()
    assert path == _cache_path(cachedir)
    assert entries == nwriters and wins == nwriters
    assert not [f for f in os.listdir(cachedir)
                if f not in (tds.AUDITION_FILE, tds.AUDITION_FILE + '.lock')]


def test_shape_hint_reads_persisted_wins(cachedir):
    tds.audition_cache_put('myshape@torch/cpu', True)
    assert tds.audition_cache_shape_hint('myshape') is True
    tds.audition_cache_put('othershape@torch/cpu', False)
    assert tds.audition_cache_shape_hint('othershape') is False
    assert tds.audition_cache_shape_hint('never') is None


class _Seeder(_Eager):
    # no probation window: the audition's win is the only verdict it
    # persists.  With one, a probation lost under load persists the
    # crossover's loss under the same key (the next test), and every
    # later attempt then reads that loss and stays on the host.
    PROBATION_RECORDS = 0


def test_probation_loss_replaces_the_audition_win(datafile, expected, small,
                                                  monkeypatch, cachedir):
    """A won audition persists True; a probation lost after the takeover
    persists its crossover verdict, False, under the same key."""

    class Losing(_Eager):
        PROBATION_RECORDS = 1
        PROBATION_SECONDS = 0.0

        def take_over_now(self):
            rv = _Eager.take_over_now(self)
            if rv:
                self._host_records = 10 ** 12
            return rv

    for attempt in range(4):
        result, instances = _scan(datafile, Losing, monkeypatch)
        assert result.points == expected[0]
        s = instances[0]
        if s._escalated:
            break
    assert s._escalated and s.route['audition']['won']
    assert s.route['probation']['won'] is False
    with open(_cache_path(cachedir)) as f:
        assert json.load(f)[s._audition_key()]['won'] is False


def _seed_verdict_from_win(datafile, expected, monkeypatch, cachedir):
    """Scan with a winnable audition until its verdict lands on disk:
    the 'previous process' half of the persistence contract."""
    for attempt in range(4):
        result, instances = _scan(datafile, _Seeder, monkeypatch)
        assert result.points == expected[0]
        if os.path.exists(_cache_path(cachedir)):
            with open(_cache_path(cachedir)) as f:
                data = json.load(f)
            if any(v.get('won') for v in data.values()):
                return data
    pytest.fail('the audition never concluded within the stream')


def test_warm_cache_reaches_device_without_reaudition(
        datafile, expected, small, monkeypatch, cachedir):
    """A fresh scan with an UNWINNABLE live audition still takes the
    device lane: the persisted verdict answers instead."""
    data = _seed_verdict_from_win(datafile, expected, monkeypatch,
                                  cachedir)
    assert all(k.endswith('@torch/cpu') for k in data)
    s = None
    for attempt in range(4):
        result, instances = _scan(datafile, _Unwinnable, monkeypatch)
        assert result.points == expected[0]
        assert _visible(result) == expected[1]
        s = instances[0]
        if s._escalated:
            break
    assert s._escalated, 'warm cache never routed the device lane'
    assert s._shadow is None and s.route['cached_verdict'] is True


def test_backend_identity_mismatch_reauditions(
        datafile, expected, small, monkeypatch, cachedir):
    data = _seed_verdict_from_win(datafile, expected, monkeypatch,
                                  cachedir)
    foreign = {k.rsplit('@', 1)[0] + '@bogus/alien-card': dict(v, won=True)
               for k, v in data.items()}
    with open(_cache_path(cachedir), 'w') as f:
        json.dump(foreign, f)
    result, instances = _scan(datafile, _Unwinnable, monkeypatch)
    assert result.points == expected[0]
    assert _visible(result) == expected[1]
    s = instances[0]
    assert not (s._escalated and s._shadow is None), \
        'foreign-device verdict routed this one without re-audition'


def test_expired_verdict_reauditions(datafile, expected, small,
                                     monkeypatch, cachedir):
    data = _seed_verdict_from_win(datafile, expected, monkeypatch,
                                  cachedir)
    aged = {k: dict(v, ts=time.time() - 7 * 86400)
            for k, v in data.items()}
    with open(_cache_path(cachedir), 'w') as f:
        json.dump(aged, f)
    k = next(iter(aged))
    assert tds.audition_cache_get(k) is None
    monkeypatch.setenv('DN_AUDITION_TTL_S', str(30 * 86400))
    assert tds.audition_cache_get(k) is True
    monkeypatch.delenv('DN_AUDITION_TTL_S')
    result, instances = _scan(datafile, _Unwinnable, monkeypatch)
    assert result.points == expected[0]
    assert _visible(result) == expected[1]
    s = instances[0]
    assert not (s._escalated and s._shadow is None), \
        'expired verdict routed this run without re-audition'


def test_cached_loss_stays_on_host(datafile, expected, small, monkeypatch,
                                   cachedir):
    data = _seed_verdict_from_win(datafile, expected, monkeypatch,
                                  cachedir)
    with open(_cache_path(cachedir), 'w') as f:
        json.dump({k: dict(v, won=False) for k, v in data.items()}, f)
    result, instances = _scan(datafile, _Eager, monkeypatch)
    assert result.points == expected[0]
    assert _visible(result) == expected[1]
    s = instances[0]
    assert not s._escalated
    if s._disabled:
        assert s._shadow is None and s.route['cached_verdict'] is False


# -- the engagement decision, in isolation ------------------------------------

def _auto_scan(query=None):
    """An AutoDeviceScan right at the audition decision: probe passed,
    switch worth it, shadow context armed."""

    class Eager(tds.AutoDeviceScan):
        ESCALATE_RECORDS = 0
        REQUIRE_ACCELERATOR = False
        MIN_REMAINING_SECONDS = 0.0
        UNKNOWN_SIZE_RECORDS = 0

    q = tquery.query_load(query or {'breakdowns': [{'name': 'host'}]})
    s = Eager(q, None, Pipeline(), device='cpu')
    s._backend_ok = True
    s._shadow_ctx = (lambda: [], lambda snap: None, lambda snap, n: None,
                     None)
    s._t0 = time.monotonic() - 1.0
    s._records_seen = 1000
    s._host_records = 1000
    return s


def test_cached_win_skips_audition(cachedir):
    s = _auto_scan()
    tds.audition_cache_put(s._audition_key(), True, device_rate=2e6,
                           host_rate=1e6)
    assert s._engage_device() is True
    assert s._shadow is None and s._escalated


@pytest.mark.parametrize('margin', [0.0, 1e9])
def test_audition_done_after_the_last_decision_concludes_at_finish(
        cachedir, margin):
    """A replay that completes after the stream's last decision point
    still concludes at finish: the verdict (won at margin 0, lost at an
    unbeatable margin) is in the route, marked at_finish, with the
    replay's wall and CPU seconds, and persisted for the next run."""
    s = _auto_scan()
    s.SHADOW_MARGIN = margin
    assert s._engage_device() is False      # the audition starts
    sp = s._shadow
    for _ in range(sp.COLLECT):
        sp.feed(object(), 1000)
    sp.join(10.0)
    assert sp.done and sp.rate is not None
    s.finish()                              # no decision point came
    aud = s.route['audition']
    assert aud['at_finish'] is True and aud['won'] is (margin == 0.0)
    assert aud['replay_s'] > 0 and aud['replay_cpu_s'] >= 0
    assert not s._escalated
    assert tds.audition_cache_get(s._audition_key()) is (margin == 0.0)


def test_cached_loss_decision(cachedir):
    s = _auto_scan()
    tds.audition_cache_put(s._audition_key(), False)
    assert s._engage_device() is False
    assert s._disabled and s._shadow is None


def test_no_cached_verdict_starts_audition(cachedir):
    s = _auto_scan()
    assert s._engage_device() is False      # audition now in flight
    assert s._shadow is not None
    s._shadow.close()


def test_audition_keys_distinguish_queries(cachedir):
    s1 = _auto_scan()
    s2 = _auto_scan({'breakdowns': [{'name': 'latency',
                                     'aggr': 'quantize'}]})
    assert s1._audition_key() != s2._audition_key()
    assert s1._audition_key().endswith('@torch/cpu')


# -- wedge armor --------------------------------------------------------------

def test_run_with_deadline_paths():
    assert tds.run_with_deadline(lambda: 42, 5.0, 't') == ('ok', 42)
    status, err = tds.run_with_deadline(
        lambda: (_ for _ in ()).throw(ValueError('x')), 5.0, 't')
    assert status == 'error' and isinstance(err, ValueError)
    status, _ = tds.run_with_deadline(lambda: time.sleep(30), 0.1, 't')
    assert status == 'timeout'


def test_probe_deadline_env(monkeypatch):
    monkeypatch.delenv('DN_DEVICE_PROBE_TIMEOUT', raising=False)
    assert tds.probe_deadline_s() == 420.0
    monkeypatch.setenv('DN_DEVICE_PROBE_TIMEOUT', '7.5')
    assert tds.probe_deadline_s() == 7.5
    monkeypatch.setenv('DN_DEVICE_PROBE_TIMEOUT', 'junk')
    assert tds.probe_deadline_s() == 420.0


@pytest.mark.parametrize('failure', ['timeout', 'error', 'refused'])
def test_forced_probe_failure_raises(monkeypatch, failure):
    """The forced lane keeps the port's no-silent-CPU rule: a probe that
    hangs past the deadline, raises or refuses raises a DNError (the
    JAX package warns and falls back to its host engine there)."""
    q = tquery.query_load({'breakdowns': [{'name': 'host'}]})
    s = tds.DeviceScan(q, None, Pipeline(), device='cpu')
    monkeypatch.setenv('DN_DEVICE_PROBE_TIMEOUT', '0.1')

    def probe():
        if failure == 'timeout':
            time.sleep(30)
        if failure == 'error':
            raise RuntimeError('no device')
        return False
    monkeypatch.setattr(s, '_probe_ok', probe)
    with pytest.raises(DNError, match='device cpu'):
        s._probe_backend()
    assert s._disabled and s.probe_status == failure
    assert s._probe_retries == (1 if failure == 'refused' else 0)


def test_forced_probe_passes_on_cpu():
    q = tquery.query_load({'breakdowns': [{'name': 'host'}]})
    s = tds.DeviceScan(q, None, Pipeline(), device='cpu')
    assert s._engage_device() is True and s.probe_status == 'ok'


def test_auto_probe_deadline_disables(monkeypatch):
    s = _auto_scan()
    s._backend_ok = None
    monkeypatch.setenv('DN_DEVICE_PROBE_TIMEOUT', '0.05')
    monkeypatch.setattr(s, '_probe_ok', lambda: time.sleep(30))
    assert s._engage_device() is False      # probe thread started
    time.sleep(0.1)
    assert s._engage_device() is False
    assert s._disabled and s.probe_status == 'timeout'


def test_auto_probe_error_raises(monkeypatch):
    """auto: a probe that raises is a fault of the device (a refusal or
    a timeout keeps the host engine)."""
    s = _auto_scan()
    s._backend_ok = None

    def probe():
        raise RuntimeError('planted probe fault')
    monkeypatch.setattr(s, '_probe_ok', probe)
    with pytest.raises(DNError, match='failed its probe: planted'):
        for _ in range(1000):       # until the probe thread answers
            assert s._engage_device() is False
            time.sleep(0.01)
    assert s._disabled and s.probe_status == 'error'


def test_auto_requires_a_cuda_device(monkeypatch):
    """REQUIRE_ACCELERATOR (auto's default): a probe on the CPU refuses,
    so the scan stays on the host."""
    q = tquery.query_load({'breakdowns': [{'name': 'host'}]})
    s = tds.AutoDeviceScan(q, None, Pipeline(), device='cpu')
    assert s._probe_with_retry() is False and s._probe_retries == 1


# -- the query's auto lane and its `iq:` audition -----------------------------

@pytest.fixture(scope='module')
def built(datafile, tmp_path_factory):
    """An hour tree built by the JAX package's host engine, and its
    host answer to QUERY."""
    d = tmp_path_factory.mktemp('iq')
    metrics = [jquery.metric_deserialize(m) for m in METRICS]
    q = {'breakdowns': [{'name': 'host'}]}

    def run():
        jds_ = JDatasourceFile(_dsconfig(datafile, d / 'idx'))
        jds_.build(metrics, 'hour')
        return jds_.query(jquery.query_load(dict(q)), 'hour')
    ref = _jax_host(run)
    return d / 'idx', q, ref.points, _visible(ref)


@pytest.fixture
def fresh_iq(monkeypatch):
    from dragnet_tpu_torch import index_query_mt as tiqmt
    for k in ('DN_INDEX_DEVICE', 'DN_IQ_STACK', 'DN_IQ_THREADS'):
        monkeypatch.delenv(k, raising=False)
    tiqmt.shard_cache_clear()
    tdi._reset_engagement()
    yield
    tiqmt.shard_cache_clear()
    tdi._reset_engagement()


def test_lane_decision_auto_branch(cachedir, monkeypatch, fresh_iq):
    cpu = torch.device('cpu')
    assert tdi.lane_decision('device', 10, 3, cpu) == ('device', 'device')
    assert tdi.lane_decision('vector', 10, 3, cpu)[0] == 'host'
    # cold: nothing persisted, CUDA not initialized -> host
    monkeypatch.setattr(tdi, '_audition_warm', lambda device: False)
    assert tdi.lane_decision('auto', 10, 3, cpu) == \
        ('host', 'host: auto, device cold')
    monkeypatch.setattr(tdi, '_audition_warm', lambda device: True)
    assert tdi.lane_decision('auto', 10, 3, cpu) == ('audition', 'audition')
    key = tdi._audition_key(10, 3)
    assert key == 'iq:r4:u3'
    tds.audition_cache_put(key + '@torch/cpu', False)
    assert tdi.lane_decision('auto', 10, 3, cpu) == \
        ('host', 'host: audition verdict')
    tds.audition_cache_put(key + '@torch/cpu', True)
    assert tdi.lane_decision('auto', 10, 3, cpu) == \
        ('device', 'device: audition verdict')
    monkeypatch.setenv('DN_INDEX_DEVICE', '0')
    assert tdi.lane_decision('auto', 10, 3, cpu)[0] == 'host'
    monkeypatch.undo()
    assert tdi._audition_warm(cpu) is False


def test_iq_audition_persists_and_routes(built, cachedir, monkeypatch,
                                         fresh_iq, datafile):
    """Auto with a warm device: the first query auditions (both paths,
    exact), persists an `iq:` verdict, and the repeat follows it; every
    answer equals the JAX package's host engine."""
    idx, q, ref_pts, ref_counters = built
    monkeypatch.setattr(tdi, '_audition_warm', lambda device: True)
    ds = DatasourceFile(_dsconfig(datafile, idx))

    def query():
        return ds.query(tquery.query_load(dict(q)), 'hour', device='cpu',
                        engine='auto')
    r = query()
    assert r.points == ref_pts and _visible(r) == ref_counters
    doc = tdi.stats_doc()
    assert doc['auditions'] == 1 and doc['routes'] == {'audition': 1}
    aud = doc['last_audition']
    assert aud['equal'] and aud['key'].startswith('iq:')
    assert aud['key'].endswith('@torch/cpu')
    with open(_cache_path(cachedir)) as f:
        entries = json.load(f)
    assert entries[aud['key']]['won'] is aud['won']
    r = query()
    assert r.points == ref_pts and _visible(r) == ref_counters
    want = 'device: audition verdict' if aud['won'] \
        else 'host: audition verdict'
    assert tdi.stats_doc()['last_route'] == want
    assert tdi.stats_doc()['auditions'] == 1


def test_iq_audition_mismatch_raises(built, cachedir, monkeypatch,
                                     fresh_iq, datafile):
    """An audition whose device sums differ from the host's raises: a
    wrong device sum is a fault, never a quiet host answer, and no
    verdict is written."""
    idx, q, _, _ = built
    monkeypatch.setattr(tdi, '_audition_warm', lambda device: True)
    real = tdi._device_fold

    def wrong(*args):
        acc, nd, nb = real(*args)
        acc = acc.copy()
        acc[0] += 1
        return acc, nd, nb
    monkeypatch.setattr(tdi, '_device_fold', wrong)
    ds = DatasourceFile(_dsconfig(datafile, idx))
    with pytest.raises(RuntimeError, match='audition'):
        ds.query(tquery.query_load(dict(q)), 'hour', device='cpu',
                 engine='auto')
    assert tdi.stats_doc()['last_audition']['equal'] is False
    assert not os.path.exists(_cache_path(cachedir))


# -- the CLI: DN_ENGINE as bin/dn reads it ------------------------------------

def _run_cli(main, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope='module')
def cli_tree(datafile, tmp_path_factory):
    """One DRAGNET_CONFIG (a filtered datasource with two metrics, an
    hour tree built by bin/dn's host engine) that both CLIs read."""
    from dragnet_tpu import cli as jcli
    d = tmp_path_factory.mktemp('autocli')
    saved = dict(os.environ)
    os.environ.update(DRAGNET_CONFIG=str(d / 'rc'), DN_PARSE_THREADS='1')
    try:
        for args in (['datasource-add', 'muskie', '--path=' + datafile,
                      '--time-field=time', '--index-path=' + str(d / 'idx'),
                      '--filter={"ne": ["host", "zzz"]}'],
                     ['metric-add', '-b',
                      'timestamp[field=time,date,aggr=lquantize,step=60],'
                      'host', 'muskie', 'byhost'],
                     ['metric-add', '-b', 'req.method,res.statusCode',
                      'muskie', 'bystatus']):
            assert _run_cli(jcli.main, args)[0] == 0
        rc = _jax_host(lambda: _run_cli(
            jcli.main, ['build', '--interval=hour', 'muskie']))
        assert rc[0] == 0, rc
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return d


CLI_CASES = {
    'scan': ['scan', '--counters', '-b', 'host,latency[aggr=quantize]',
             '-f', '{"ne": ["res.statusCode", 599]}', 'muskie'],
    'query': ['query', '--counters', '--interval=hour', '-b',
              'req.method,res.statusCode', 'muskie'],
}


@pytest.mark.parametrize('mode', ['auto', 'jax', 'vector'])
@pytest.mark.parametrize('case', sorted(CLI_CASES))
def test_cli_engine_modes_match_bin_dn(cli_tree, monkeypatch, mode, case):
    """The port's CLI (on the CPU) against bin/dn (XLA:CPU) under the
    same DN_ENGINE: stdout, stderr (--counters) and the exit code
    identical."""
    from dragnet_tpu import cli as jcli
    from dragnet_tpu_torch import cli as tcli
    monkeypatch.setenv('DRAGNET_CONFIG', str(cli_tree / 'rc'))
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_ENGINE', mode)
    args = CLI_CASES[case]
    ref = _run_cli(jcli.main, args)
    got = _run_cli(tcli.main, args)
    assert ref[0] == 0, ref[2]
    assert got == ref
    assert 'Aggregator' in got[2] or 'Index' in got[2]


def test_cli_build_auto_matches_bin_dn(datafile, monkeypatch, tmp_path):
    """`build` under the default engine (auto) in both CLIs, on one
    config: the port's tree and --counters equal bin/dn's."""
    from dragnet_tpu import cli as jcli
    from dragnet_tpu_torch import cli as tcli
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.delenv('DN_ENGINE', raising=False)
    for args in (['datasource-add', 'muskie', '--path=' + datafile,
                  '--time-field=time',
                  '--index-path=' + str(tmp_path / 'idx')],
                 ['metric-add', '-b', 'host,latency[aggr=quantize]',
                  'muskie', 'm']):
        assert _run_cli(tcli.main, args)[0] == 0
    args = ['build', '--interval=hour', '--counters', 'muskie']
    got = _run_cli(tcli.main, args)
    assert got[0] == 0, got[2]
    os.rename(str(tmp_path / 'idx'), str(tmp_path / 'port'))
    ref = _run_cli(jcli.main, args)
    assert ref == got
    assert _tree(tmp_path / 'port') == _tree(tmp_path / 'idx')


def test_cli_engine_host_is_not_ported(cli_tree, monkeypatch):
    """DN_ENGINE=host, once refused, is the per-record engine now:
    stdout, stderr (--counters) and the exit code equal bin/dn's under
    the same mode."""
    from dragnet_tpu import cli as jcli
    from dragnet_tpu_torch import cli as tcli
    monkeypatch.setenv('DRAGNET_CONFIG', str(cli_tree / 'rc'))
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_ENGINE', 'host')
    for args in CLI_CASES.values():
        ref = _run_cli(jcli.main, args)
        got = _run_cli(tcli.main, args)
        assert ref[0] == 0, ref[2]
        assert got == ref
        assert 'not yet ported' not in got[2]


def test_cli_usage_names_the_engine_modes():
    from dragnet_tpu_torch import cli as tcli
    for mode in ('auto', 'jax', 'vector', 'host', 'DN_ENGINE'):
        assert mode in tcli.USAGE_TEXT
