"""The port's pipelined device dispatch on the CPU, held against the JAX
package: the staging ring, the in-flight window (DN_DEVICE_PIPELINE_DEPTH)
and the async flush prefetch (DN_PREFETCH, PREFETCH_PROGRESS) must leave
points, their emission order and the visible --counters equal to the JAX
package's host engine, for dense scans, sparse scans and the stacked
build, at depths 1, 2 and 4, with the prefetch on and off.  Also the
staging slots' capacity, the device knobs' validation
(config.device_config, the reference's contract, and the CLI's use of
it), a planted prefetch failure that must raise, and the ring's
layout.

On the CPU there are no streams or events: the ring packs and copies
synchronously and the completion tokens are None.  Tests marked `cuda`
run on the card: the ring under a busy compute stream, the streams K1
and the copies run on, and the overlap count."""

import json
import random

import numpy as np
import pytest
import torch

from dragnet_tpu import native as jnative
from dragnet_tpu import config as jconfig
from dragnet_tpu import query as jquery
from dragnet_tpu.datasource_file import DatasourceFile as JDatasourceFile

from dragnet_tpu_torch import config as tconfig
from dragnet_tpu_torch import datasource_file as tdf
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.obs import metrics as tmetrics
from dragnet_tpu_torch.vpipe import Pipeline

from helpers.scan_differential import scan_points_counters

DS_FILTER = {'ne': ['host', 'zzz']}
BATCH = 128
READ_SIZE = 8192
DENSE_Q = {'breakdowns': [{'name': 'host'},
                          {'name': 'latency', 'aggr': 'quantize'}]}
SPARSE_Q = {'breakdowns': [{'name': 'host'}, {'name': 'latency'}]}
EDGE_LINES = [
    # array value in a key field, non-integral latency: host batches
    '{"host":[1,"two"],"latency":3,"time":"2014-05-01T01:00:00Z"}',
    '{"host":"a","latency":2.5,"time":"2014-05-01T02:00:00Z"}',
]


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    if jnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_SCAN_THREADS', '0')
    for k in ('DN_DEVICE_PIPELINE_DEPTH', 'DN_PREFETCH'):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def registry(monkeypatch):
    """A fresh global metrics registry for the test."""
    monkeypatch.setattr(tmetrics, '_GLOBAL', tmetrics.Registry())
    return tmetrics._GLOBAL


def _lines(seed, n, edges=False):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = rng.choice(['a', 'b', 'c', 'host-%d' % rng.randrange(40)])
        out.append(json.dumps({
            'host': h,
            'latency': rng.choice([0, 1, 3, 17, 200, 4096, 123456]),
            'time': '2014-05-%02dT%02d:%02d:00Z' % (
                1 + i * 3 // n, rng.randrange(24), rng.randrange(60))}))
    if edges:
        # host batches AFTER the prefetch point
        for i, el in enumerate(EDGE_LINES):
            out.insert(n * 2 // 3 + i * 40, el)
    return out


def _write(tmp_path, lines):
    path = str(tmp_path / 'data.log')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def _jax_host(monkeypatch, datafile, qconf):
    return scan_points_counters(monkeypatch, datafile, qconf, 'vector',
                                batch=BATCH, read_size=READ_SIZE,
                                time_field='time', ds_filter=DS_FILTER)


def _port_scan(monkeypatch, datafile, qconf):
    """(points, visible counters, hidden aggregator counters) of the
    port's forced device scan on the CPU."""
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    monkeypatch.setenv('DN_READ_SIZE', str(READ_SIZE))
    ds = tdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': datafile, 'timeField': 'time'},
        'ds_filter': DS_FILTER, 'ds_format': 'json'})
    r = ds.scan(tquery.query_load(json.loads(json.dumps(qconf))),
                device='cpu', engine='device')
    counters = {(s.name, k): v for s in r.pipeline.stages
                for k, v in s.counters.items()
                if v and k not in s.hidden}
    aggr = [s for s in r.pipeline.stages if s.name == 'Aggregator'][0]
    return r.points, counters, {k: aggr.counters[k] for k in aggr.hidden}


def _spy(monkeypatch, name):
    """Record each call of DeviceScan.<name> (the pending epochs it saw
    for _drain_pending, whether an accumulator was live otherwise)."""
    seen = []
    orig = getattr(tds.DeviceScan, name)

    def spy(self):
        seen.append(len(self._pending_flush) if name == '_drain_pending'
                    else self._acc is not None)
        return orig(self)
    monkeypatch.setattr(tds.DeviceScan, name, spy)
    return seen


def _force_sparse(monkeypatch, max_dense=64):
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    from dragnet_tpu_torch import engine as tengine
    for mod in (jengine, jds, tengine, tds):
        monkeypatch.setattr(mod, 'MAX_DENSE_SEGMENTS', max_dense)


# -- scans: depth x prefetch, dense and sparse -------------------------------

@pytest.mark.parametrize('prefetch', ['1', '0'])
@pytest.mark.parametrize('depth', ['1', '2', '4'])
@pytest.mark.parametrize('mode', ['dense', 'sparse'])
def test_pipeline_scan_matches_jax_host(tmp_path, monkeypatch, registry,
                                        mode, depth, prefetch):
    """The prefetch fires mid-stream (PREFETCH_PROGRESS 0.01) and host
    batches follow it; every depth and both prefetch settings give the
    JAX package's host-engine points, order and counters."""
    monkeypatch.setenv('DN_DEVICE_PIPELINE_DEPTH', depth)
    monkeypatch.setenv('DN_PREFETCH', prefetch)
    monkeypatch.setattr(tds.DeviceScan, 'PREFETCH_PROGRESS', 0.01)
    if mode == 'dense':
        qconf = DENSE_Q
        monkeypatch.setattr(tds.DeviceScan, 'COMPACT_MIN_SEGMENTS', 1)
    else:
        qconf = SPARSE_Q
        _force_sparse(monkeypatch)
    fired = _spy(monkeypatch, '_prefetch_flush')
    drained = _spy(monkeypatch, '_drain_pending')
    datafile = _write(tmp_path, _lines(55, 900, edges=True))
    jpoints, jcounters = _jax_host(monkeypatch, datafile, qconf)
    points, counters, hidden = _port_scan(monkeypatch, datafile, qconf)
    assert points == jpoints
    assert counters == jcounters
    if prefetch == '1':
        assert fired and fired[0], 'the prefetch never fired'
        assert any(drained), 'no prefetched epoch drained'
    else:
        assert not fired and not any(drained)
    doc = tmetrics.pipeline_doc()
    assert doc['dispatches'] == hidden['ndevicebatches'] > 0
    assert doc['depth'] == int(depth)
    # on the CPU the tokens are None: overlap cannot be observed
    assert doc['overlapped'] == 0 and doc['h2d_overlapped_bytes'] == 0
    assert doc['h2d_bytes'] > 0 and doc['h2d_pinned_bytes'] == 0
    if mode == 'sparse':
        assert hidden['ncompactflush'] > 0


def test_prefetch_refetches_a_short_speculative_width(tmp_path,
                                                     monkeypatch):
    """More segments occurred than the prefetch's compacted width: the
    drain refetches wider from the kept accumulator."""
    monkeypatch.setattr(tds.DeviceScan, 'PREFETCH_PROGRESS', 0.01)
    monkeypatch.setattr(tds.DeviceScan, 'COMPACT_MIN_SEGMENTS', 1)
    monkeypatch.setattr(tds.DeviceScan, 'COMPACT_K', 8)
    refetched = []
    orig = tds._compact_fetch

    def spy(acc, k0):
        refetched.append(k0)
        return orig(acc, k0)
    monkeypatch.setattr(tds, '_compact_fetch', spy)
    datafile = _write(tmp_path, _lines(57, 900))
    jpoints, jcounters = _jax_host(monkeypatch, datafile, DENSE_Q)
    points, counters, _ = _port_scan(monkeypatch, datafile, DENSE_Q)
    assert points == jpoints and counters == jcounters
    assert refetched and max(refetched) > 8


def test_planted_prefetch_failure_raises(tmp_path, monkeypatch):
    """A prefetch whose device work fails is a fault of the device path:
    the scan raises, it never carries on with a synchronous flush."""
    def planted(acc, k):
        raise RuntimeError('planted compaction fault')
    monkeypatch.setattr(tds.DeviceScan, 'PREFETCH_PROGRESS', 0.01)
    monkeypatch.setattr(tds.DeviceScan, 'COMPACT_MIN_SEGMENTS', 1)
    monkeypatch.setattr(tds, '_compact_program', planted)
    datafile = _write(tmp_path, _lines(58, 600))
    with pytest.raises(DNError, match='device flush prefetch failed: '
                                      'planted compaction fault'):
        _port_scan(monkeypatch, datafile, DENSE_Q)


# -- the stacked build --------------------------------------------------------

BUILD_METRICS = [
    # one metric per fold route: kernel, index_add_, sparse
    {'name': 'byhost', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 86400},
        {'name': 'host', 'field': 'host'}]},
    {'name': 'bylat', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 86400},
        {'name': 'host', 'field': 'host'},
        {'name': 'latency', 'field': 'latency', 'aggr': 'lquantize',
         'step': 50}]},
    {'name': 'byminute', 'breakdowns': [
        {'name': 'timestamp', 'field': 'time', 'date': '',
         'aggr': 'lquantize', 'step': 60},
        {'name': 'host', 'field': 'host'},
        {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]},
]


def _tree(root):
    import os
    from dragnet_tpu_torch import index_journal as tjournal
    out = {}
    for dirpath, dirs, files in os.walk(str(root)):
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


def _dsconfig(datafile, indexdir):
    return {'ds_backend': 'file',
            'ds_backend_config': {'path': datafile,
                                  'indexPath': str(indexdir),
                                  'timeField': 'time'},
            'ds_filter': None, 'ds_format': 'json'}


@pytest.mark.parametrize('depth', ['1', '2', '4'])
def test_pipeline_stacked_build_matches_jax(tmp_path, monkeypatch, registry,
                                            depth):
    """The stacked build with the prefetch fired in every metric: one
    staged upload and one token per stacked batch, and the index tree
    byte-identical to the JAX package's host build."""
    from dragnet_tpu import engine as jengine
    from dragnet_tpu import device_scan as jds
    _force_sparse(monkeypatch, 1 << 16)
    monkeypatch.setenv('DN_DEVICE_PIPELINE_DEPTH', depth)
    monkeypatch.setattr(tds.DeviceScan, 'PREFETCH_PROGRESS', 0.01)
    monkeypatch.setattr(tds.DeviceScan, 'COMPACT_MIN_SEGMENTS', 1)
    fired = _spy(monkeypatch, '_prefetch_flush')
    datafile = _write(tmp_path, _lines(59, 1200))
    monkeypatch.setenv('DN_READ_SIZE', str(BATCH * 64))
    monkeypatch.setenv('DN_ENGINE', 'vector')
    monkeypatch.setattr(jengine, 'BATCH_SIZE', BATCH)
    monkeypatch.setattr(jds, 'BATCH_SIZE', BATCH)
    JDatasourceFile(_dsconfig(datafile, tmp_path / 'j')).build(
        [jquery.metric_deserialize(m) for m in BUILD_METRICS], 'day')
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    r = tdf.DatasourceFile(_dsconfig(datafile, tmp_path / 't')).build(
        [tquery.metric_deserialize(m) for m in BUILD_METRICS], 'day',
        device='cpu', engine='device')
    assert _tree(tmp_path / 't') == _tree(tmp_path / 'j')
    stacked = sum(s.counters.get('nstackedbatches', 0)
                  for s in r.pipeline.stages)
    assert stacked and len(fired) == len(BUILD_METRICS) and all(fired)
    assert tmetrics.pipeline_doc()['dispatches'] == \
        stacked // len(BUILD_METRICS)


# -- the staging slots' capacity --------------------------------------------

@pytest.mark.parametrize('cap0', [64, 128, 4096])
def test_slot_capacity_from_batch_rows(tmp_path, monkeypatch, registry,
                                       cap0):
    """A slot's first capacity is the engine's BATCH_SIZE in rows,
    doubled until a batch fits (128-row batches here); only the batch's
    own bytes cross, never padding; the output is unchanged."""
    from dragnet_tpu_torch import engine as tengine
    monkeypatch.setattr(tengine, 'BATCH_SIZE', cap0)
    staged = []
    orig = tds._StagingRing.stage

    def spy(self, inputs, first, compute):
        rv = orig(self, inputs, first, compute)
        arrs = [v for v in inputs.values() if isinstance(v, np.ndarray)]
        cap = first
        while cap < max(v.size for v in arrs):
            cap <<= 1
        need = sum(tds._align(v.itemsize * cap) for v in arrs)
        staged.append((rv[2], need, sum(v.nbytes for v in arrs), first))
        return rv
    monkeypatch.setattr(tds._StagingRing, 'stage', spy)
    datafile = _write(tmp_path, _lines(60, 400))
    jpoints, jcounters = _jax_host(monkeypatch, datafile, DENSE_Q)
    points, counters, _ = _port_scan(monkeypatch, datafile, DENSE_Q)
    assert points == jpoints and counters == jcounters
    assert staged and all(st[3] == cap0 for st in staged)
    # slots only grow: each holds the largest batch it was given
    for slot in set(st[0] for st in staged):
        assert slot.nbytes == max(st[1] for st in staged if st[0] is slot)
    assert tmetrics.pipeline_doc()['h2d_bytes'] == \
        sum(st[2] for st in staged)


# -- the ring and the window, directly ---------------------------------------

def test_staging_ring_layout_and_rotation():
    """Every per-record array crosses at a 256-byte-aligned offset of one
    slot and comes back as a typed view equal to it; tables pass
    through; slots rotate, so a batch's views survive the next
    nslots - 1 batches; a batch past the capacity regrows the slot."""
    ring = tds._StagingRing(torch.device('cpu'), 3)
    table = torch.arange(5)
    rng = np.random.default_rng(3)
    kept = []
    for b in range(7):
        n = 100 + 37 * b
        inputs = {'alive': rng.random(n) < 0.5,
                  'tags': rng.integers(0, 9, n).astype(np.uint8),
                  'kv': rng.integers(-300, 300, n).astype(np.int16),
                  'w': rng.integers(-5, 5, n).astype(np.int32),
                  'tab': table}
        args, nbytes, slot = ring.stage(inputs, 256 if b < 5 else 1024,
                                        None)
        assert ring.release(slot, None) is None
        assert nbytes == sum(v.nbytes for v in inputs.values()
                             if isinstance(v, np.ndarray))
        assert args['tab'] is table
        for k, v in inputs.items():
            if isinstance(v, np.ndarray):
                t = args[k]
                assert t.numpy().dtype == v.dtype
                assert (t.numpy() == v).all()
                assert (t.storage_offset() * t.element_size()) % 256 == 0
        kept.append((args, inputs))
        if len(kept) > 3:
            kept.pop(0)
        for a, i in kept:      # the last nslots batches stay intact
            assert all((a[k].numpy() == v).all() for k, v in i.items()
                       if isinstance(v, np.ndarray))
    assert ring.slots[ring.next - 1].nbytes >= 1024 * 8


class _Token(object):
    """A completion token whose readiness the test sets."""

    def __init__(self, ready):
        self.ready = ready
        self.waited = False

    def query(self):
        return self.ready

    def synchronize(self):
        self.waited = True


@pytest.mark.parametrize('depth', [1, 2, 4])
def test_note_dispatch_window(monkeypatch, registry, depth):
    """_note_dispatch counts every dispatch, an overlap only when the
    previous token was still running, never one for a None token, and
    blocks on exactly the token `depth` dispatches back."""
    monkeypatch.setenv('DN_DEVICE_PIPELINE_DEPTH', str(depth))
    s = tds.DeviceScan(tquery.query_load(dict(DENSE_Q)), 'time',
                       Pipeline(), device='cpu')
    toks = [_Token(ready=(i % 3 != 0)) for i in range(10)]
    for i, t in enumerate(toks):
        s._note_dispatch(t, 100)
        assert len(s._pipe) == min(i + 1, depth)
    s._note_dispatch(None, 7)
    doc = tmetrics.pipeline_doc()
    assert doc['dispatches'] == 11 and doc['depth'] == depth
    # each dispatch after the first finds the previous token: toks[0],
    # [3], [6] and [9] were still running
    assert doc['overlapped'] == 4
    assert doc['h2d_overlapped_bytes'] == 307
    assert [t.waited for t in toks] == \
        [i < 11 - depth for i in range(10)]


def test_pipeline_depth_env(monkeypatch):
    for raw, want in (('', 2), ('1', 1), ('4', 4), ('0', 1), ('x', 2)):
        monkeypatch.setenv('DN_DEVICE_PIPELINE_DEPTH', raw)
        assert tds.pipeline_depth() == want


# -- the knobs' validation (the reference's device_config contract) ----------

def _reference_subset(conf, env):
    """The JAX package's device_config on the same env, restricted to the
    knobs the port reads."""
    jconf = jconfig.device_config(env=env)
    return {k: jconf[k] for k in conf}


def test_device_config_defaults():
    conf = tconfig.device_config(env={})
    assert conf == {'residency_mb': 0, 'prewarm': True,
                    'probe_timeout_s': 420, 'audition_ttl_s': 86400,
                    'pipeline_depth': 2, 'scan_partitions': 'auto'}
    assert conf == _reference_subset(conf, {})


def test_device_config_parses_overrides():
    env = {'DN_DEVICE_PIPELINE_DEPTH': '4',
           'DN_DEVICE_PROBE_TIMEOUT': '30',
           'DN_SCAN_PARTITIONS': '16'}
    conf = tconfig.device_config(env=env)
    assert conf['pipeline_depth'] == 4
    assert conf['probe_timeout_s'] == 30
    assert conf['scan_partitions'] == 16
    assert conf == _reference_subset(conf, env)
    assert tconfig.device_config(
        env={'DN_SCAN_PARTITIONS': 'auto'})['scan_partitions'] == 'auto'


def test_device_config_rejects_bad_values():
    for env in ({'DN_DEVICE_PIPELINE_DEPTH': '0'},
                {'DN_DEVICE_PIPELINE_DEPTH': 'deep'},
                {'DN_DEVICE_PROBE_TIMEOUT': '0'},
                {'DN_AUDITION_TTL_S': '-1'},
                {'DN_SCAN_PARTITIONS': '0'},
                {'DN_SCAN_PARTITIONS': 'some'}):
        err = tconfig.device_config(env=env)
        assert isinstance(err, DNError), env
        assert str(err).startswith(list(env)[0]), env
        assert str(err) == str(jconfig.device_config(env=env))


@pytest.mark.parametrize('depth,rc', [('deep', 1), ('0', 1), ('3', 0)])
def test_cli_validates_the_device_knobs(tmp_path, monkeypatch, capsys,
                                        depth, rc):
    """The port's CLI checks the device knobs before a scan reaches the
    device: a malformed DN_DEVICE_PIPELINE_DEPTH fails the command with
    device_config's message instead of reading as the default."""
    from dragnet_tpu_torch import cli as tcli
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'dragnetrc'))
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_ENGINE', 'jax')
    datafile = _write(tmp_path, _lines(63, 50))
    assert tcli.main(['datasource-add', 'ds', '--path=' + datafile,
                      '--time-field=time']) == 0
    capsys.readouterr()
    assert tcli.main(['scan', '-b', 'host', 'ds']) == 0
    default_out = capsys.readouterr()[0]
    monkeypatch.setenv('DN_DEVICE_PIPELINE_DEPTH', depth)
    assert tcli.main(['scan', '-b', 'host', 'ds']) == rc
    out, err = capsys.readouterr()
    if rc:
        assert str(tconfig.device_config()) in err and not out
    else:
        assert out == default_out and 'VALUE' in out


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _busy(stream, mcycles):
    """Keep `stream` busy for `mcycles` million clock cycles."""
    with torch.cuda.stream(stream):
        torch.cuda._sleep(int(mcycles * 1.0e6))


@pytest.mark.cuda
def test_ring_never_overwrites_in_flight_cuda(cuda):
    """Depth 4, the smallest floor, 64 batches staged while the compute
    stream is held busy before each batch's reads: every batch's sum, taken on
    the compute stream from the ring's views, equals numpy's."""
    compute = torch.cuda.Stream(cuda)
    ring = tds._StagingRing(cuda, 5)
    rng = np.random.default_rng(11)
    sums, want = [], []
    with torch.cuda.stream(compute):
        for b in range(64):
            n = int(rng.integers(1000, 9000))
            a = rng.integers(-1000, 1000, n).astype(np.int32)
            c = rng.integers(0, 255, n).astype(np.uint8)
            args, _, slot = ring.stage({'a': a, 'c': c}, 4096, compute)
            _busy(compute, 1.0)
            sums.append(args['a'].to(torch.int64).sum() +
                        args['c'].to(torch.int64).sum())
            ring.release(slot, compute)
            want.append(int(a.astype(np.int64).sum() +
                            c.astype(np.int64).sum()))
    compute.synchronize()
    assert [int(s) for s in sums] == want
    assert all(s.host.is_pinned() for s in ring.slots)


@pytest.mark.cuda
def test_streams_of_the_dispatch_cuda(cuda, tmp_path, monkeypatch, registry):
    """A forced scan driven from a side stream: K1 launches on that
    stream (the scan's compute stream), the staging copies on the ring's
    own copy stream; the output equals the CPU path's; every per-record
    byte crossed from page-locked memory."""
    from dragnet_tpu_torch.ops import cuda_kernels
    handles = []
    orig = cuda_kernels.current_stream_handle

    def spy(index):
        h = orig(index)
        handles.append(h)
        return h
    monkeypatch.setattr(cuda_kernels, 'current_stream_handle', spy)
    scans = []
    orig_up = tds.DeviceScan._upload_inputs

    def up(self, inputs):
        scans.append(self)
        return orig_up(self, inputs)
    monkeypatch.setattr(tds.DeviceScan, '_upload_inputs', up)
    datafile = _write(tmp_path, _lines(61, 2000))
    cpu = _port_scan(monkeypatch, datafile, DENSE_Q)
    side = torch.cuda.Stream(cuda)
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cuda')
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    ds = tdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': datafile, 'timeField': 'time'},
        'ds_filter': DS_FILTER, 'ds_format': 'json'})
    del scans[:]
    before = tmetrics.pipeline_doc()
    with torch.cuda.stream(side):
        r = ds.scan(tquery.query_load(dict(DENSE_Q)), device='cuda',
                    engine='device')
    torch.cuda.synchronize()
    assert r.points == cpu[0]
    s = scans[-1]
    assert handles and set(handles) == {side.cuda_stream}
    assert s._compute.cuda_stream == side.cuda_stream
    assert s._ring.copy_stream.cuda_stream not in (side.cuda_stream, 0)
    doc = tmetrics.pipeline_doc()
    assert doc['h2d_bytes'] - before['h2d_bytes'] == \
        doc['h2d_pinned_bytes'] - before['h2d_pinned_bytes'] > 0


@pytest.mark.cuda
def test_note_dispatch_counts_overlap_cuda(cuda, tmp_path, monkeypatch,
                                           registry):
    """With the device the slower side (each fold followed by 50M clock
    cycles, ~25 ms, of device work on the compute stream), the next
    dispatch finds the previous token running: overlapped dispatches
    are counted, and the output is unchanged."""
    monkeypatch.setenv('DN_DEVICE_PIPELINE_DEPTH', '2')
    orig = tds.DeviceScan._fold_staged

    def slow(self, staged, args):
        rv = orig(self, staged, args)
        _busy(self._compute, 50.0)
        return rv
    monkeypatch.setattr(tds.DeviceScan, '_fold_staged', slow)
    datafile = _write(tmp_path, _lines(62, 2000))
    monkeypatch.setattr(tdf, 'BATCH_SIZE', BATCH)
    monkeypatch.setenv('DN_READ_SIZE', str(READ_SIZE))
    ds = tdf.DatasourceFile({
        'ds_backend': 'file',
        'ds_backend_config': {'path': datafile, 'timeField': 'time'},
        'ds_filter': DS_FILTER, 'ds_format': 'json'})
    r = ds.scan(tquery.query_load(dict(DENSE_Q)), device='cuda',
                engine='device')
    torch.cuda.synchronize()
    jpoints, _ = _jax_host(monkeypatch, datafile, DENSE_Q)
    assert r.points == jpoints
    doc = tmetrics.pipeline_doc()
    assert doc['dispatches'] > 2 and doc['overlapped'] > 0
