"""Device residency of the port (dragnet_tpu_torch/serve/residency.py)
and K7a (index_query_stack._sums_program / _device_sums).

The JAX package's residency suite (tests/test_residency.py) against the
port on the CPU; K7a against the JAX package's `_device_sums` on the
same seeded inputs, exactly, at several (rows, uniques) including both
pre-warm shapes; a stacked `dn query` with residency armed — its first
pass, its accumulator-hit repeat and its pinned-shard repeat after
drop_host_pins() — byte-equal to the JAX package's `dn query`; and a
pinned accumulator unchanged by a different query's fold.  The `cuda`
tests hold K7a on the card against its plain version, concurrent
served K1 scans against their serial answers, and device memory after
a server's drain against its level before it started.
"""

import contextlib
import io
import json
import os
import random
import threading

import numpy as np
import pytest
import torch

from dragnet_tpu import cli as jcli
from dragnet_tpu import index_query_stack as jiqs
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch import device_index as tdi
from dragnet_tpu_torch import index_query_mt as tiqmt
from dragnet_tpu_torch import index_query_stack as tiqs
from dragnet_tpu_torch.obs import metrics as obs_metrics
from dragnet_tpu_torch.serve import residency


@pytest.fixture(autouse=True)
def _isolated_singleton():
    """Every test starts and ends with no residency configured (the
    manager is process-global)."""
    residency.deconfigure()
    yield
    residency.deconfigure()


def _arrs(nbytes=64, fill=1.0):
    dev = np.full(nbytes // 8, fill)
    return dev, dev.copy()


# -- DeviceResidency unit mechanics (tests/test_residency.py) ----------------

def test_disabled_when_budget_zero():
    mgr = residency.DeviceResidency(0)
    assert not mgr.enabled()
    dev, host = _arrs()
    assert mgr.put('k', 1, dev, host, h2d_bytes=10) is False
    assert mgr.get('k', 1) is None
    st = mgr.stats()
    assert st['enabled'] is False
    assert st['hits'] == 0 and st['misses'] == 0


def test_pin_hit_books_saved_transfers():
    mgr = residency.DeviceResidency(1 << 20)
    dev, host = _arrs(64)
    assert mgr.put('k', 7, dev, host, h2d_bytes=1000)
    got = mgr.get('k', 7)
    assert got is host
    st = mgr.stats()
    assert st['hits'] == 1 and st['misses'] == 0
    assert st['entries'] == 1 and st['bytes'] == 64
    assert st['h2d_saved_bytes'] == 1000
    assert st['d2h_saved_bytes'] == 64
    assert st['hit_rate'] == 1.0


def test_miss_then_hit_rate():
    mgr = residency.DeviceResidency(1 << 20)
    assert mgr.get('absent', 1) is None
    dev, host = _arrs()
    mgr.put('k', 1, dev, host, h2d_bytes=0)
    assert mgr.get('k', 1) is host
    assert mgr.stats()['hit_rate'] == 0.5


def test_lru_eviction_under_budget():
    mgr = residency.DeviceResidency(160)     # fits two 64B entries
    for i in range(3):
        dev, host = _arrs(64, fill=i)
        mgr.put('k%d' % i, 1, dev, host, h2d_bytes=0)
    st = mgr.stats()
    assert st['entries'] == 2 and st['evictions'] == 1
    assert mgr.get('k0', 1) is None
    assert mgr.get('k2', 1) is not None


def test_hit_refreshes_lru_order():
    mgr = residency.DeviceResidency(160)
    d0, h0 = _arrs(64, 0)
    d1, h1 = _arrs(64, 1)
    mgr.put('k0', 1, d0, h0, h2d_bytes=0)
    mgr.put('k1', 1, d1, h1, h2d_bytes=0)
    assert mgr.get('k0', 1) is h0
    d2, h2 = _arrs(64, 2)
    mgr.put('k2', 1, d2, h2, h2d_bytes=0)    # evicts k1, not k0
    assert mgr.get('k0', 1) is h0
    assert mgr.get('k1', 1) is None


def test_oversize_pin_is_shed():
    mgr = residency.DeviceResidency(32)
    dev, host = _arrs(64)
    assert mgr.put('big', 1, dev, host, h2d_bytes=0) is False
    st = mgr.stats()
    assert st['shed'] == 1 and st['entries'] == 0


def test_epoch_invalidation_drops_stale_pin():
    mgr = residency.DeviceResidency(1 << 20)
    dev, host = _arrs()
    mgr.put('k', 1, dev, host, h2d_bytes=0)
    assert mgr.get('k', 2) is None
    st = mgr.stats()
    assert st['stale_drops'] == 1 and st['entries'] == 0
    mgr.put('k', 2, dev, host, h2d_bytes=0)
    assert mgr.get('k', 2) is host


def test_clear_releases_everything():
    mgr = residency.DeviceResidency(1 << 20)
    for i in range(4):
        dev, host = _arrs(64, i)
        mgr.put('k%d' % i, 1, dev, host, h2d_bytes=0)
    mgr.clear()
    st = mgr.stats()
    assert st['entries'] == 0 and st['bytes'] == 0


def test_content_key_separates_different_bytes():
    a = np.array([1, 2, 3], dtype=np.int64)
    b = np.array([1, 2, 4], dtype=np.int64)
    k1 = residency.content_key('iq', (a,), (8, 4, 3))
    k2 = residency.content_key('iq', (b,), (8, 4, 3))
    k3 = residency.content_key('iq', (a,), (8, 8, 3))
    assert k1 != k2 and k1 != k3
    assert k1 == residency.content_key('iq', (a.copy(),), (8, 4, 3))
    assert k1 != residency.content_key(
        'iq', (a.view(np.float64),), (8, 4, 3))


def test_content_key_equals_the_jax_package():
    """The key hashes the same host bytes as the JAX package's."""
    from dragnet_tpu.serve import residency as jresidency
    rng = np.random.RandomState(3)
    inv = rng.randint(0, 40, size=300).astype(np.int64)
    w = rng.randint(0, 9, size=300).astype(np.int64)
    for kind, shape in (('iq-acc', (64, 40)), ('iq-sums', (512, 64, 40))):
        assert residency.content_key(kind, (inv, w), shape) == \
            jresidency.content_key(kind, (inv, w), shape)


def test_singleton_configure_active_deconfigure():
    assert residency.active() is None
    assert residency.stats() == {'enabled': False}
    mgr = residency.configure(1 << 20)
    assert residency.active() is mgr
    assert residency.stats()['enabled'] is True
    residency.deconfigure()
    assert residency.active() is None


def test_zero_budget_configure_reports_but_disables():
    residency.configure(0)
    assert residency.active() is None
    st = residency.stats()
    assert st['enabled'] is False and st['budget_bytes'] == 0


def test_residency_gauges_flow_through_device_refresh():
    mgr = residency.configure(1 << 20)
    dev, host = _arrs(64)
    mgr.put('k', 1, dev, host, h2d_bytes=100)
    assert mgr.get('k', 1) is host
    reg = obs_metrics.Registry()
    obs_metrics.refresh_device_gauges({}, reg)
    gauges = {n: m.value for n, _lb, m in reg.snapshot()
              if m.kind == obs_metrics.GAUGE}
    assert gauges['device_residency_hit_rate'] == 1.0
    assert gauges['device_pinned_bytes'] == 64
    assert gauges['device_h2d_saved_bytes'] == 100
    assert gauges['device_d2h_saved_bytes'] == 64
    residency.deconfigure()
    reg2 = obs_metrics.Registry()
    obs_metrics.refresh_device_gauges({}, reg2)
    names = {n for n, _lb, m in reg2.snapshot()}
    assert 'device_residency_hit_rate' not in names


def test_shard_pins_are_capped_by_their_share():
    """put_device is bounded by DN_INDEX_RESIDENCY_SHARE of the budget,
    evicting older shard pins first; get_device hands back the pinned
    tensors themselves."""
    mgr = residency.DeviceResidency(1024, shard_share=0.25)   # 256 B
    pairs = [(torch.full((8,), i, dtype=torch.int64),
              torch.zeros(8, dtype=torch.int64)) for i in range(3)]
    for i, pair in enumerate(pairs):
        assert mgr.put_device(('s', i), 1, pair, nbytes=128)
    st = mgr.stats()
    assert st['shard_bytes'] == 256 and st['evictions'] == 1
    assert mgr.get_device(('s', 0), 1) is None
    assert mgr.get_device(('s', 2), 1) is pairs[2]
    assert mgr.put_device(('s', 9), 1, pairs[0], nbytes=512) is False
    assert mgr.get_device(('s', 2), 2) is None      # epoch moved on
    assert mgr.stats()['stale_drops'] == 1


# -- K7a against the JAX package ---------------------------------------------

def test_device_sums_pins_and_serves_repeats():
    residency.configure(64 << 20)
    seg = np.array([0, 1, 1, 2, 2, 2], dtype=np.int64)
    w = np.array([1, 2, 3, 4, 5, 6], dtype=np.int64)
    first = tiqs._device_sums(seg, w, 3, device='cpu')
    again = tiqs._device_sums(seg, w, 3, device='cpu')
    assert np.array_equal(first, again)
    assert again.dtype == np.float64
    st = residency.stats()
    assert st['hits'] == 1 and st['entries'] >= 1
    assert st['h2d_saved_bytes'] > 0 and st['d2h_saved_bytes'] > 0
    again[0] = 12345.0                       # a private copy
    third = tiqs._device_sums(seg, w, 3, device='cpu')
    assert np.array_equal(first, third)
    tiqmt.invalidate_index_tree('/nonexistent/tree')
    fourth = tiqs._device_sums(seg, w, 3, device='cpu')
    assert np.array_equal(first, fourth)
    assert residency.stats()['stale_drops'] >= 1


def test_device_sums_identical_with_and_without_residency():
    rng = np.random.RandomState(7)
    seg = rng.randint(0, 50, size=777).astype(np.int64)
    w = rng.randint(0, 1000, size=777).astype(np.int64)
    bare = tiqs._device_sums(seg, w, 50, device='cpu')
    residency.configure(64 << 20)
    pinned_miss = tiqs._device_sums(seg, w, 50, device='cpu')
    pinned_hit = tiqs._device_sums(seg, w, 50, device='cpu')
    assert np.array_equal(bare, pinned_miss)
    assert np.array_equal(bare, pinned_hit)
    host = np.bincount(seg, weights=w.astype(np.float64), minlength=50)
    assert np.array_equal(bare, host)


def test_prewarm_runs_and_reports():
    doc = residency.prewarm(shapes=((1 << 6, 1 << 4),), deadline_s=120,
                            device='cpu')
    assert doc['state'] == 'ok'
    assert doc['programs'] == 1
    assert doc['backend'] == 'torch/cpu'
    assert doc['ms'] >= 0
    assert 'auditions' in doc and 'audition_wins' in doc
    assert (1 << 6, 1 << 4) in tiqs._SUMS_CACHE


def test_prewarm_failure_is_reported_not_raised(monkeypatch):
    def broken(pn, pu):
        raise RuntimeError('planted prewarm fault')
    monkeypatch.setattr(tiqs, '_sums_program', broken)
    doc = residency.prewarm(deadline_s=30, device='cpu')
    assert doc['state'] == 'failed' and doc['programs'] == 0
    assert 'planted prewarm fault' in doc['error']


# (rows, uniques): tiny, the JAX package's test shape, both pre-warm
# shapes (1,024 x 256 and 16,384 x 1,024 once padded), a non-pow2 pair
# and the dense ceiling's neighbourhood
SUMS_SHAPES = [(6, 3), (777, 50), (1000, 200), (16000, 1000),
               (3001, 777), (20000, 4096)]


@pytest.mark.parametrize('n,nuniq', SUMS_SHAPES)
def test_device_sums_match_the_jax_package(monkeypatch, n, nuniq):
    monkeypatch.setenv('JAX_PLATFORMS', 'cpu')
    jiqs._reset_device_state()
    rng = np.random.RandomState(n)
    inv = np.sort(rng.randint(0, nuniq, size=n)).astype(np.int64)
    inv[:nuniq] = np.arange(nuniq)                 # every segment used
    w = rng.randint(-1000, 1 << 30, size=n).astype(np.int64)
    ref = jiqs._device_sums(inv, w, nuniq)
    if ref is None:
        pytest.skip('the JAX package\'s device lane is unavailable here')
    got = tiqs._device_sums(inv, w, nuniq, device='cpu')
    assert got.dtype == ref.dtype == np.float64
    assert np.array_equal(got, ref)
    assert tiqs._device_sums(inv[:0], w[:0], nuniq, device='cpu') is None


# -- a stacked query with residency armed ------------------------------------

METRICS = ('timestamp[date,field=time,aggr=lquantize,step=3600],host,'
           'latency[aggr=quantize]')


def _make_data(path, n=3000, seed=5):
    rng = random.Random(seed)
    with open(path, 'w') as f:
        for i in range(n):
            f.write(json.dumps({
                'host': 'host%d' % rng.randrange(12),
                'operation': 'op%d' % rng.randrange(6),
                'latency': rng.randrange(1, 1500),
                'time': '2014-05-%02dT%02d:10:0%d.000Z'
                        % (rng.randrange(1, 5), rng.randrange(24),
                           rng.randrange(10))}) + '\n')


def _run(main, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """An hour tree (96 shards) built by the JAX package; the port runs
    on the CPU device lane."""
    data = str(tmp_path / 'data.log')
    _make_data(data)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    for k in ('DN_INDEX_DEVICE', 'DN_IQ_STACK', 'DN_INDEX_FORMAT'):
        monkeypatch.delenv(k, raising=False)
    for args in (['datasource-add', '--path', data, '--index-path',
                  str(tmp_path / 'idx'), '--time-field', 'time', 'ds'],
                 ['metric-add', '-b', METRICS, 'ds', 'm'],
                 ['build', '--interval=hour', 'ds']):
        rc, out, err = _run(jcli.main, args)
        assert rc == 0, err
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_ENGINE', 'jax')
    tiqmt.shard_cache_clear()
    tdi._reset_engagement()
    yield
    tiqmt.shard_cache_clear()


QUERIES = [
    ['query', '--interval=hour', '--counters', '-b',
     'host,latency[aggr=quantize]'],
    ['query', '--interval=hour', '--points', '-b', 'host', '-f',
     '{"ge": ["latency", 700]}'],
]


@pytest.mark.parametrize('iq', range(len(QUERIES)))
def test_stacked_query_with_residency_equals_the_jax_package(tree, iq):
    args = QUERIES[iq] + ['ds']
    expected = _run(jcli.main, args)
    assert expected[0] == 0 and expected[1]
    residency.configure(64 << 20)
    first = _run(tcli.main, args)
    e1 = tdi.stats_doc()
    assert first == expected
    assert e1['dispatches'] > 0 and e1['pinned_shard_hits'] == 0
    assert e1['shards'] > 1
    hit = _run(tcli.main, args)
    e2 = tdi.stats_doc()
    assert hit == expected
    assert e2['dispatches'] == e1['dispatches']      # no fold
    st = residency.stats()
    assert st['hits'] >= 1 and st['d2h_saved_bytes'] > 0
    residency.active().drop_host_pins()
    pinned = _run(tcli.main, args)
    e3 = tdi.stats_doc()
    assert pinned == expected
    assert e3['dispatches'] - e2['dispatches'] == e1['dispatches']
    assert e3['pinned_shard_hits'] == e1['shards']
    assert e3['h2d_saved_bytes'] > 0
    # only the translation tables crossed on the pinned-shard repeat
    assert e3['h2d_bytes'] - e2['h2d_bytes'] < e1['h2d_bytes']


def test_pinned_accumulator_unchanged_by_another_fold(tree):
    """No pinned tensor is the target of a later in-place op: query A's
    pinned accumulator keeps its bytes through query B's fold, and A's
    repeat still equals the JAX package's answer."""
    residency.configure(64 << 20)
    a = QUERIES[0] + ['ds']
    b = QUERIES[1] + ['ds']
    first = _run(tcli.main, a)
    mgr = residency.active()
    accs = [ent['device'] for ent in mgr._entries.values()
            if ent.get('kind') != 'shard']
    assert len(accs) == 1
    before = accs[0].clone()
    assert _run(tcli.main, b)[0] == 0
    assert torch.equal(accs[0], before)
    assert _run(tcli.main, a) == first == _run(jcli.main, a)


def test_writer_epoch_retires_every_pin(tree):
    residency.configure(64 << 20)
    args = QUERIES[0] + ['ds']
    first = _run(tcli.main, args)
    assert residency.stats()['entries'] > 1
    tiqmt.invalidate_index_tree('/nonexistent/tree')    # any write
    again = _run(tcli.main, args)
    assert again == first
    st = residency.stats()
    assert st['stale_drops'] >= 1 and tdi.stats_doc()[
        'pinned_shard_hits'] == 0


# -- on the card --------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
@pytest.mark.parametrize('pn,pu', [(1 << 10, 1 << 8), (1 << 14, 1 << 10)])
def test_k7a_cuda_matches_plain(pn, pu):
    """K7a on the card at both pre-warm shapes against the plain numpy
    sums, exactly."""
    _need_cuda()
    rng = np.random.RandomState(pn)
    seg = rng.randint(0, pu, size=pn).astype(np.int64)
    w = rng.randint(-(1 << 40), 1 << 40, size=pn).astype(np.int64)
    out = tiqs._sums_program(pn, pu)(torch.from_numpy(seg).cuda(),
                                     torch.from_numpy(w).cuda())
    plain = np.zeros(pu, dtype=np.int64)
    np.add.at(plain, seg, w)
    assert np.array_equal(out.cpu().numpy(), plain)


@pytest.mark.cuda
def test_concurrent_served_k1_scans_cuda(tmp_path, monkeypatch):
    """Eight client threads scanning through the server on the card
    (DN_ENGINE=jax, a key space K1 takes; coalescing off, so every
    request executes): every answer equals the serial one, and K1
    launched for each of them on the server's worker threads."""
    _need_cuda()
    from dragnet_tpu_torch.ops import cuda_kernels as ck
    from dragnet_tpu_torch.serve import server as tserver
    data = str(tmp_path / 'data.log')
    _make_data(data, n=20000)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cuda')
    monkeypatch.setenv('DN_ENGINE', 'jax')
    assert _run(tcli.main, ['datasource-add', '--path', data,
                            '--time-field', 'time', 'ds'])[0] == 0
    case = ['scan', '-b', 'host,latency[aggr=quantize]', '--counters',
            'ds']
    serial = _run(tcli.main, case)
    assert serial[0] == 0
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock'),
                           conf={'max_inflight': 4,
                                 'coalesce': False}).start()
    results = []
    ck.reset_launches()
    try:
        def client():
            for _ in range(3):
                with tserver.thread_stdio() as cap:
                    rc = tcli.main(case[:1] + ['--remote',
                                               srv.socket_path] + case[1:])
                out, err = cap.finish()
                results.append((rc, out.decode(), err.decode()))
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        srv.stop()
    assert len(results) == 24 and all(r == serial for r in results)
    assert ck.launches['onehot_dense'] >= 24


@pytest.mark.cuda
def test_memory_returns_after_drain_cuda(tree, tmp_path, monkeypatch):
    """A residency-armed server's pins are dropped at drain: device
    memory falls back to within one query's accumulators of its level
    before the server started."""
    _need_cuda()
    from dragnet_tpu_torch.serve import client as tclient
    from dragnet_tpu_torch.serve import server as tserver
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cuda')
    monkeypatch.setenv('DN_DEVICE_RESIDENCY_MB', '256')
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    srv = tserver.DnServer(socket_path=str(tmp_path / 'dn.sock'),
                           conf={'max_inflight': 4}).start()
    try:
        req = {'op': 'query', 'ds': 'ds', 'interval': 'hour',
               'config': os.environ['DRAGNET_CONFIG'],
               'queryconfig': {'breakdowns': [{'name': 'host',
                                               'field': 'host'}]},
               'opts': {}}
        for _ in range(3):
            assert tclient.request_bytes(srv.socket_path, req)[0] == 0
        assert residency.stats()['bytes'] > 0
    finally:
        srv.stop()
    torch.cuda.synchronize()
    assert residency.active() is None
    assert torch.cuda.memory_allocated() - before <= 1 << 20
