"""The port's `dn query` (dragnet_tpu_torch, device='cpu') against the
JAX package's on the same index trees, built by the JAX package: points
and counters (visible and hidden) exact, with no tolerance, for the
JAX package's forced device lane (DN_ENGINE=jax, DN_INDEX_DEVICE=1 on
XLA:CPU) and its host bincount (DN_INDEX_DEVICE=0), over index formats
x intervals x the predicate shapes of tests/test_device_index.py; the
slot-packed fold (device_index, K7) against numpy and the JAX package;
the structural host routes, the per-shard fall-backs, the rollup
planner, verified reads; and `python -m dragnet_tpu_torch query`
against bin/dn's entry point."""

import contextlib
import io
import json
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dragnet_tpu import device_index as jdi
from dragnet_tpu import index_query_mt as jiqmt
from dragnet_tpu import integrity as jintegrity
from dragnet_tpu import query as jquery
from dragnet_tpu import rollup as jrollup
from dragnet_tpu.datasource_file import DatasourceFile as JDatasourceFile
from dragnet_tpu.engine import MAX_DENSE_SEGMENTS
from dragnet_tpu.serve import residency as jresidency
from dragnet_tpu_torch import device_index as tdi
from dragnet_tpu_torch import index_query_mt as tiqmt
from dragnet_tpu_torch import integrity as tintegrity
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch.datasource_file import DatasourceFile as TDatasourceFile
from dragnet_tpu_torch.errors import DNError as TDNError

NDAYS = 8

METRIC = {'name': 'm', 'breakdowns': [
    {'name': 'ts', 'field': 'time', 'date': '', 'aggr': 'lquantize',
     'step': 86400},
    {'name': 'host', 'field': 'host'},
    {'name': 'operation', 'field': 'operation'},
    {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]}

# the predicate shapes of tests/test_device_index.py (FUZZ_QUERIES)
FUZZ_QUERIES = [
    {'breakdowns': [{'name': 'host'},
                    {'name': 'latency', 'aggr': 'quantize'}]},
    {'breakdowns': [{'name': 'host'}, {'name': 'operation'}],
     'filter': {'eq': ['operation', 'op3']}},
    {'breakdowns': [{'name': 'latency', 'aggr': 'lquantize',
                     'step': 32}]},
    {'breakdowns': []},                        # bare SUM
    {'breakdowns': [],                         # NULL SUM -> 0
     'filter': {'eq': ['host', 'no-such-host']}},
    {'breakdowns': [{'name': 'host'}],         # window + zero shards
     'filter': {'eq': ['host', 'host7']},
     'timeAfter': '2014-05-02', 'timeBefore': '2014-05-07'},
    {'breakdowns': [{'name': 'host'},          # empty WITH breakdowns
                    {'name': 'operation'}],
     'filter': {'eq': ['host', 'no-such-host']}},
]


def _make_data(path, n=4000, nhosts=30, seed=99):
    rng = random.Random(seed)
    with open(path, 'w') as f:
        for i in range(n):
            f.write(json.dumps({
                'host': 'host%d' % rng.randrange(nhosts),
                'operation': 'op%d' % rng.randrange(8),
                'latency': rng.randrange(1, 1500),
                'time': '2014-05-%02dT%02d:10:0%d.000Z'
                        % (rng.randrange(1, NDAYS + 1),
                           rng.randrange(24), rng.randrange(10)),
            }, separators=(',', ':')) + '\n')


def _dsconfig(datafile, idx):
    return {'ds_backend': 'file',
            'ds_backend_config': {'path': str(datafile),
                                  'timeField': 'time',
                                  'indexPath': str(idx)},
            'ds_filter': None, 'ds_format': 'json'}


def _built(tmp_path, interval, n=4000, name='idx', seed=99):
    """An index tree built by the JAX package, and the two packages'
    datasources over it."""
    datafile = tmp_path / ('%s.log' % name)
    idx = tmp_path / name
    _make_data(str(datafile), n=n, seed=seed)
    jds = JDatasourceFile(_dsconfig(datafile, idx))
    jds.build([jquery.metric_deserialize(METRIC)], interval)
    return jds, TDatasourceFile(_dsconfig(datafile, idx)), str(idx)


def _counters(result):
    """Every stage's counters, hidden ones included."""
    return [(s.name, dict(s.counters)) for s in result.pipeline.stages]


def _visible(result):
    return [(s.name, {c: v for c, v in s.counters.items()
                      if c not in s.hidden})
            for s in result.pipeline.stages]


def _jax_query(jds, interval, conf, monkeypatch, device):
    """The JAX package's query on its forced device lane (device=True:
    DN_ENGINE=jax, DN_INDEX_DEVICE=1) or its host bincount."""
    if device:
        monkeypatch.setenv('DN_ENGINE', 'jax')
        monkeypatch.setenv('DN_INDEX_DEVICE', '1')
    else:
        monkeypatch.delenv('DN_ENGINE', raising=False)
        monkeypatch.setenv('DN_INDEX_DEVICE', '0')
    try:
        return jds.query(jquery.query_load(dict(conf)), interval)
    finally:
        monkeypatch.delenv('DN_ENGINE', raising=False)
        monkeypatch.delenv('DN_INDEX_DEVICE', raising=False)


def _port_query(tds, interval, conf, engine='device'):
    q = tquery.query_load(dict(conf))
    assert not isinstance(q, TDNError), q
    return tds.query(q, interval, device='cpu', engine=engine)


def _need_jax_lane():
    if jdi._DEVICE_STATE['ready'] is False:
        pytest.skip('the JAX package\'s device lane is unavailable here')


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Cold shard caches, zeroed engagement and the default routing in
    both packages for every test."""
    for k in ('DN_ENGINE', 'DN_INDEX_DEVICE', 'DN_INDEX_DEVICE_BATCH_ROWS',
              'DN_IQ_STACK', 'DN_IQ_THREADS', 'DN_VERIFY',
              'DN_INDEX_FORMAT', 'DN_TORCH_DEVICE'):
        monkeypatch.delenv(k, raising=False)

    def reset():
        jiqmt.shard_cache_clear()
        tiqmt.shard_cache_clear()
        jdi._reset_device_state()
        jdi._reset_engagement()
        tdi._reset_engagement()
        jintegrity.reset_memo()
        tintegrity.reset_memo()
        jresidency.deconfigure()
    reset()
    yield
    reset()


# -- the differential grid ----------------------------------------------------

@pytest.mark.parametrize('index_format', ['dnc', 'sqlite'])
@pytest.mark.parametrize('interval', ['hour', 'day', 'all'])
def test_port_query_grid_matches_jax_package(tmp_path, monkeypatch,
                                             index_format, interval):
    """Format x interval x predicate shape: the port's device lane and
    host engine against the JAX package's forced device lane and host
    bincount — points, every counter (hidden ones too) and the fold's
    dispatch count exact."""
    monkeypatch.setenv('DN_INDEX_FORMAT', index_format)
    jds, tds, _ = _built(tmp_path, interval)
    engaged = 0
    for conf in FUZZ_QUERIES:
        ref = _jax_query(jds, interval, conf, monkeypatch, False)
        j0 = jdi.stats_doc()['dispatches']
        jdev = _jax_query(jds, interval, conf, monkeypatch, True)
        _need_jax_lane()
        t0 = tdi.stats_doc()['dispatches']
        got = _port_query(tds, interval, conf)
        host = _port_query(tds, interval, conf, engine='vector')
        assert got.points == jdev.points == ref.points == host.points, \
            conf
        assert _counters(got) == _counters(jdev), conf
        assert _counters(host) == _counters(ref), conf
        assert _visible(got) == _visible(ref), conf
        jd = jdi.stats_doc()['dispatches'] - j0
        td = tdi.stats_doc()['dispatches'] - t0
        assert td == jd, conf
        engaged += td
    assert engaged > 0


def test_port_query_routes(tmp_path, monkeypatch):
    """The engagement snapshot names the route each query took: the
    device lane, the bare query's host route, DN_INDEX_DEVICE=0, the
    host engine, the empty result, and the per-shard fall-backs."""
    jds, tds, _ = _built(tmp_path, 'day')

    def route(conf, engine='device'):
        _port_query(tds, 'day', conf, engine=engine)
        return tdi.stats_doc()['last_route']

    assert route(FUZZ_QUERIES[0]) == 'device'
    assert tdi.stats_doc()['last_lane'] == 'device'
    assert route(FUZZ_QUERIES[3]) == 'host: no breakdowns'
    assert route(FUZZ_QUERIES[6]) == 'empty result'
    assert route(FUZZ_QUERIES[0], engine='vector') == 'host: host engine'
    monkeypatch.setenv('DN_INDEX_DEVICE', '0')
    assert route(FUZZ_QUERIES[0]) == 'host: DN_INDEX_DEVICE=0'
    assert tdi.stats_doc()['last_lane'] == 'host'
    monkeypatch.delenv('DN_INDEX_DEVICE')
    monkeypatch.setenv('DN_IQ_STACK', '0')
    assert route(FUZZ_QUERIES[0]) == 'per-shard: DN_IQ_STACK=0'
    monkeypatch.delenv('DN_IQ_STACK')
    aliased = {'breakdowns': [{'name': 'host', 'field': 'operation'}]}
    ref = _jax_query(jds, 'day', aliased, monkeypatch, True)
    got = _port_query(tds, 'day', aliased)
    assert got.points == ref.points
    assert tdi.stats_doc()['last_route'] == \
        'per-shard: breakdown not stack-eligible'
    routes = tdi.stats_doc()['routes']
    assert routes['device'] == 1 and sum(routes.values()) == 7


# -- aggregate_weights and the fold -------------------------------------------

def _seam_inputs(nuniq, seed=11):
    rng = np.random.RandomState(seed)
    n = max(nuniq * 3, 512)
    inv = rng.randint(0, nuniq, size=n).astype(np.int64)
    # every segment id present: inv from _unique_rows is surjective
    inv[:nuniq] = np.arange(nuniq)
    w = rng.randint(0, 1000, size=n).astype(np.int64)
    sid = np.sort(rng.randint(0, 37, size=n).astype(np.int64))
    return inv, w, (sid, [(None, None)] * 37, None)


@pytest.mark.parametrize('nuniq', [8, 1000, 50000])
def test_port_aggregate_weights_matches_bincount_and_jax(monkeypatch,
                                                         nuniq):
    inv, w, ctx = _seam_inputs(nuniq)
    monkeypatch.setenv('DN_INDEX_DEVICE', '1')
    ref = np.bincount(inv, weights=w, minlength=nuniq)
    jgot = jdi.aggregate_weights(inv, w, nuniq, shard_ctx=ctx)
    _need_jax_lane()
    got = tdi.aggregate_weights(inv, w, nuniq, shard_ctx=ctx,
                                device='cpu')
    assert got.dtype == ref.dtype == np.float64
    assert np.array_equal(got, ref) and np.array_equal(got, jgot)
    assert tdi.stats_doc()['last_route'] == 'device'
    assert tdi.stats_doc()['dispatches'] == jdi.stats_doc()['dispatches']
    assert tdi.stats_doc()['h2d_bytes'] == jdi.stats_doc()['h2d_bytes']


def test_port_aggregate_weights_structural_host_routes():
    """Past the dense ceiling, and with no rows, the device lane
    refuses and the host bincount answers, as in the JAX package."""
    nuniq = MAX_DENSE_SEGMENTS + 1
    inv = np.arange(nuniq, dtype=np.int64)
    w = np.ones(nuniq, dtype=np.int64)
    got = tdi.aggregate_weights(inv, w, nuniq, device='cpu')
    assert np.array_equal(got, np.ones(nuniq))
    assert tdi.stats_doc()['last_route'] == \
        'host: segments past the dense ceiling'
    assert tdi.stats_doc()['dispatches'] == 0
    del inv, w, got
    empty = np.zeros(0, dtype=np.int64)
    got = tdi.aggregate_weights(empty, empty, 0, device='cpu')
    assert len(got) == 0
    assert tdi.stats_doc()['last_route'] == 'host: no rows'
    assert tdi.stats_doc()['last_lane'] == 'host'


def test_port_small_batch_rows_dispatch_count(tmp_path, monkeypatch):
    """A small DN_INDEX_DEVICE_BATCH_ROWS splits the slot packing into
    more dispatches: the same count as the JAX package's under either
    budget, and the same points."""
    jds, tds, _ = _built(tmp_path, 'day', n=40000)
    conf = FUZZ_QUERIES[0]
    counts = []
    for budget in ('4096', None):
        if budget is not None:
            monkeypatch.setenv('DN_INDEX_DEVICE_BATCH_ROWS', budget)
        else:
            monkeypatch.delenv('DN_INDEX_DEVICE_BATCH_ROWS')
        j0 = jdi.stats_doc()['dispatches']
        t0 = tdi.stats_doc()['dispatches']
        jdev = _jax_query(jds, 'day', conf, monkeypatch, True)
        _need_jax_lane()
        got = _port_query(tds, 'day', conf)
        assert got.points == jdev.points
        assert _counters(got) == _counters(jdev)
        nd = tdi.stats_doc()['dispatches'] - t0
        assert nd == jdi.stats_doc()['dispatches'] - j0
        counts.append(nd)
    assert counts[0] > counts[1] >= 1, counts


def test_port_fold_indices_stay_in_range(tmp_path, monkeypatch):
    """Padding keeps every index of every dispatch in range: local
    codes below the translation row's width, global ids below the
    accumulator's length (torch raises or asserts where JAX drops)."""
    jds, tds, _ = _built(tmp_path, 'hour')
    seen = []
    orig = tdi._fold_program

    def fold(lmat, wmat, ttabs, acc):
        seen.append((int(lmat.min()), int(lmat.max()), ttabs.shape[1],
                     int(ttabs.min()), int(ttabs.max()), acc.shape[0]))
        assert lmat.shape == wmat.shape and lmat.dtype == torch.int64
        return orig(lmat, wmat, ttabs, acc)
    monkeypatch.setattr(tdi, '_fold_program', fold)
    for conf in FUZZ_QUERIES[:3]:
        _port_query(tds, 'hour', conf)
    assert seen
    for lmin, lmax, ptab, tmin, tmax, pu in seen:
        assert 0 <= lmin and lmax < ptab
        assert 0 <= tmin and tmax < pu


def _fold_case(seed=3):
    """Three slots of a pu=16 accumulator, with pad ids at the edges:
    a slot using every local code up to ptab - 2 (its pad code
    ptab - 1 maps to pu - 1), a slot whose ttable names segment 0 and
    pu - 1, and an all-pad slot."""
    rng = np.random.RandomState(seed)
    pu, prow, ptab = 16, 8, 8
    ttabs = np.full((3, ptab), pu - 1, dtype=np.int64)
    lmat = np.empty((3, prow), dtype=np.int64)
    wmat = np.zeros((3, prow), dtype=np.int64)
    ttabs[0, :7] = [3, 0, 9, 14, 15, 1, 2]
    lmat[0] = [0, 1, 2, 3, 4, 5, 6, 6]
    wmat[0] = rng.randint(-50, 50, size=prow)
    ttabs[1, :2] = [15, 0]
    lmat[1] = [1, 0, 1, 2, 2, 2, 2, 2]      # nlocal = 2 pads
    wmat[1, :3] = [7, -3, 11]
    lmat[2] = 0                               # nlocal = 0: all pad
    acc0 = rng.randint(-5, 5, size=pu).astype(np.int64)
    ref = acc0.copy()
    np.add.at(ref, np.take_along_axis(ttabs, lmat, axis=1).reshape(-1),
              wmat.reshape(-1))
    return lmat, wmat, ttabs, acc0, ref


def test_port_fold_program_matches_numpy():
    lmat, wmat, ttabs, acc0, ref = _fold_case()
    acc = torch.from_numpy(acc0.copy())
    out = tdi._fold_program(torch.from_numpy(lmat),
                            torch.from_numpy(wmat),
                            torch.from_numpy(ttabs), acc)
    assert out is acc
    assert np.array_equal(acc.numpy(), ref)


@pytest.mark.cuda
def test_port_fold_program_cuda_matches_cpu():
    """K7 on the card against the CPU, on the padded case and at a
    main-path shape (64 slots of 4,096 rows into 65,536 segments)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.RandomState(5)
    cases = [_fold_case()[:4]]
    s, prow, ptab, pu = 64, 4096, 4096, 1 << 16
    lmat = rng.randint(0, ptab, size=(s, prow)).astype(np.int64)
    ttabs = rng.randint(0, pu, size=(s, ptab)).astype(np.int64)
    wmat = rng.randint(0, 1 << 20, size=(s, prow)).astype(np.int64)
    cases.append((lmat, wmat, ttabs, np.zeros(pu, dtype=np.int64)))
    for lmat, wmat, ttabs, acc0 in cases:
        outs = []
        for dev in ('cpu', 'cuda'):
            args = [torch.from_numpy(a).to(dev)
                    for a in (lmat, wmat, ttabs, acc0.copy())]
            outs.append(tdi._fold_program(*args).cpu().numpy())
        torch.cuda.synchronize()
        assert np.array_equal(outs[0], outs[1])


def test_port_device_fold_failure_raises(tmp_path, monkeypatch):
    """A fold that fails on the device lane surfaces as the error, never
    as a host result."""
    jds, tds, _ = _built(tmp_path, 'day')

    def broken(*a):
        raise RuntimeError('device fold failed')
    monkeypatch.setattr(tdi, '_fold_program', broken)
    with pytest.raises(RuntimeError, match='device fold failed'):
        _port_query(tds, 'day', FUZZ_QUERIES[0])
    assert tdi.stats_doc()['routes'] == {}
    # the host engine never reaches the fold
    host = _port_query(tds, 'day', FUZZ_QUERIES[0], engine='vector')
    ref = _jax_query(jds, 'day', FUZZ_QUERIES[0], monkeypatch, False)
    assert host.points == ref.points


# -- per-shard fall-backs, rollups, generations -------------------------------

def test_port_float_weights_take_per_shard_path(tmp_path, monkeypatch):
    """Non-integral weights fail the 2^53 exactness gate: the query
    falls back to the per-shard loop, as the JAX package's does."""
    idx = tmp_path / 'idx'
    jds = JDatasourceFile(_dsconfig(tmp_path / 'none.log', idx))
    metric = jquery.metric_deserialize({'name': 'm', 'breakdowns': [
        {'name': 'host', 'field': 'host'}]})
    lines = [json.dumps({'fields': {'host': h, '__dn_metric': 0},
                         'value': v})
             for h, v in [('a', 1.5), ('b', 2), ('a', 0.25), ('c', 3.75)]]
    jds.index_read([metric], 'all',
                   io.BytesIO(('\n'.join(lines) + '\n').encode()))
    tds = TDatasourceFile(_dsconfig(tmp_path / 'none.log', idx))
    conf = {'breakdowns': [{'name': 'host'}]}
    ref = _jax_query(jds, 'all', conf, monkeypatch, True)
    got = _port_query(tds, 'all', conf)
    assert got.points == ref.points == [
        ({'host': 'a'}, 1.75), ({'host': 'b'}, 2), ({'host': 'c'}, 3.75)]
    assert _counters(got) == _counters(ref)
    assert tdi.stats_doc()['last_route'] == \
        'per-shard: weights past the exactness gate'
    assert tdi.stats_doc()['dispatches'] == 0


@pytest.mark.parametrize('interval', ['hour', 'day'])
def test_port_rollup_tree_matches_jax_package(tmp_path, monkeypatch,
                                              interval):
    """A tree given rollup shards by the JAX package's build_rollups:
    the port's planner serves the same points through them, with the
    same `index shards via rollup` counters."""
    monkeypatch.setenv('DN_IQ_STAT_TTL_MS', '0')
    jds, tds, idx = _built(tmp_path, interval)
    assert jrollup.build_rollups(idx, interval)['built'] > 0
    via = 0
    for conf in FUZZ_QUERIES + [{'breakdowns': [{'name': 'host'}],
                                 'timeAfter': '2014-05-02',
                                 'timeBefore': '2014-05-04'}]:
        ref = _jax_query(jds, interval, conf, monkeypatch, True)
        got = _port_query(tds, interval, conf)
        assert got.points == ref.points, conf
        assert _counters(got) == _counters(ref), conf
        il = dict(_counters(got))['Index List']
        via += il.get('index shards via rollup', 0)
        if il.get('index shards via rollup'):
            assert tdi.stats_doc()['last_route'] == 'rollup plan'
    assert via > 0


def test_port_generation_files_match_jax_package(tmp_path, monkeypatch):
    """Follow mini-generations (`<shard>-gNNNNNN`) merge into their base
    shard as one logical shard, bounded walks included."""
    monkeypatch.setenv('DN_IQ_STAT_TTL_MS', '0')
    jds, tds, idx = _built(tmp_path, 'day')
    _, _, idx2 = _built(tmp_path, 'day', n=500, name='idx2', seed=5)
    for day in ('2014-05-03', '2014-05-05'):
        src = os.path.join(idx2, 'by_day', day + '.sqlite')
        shutil.copy(src, os.path.join(idx, 'by_day',
                                      day + '.sqlite-g000001'))
    for conf in FUZZ_QUERIES:
        ref = _jax_query(jds, 'day', conf, monkeypatch, True)
        got = _port_query(tds, 'day', conf)
        assert got.points == ref.points, conf
        assert _counters(got) == _counters(ref), conf
    assert tdi.stats_doc()['routes'] == {'rollup plan': len(FUZZ_QUERIES)}


def test_port_time_pruning_counters(tmp_path, monkeypatch):
    jds, tds, _ = _built(tmp_path, 'hour')
    conf = {'breakdowns': [{'name': 'host'}],
            'timeAfter': '2014-05-02T05:00:00',
            'timeBefore': '2014-05-04T07:00:00'}
    ref = _jax_query(jds, 'hour', conf, monkeypatch, True)
    got = _port_query(tds, 'hour', conf)
    assert got.points == ref.points
    il = dict(_counters(got))['Index List']
    assert il == dict(_counters(ref))['Index List']
    assert il['index shards queried'] == 50
    assert il['index shards pruned'] > 0


# -- verified reads ------------------------------------------------------------

def test_port_catalogued_shard_deleted(tmp_path, monkeypatch):
    """DN_VERIFY=open: a catalogued shard missing from the walk is the
    same clean error as in the JAX package; with verification off the
    query answers from what is left, as the JAX package's does."""
    jds, tds, idx = _built(tmp_path, 'day')
    os.unlink(os.path.join(idx, 'by_day', '2014-05-04.sqlite'))
    conf = FUZZ_QUERIES[0]
    ref = _jax_query(jds, 'day', conf, monkeypatch, False)
    assert _port_query(tds, 'day', conf).points == ref.points
    monkeypatch.setenv('DN_VERIFY', 'open')
    with pytest.raises(Exception) as jerr:
        _jax_query(jds, 'day', conf, monkeypatch, True)
    with pytest.raises(tintegrity.ShardIntegrityError) as terr:
        _port_query(tds, 'day', conf)
    assert str(terr.value) == str(jerr.value)
    assert 'catalogued shard(s) missing' in str(terr.value)
    assert terr.value.integrity_shards == jerr.value.integrity_shards


def test_port_corrupt_shard_quarantined(tmp_path, monkeypatch):
    """DN_VERIFY=open: a shard whose bytes no longer match the catalog
    is quarantined and reported with the JAX package's error."""
    jds, tds, idx = _built(tmp_path, 'day')
    shutil.copytree(idx, str(tmp_path / 'copy'))
    victim = os.path.join('by_day', '2014-05-02.sqlite')
    for root in (idx, str(tmp_path / 'copy')):
        with open(os.path.join(root, victim), 'r+b') as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0xff]))
    tds = TDatasourceFile(_dsconfig(tmp_path / 'idx.log',
                                    tmp_path / 'copy'))
    monkeypatch.setenv('DN_VERIFY', 'open')
    with pytest.raises(Exception) as jerr:
        _jax_query(jds, 'day', FUZZ_QUERIES[0], monkeypatch, True)
    with pytest.raises(tintegrity.ShardIntegrityError) as terr:
        _port_query(tds, 'day', FUZZ_QUERIES[0])
    assert str(terr.value).replace(str(tmp_path / 'copy'), idx) == \
        str(jerr.value)
    assert terr.value.corrupt_shard == victim
    assert os.listdir(str(tmp_path / 'copy' / '.dn_quarantine')) == \
        ['2014-05-02.sqlite']


# -- the CLI ------------------------------------------------------------------

CLI_METRICS = [
    ['metric-add', '-b', 'timestamp[field=time,date,aggr=lquantize,'
     'step=3600],host', 'muskie', 'byhour'],
    ['metric-add', '-b', 'timestamp[field=time,date,aggr=lquantize,'
     'step=60],req.method,res.statusCode,latency[aggr=quantize]',
     'muskie', 'requests'],
]

CLI_CASES = {
    'table': ['-b', 'req.method,res.statusCode'],
    'points': ['--points', '-b', 'host'],
    'counters': ['--counters', '-b', 'req.method,res.statusCode', '-f',
                 '{"ge": ["res.statusCode", 500]}', '--interval=hour'],
    'window': ['--counters', '-b', 'host', '--interval=hour',
               '--after', '2014-06-01T00:30:00',
               '--before', '2014-06-01T02:00:00'],
    'bare': ['--counters', '--interval=hour'],
    'dry-run': ['--dry-run', '--interval=hour', '-b', 'host'],
    'iq-threads': ['--iq-threads=0', '--counters', '-b', 'host'],
    'iq-stack-0': ['--iq-stack=0', '--counters', '-b', 'host',
                   '--interval=hour'],
    'iq-stack-1': ['--iq-stack', '1', '--points', '-b',
                   'latency[aggr=quantize]'],
    'raw': ['--raw', '-b', 'req.method,latency[aggr=quantize]'],
    'no-metric': ['-b', 'operation'],
}


def _run_cli(main, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(args)
    return subprocess.CompletedProcess(args, rc, out.getvalue(),
                                       err.getvalue())


def _bin_dn(args):
    from dragnet_tpu import cli
    return _run_cli(cli.main, args)


def _port_cli(args):
    from dragnet_tpu_torch import cli
    return _run_cli(cli.main, args)


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    """A datasource with two metrics, built by bin/dn at hour and day,
    in one DRAGNET_CONFIG both CLIs read."""
    from dragnet_tpu_torch import native as tnative
    data = str(tmp_path / 'muskie.log')
    tnative.gen_to_file(3000, data, seed=7)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'dragnetrc'))
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    r = _bin_dn(['datasource-add', 'muskie', '--path=' + data,
                 '--time-field=time',
                 '--index-path=' + str(tmp_path / 'idx')])
    assert r.returncode == 0, r.stderr
    for args in CLI_METRICS:
        assert _bin_dn(args).returncode == 0
    for interval in ('hour', 'day'):
        r = _bin_dn(['build', '--interval=' + interval, 'muskie'])
        assert r.returncode == 0, r.stderr
    return tmp_path


@pytest.mark.parametrize('case', sorted(CLI_CASES))
def test_port_cli_query_matches_bin_dn(cli_env, monkeypatch, case):
    """`query` through the port's CLI (on the CPU) against bin/dn's
    (DN_ENGINE=jax): stdout, stderr (--counters, errors) and the exit
    code identical."""
    args = ['query'] + CLI_CASES[case] + ['muskie']
    monkeypatch.setenv('DN_ENGINE', 'jax')
    ref = _bin_dn(args)
    monkeypatch.delenv('DN_ENGINE')
    got = _port_cli(args)
    assert got.returncode == ref.returncode, got.stderr
    assert got.stdout == ref.stdout and got.stderr == ref.stderr
    if case == 'no-metric':
        assert got.returncode == 1 and 'no metrics available' in got.stderr
    else:
        assert got.returncode == 0 and (got.stdout or got.stderr)
    if case == 'dry-run':
        assert got.stderr.startswith('would scan files:\n')


@pytest.mark.parametrize('bad', [['--iq-threads', '-1'],
                                 ['--iq-threads', 'many'],
                                 ['--iq-stack', '2']])
def test_port_cli_query_bad_flag_values(cli_env, bad):
    """A bad explicit pool or mode flag is a usage error in both CLIs
    (their usage texts differ: the port's names its own commands)."""
    args = ['query'] + bad + ['-b', 'host', 'muskie']
    ref, got = _bin_dn(args), _port_cli(args)
    assert got.returncode == ref.returncode == 2
    assert got.stderr.splitlines()[0] == ref.stderr.splitlines()[0]
    assert 'bad value for' in got.stderr


@pytest.mark.parametrize('bad', [['--remote', 'x'], ['--trace'],
                                 ['--assetroot', '/x']])
def test_port_cli_query_unsupported_options(cli_env, bad):
    """Options the port cannot honour yet are usage errors (exit 2)."""
    got = _port_cli(['query'] + bad + ['-b', 'host', 'muskie'])
    assert got.returncode == 2
    assert 'unknown option' in got.stderr
    assert 'dn query' in got.stderr


def test_port_cli_build_threads_matches_bin_dn(cli_env, monkeypatch):
    """`build --build-threads` (DN_BUILD_THREADS for one run): the same
    tree as bin/dn's, and the env restored after the command."""
    tmp = cli_env
    monkeypatch.delenv('DN_BUILD_THREADS', raising=False)
    shutil.rmtree(str(tmp / 'idx'))
    args = ['build', '--build-threads=2', '--interval=hour', '--counters',
            'muskie']
    got = _port_cli(args)
    assert got.returncode == 0, got.stderr
    assert 'DN_BUILD_THREADS' not in os.environ
    os.rename(str(tmp / 'idx'), str(tmp / 'port'))
    monkeypatch.setenv('DN_ENGINE', 'jax')
    ref = _bin_dn(args)
    assert ref.returncode == 0 and got.stderr == ref.stderr
    a = {os.path.relpath(os.path.join(d, f), str(tmp / 'port'))
         for d, _, fs in os.walk(str(tmp / 'port')) for f in fs}
    b = {os.path.relpath(os.path.join(d, f), str(tmp / 'idx'))
         for d, _, fs in os.walk(str(tmp / 'idx')) for f in fs}
    assert a == b and len(a) > 3
    for rel in a:
        with open(str(tmp / 'port' / rel), 'rb') as f1, \
                open(str(tmp / 'idx' / rel), 'rb') as f2:
            assert f1.read() == f2.read(), rel
    bad = _port_cli(['build', '--build-threads=-2', 'muskie'])
    assert bad.returncode == 2 and 'bad value for' in bad.stderr
