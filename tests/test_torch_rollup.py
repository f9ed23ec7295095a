"""The port's rollup builder and compactor (dragnet_tpu_torch/rollup.py,
`dn rollup`, `dn compact`) against the JAX package's, on the CPU.

- `build_rollups` on two copies of one fine tree, one per package: the
  rollup shards byte-identical, the level manifests equal in their
  shard lists and sources (their stat keys name each copy's own
  files), the integrity catalogs equal; queries equal before and after
  the rollups (the bare query engaging them), a second build a no-op,
  a stale source rebuilding its bucket, a stale rollup falling back to
  the fine shards.
- `dn follow` with DN_FOLLOW_APPEND=1 in both packages, then
  `compact_tree`: the generation-bearing trees answer queries equal to
  a from-scratch build, and the compacted trees byte-equal it, over two
  rounds; `dn compact --min-gens` and the CLI errors of both commands
  equal bin/dn's.
"""

import json
import os
import random
import shutil

import pytest

from dragnet_tpu import query as jquery
from dragnet_tpu import rollup as jrollup
from dragnet_tpu.datasource_file import DatasourceFile as JDatasourceFile
from dragnet_tpu_torch import config as tconfig
from dragnet_tpu_torch import index_journal as tjournal
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import rollup as trollup
from dragnet_tpu_torch.datasource_file import DatasourceFile

from test_torch_follow import (_env, corpus, follow_both,  # noqa: F401
                               gen, normalized, rebuild, run_cli,
                               tree_bytes)

ROLLUP_QUERIES = [
    ('bare', {}),
    ('host', {'breakdowns': [{'name': 'host'}]}),
    ('host+lat', {'breakdowns': [
        {'name': 'host'}, {'name': 'latency', 'aggr': 'quantize'}]}),
    ('filtered', {'filter': {'eq': ['host', 'host3']},
                  'breakdowns': [{'name': 'operation'}]}),
    ('window-exact-month', {'breakdowns': [{'name': 'host'}],
                            'timeAfter': '2014-04-01',
                            'timeBefore': '2014-05-01'}),
    ('window-partial', {'breakdowns': [{'name': 'host'}],
                        'timeAfter': '2014-04-03',
                        'timeBefore': '2014-05-03'}),
    ('window-mid-day', {'breakdowns': [{'name': 'host'}],
                        'timeAfter': '2014-04-02T05:00:00',
                        'timeBefore': '2014-04-03T07:00:00'}),
]

METRIC = {'name': 'm', 'breakdowns': [
    {'name': 'ts', 'field': 'time', 'date': '', 'aggr': 'lquantize',
     'step': 3600},
    {'name': 'host', 'field': 'host'},
    {'name': 'operation', 'field': 'operation'},
    {'name': 'latency', 'field': 'latency', 'aggr': 'quantize'}]}


def gen_two_months(path, n=900):
    """Records over 2014-04-01..07 and 2014-05-01..04 (two partial
    months: by_month rollups and window-edge composition both matter;
    tests/test_rollup.py's generator)."""
    rng = random.Random(7)
    with open(path, 'w') as f:
        for _ in range(n):
            mon = rng.choice([4, 5])
            day = rng.randrange(1, 8 if mon == 4 else 5)
            f.write(json.dumps({
                'host': 'host%d' % rng.randrange(12),
                'operation': 'op%d' % rng.randrange(6),
                'latency': rng.randrange(1, 500),
                'time': '2014-%02d-%02dT%02d:%02d:00.000Z'
                        % (mon, day, rng.randrange(24),
                           rng.randrange(60)),
            }, separators=(',', ':')) + '\n')


def _dsconfig(datafile, idx):
    return {'ds_backend': 'file',
            'ds_backend_config': {'path': datafile, 'timeField': 'time',
                                  'indexPath': idx},
            'ds_filter': None, 'ds_format': 'json'}


def _q(mod, conf):
    r = mod.query_load(dict(conf))
    assert not hasattr(r, 'message'), r
    return r


def _hidden(result):
    h = {}
    for s in result.pipeline.stages:
        for c in ('index shards via rollup', 'rollup shards queried',
                  'index shards queried'):
            if c in s.counters:
                h[c] = h.get(c, 0) + s.counters[c]
    return h


@pytest.fixture
def two_trees(tmp_path, monkeypatch):
    """A fine tree built by the port (on the CPU, its stacked device
    lane), copied once per package: (datafile, {pkg: (ds, idx)})."""
    monkeypatch.setenv('DN_IQ_THREADS', '0')
    monkeypatch.setenv('DN_IQ_STAT_TTL_MS', '0')
    datafile = str(tmp_path / 'data.json')
    gen_two_months(datafile)

    def make(interval, fmt):
        monkeypatch.setenv('DN_INDEX_FORMAT', fmt)
        src = str(tmp_path / 'fine')
        shutil.rmtree(src, ignore_errors=True)
        DatasourceFile(_dsconfig(datafile, src)).build(
            [tquery.metric_deserialize(METRIC)], interval, device='cpu')
        out = {}
        for pkg, cls in (('port', DatasourceFile),
                         ('ref', JDatasourceFile)):
            idx = str(tmp_path / ('idx_' + pkg))
            shutil.rmtree(idx, ignore_errors=True)
            shutil.copytree(src, idx)
            out[pkg] = (cls(_dsconfig(datafile, idx)), idx)
        return out
    return make


def _query(pkg, ds, conf, interval):
    if pkg == 'port':
        return ds.query(_q(tquery, conf), interval, device='cpu')
    return ds.query(_q(jquery, conf), interval)


def _rollup_files(idx):
    """The rollup subtree's shard bytes, and each level's manifest as
    {shard: sorted source names} plus its fine span."""
    shards, manifests = {}, {}
    for rel, data in tree_bytes(idx).items():
        if not rel.startswith(tjournal.ROLLUP_DIR + os.sep):
            continue
        if os.path.basename(rel) == '.dn_rollup.json':
            doc = json.loads(data)
            manifests[rel] = (doc['version'], doc['fine_span'], {
                k: sorted(v['sources']) for k, v in doc['shards'].items()})
        else:
            shards[rel] = data
    return shards, manifests


def _catalog(idx):
    with open(os.path.join(idx, '.dn_integrity.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('interval', ['hour', 'day'])
@pytest.mark.parametrize('fmt', ['dnc', 'sqlite'])
def test_rollup_matches_reference(two_trees, fmt, interval):
    trees = two_trees(interval, fmt)
    base = {name: _query('port', trees['port'][0], conf, interval).points
            for name, conf in ROLLUP_QUERIES}
    docs = {'port': trollup.build_rollups(trees['port'][1], interval),
            'ref': jrollup.build_rollups(trees['ref'][1], interval)}
    assert docs['port'] == docs['ref'] and docs['port']['built'] > 0
    assert set(docs['port']['levels']) == (
        {'by_day', 'by_month'} if interval == 'hour' else {'by_month'})
    got, ref = (_rollup_files(trees[p][1]) for p in ('port', 'ref'))
    assert got == ref and len(got[0]) == docs['port']['built']
    assert _catalog(trees['port'][1]) == _catalog(trees['ref'][1])

    for name, conf in ROLLUP_QUERIES:
        rp = _query('port', trees['port'][0], conf, interval)
        rr = _query('ref', trees['ref'][0], conf, interval)
        assert rp.points == rr.points == base[name], name
        if name == 'bare':
            h = _hidden(rp)
            assert h == _hidden(rr)
            assert h.get('index shards via rollup', 0) > 0, h
            assert h.get('rollup shards queried', 0) > 0, h

    # a second build with nothing stale is a no-op
    again = trollup.build_rollups(trees['port'][1], interval)
    assert again['built'] == 0 and again['fresh'] == docs['port']['built']
    # a stale source rebuilds its bucket, in both packages alike
    for pkg in ('port', 'ref'):
        finedir = os.path.join(trees[pkg][1], 'by_' + interval)
        os.utime(os.path.join(finedir, sorted(os.listdir(finedir))[0]))
    d3 = {'port': trollup.build_rollups(trees['port'][1], interval),
          'ref': jrollup.build_rollups(trees['ref'][1], interval)}
    assert d3['port'] == d3['ref'] and d3['port']['built'] >= 1
    assert _rollup_files(trees['port'][1]) == \
        _rollup_files(trees['ref'][1])
    r = _query('port', trees['port'][0], ROLLUP_QUERIES[2][1], interval)
    assert r.points == base['host+lat']


def test_stale_rollup_falls_back_to_fine(two_trees):
    """Fine shards rewritten after the rollup was built: the planner
    takes the fine path (the same points, no rollup engaged)."""
    trees = two_trees('day', 'dnc')
    ds, idx = trees['port']
    conf = {'breakdowns': [{'name': 'host'}]}
    base = _query('port', ds, conf, 'day').points
    assert trollup.build_rollups(idx, 'day')['built'] > 0
    assert _hidden(_query('port', ds, {}, 'day')).get(
        'index shards via rollup', 0) > 0
    finedir = os.path.join(idx, 'by_day')
    for name in sorted(os.listdir(finedir)):
        os.utime(os.path.join(finedir, name))
    r = _query('port', ds, conf, 'day')
    assert r.points == base
    assert _hidden(r).get('index shards via rollup', 0) == 0


# -- follow --append generations and compaction ------------------------------

COMPACT_QUERIES = [
    [],
    ['-b', 'host'],
    ['-f', '{"eq": ["operation", "get"]}',
     '-b', 'host,latency[aggr=quantize]'],
    ['-b', 'host', '-A', '2014-01-01T12:00:00',
     '-B', '2014-01-03T06:00:00'],
]
APPEND = {'DN_FOLLOW_APPEND': '1'}


def _queries_equal(ctx, fmt):
    """Each query over the follow trees (the port's and bin/dn's, both
    through their CLIs) equals the port's query over its from-scratch
    build."""
    rebuild(ctx, fmt)
    for qargs in COMPACT_QUERIES:
        for threads in ('0', '3'):
            env = {'DN_IQ_THREADS': threads, 'DN_INDEX_FORMAT': fmt}
            want = run_cli('port', ['query', '--points', '--counters'] +
                           qargs + ['r_' + fmt], env=env)
            assert want[0] == 0 and want[1], want
            for pkg, tag in (('port', 'p'), ('ref', 'j')):
                got = run_cli(pkg, ['query', '--points'] + qargs +
                              ['%s_%s' % (tag, fmt)], env=env)
                assert got[:2] == (0, want[1]), (pkg, qargs, threads)


def _compact_both(ctx, fmt):
    docs = {}
    for pkg, mod, tag in (('port', trollup, 'p'), ('ref', jrollup, 'j')):
        docs[pkg] = mod.compact_tree(ctx['idx']['%s_%s' % (tag, fmt)],
                                     'day')
    assert docs['port'] == docs['ref'], docs
    return docs['port']


def _assert_follow_trees(ctx, fmt, tag):
    rebuild(ctx, fmt)
    want = tree_bytes(ctx['idx']['r_' + fmt])
    for t in ('p', 'j'):
        assert tree_bytes(ctx['idx']['%s_%s' % (t, fmt)]) == want, \
            (tag, t)


@pytest.mark.parametrize('fmt', ['dnc', 'sqlite'])
def test_append_compact_matches_reference(tmp_path, monkeypatch, fmt):
    """Mini-generations through both packages' `follow`, then
    compaction: queries equal a from-scratch build before and after,
    and the compacted trees byte-equal it, over two rounds."""
    # the compactor writes in the tree's format, as a build would
    monkeypatch.setenv('DN_INDEX_FORMAT', fmt)
    ctx = corpus(tmp_path, monkeypatch, n=200, fmts=(fmt,))
    assert follow_both(fmt, env=APPEND)[0] == 0
    n = 200
    for _ in range(2):
        gen(ctx['datafile'], 40, start=n)
        n += 40
        assert follow_both(fmt, env=APPEND)[0] == 0
    ctx['n'] = n
    gens = trollup.compaction_backlog(ctx['idx']['p_' + fmt], 'day')
    assert gens > 0 and gens == jrollup.compaction_backlog(
        ctx['idx']['j_' + fmt], 'day')
    assert [os.path.basename(b) for b, g in trollup.find_gen_groups(
        ctx['idx']['p_' + fmt], 'day')] == \
        [os.path.basename(b) for b, g in jrollup.find_gen_groups(
            ctx['idx']['j_' + fmt], 'day')]
    _queries_equal(ctx, fmt)

    doc = _compact_both(ctx, fmt)
    assert doc['compacted'] > 0 and doc['generations_removed'] == gens
    _assert_follow_trees(ctx, fmt, 'compacted')

    gen(ctx['datafile'], 60, start=n)
    assert follow_both(fmt, env=APPEND)[0] == 0
    assert trollup.compaction_backlog(ctx['idx']['p_' + fmt], 'day') > 0
    _compact_both(ctx, fmt)
    _assert_follow_trees(ctx, fmt, 'round 2')


def test_compact_cli_min_gens(tmp_path, monkeypatch):
    """`dn compact --min-gens N` leaves smaller groups alone and a
    later run folds them: stdout, stderr and rc equal bin/dn's."""
    ctx = corpus(tmp_path, monkeypatch, n=150, fmts=('dnc',))
    env = dict(APPEND, DN_INDEX_FORMAT='dnc')
    assert follow_both('dnc', env=env)[0] == 0
    gen(ctx['datafile'], 30, start=150)
    assert follow_both('dnc', env=env)[0] == 0
    trees = {'port': ctx['idx']['p_dnc'], 'ref': ctx['idx']['j_dnc']}
    gens = trollup.compaction_backlog(trees['port'], 'day')
    assert gens > 0
    for min_gens, left in (('4', gens), ('1', 0)):
        res = {pkg: run_cli(pkg, ['compact', '--tree', trees[pkg],
                                  '--interval', 'day', '--min-gens',
                                  min_gens])
               for pkg in trees}
        assert res['port'] == res['ref'] and res['port'][0] == 0, res
        assert trollup.compaction_backlog(trees['port'], 'day') == left
    _assert_follow_trees(ctx, 'dnc', 'cli-compact')


def test_rollup_cli_builds_then_is_fresh(two_trees):
    """`dn rollup --tree`: the first run builds, the second finds every
    shard fresh; stdout, stderr and rc equal bin/dn's."""
    trees = two_trees('day', 'dnc')
    for _ in range(2):
        res = {pkg: run_cli(pkg, ['rollup', '--tree', trees[pkg][1],
                                  '--interval', 'day'])
               for pkg in trees}
        assert res['port'] == res['ref'] and res['port'][0] == 0, res
    assert res['port'][2] == 'dn rollup: 0 shard(s) built, 2 fresh, ' \
        '0 removed\n'


CLI_ERRORS = [
    ['rollup', '--interval', 'decade'],
    ['rollup', '--interval', 'all'],
    ['rollup', 'extra'],
    ['rollup', '--min-gens', '2'],
    ['compact', '--interval', 'decade'],
    ['compact', '--min-gens', '0'],
    ['compact', '--min-gens', 'x'],
    ['compact', 'extra'],
    ['rollup'],
    ['compact'],
    ['rollup', '--tree', 'nosuch', '--interval', 'hour'],
    ['compact', '--tree', 'nosuch'],
]


@pytest.mark.parametrize('args', CLI_ERRORS,
                         ids=['-'.join(a) for a in CLI_ERRORS])
def test_rollup_compact_cli_errors_match_reference(tmp_path, monkeypatch,
                                                   args):
    """Argument errors, an empty configuration and a missing tree:
    stdout, stderr and rc equal bin/dn's."""
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    monkeypatch.chdir(tmp_path)
    got = normalized('port', run_cli('port', args))
    ref = normalized('ref', run_cli('ref', args))
    assert got == ref, (got, ref)
    assert got[0] in (0, 1, 2)
    assert not os.path.exists(tmp_path / 'rc.json')
    assert tconfig.ConfigBackendLocal().load()[1].datasource_list() == []
