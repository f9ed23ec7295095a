"""The port's serve-side observability against the JAX package's: the
Prometheus exposition and the /stats metrics section of a fixed
registry (byte-equal), request-scoped metrics, and the span tree of a
traced `query` and `scan` — names, nesting and every attribute but the
times — locally and joined across `--remote --trace`."""

import contextlib
import io
import json
import os
import random

import pytest

from dragnet_tpu import cli as jcli
from dragnet_tpu.obs import export as jexport
from dragnet_tpu.obs import metrics as jmetrics
from dragnet_tpu.serve import server as jserver
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch.obs import export as texport
from dragnet_tpu_torch.obs import metrics as tmetrics
from dragnet_tpu_torch.obs import trace as ttrace
from dragnet_tpu_torch.serve import server as tserver

PKGS = {'ref': (jmetrics, jexport), 'port': (tmetrics, texport)}


def _fill(mod_metrics):
    """The same observations into a fresh registry of either package."""
    reg = mod_metrics.Registry()
    reg.inc('serve_errors_total', 3, op='query')
    reg.inc('serve_errors_total', 1, op='scan')
    reg.inc('index_device_dispatches', 12)
    reg.set_gauge('device_prewarm_ms', 41.25)
    reg.set_gauge('quarantine_bytes', 0.0)
    for v in (0.4, 3.0, 7.5, 12.0, 180.0, 2600.0, 45000.0):
        reg.observe('serve_op_latency_ms', v, op='query')
    reg.observe('stage_ms', 5.5, stage='index_query_stack.load')
    return reg


COUNTERS = {'ndevicebatches': 7, 'nhostbatches': 3,
            'index device sums': 2, 'index shards via rollup': 4,
            'index shards queried': 10, 'rollup shards queried': 1}


@pytest.mark.parametrize('counters', [None, COUNTERS])
def test_prometheus_text_equals_the_jax_package(counters):
    texts = {k: e.prometheus_text(registry=_fill(m), counters=counters)
             for k, (m, e) in PKGS.items()}
    assert texts['port'] == texts['ref']
    assert 'dn_serve_op_latency_ms_bucket{op="query",le="+Inf"} 7' in \
        texts['port']


@pytest.mark.parametrize('counters', [None, COUNTERS])
def test_stats_section_equals_the_jax_package(counters):
    docs = {k: json.dumps(e.stats_section(registry=_fill(m),
                                          counters=counters),
                          sort_keys=True)
            for k, (m, e) in PKGS.items()}
    assert docs['port'] == docs['ref']


def test_request_scope_routes_metrics_to_its_registry():
    """Inside a request's obs context, writes land in its private
    registry and merge into the process registry when it ends."""
    before = tmetrics.global_registry().counter('obs_scope_probe').value
    with ttrace.request('query', force=True, emit=False) as obs:
        tmetrics.inc('obs_scope_probe', 2)
        assert obs.registry.counter('obs_scope_probe').value == 2
        assert tmetrics.global_registry().counter(
            'obs_scope_probe').value == before
    assert tmetrics.global_registry().counter(
        'obs_scope_probe').value == before + 2


# -- span trees ---------------------------------------------------------------

def _gen(path, n=2000, seed=8):
    rng = random.Random(seed)
    with open(path, 'w') as f:
        for i in range(n):
            f.write(json.dumps({
                'host': 'host%d' % rng.randrange(6),
                'req': {'method': ('GET', 'PUT')[rng.randrange(2)]},
                'latency': rng.randrange(1, 900),
                'time': '2014-05-%02dT%02d:10:00.000Z'
                        % (rng.randrange(1, 4), rng.randrange(24))}) +
                '\n')


def _run(main, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(params=['dnc', 'sqlite'])
def tree(request, tmp_path, monkeypatch):
    data = str(tmp_path / 'data.log')
    _gen(data)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    monkeypatch.setenv('DN_INDEX_FORMAT', request.param)
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_ENGINE', 'vector')
    for k in ('DN_TRACE', 'DN_SLOW_MS', 'DN_IQ_STACK', 'DN_INDEX_DEVICE'):
        monkeypatch.delenv(k, raising=False)
    for args in (['datasource-add', '--path', data, '--index-path',
                  str(tmp_path / 'idx'), '--time-field', 'time', 'ds'],
                 ['metric-add', '-b', 'host,req.method,'
                  'latency[aggr=quantize]', 'ds', 'm'],
                 ['build', 'ds']):
        rc, out, err = _run(jcli.main, args)
        assert rc == 0, err
    return tmp_path


def shape(node, root):
    """A span without its times: name, attributes (socket paths made
    relative to the test's directory), events, whether it ran on a pool
    thread, and its children's shapes in order."""
    d = {'name': node['name']}
    if node.get('attrs'):
        d['attrs'] = {k: (v.replace(str(root), '@') if isinstance(v, str)
                          else v) for k, v in node['attrs'].items()}
    if node.get('events'):
        d['events'] = node['events']
    d['thread'] = 'thread' in node
    if node.get('children'):
        d['children'] = [shape(c, root) for c in node['children']]
    return d


def _traced(main, args, root, tag, nlines=1):
    """One CLI run with its trace lines sent to a file: the run's result,
    and the last line (the command's own tree) and its shape."""
    path = str(root / ('trace_%s.jsonl' % tag))
    os.environ['DN_TRACE'] = path
    try:
        res = _run(main, args)
    finally:
        del os.environ['DN_TRACE']
    with open(path) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    assert len(lines) == nlines, lines
    doc = lines[-1]
    return res, doc, shape(doc['spans'], root)


TRACED = [
    ['query', '--trace', '-b', 'host,latency[aggr=quantize]', 'ds'],
    ['query', '--trace', '--counters', '-b', 'req.method', '-f',
     '{"ge": ["latency", 300]}', 'ds'],
]


@pytest.mark.parametrize('it', range(len(TRACED)))
def test_traced_query_span_tree_equals_the_jax_package(tree, it):
    args = TRACED[it]
    jres, jdoc, jshape = _traced(jcli.main, args, tree, 'ref')
    tres, tdoc, tshape = _traced(tcli.main, args, tree, 'port')
    assert tres == jres
    assert tshape == jshape
    assert tdoc['op'] == jdoc['op'] == 'query'
    names = [c['name'] for c in tshape['children']]
    assert names == ['index_query_stack.load', 'index_query_stack.sort',
                     'index_query_stack.aggregate']


def test_traced_scan_span_tree_equals_the_jax_package(tree, monkeypatch):
    monkeypatch.setenv('DN_SCAN_THREADS', '2')
    args = ['scan', '--trace', '-b', 'host', 'ds']
    jres, jdoc, jshape = _traced(jcli.main, args, tree, 'ref')
    tres, tdoc, tshape = _traced(tcli.main, args, tree, 'port')
    assert tres == jres
    assert tshape == jshape
    assert any(c['name'] == 'scan_mt.fanout'
               for c in tshape.get('children', []))


def test_remote_trace_joined_tree_equals_the_jax_package(tree):
    """`query --remote S --trace`: the client's tree with the server's
    subtree grafted in, for each package against its own (in-process)
    server, whose own trace line comes first."""
    args = ['-b', 'host,latency[aggr=quantize]', 'ds']
    shapes = {}
    for tag, main, mod_server in (('ref', jcli.main, jserver),
                                  ('port', tcli.main, tserver)):
        sock = str(tree / 'dn.sock')
        srv = mod_server.DnServer(socket_path=sock,
                                  conf={'max_inflight': 2}).start()
        try:
            res, doc, sh = _traced(
                main, ['query', '--remote', sock, '--trace'] + args,
                tree, tag, nlines=2)
        finally:
            srv.stop()
        assert res[0] == 0 and doc['op'] == 'query'
        shapes[tag] = (res, sh)
    assert shapes['port'] == shapes['ref']
    exchange = shapes['port'][1]['children'][0]
    assert exchange['name'] == 'remote.exchange'
    served = exchange['children'][0]
    assert served['name'] == 'serve.query'
    assert 'serve.execute' in [c['name'] for c in served['children']]


def test_slow_log_reaches_the_process_stderr(tree, monkeypatch, capfd):
    """DN_SLOW_MS=0 makes every request slow: its tree goes to the
    process stderr marked slow, never into the command's output."""
    monkeypatch.setenv('DN_SLOW_MS', '0')
    rc, out, err = _run(tcli.main, ['query', '-b', 'host', 'ds'])
    assert rc == 0 and '"slow"' not in out + err
    captured = capfd.readouterr().err
    line = [x for x in captured.splitlines() if '"slow":true' in x]
    assert line and json.loads(line[-1])['slow_ms'] == 0
