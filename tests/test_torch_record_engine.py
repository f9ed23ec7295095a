"""The port's per-record engine and Python record path against the JAX
package's, all exact (points, counters, stderr and index trees equal):

- `batch.py` (pluck_column, numeric_column, date_column, js_value_key,
  RawColumn, StringColumn) and `ingest.py` (LineAssembler and the line
  iterators at random chunkings, iter_records' counters) on the
  reference's adversarial corpus (tests/test_byteparse.py);
- `scan.StreamScan` fed the same records as the reference's;
- through both CLIs in-process: DN_ENGINE=host scans, index-scans and
  builds, DN_BUILD_ENGINE=host builds, DN_NATIVE=0 scans and builds
  (the byte lane under auto, the record path through
  VectorScan.write_batch for dotted queries, json-skinner and
  DN_PARSE=host), and `--warnings` stderr, each against bin/dn's.
"""

import io
import json
import os
import random

import numpy as np
import pytest

from dragnet_tpu import batch as jbatch
from dragnet_tpu import ingest as jingest
from dragnet_tpu import query as jquery
from dragnet_tpu import scan as jscan
from dragnet_tpu import vpipe as jvpipe
from dragnet_tpu_torch import batch as tbatch
from dragnet_tpu_torch import ingest as tingest
from dragnet_tpu_torch import query as tquery
from dragnet_tpu_torch import scan as tscan
from dragnet_tpu_torch import vpipe as tvpipe

from test_byteparse import gen_lines
from test_torch_byteparse import (BUILD_METRICS, SCANS, _both, _run,
                                  build_both, corpus_env)  # noqa: F401


def _records(seed, count=800):
    """Parsed records of the adversarial corpus (objects, scalars and
    arrays: every line json.loads accepts)."""
    out = []
    for line in gen_lines(seed, count=count):
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def _loads(line):
    try:
        return json.loads(line)
    except ValueError:
        return None


def _same_js(a, b):
    """Equal lists of JS values, NaN equal to NaN, -0.0 apart from 0.0."""
    return json.dumps(a, sort_keys=True, default=repr) == \
        json.dumps(b, sort_keys=True, default=repr)


# -- batch.py ---------------------------------------------------------------

@pytest.mark.parametrize('path', ['host', 'latency', 'time', 'pad0',
                                  'pad0.a', 'pad0.a.b', 'arr', 'nosuch'])
def test_batch_columns_match_reference(path):
    recs = _records(101)
    jcol = jbatch.pluck_column(recs, path)
    tcol = tbatch.pluck_column(recs, path)
    assert len(jcol) == len(tcol) == len(recs)
    for a, b in zip(jcol, tcol):
        assert (a is jbatch.jsv.UNDEFINED) == (b is tbatch.jsv.UNDEFINED)
    defined = [v for v in jcol if v is not jbatch.jsv.UNDEFINED]
    tdefined = [v for v in tcol if v is not tbatch.jsv.UNDEFINED]
    assert _same_js(defined, tdefined)
    # the converters take the reference's values (the port's UNDEFINED
    # sentinel in place of the reference's)
    conv = [tbatch.jsv.UNDEFINED if v is jbatch.jsv.UNDEFINED else v
            for v in jcol]
    for jf, tf in ((jbatch.numeric_column, tbatch.numeric_column),
                   (jbatch.date_column, tbatch.date_column)):
        for a, b in zip(jf(jcol), tf(conv)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    jraw, traw = jbatch.RawColumn(), tbatch.RawColumn()
    assert np.array_equal(jraw.encode(jcol), traw.encode(conv))
    assert [jbatch.js_value_key(v) for v in jcol if v is not
            jbatch.jsv.UNDEFINED] == \
        [tbatch.js_value_key(v) for v in conv if v is not
         tbatch.jsv.UNDEFINED]
    jstr, tstr = jbatch.StringColumn(), tbatch.StringColumn()
    assert np.array_equal(jstr.encode(jcol), tstr.encode(conv))
    assert jstr.dict.values == tstr.dict.values


# -- ingest.py --------------------------------------------------------------

def _chunks(data, rng):
    out, pos = [], 0
    while pos < len(data):
        k = rng.choice([1, 2, 7, 64, 1000, 5000])
        out.append(data[pos:pos + k])
        pos += k
    return out


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_ingest_line_iterators_match_reference(seed, tmp_path):
    rng = random.Random(seed)
    lines = gen_lines(100 + seed, count=400)
    sep = b'\r\n' if seed == 2 else b'\n'
    data = sep.join(lines) + (b'' if seed == 3 else sep)
    chunks = _chunks(data, rng)
    assert list(tingest.iter_chunk_lines(chunks)) == \
        list(jingest.iter_chunk_lines(chunks))
    assert list(tingest.iter_line_buffers(chunks)) == \
        list(jingest.iter_line_buffers(chunks))
    ja, ta = jingest.LineAssembler(), tingest.LineAssembler()
    for c in chunks:
        assert ta.feed(c) == ja.feed(c)
        assert ta.pending() == ja.pending()
    assert ta.flush() == ja.flush()
    paths = []
    for i in range(3):
        p = tmp_path / ('part%d' % i)
        p.write_bytes(data[i * len(data) // 3:(i + 1) * len(data) // 3])
        paths.append(str(p))
    assert list(tingest.iter_lines(paths, chunk_size=97)) == \
        list(jingest.iter_lines(paths, chunk_size=97))
    assert list(tingest.iter_stream_lines(io.BytesIO(data), 333)) == \
        list(jingest.iter_stream_lines(io.BytesIO(data), 333))
    # json-skinner lines are objects (the reference's contract)
    objs = [ln for ln in lines if ln.startswith(b'{') and
            isinstance(_loads(ln), dict)]
    for fmt, src in (('json', chunks), ('json-skinner', objs)):
        jp, tp = jvpipe.Pipeline(), tvpipe.Pipeline()
        jr = list(jingest.iter_records(
            jingest.iter_chunk_lines(src), fmt, pipeline=jp))
        tr = list(tingest.iter_records(
            tingest.iter_chunk_lines(src), fmt, pipeline=tp))
        assert _same_js(jr, tr)
        assert [(s.name, s.counters) for s in jp.stages] == \
            [(s.name, s.counters) for s in tp.stages]


# -- scan.StreamScan --------------------------------------------------------

STREAM_QUERIES = [
    {'breakdowns': [{'name': 'host'},
                    {'name': 'latency', 'aggr': 'quantize'}]},
    {'filter': {'gt': ['latency', 50]}, 'breakdowns': [{'name': 'host'}]},
    {'timeAfter': '2014-05-05', 'timeBefore': '2014-05-20',
     'breakdowns': [{'name': 'timestamp', 'field': 'time', 'date': '',
                     'aggr': 'lquantize', 'step': 86400},
                    {'name': 'pad0.a'}]},
]


@pytest.mark.parametrize('qi', range(len(STREAM_QUERIES)))
def test_stream_scan_matches_reference(qi):
    conf = STREAM_QUERIES[qi]
    dsf = {'ne': ['host', 'janey']}
    jp, tp = jvpipe.Pipeline(), tvpipe.Pipeline()
    jwarn, twarn = [], []
    jp.warn_func = lambda st, kind, e: jwarn.append((st.name, kind,
                                                     str(e)))
    tp.warn_func = lambda st, kind, e: twarn.append((st.name, kind,
                                                     str(e)))
    js = jscan.StreamScan(jquery.query_load(dict(conf)), 'time', jp,
                          ds_filter=dsf)
    ts = tscan.StreamScan(tquery.query_load(dict(conf)), 'time', tp,
                          ds_filter=dsf)
    for rec in _records(102):
        if isinstance(rec, dict):
            js.write(dict(rec), 1)
            ts.write(dict(rec), 1)
    assert _same_js(js.aggr.points(), ts.aggr.points())
    assert [(s.name, s.counters) for s in jp.stages] == \
        [(s.name, s.counters) for s in tp.stages]
    assert jwarn == twarn


# -- through both CLIs ------------------------------------------------------

WARN_SCANS = [
    ['scan', '--warnings', '--counters', '-b',
     'timestamp[field=time,date,aggr=lquantize,step=86400],host'],
    ['scan', '--warnings', '-f', '{"gt": ["latency", 50]}', '-b',
     'host'],
]


@pytest.mark.parametrize('env', [{'DN_ENGINE': 'host'},
                                 {'DN_NATIVE': '0'},
                                 {'DN_NATIVE': '0', 'DN_PARSE': 'host'},
                                 {'DN_NATIVE': '0', 'DN_ENGINE': 'jax'}],
                         ids=['host', 'nonative', 'nonative-records',
                              'nonative-jax'])
@pytest.mark.parametrize('ds', ['plain', 'trunc'])
def test_cli_record_engines_match_bin_dn(corpus_env, monkeypatch, env,
                                         ds):
    for args in SCANS + [['scan', '--counters', '-b', 'req.method,host']]:
        ref, got = _both(monkeypatch, args + [ds], env)
        assert ref.returncode == 0, ref.stderr
        assert (got.returncode, got.stdout, got.stderr) == \
            (ref.returncode, ref.stdout, ref.stderr), args


@pytest.mark.parametrize('engine', ['auto', 'host', 'jax'])
def test_cli_warnings_stderr_matches_bin_dn(corpus_env, monkeypatch,
                                            engine):
    """--warnings runs the per-record engine whatever DN_ENGINE says:
    every warning, in order, byte-identical."""
    for args in WARN_SCANS:
        ref, got = _both(monkeypatch, args + ['trunc'],
                         {'DN_ENGINE': engine})
        assert ref.returncode == 0
        assert (got.stdout, got.stderr) == (ref.stdout, ref.stderr)
        assert got.stderr.count('warn: ') > 10
        assert '    at ' in got.stderr


def test_cli_json_skinner_record_path(tmp_path, monkeypatch):
    """json-skinner points without the native parser: the byte lane is
    ineligible, so the record path (VectorScan.write_batch) runs; with
    the native parser its remapped columns.  Point values in every JS
    form, weights coerced alike."""
    from dragnet_tpu_torch import cli as tcli
    rng = random.Random(5)
    lines = []
    for i in range(600):
        lines.append(json.dumps({
            'fields': {'host': rng.choice(['a', 'b', None, 3]),
                       'latency': rng.choice([1, 2.5, '7', 'x', 300])},
            'value': rng.choice([1, 2, '3', 'junk', 1.5, None, True])}))
    lines.insert(100, '{bad')
    data = tmp_path / 'points.log'
    data.write_text('\n'.join(lines) + '\n')
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc'))
    monkeypatch.setenv('DN_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('DN_PARSE_THREADS', '1')
    assert _run(tcli.main, ['datasource-add', 'pts', '--path=' + str(data),
                            '--data-format=json-skinner']).returncode == 0
    for env in ({'DN_NATIVE': '0'}, {'DN_NATIVE': '0', 'DN_PARSE':
                                     'vector', 'DN_COUNTERS_ALL': '1'},
                {'DN_ENGINE': 'host'}, {}):
        for q in (['-b', 'host'], ['-b', 'host,latency[aggr=quantize]']):
            ref, got = _both(monkeypatch, ['scan', '--counters'] + q +
                             ['pts'], dict(env, DN_ENGINE=env.get(
                                 'DN_ENGINE', 'vector')))
            assert ref.returncode == 0, ref.stderr
            assert (got.stdout, got.stderr) == (ref.stdout, ref.stderr)


@pytest.mark.parametrize('env', [
    {'DN_ENGINE': 'host'}, {'DN_BUILD_ENGINE': 'host'},
    {'DN_NATIVE': '0', 'DN_ENGINE': 'vector'},
    {'DN_NATIVE': '0', 'DN_PARSE': 'host', 'DN_ENGINE': 'vector'},
    {'warnings': '1', 'DN_ENGINE': 'jax'}],
    ids=['host', 'build-host', 'nonative', 'nonative-records',
         'warnings'])
def test_cli_record_builds_match_bin_dn(corpus_env, monkeypatch, env):
    """Builds on the per-record engine (with the datasource filter's
    shared stage) and without the native parser: trees, --counters and
    --warnings stderr identical; then index-scan."""
    from dragnet_tpu_torch import cli as tcli
    env = dict(env)
    warn = ['--warnings'] if env.pop('warnings', None) else []
    data = corpus_env / 'filtered.log'
    os.link(corpus_env / 'trunc.log', data)
    assert _run(tcli.main, [
        'datasource-add', 'filtered', '--path=' + str(data),
        '--time-field=time', '--filter={"ne": ["host", "ralph"]}',
        '--index-path=' + str(corpus_env / 'filtered')]).returncode == 0
    for args in BUILD_METRICS:
        assert _run(tcli.main, args[:-2] + ['filtered', args[-1]]) \
            .returncode == 0
    args = ['build', '--interval=hour', '--counters'] + warn + \
        ['filtered']
    ref, got, rt, gt = build_both(monkeypatch, corpus_env, args, env,
                                  ds='filtered')
    assert ref.returncode == got.returncode == 0, got.stderr
    assert (got.stdout, got.stderr) == (ref.stdout, ref.stderr)
    assert 'Datasource filter' in got.stderr
    assert rt == gt and len(rt) > 2
    if warn:
        assert got.stderr.count('warn: ') > 10
    args = ['index-scan', '--interval=day', '--counters', 'filtered']
    ref, got = _both(monkeypatch, args, env)
    assert ref.returncode == got.returncode == 0
    assert (got.stdout, got.stderr) == (ref.stdout, ref.stderr)


def test_library_scan_host_engine_matches_reference(corpus_env,
                                                    monkeypatch):
    """DatasourceFile.scan(engine='host') and a warn_func, as a library
    caller passes them, against the reference's per-record scan."""
    from dragnet_tpu.datasource_file import DatasourceFile as JDS
    from dragnet_tpu_torch.datasource_file import DatasourceFile as TDS
    conf = {'ds_backend': 'file',
            'ds_backend_config': {'path': str(corpus_env / 'plain.log'),
                                  'timeField': 'time'},
            'ds_filter': {'ne': ['host', 'janey']}, 'ds_format': 'json'}
    monkeypatch.setenv('DN_ENGINE', 'host')
    for qconf in STREAM_QUERIES:
        jw, tw = [], []
        jr = JDS(conf).scan(jquery.query_load(dict(qconf)),
                            warn_func=lambda s, k, e: jw.append(k))
        tr = TDS(conf).scan(tquery.query_load(dict(qconf)), device='cpu',
                            engine='host',
                            warn_func=lambda s, k, e: tw.append(k))
        assert _same_js(jr.points, tr.points)
        assert jw == tw
        assert [(s.name, s.counters) for s in jr.pipeline.stages] == \
            [(s.name, s.counters) for s in tr.pipeline.stages]
