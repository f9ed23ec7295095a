"""The port's `dn follow` (dragnet_tpu_torch/follow/) against the JAX
package's, on the CPU (DN_TORCH_DEVICE=cpu).

Every case runs the same seeded corpus through both CLIs in-process:
the port on its forced device lane (DN_ENGINE=jax: each mini-batch
folds through DeviceScanStack, with the one-hot kernel's plain
version), bin/dn on its host engine.  Held equal: the shard bytes of
the two follow trees and of the port's own from-scratch `dn build`
over the same prefix (follow state and quarantine left out, as
tests/test_follow.py does), and stdout, stderr and the exit code.

Scenarios (tests/test_follow.py's): --once at both index formats and
every interval with appends between rounds, a held partial final
line, rotation and truncation, stdin, --validate and the argument
errors, kill -9 exactly-once at the three publish sites in a
`python -m dragnet_tpu_torch follow` subprocess, the fault retries,
the stats document; and the port's own routing: the stack runs at
DN_ENGINE=jax and not at vector, and a device-lane fault ends the loop
with rc 1 and no retry.
"""

import contextlib
import datetime
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from dragnet_tpu import cli as jcli
from dragnet_tpu import faults as jfaults
from dragnet_tpu import index_journal as jjournal
from dragnet_tpu import native as jnative
from dragnet_tpu.follow import loop as jloop
from dragnet_tpu.follow import tailer as jtailer
from dragnet_tpu_torch import cli as tcli
from dragnet_tpu_torch import device_scan as tds
from dragnet_tpu_torch import faults as tfaults
from dragnet_tpu_torch import index_journal as tjournal
from dragnet_tpu_torch.errors import DNError
from dragnet_tpu_torch.follow import loop as tloop
from dragnet_tpu_torch.follow import tailer as ttailer
from dragnet_tpu_torch.follow.checkpoint import Checkpointer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FOLLOW_ENV = {'DN_FOLLOW_LATENCY_MS': '0',
              'DN_FOLLOW_MAX_BYTES': '2048',
              'DN_FOLLOW_POLL_MS': '5'}
# the port on its forced device lane (on the CPU), bin/dn on its host
# engine: every tree is held to the same bytes either way
PKG_ENV = {'port': {'DN_TORCH_DEVICE': 'cpu', 'DN_ENGINE': 'jax'},
           'ref': {'DN_ENGINE': 'vector'}}
CLIS = {'port': tcli, 'ref': jcli}
SKIP_DIRS = (tjournal.FOLLOW_DIR, tjournal.QUARANTINE_DIR)


# bytes a tailer reads per poll (the loops' default is 1 MiB, so a small
# file would be one mini-batch): with latency 0 each poll is a batch
READ_CHUNK = 4096


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    if jnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    for mod in (tloop, jloop):
        cls = mod.SourceTailer

        def small(path, chunk_size=READ_CHUNK, cls=cls):
            return cls(path, chunk_size=chunk_size)
        monkeypatch.setattr(mod, 'SourceTailer', small)


@contextlib.contextmanager
def env_scope(env):
    """Set environment variables (None unsets) for a block."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Stdin(object):
    def __init__(self, data):
        self.buffer = io.BytesIO(data)


def run_cli(pkg, args, env=None, stdin=None):
    """One CLI call of `pkg` ('port' or 'ref'), in-process: (rc,
    stdout, stderr).  `stdin` (bytes) stands in for the standard
    input."""
    e = dict(PKG_ENV[pkg])
    e.update(env or {})
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = _Stdin(stdin)
    try:
        with env_scope(e), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = CLIS[pkg].main(list(args))
    finally:
        sys.stdin = saved
    return rc, out.getvalue(), err.getvalue()


def normalized(pkg, res):
    """(rc, stdout, stderr) with the package's own usage text (the
    port lists its own commands) replaced by a marker."""
    rc, out, err = res
    return rc, out, err.replace(CLIS[pkg].USAGE_TEXT, '<usage>\n')


def gen(path, n, start=0):
    """n muskie-like records (tests/test_follow.py's generator): four
    days of timestamps, 3 hosts, 3 operations."""
    t0 = 1388534400
    with open(path, 'a' if start else 'w') as f:
        for i in range(start, start + n):
            ts = datetime.datetime.fromtimestamp(
                t0 + (i * 997) % (4 * 86400),
                datetime.timezone.utc).strftime('%Y-%m-%dT%H:%M:%S.000Z')
            f.write(json.dumps({
                'time': ts, 'host': 'h%d' % (i % 3),
                'operation': ('get', 'put', 'index')[i % 3],
                'latency': (i * 7) % 100}) + '\n')


# follow datasources: p_ (the port's tree), j_ (bin/dn's); r_ is the
# port's from-scratch build over the same file
TAGS = ('p', 'j', 'r')


def corpus(tmp_path, monkeypatch, n=300, fmts=('dnc', 'sqlite')):
    """One data file and, per index format, the three datasources over
    it with separate trees and the same two metrics."""
    datafile = str(tmp_path / 'data.log')
    gen(datafile, n)
    monkeypatch.setenv('DRAGNET_CONFIG', str(tmp_path / 'rc.json'))
    monkeypatch.setenv('DN_IQ_STAT_TTL_MS', '0')
    # a fixed free-space reading: the governor's pauses (and their
    # warnings) must not depend on the disk the tests run on
    sim = str(tmp_path / 'disk_free_pct')
    with open(sim, 'w') as f:
        f.write('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', sim)
    ctx = {'datafile': datafile, 'n': n, 'idx': {}, 'tmp': tmp_path}
    for fmt in fmts:
        for tag in TAGS:
            ds = '%s_%s' % (tag, fmt)
            idx = str(tmp_path / ('idx_%s' % ds))
            for args in (['datasource-add', '--path', datafile,
                          '--index-path', idx, '--time-field', 'time',
                          ds],
                         ['metric-add', '-b',
                          'timestamp[date,field=time,aggr=lquantize,'
                          'step=86400],host', ds, 'm1'],
                         ['metric-add', '-b',
                          'host,latency[aggr=quantize]', '-f',
                          '{"eq": ["operation", "get"]}', ds, 'm2']):
                assert run_cli('port', args)[0] == 0
            ctx['idx'][ds] = idx
    return ctx


def tree_bytes(idx):
    """Every file's bytes under an index tree, follow state and
    quarantine left out."""
    out = {}
    for r, dirs, names in os.walk(idx):
        for skip in SKIP_DIRS:
            if skip in dirs:
                dirs.remove(skip)
        for name in sorted(names):
            p = os.path.join(r, name)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, idx)] = f.read()
    return out


def follow_once(pkg, fmt, env=None, interval=None, extra=()):
    e = dict(FOLLOW_ENV, DN_INDEX_FORMAT=fmt)
    e.update(env or {})
    args = ['follow', '--once'] + (['-i', interval] if interval else []) \
        + list(extra) + ['%s_%s' % ('p' if pkg == 'port' else 'j', fmt)]
    return run_cli(pkg, args, env=e)


def follow_both(fmt, env=None, interval=None, extra=()):
    """follow --once through both CLIs: equal rc, stdout and stderr."""
    got = follow_once('port', fmt, env, interval, extra)
    ref = follow_once('ref', fmt, env, interval, extra)
    assert got == ref, (got, ref)
    return got


def rebuild(ctx, fmt, interval='day'):
    tjournal.reset_sweep_memo()
    jjournal.reset_sweep_memo()
    idx = ctx['idx']['r_' + fmt]
    shutil.rmtree(idx, ignore_errors=True)
    rc, out, err = run_cli('port', ['build', '-i', interval, 'r_' + fmt],
                           env={'DN_INDEX_FORMAT': fmt})
    assert rc == 0, err


def assert_trees(ctx, fmt, tag, interval='day', follows=('p', 'j')):
    """The follow trees byte-equal to the port's from-scratch build,
    and no litter left."""
    rebuild(ctx, fmt, interval)
    ref = tree_bytes(ctx['idx']['r_' + fmt])
    assert len(ref) > 1
    for t in follows:
        got = tree_bytes(ctx['idx']['%s_%s' % (t, fmt)])
        assert sorted(got) == sorted(ref), (tag, t, sorted(got),
                                            sorted(ref))
        diff = [k for k in ref if got[k] != ref[k]]
        assert diff == [], '%s (%s): bytes diverge: %s' % (tag, t, diff)


def reset_faults():
    tfaults.reset()
    jfaults.reset()


# -- byte equality -----------------------------------------------------------

@pytest.mark.parametrize('interval', ['day', 'hour', 'all'])
@pytest.mark.parametrize('fmt', ['dnc', 'sqlite'])
def test_follow_once_matches_reference(tmp_path, monkeypatch, fmt,
                                       interval):
    """--once over an existing file (many 2 KiB mini-batches, each
    shard read-modify-published), then appends between rounds: the
    port's tree equals bin/dn's follow tree and the port's own build."""
    ctx = corpus(tmp_path, monkeypatch, n=200, fmts=(fmt,))
    assert follow_both(fmt, interval=interval) == (0, '', '')
    assert_trees(ctx, fmt, 'initial', interval)
    gen(ctx['datafile'], 100, start=200)
    assert follow_both(fmt, interval=interval)[0] == 0
    assert_trees(ctx, fmt, 'appended', interval)
    # a caught-up follower publishes nothing
    doc = Checkpointer(ctx['idx']['p_' + fmt]).load()
    assert follow_both(fmt, interval=interval)[0] == 0
    assert Checkpointer(ctx['idx']['p_' + fmt]).load()['seq'] == \
        doc['seq'] == Checkpointer(ctx['idx']['j_' + fmt]).load()['seq']


def test_follow_holds_partial_final_line(tmp_path, monkeypatch):
    """A file ending mid-line: the partial is held and the checkpoint
    stays on the last line boundary; once the line completes, it is
    ingested exactly once."""
    ctx = corpus(tmp_path, monkeypatch, n=50, fmts=('dnc',))
    boundary = os.path.getsize(ctx['datafile'])
    with open(ctx['datafile'], 'a') as f:
        f.write('{"time": "2014-01-02T03:04:05.000Z", "host": "hZ"')
    assert follow_both('dnc')[0] == 0
    for t in ('p', 'j'):
        doc = Checkpointer(ctx['idx'][t + '_dnc']).load()
        assert doc['sources'][0]['offset'] == boundary
    with open(ctx['datafile'], 'a') as f:
        f.write(', "operation": "get", "latency": 7}\n')
    assert follow_both('dnc')[0] == 0
    assert_trees(ctx, 'dnc', 'completed tail')
    for t in ('p', 'j'):
        doc = Checkpointer(ctx['idx'][t + '_dnc']).load()
        assert doc['sources'][0]['offset'] == \
            os.path.getsize(ctx['datafile'])


# -- rotation, truncation, stdin --------------------------------------------

def test_follow_rotation(tmp_path, monkeypatch):
    """Rename-rotation between runs: the new file ingests from 0 and
    both trees equal a build over concat(old, new)."""
    ctx = corpus(tmp_path, monkeypatch, n=120, fmts=('dnc',))
    assert follow_both('dnc')[0] == 0
    os.rename(ctx['datafile'], ctx['datafile'] + '.1')
    gen(ctx['datafile'], 80)
    got = follow_once('port', 'dnc')
    ref = follow_once('ref', 'dnc')
    assert got == ref and got[0] == 0
    assert 'rotated while down' in got[2]
    concat = str(tmp_path / 'concat.log')
    with open(concat, 'wb') as f:
        for p in (ctx['datafile'] + '.1', ctx['datafile']):
            with open(p, 'rb') as g:
                f.write(g.read())
    assert run_cli('port', ['datasource-update', '--path', concat,
                            'r_dnc'])[0] == 0
    assert_trees(ctx, 'dnc', 'rotation')


@pytest.mark.parametrize('what', ['rotation', 'truncation',
                                  'open-failure'])
def test_follow_tailer_matches_reference(tmp_path, monkeypatch, what):
    """The tailer units: the port's SourceTailer returns the same
    buffers and offsets as the reference's through a live rotation
    (the old tail drains first), an in-place truncation (restart at 0,
    the held partial dropped) and a failed open of the new file (the
    old tail survives, the next poll retries)."""
    seen = {}
    for name, mod in (('port', ttailer), ('ref', jtailer)):
        path = str(tmp_path / ('%s.log' % name))
        with open(path, 'w') as f:
            f.write('one\ntwo\npart')
        t = mod.SourceTailer(path, chunk_size=64)
        log = [t.poll(), t.line_off, t.read_off]
        if what == 'truncation':
            with open(path, 'r+') as f:
                f.truncate(0)
            with open(path, 'w') as f:
                f.write('four\n')
            buf = t.poll()
            if t.line_off != 5:
                buf += t.poll()
            log += [buf, t.line_off]
        else:
            os.rename(path, path + '.1')
            with open(path, 'w') as f:
                f.write('three\n')
            if what == 'open-failure':
                orig = mod.SourceTailer.open_at

                def flaky(self, offset=0):
                    raise mod.DNError('transient open failure')
                monkeypatch.setattr(mod.SourceTailer, 'open_at', flaky)
                log += [t.poll()]
                monkeypatch.setattr(mod.SourceTailer, 'open_at', orig)
            log += [t.poll(), t.line_off]
        seen[name] = log
    assert seen['port'] == seen['ref']
    assert seen['port'][:3] == [b'one\ntwo\n', 8, 12]


def test_follow_stdin(tmp_path, monkeypatch):
    ctx = corpus(tmp_path, monkeypatch, n=60, fmts=('dnc',))
    with open(ctx['datafile'], 'rb') as f:
        data = f.read()
    e = dict(FOLLOW_ENV, DN_INDEX_FORMAT='dnc')
    got = run_cli('port', ['follow', '--once', 'p_dnc', '-'], env=e,
                  stdin=data)
    ref = run_cli('ref', ['follow', '--once', 'j_dnc', '-'], env=e,
                  stdin=data)
    assert got == ref and got[0] == 0, got
    assert_trees(ctx, 'dnc', 'stdin')


# -- --validate and the argument errors --------------------------------------

ARG_CASES = {
    'validate': (['follow', '--validate', '%s_dnc'], {}),
    'validate-sources': (['follow', '--validate', '-i', 'hour',
                          '%s_dnc', '-', 'rel.log'], {}),
    'validate-faults': (['follow', '--validate', '%s_dnc'],
                        {'DN_FAULTS': 'follow.publish:error:0.5:3'}),
    'bad-knob': (['follow', '--validate', '%s_dnc'],
                 {'DN_FOLLOW_LATENCY_MS': 'nope'}),
    'bad-bool': (['follow', '--once', '%s_dnc'],
                 {'DN_FOLLOW_APPEND': 'yes'}),
    'bad-obs': (['follow', '--validate', '%s_dnc'],
                {'DN_SLOW_MS': '-3'}),
    'bad-disk': (['follow', '--validate', '%s_dnc'],
                 {'DN_DISK_LOW_PCT': 'x'}),
    'nosuch': (['follow', '--validate', '--once', 'nosuch'], {}),
    'interval': (['follow', '--interval', 'decade', '%s_dnc'], {}),
    'stdin-twice': (['follow', '%s_dnc', '-', '-'], {}),
    'no-args': (['follow'], {}),
    'unknown-option': (['follow', '--points', '%s_dnc'], {}),
    'no-metrics': (['follow', '--once', 'bare'], {}),
    'no-index': (['follow', '--once', 'noidx'], {}),
}


@pytest.mark.parametrize('case', sorted(ARG_CASES))
def test_follow_arguments_match_reference(tmp_path, monkeypatch, case):
    """--validate and every argument error: stdout, stderr and the exit
    code equal bin/dn's (the usage text aside, which lists each CLI's
    own commands)."""
    ctx = corpus(tmp_path, monkeypatch, n=10, fmts=('dnc',))
    for args in (['datasource-add', '--path', ctx['datafile'],
                  '--index-path', str(tmp_path / 'bare'),
                  '--time-field', 'time', 'bare'],
                 ['datasource-add', '--path', ctx['datafile'], 'noidx'],
                 ['metric-add', '-b', 'host', 'noidx', 'm']):
        assert run_cli('port', args)[0] == 0
    argv, env = ARG_CASES[case]
    monkeypatch.chdir(tmp_path)
    res = {}
    for pkg, tag in (('port', 'p'), ('ref', 'j')):
        args = [a.replace('%s', tag) for a in argv]
        rc, out, err = normalized(pkg, run_cli(
            pkg, args, env=dict(FOLLOW_ENV, **env)))
        res[pkg] = (rc, out.replace('_' + tag + '_', '_X_')
                    .replace('=%s_' % tag, '=X_'),
                    err.replace('idx_%s_' % tag, 'idx_X_'))
    assert res['port'] == res['ref'], res
    rc, out, err = res['port']
    if case.startswith('validate'):
        assert rc == 0 and 'follow config ok: latency_ms=0 ' \
            'max_bytes=2048 poll_ms=5' in out
    else:
        assert rc in (1, 2) and err.startswith('dn: ')
    assert not os.path.exists(ctx['idx']['p_dnc'])


def test_follow_cuda_absent_fails_before_publishing(tmp_path,
                                                    monkeypatch):
    """DN_ENGINE=jax with CUDA asked for and absent: a DNError before
    any batch is published (no tree, no checkpoint)."""
    if torch.cuda.is_available():
        pytest.skip('CUDA is available here')
    ctx = corpus(tmp_path, monkeypatch, n=20, fmts=('dnc',))
    rc, out, err = follow_once('port', 'dnc',
                               env={'DN_TORCH_DEVICE': 'cuda'})
    assert rc == 1 and not out
    assert err.startswith('dn: CUDA device "cuda" requested but CUDA '
                          'is not available')
    assert not os.path.exists(ctx['idx']['p_dnc'])


# -- exactly-once across kill -9 ---------------------------------------------

KILL_SPECS = [
    'sink.flush:kill:1.0',      # mid-prepare: rollback, re-ingest
    'follow.publish:kill:1.0',  # between prepare and commit: rollback
    'sink.rename:kill:1.0',     # post-commit: roll-forward
]


@pytest.mark.parametrize('spec', KILL_SPECS)
def test_follow_kill9_exactly_once(tmp_path, monkeypatch, spec):
    """SIGKILL a `python -m dragnet_tpu_torch follow` subprocess (on
    its device lane) at each phase of its publish: the resumed
    follower lands the tree on the exact from-scratch bytes, equal to
    bin/dn's follow tree."""
    ctx = corpus(tmp_path, monkeypatch, n=200, fmts=('dnc',))
    assert follow_both('dnc')[0] == 0
    gen(ctx['datafile'], 150, start=200)
    env = dict(os.environ, DN_FAULTS=spec, JAX_PLATFORMS='cpu',
               DN_INDEX_FORMAT='dnc', **dict(FOLLOW_ENV,
                                             **PKG_ENV['port']))
    proc = subprocess.run(
        [sys.executable, '-m', 'dragnet_tpu_torch', 'follow', '--once',
         'p_dnc'], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, timeout=240)
    assert proc.returncode == -9, (proc.returncode, proc.stderr)
    reset_faults()
    tjournal.reset_sweep_memo()
    assert follow_once('port', 'dnc')[0] == 0
    assert follow_once('ref', 'dnc')[0] == 0
    assert_trees(ctx, 'dnc', 'kill [%s]' % spec)


# -- fault seams --------------------------------------------------------------

def _with_faults(monkeypatch, spec, fn):
    reset_faults()
    monkeypatch.setenv('DN_FAULTS', spec)
    try:
        return fn()
    finally:
        monkeypatch.delenv('DN_FAULTS')
        reset_faults()


def _faulted_both(monkeypatch, spec, fmt='dnc'):
    got = _with_faults(monkeypatch, spec,
                       lambda: follow_once('port', fmt))
    ref = _with_faults(monkeypatch, spec,
                       lambda: follow_once('ref', fmt))
    return got, ref


def test_follow_error_faults_retry_clean(tmp_path, monkeypatch):
    """error-kind faults at the follow seams: the batches retry and
    both runs converge on the build's bytes, with the same warnings."""
    ctx = corpus(tmp_path, monkeypatch, n=120, fmts=('dnc',))
    got, ref = _faulted_both(
        monkeypatch, 'follow.read:error:0.1:7,follow.checkpoint:error:'
        '0.2:8,follow.publish:error:0.2:9')
    assert got == ref and got[0] == 0, got
    assert 'publish failed (attempt 1)' in got[2]
    assert_trees(ctx, 'dnc', 'error faults')


@pytest.mark.parametrize('fmt', ['dnc', 'sqlite'])
def test_follow_post_commit_error_retry_exact(tmp_path, monkeypatch,
                                              fmt):
    """Every sink rename fails after the commit record: the retry
    completes the landed intent and skips the batch by its seq."""
    ctx = corpus(tmp_path, monkeypatch, n=150, fmts=(fmt,))
    got, ref = _faulted_both(monkeypatch, 'sink.rename:error:1.0', fmt)
    assert got[0] == ref[0] == 0, (got, ref)
    assert_trees(ctx, fmt, 'post-commit retry')


def test_follow_once_publish_failure_streak_exits(tmp_path,
                                                  monkeypatch):
    """A publish seam that always fails: the drain's retry cap ends
    --once with rc 1, the same warnings as bin/dn's."""
    ctx = corpus(tmp_path, monkeypatch, n=60, fmts=('dnc',))
    got, ref = _faulted_both(monkeypatch, 'follow.publish:error:1.0')
    assert got == ref and got[0] == 1, got
    assert got[2].count('publish failed (attempt') == \
        tloop.FollowLoop.DRAIN_PUBLISH_RETRIES
    assert Checkpointer(ctx['idx']['p_dnc']).load() is None


def test_follow_once_read_errors_retry_to_eof(tmp_path, monkeypatch):
    """Poll passes that read nothing because the source errored are
    not caught up: they retry, and the checkpoint covers the file."""
    ctx = corpus(tmp_path, monkeypatch, n=120, fmts=('dnc',))
    got, ref = _faulted_both(monkeypatch, 'follow.read:error:0.4:31')
    assert got == ref and got[0] == 0, got
    doc = Checkpointer(ctx['idx']['p_dnc']).load()
    assert doc['sources'][0]['offset'] == os.path.getsize(ctx['datafile'])
    assert_trees(ctx, 'dnc', 'transient read faults')
    # a source that can never be read: a bounded streak, then rc 1
    got, ref = _faulted_both(monkeypatch, 'follow.read:error:1.0')
    assert got == ref and got[0] == 1 and 'giving up' in got[2]


# -- telemetry ----------------------------------------------------------------

def test_follow_stats_doc(tmp_path, monkeypatch):
    """The `follow` stats section after a run: the reference's fields,
    the same counts and offsets."""
    ctx = corpus(tmp_path, monkeypatch, n=80, fmts=('dnc',))
    docs = {}
    for pkg, mod in (('port', tloop), ('ref', jloop)):
        assert follow_once(pkg, 'dnc')[0] == 0
        docs[pkg] = mod.stats_doc()
    a, b = docs['port'], docs['ref']
    assert sorted(a) == sorted(b)
    for k in ('seq', 'batches_published', 'records', 'bytes',
              'pending_bytes', 'publish_pauses'):
        assert a[k] == b[k], k
    assert a['records'] == 80 and a['batches_published'] >= 1
    assert a['checkpoint_age_s'] is not None
    assert [(s['path'], s['offset']) for s in a['sources']] == \
        [(s['path'], s['offset']) for s in b['sources']] == \
        [(ctx['datafile'], os.path.getsize(ctx['datafile']))]
    from dragnet_tpu_torch.obs import metrics as obs_metrics
    names = {name for name, labels, m in
             obs_metrics.global_registry().snapshot()}
    assert {'follow_batches_total', 'follow_records_total',
            'follow_scan_ms', 'follow_publish_ms',
            'follow_ingest_lag_ms'} <= names


# -- the port's routing: the stack, and device-lane faults --------------------

def _stack_spy(monkeypatch):
    calls = {'stack': 0}
    orig = tds.DeviceScanStack.process

    def process(self, *a, **k):
        calls['stack'] += 1
        return orig(self, *a, **k)
    monkeypatch.setattr(tds.DeviceScanStack, 'process', process)
    return calls


@pytest.mark.parametrize('engine', ['jax', 'vector', 'auto'])
def test_follow_engine_routing(tmp_path, monkeypatch, engine):
    """Each mini-batch scans on the CLI's engine: at DN_ENGINE=jax it
    folds through DeviceScanStack, at vector and under auto (a
    mini-batch stays far below the escalation point) it does not; the
    trees are identical either way."""
    ctx = corpus(tmp_path, monkeypatch, n=150, fmts=('dnc',))
    calls = _stack_spy(monkeypatch)
    rc, out, err = follow_once('port', 'dnc', env={'DN_ENGINE': engine})
    assert rc == 0, err
    nb = tloop.stats_doc()['batches_published']
    assert nb > 3
    if engine == 'jax':
        assert calls['stack'] >= nb
    else:
        assert calls['stack'] == 0
    assert_trees(ctx, 'dnc', engine, follows=('p',))


@pytest.mark.parametrize('fault', ['dnerror', 'runtime'])
def test_follow_device_fault_ends_loop(tmp_path, monkeypatch, fault):
    """A fault of the device lane in the third mini-batch: rc 1 with
    the device error on stderr, no `publish failed` retry, and the
    checkpoint at the last good batch; a follower resumed on a good
    lane converges on the build's bytes."""
    ctx = corpus(tmp_path, monkeypatch, n=150, fmts=('dnc',))
    orig = tds.DeviceScanStack._process_device
    seen = {'n': 0}

    def planted(self, *a, **k):
        seen['n'] += 1
        if seen['n'] == 3:
            if fault == 'dnerror':
                raise DNError('device staging: the input copy failed',
                              cause=DNError('planted'))
            raise RuntimeError('one-hot kernel launch failed: CUDA '
                               'error 700')
        return orig(self, *a, **k)
    monkeypatch.setattr(tds.DeviceScanStack, '_process_device', planted)
    rc, out, err = follow_once('port', 'dnc')
    assert rc == 1 and not out
    assert 'publish failed' not in err
    msg = 'device staging: the input copy failed: planted' \
        if fault == 'dnerror' else 'one-hot kernel launch failed'
    assert err.startswith('dn: mini-batch 3 (') and msg in err, err
    assert err.count('\n') == 1
    doc = Checkpointer(ctx['idx']['p_dnc']).load()
    assert doc['seq'] == 2
    assert tloop.stats_doc()['seq'] == 2
    monkeypatch.setattr(tds.DeviceScanStack, '_process_device', orig)
    assert follow_once('port', 'dnc')[0] == 0
    assert_trees(ctx, 'dnc', 'after a device fault', follows=('p',))


def test_follow_host_engine_keeps_publish_retry(tmp_path, monkeypatch):
    """On the host engine a scan error keeps the reference's discipline
    (a retried publish failure): only the device lane is fatal."""
    corpus(tmp_path, monkeypatch, n=60, fmts=('dnc',))
    from dragnet_tpu_torch import datasource_file as tdsf
    orig = tdsf.DatasourceFile.index_scan
    seen = {'n': 0}

    def flaky(self, *a, **k):
        seen['n'] += 1
        if seen['n'] == 1:
            raise DNError('planted host scan error')
        return orig(self, *a, **k)
    monkeypatch.setattr(tdsf.DatasourceFile, 'index_scan', flaky)
    rc, out, err = follow_once('port', 'dnc', env={'DN_ENGINE': 'vector'})
    assert rc == 0, err
    assert 'publish failed (attempt 1): planted host scan error' in err


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_follow_on_card_matches_host(tmp_path, monkeypatch):
    """follow --once on the card (DN_ENGINE=jax) against the host
    engine: identical trees, every mini-batch through the stack, K1
    launching once per device batch for each metric (m1 and m2 both
    fold into small dense accumulators, the kernel's route)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from dragnet_tpu_torch.ops import cuda_kernels as ck
    ctx = corpus(tmp_path, monkeypatch, n=400, fmts=('dnc',))
    calls = _stack_spy(monkeypatch)
    ck.reset_launches()
    rc, out, err = follow_once('port', 'dnc',
                               env={'DN_TORCH_DEVICE': 'cuda'})
    assert rc == 0, err
    assert calls['stack'] > 3
    assert ck.launches['onehot_dense'] == 2 * calls['stack']
    rebuild(ctx, 'dnc')
    want = tree_bytes(ctx['idx']['r_dnc'])
    shutil.rmtree(ctx['idx']['r_dnc'])
    rc, out, err = run_cli('port', ['build', 'r_dnc'], env={
        'DN_ENGINE': 'vector', 'DN_INDEX_FORMAT': 'dnc'})
    assert rc == 0, err
    assert tree_bytes(ctx['idx']['r_dnc']) == want == \
        tree_bytes(ctx['idx']['p_dnc'])
