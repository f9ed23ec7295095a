"""`python -m dragnet_tpu_torch scan` (DN_TORCH_DEVICE=cpu) against
`bin/dn scan` with the JAX package's forced device engine
(DN_ENGINE=jax), on generated muskie records and one shared
DRAGNET_CONFIG written by the port's `datasource-add`: stdout and the
--counters dump must be byte-identical.  The port runs as a real
subprocess; bin/dn's entry point (dragnet_tpu.cli.main) runs in-process,
as the parity suite runs it, to spare an interpreter start per case."""

import contextlib
import io
import os
import subprocess
import sys

import pytest

from dragnet_tpu import native as jnative
from dragnet_tpu_torch import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    'table': ['-b', 'host,req.method', '-f',
              '{"ne": ["res.statusCode", 599]}'],
    'quantize': ['-b', 'latency[aggr=quantize]'],
    'points': ['--points', '-b', 'operation,res.statusCode'],
    'counters': ['--counters', '-b',
                 'timestamp[field=time,date,aggr=lquantize,step=600],'
                 'res.statusCode', '-f', '{"ge": ["res.statusCode", 500]}'],
}


@pytest.fixture(scope='module')
def dsenv(tmp_path_factory):
    if jnative.get_lib() is None:
        pytest.skip('native parser unavailable')
    d = tmp_path_factory.mktemp('torch_cli')
    data = str(d / 'muskie.log')
    tnative.gen_to_file(3000, data, seed=7)
    env = dict(os.environ)
    env.update(DRAGNET_CONFIG=str(d / 'dragnetrc'), JAX_PLATFORMS='cpu',
               DN_PARSE_THREADS='1', DN_READ_SIZE='65536')
    env.pop('DN_ENGINE', None)
    proc = _port(env, ['datasource-add', 'muskie', '--path=' + data,
                       '--time-field=time',
                       '--filter={"ne": ["host", "zzz"]}'])
    assert proc.returncode == 0, proc.stderr
    proc = _port(env, ['datasource-list'])
    assert proc.returncode == 0 and 'muskie' in proc.stdout
    return env


def _port(env, args):
    return subprocess.run(
        [sys.executable, '-m', 'dragnet_tpu_torch'] + args, cwd=ROOT,
        env=dict(env, DN_TORCH_DEVICE='cpu'), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=300)


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


@pytest.mark.parametrize('case', sorted(CASES))
def test_port_cli_matches_bin_dn(dsenv, monkeypatch, case):
    args = ['scan'] + CASES[case] + ['muskie']
    ref = _bin_dn(monkeypatch, dsenv, args)
    got = _port(dsenv, args)
    assert ref.returncode == 0, ref.stderr
    assert got.returncode == 0, got.stderr
    assert ref.stdout and got.stdout == ref.stdout
    if case == 'counters':
        assert 'Aggregator' in got.stderr
        assert got.stderr == ref.stderr
