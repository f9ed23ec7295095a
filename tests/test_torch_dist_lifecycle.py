"""The orderly end of the port's gloo process group
(`parallel.distributed.shutdown`) on the CPU.

Back-to-back pairs of the cluster worker's `build` mode must each end
with both processes at rc 0 (a group torn down by interpreter exit let
process 1 abort with SIGABRT after a sound build); `shutdown()` is
idempotent, and a no-op with no group or with a group an outer
launcher started; a CLI pair whose index write fails ends both
processes with rc 1, through the same orderly end, and a failure on
one process alone ends both with rc 1 within seconds.  The pair
helpers are tests/test_torch_cluster.py's.
"""

import datetime
import json
import os
import random
import subprocess
import sys
import time

import pytest
import torch.distributed as dist

from dragnet_tpu_torch.parallel import distributed as tdist
from test_torch_cluster import _assert_pair_ok, _free_port, _spawn_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'helpers', 'torch_cluster_worker.py')
PAIRS = 6
# a one-sided failure's pair ends within the failed process's short
# rendezvous (FAILED_SHUTDOWN_TIMEOUT_S) plus its peer's, with room for
# both processes' start on a loaded machine
ONE_SIDED_S = 60


def _write_data(datadir):
    rng = random.Random(5)
    for fn in ('a.log', 'b.log'):
        with open(os.path.join(datadir, fn), 'w') as f:
            for _ in range(100):
                f.write(json.dumps({
                    'time': '2014-05-0%dT%02d:00:00Z'
                            % (rng.randrange(1, 4), rng.randrange(24)),
                    'host': rng.choice(['x', 'y', 'z']),
                    'latency': rng.choice([1, 7, 90]),
                }) + '\n')


def _cli_env(tmp_path, index_path):
    """A `--backend=cluster` datasource `cl` with one metric, in a
    config of its own; the environment that runs the port's CLI on
    it."""
    datadir = str(tmp_path / 'data')
    os.mkdir(datadir)
    _write_data(datadir)
    env = dict(os.environ, DRAGNET_CONFIG=str(tmp_path / 'rc'),
               DN_TORCH_DEVICE='cpu', PYTHONPATH=ROOT)
    cmd = [sys.executable, '-m', 'dragnet_tpu_torch']
    for args in (['datasource-add', 'cl', '--backend=cluster',
                  '--path=%s' % datadir, '--time-field=time',
                  '--index-path=%s' % index_path],
                 ['metric-add', '-b', 'host', 'cl', 'm']):
        subprocess.run(cmd + args, check=True, env=env,
                       capture_output=True, cwd=ROOT)
    return env


def test_back_to_back_build_pairs_exit_zero(tmp_path):
    datadir = str(tmp_path / 'data')
    os.mkdir(datadir)
    _write_data(datadir)
    built = None
    for i in range(PAIRS):
        outs = _spawn_pair([sys.executable, WORKER, 'build', datadir,
                            str(tmp_path / ('idx%d' % i))],
                           dict(os.environ))
        _assert_pair_ok(outs)
        results = [json.loads(o[1].decode().strip().splitlines()[-1])
                   for o in outs]
        assert results[0]['built'] == results[1]['built']
        built = built or results[0]['built']
        assert results[0]['built'] == built


def _describe(outs):
    return '\n'.join('DN_PROCESS_ID=%d pid %d rc %d: %s'
                     % (i, os_pid, rc, err.decode(errors='replace')[-800:])
                     for i, (rc, out, err, os_pid) in enumerate(outs))


def test_cli_failed_build_ends_both_with_rc_1(tmp_path):
    """A DNError exit takes the same orderly end: the write fails on
    process 0, both processes report it and exit 1, neither aborts."""
    bad = tmp_path / 'notadir'
    bad.write_text('x')
    env = _cli_env(tmp_path, bad / 'idx')
    outs = _spawn_pair([sys.executable, '-m', 'dragnet_tpu_torch',
                        'build', 'cl'], env)
    assert [o[0] for o in outs] == [1, 1], _describe(outs)
    assert b'index write failed' in outs[1][2], _describe(outs)


@pytest.mark.parametrize('failpid', [0, 1])
def test_cli_one_sided_failure_ends_both_promptly(tmp_path, failpid):
    """A failure on one process before the cross-process merge: that
    process waits only briefly at the end for its peer, which sits in
    the merge's collective and leaves it once the group is destroyed;
    both exit 1 well inside the pair's deadline, neither aborts."""
    env = _cli_env(tmp_path, tmp_path / 'idx')
    t0 = time.monotonic()
    outs = _spawn_pair([sys.executable, WORKER, 'cli_fail', str(failpid),
                        'build', 'cl'], env, timeout=ONE_SIDED_S)
    assert time.monotonic() - t0 < ONE_SIDED_S
    assert [o[0] for o in outs] == [1, 1], _describe(outs)
    assert b'planted scan failure on process %d' % failpid in \
        outs[failpid][2], _describe(outs)
    assert not os.path.exists(tmp_path / 'idx'), _describe(outs)
    assert not any(b'Traceback' in o[2] for o in outs), _describe(outs)


def test_shutdown_without_a_group_is_a_noop(monkeypatch):
    monkeypatch.delenv('DN_COORDINATOR', raising=False)
    assert not dist.is_initialized()
    assert tdist.shutdown() is False
    assert tdist.shutdown() is False
    assert tdist.maybe_initialize() == (1, 0)
    assert not dist.is_initialized()


def test_shutdown_is_idempotent(monkeypatch):
    """A group this module started (one process here) ends once: the
    second call finds nothing to end."""
    monkeypatch.setenv('DN_COORDINATOR', '127.0.0.1:%d' % _free_port())
    monkeypatch.setenv('DN_NUM_PROCESSES', '1')
    monkeypatch.setenv('DN_PROCESS_ID', '0')
    assert tdist.maybe_initialize() == (1, 0)
    try:
        assert dist.is_initialized()
        assert tdist.barrier(False) is False
    finally:
        assert tdist.shutdown() is True
    assert not dist.is_initialized()
    assert tdist.shutdown() is False


def test_shutdown_leaves_an_outer_launchers_group(monkeypatch):
    """A group some outer launcher started is the launcher's to end:
    shutdown() leaves it up."""
    monkeypatch.delenv('DN_COORDINATOR', raising=False)
    store = dist.TCPStore('127.0.0.1', _free_port(), 1, is_master=True,
                          timeout=datetime.timedelta(seconds=30))
    dist.init_process_group('gloo', store=store, world_size=1, rank=0)
    try:
        assert tdist.maybe_initialize() == (1, 0)
        assert tdist.shutdown() is False
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
