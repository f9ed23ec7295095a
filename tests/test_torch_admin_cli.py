"""The port's administrative commands against bin/dn's, in-process on
the CPU: `datasource-update`, `datasource-remove`, `datasource-show`
(with and without -v), `index-read` (the tagged points `index-scan`
prints, fed on stdin) and the `-t` timing flag.  For each, stdout,
stderr (the usage text aside, which lists each CLI's own commands),
the exit code, the written configuration file and the written index
tree equal bin/dn's.
"""

import json
import os
import re

import pytest

from dragnet_tpu_torch import cli as tcli

from test_torch_follow import (_env, gen, normalized,  # noqa: F401
                               run_cli, tree_bytes)

PKGS = ('port', 'ref')


@pytest.fixture
def admin(tmp_path, monkeypatch):
    """One data file and a config file per package; `run(args)` runs
    the same command through both CLIs, each on its own config, and
    returns both results with the config files' bytes."""
    datafile = str(tmp_path / 'data.log')
    gen(datafile, 300)
    sim = str(tmp_path / 'disk_free_pct')
    with open(sim, 'w') as f:
        f.write('50\n')
    monkeypatch.setenv('DN_DISK_SIM_FILE', sim)
    monkeypatch.chdir(tmp_path)

    def cfg(pkg):
        return str(tmp_path / ('rc_%s.json' % pkg))

    def run(args, stdin=None, env=None):
        out = {}
        for pkg in PKGS:
            a = [x.replace('@IDX', str(tmp_path / ('idx_' + pkg)))
                 for x in args]
            e = dict(env or {}, DRAGNET_CONFIG=cfg(pkg))
            res = normalized(pkg, run_cli(pkg, a, env=e, stdin=stdin))
            res = tuple(r.replace(str(tmp_path / ('idx_' + pkg)), '@IDX')
                        if isinstance(r, str) else r for r in res)
            conf = None
            if os.path.exists(cfg(pkg)):
                with open(cfg(pkg), 'rb') as f:
                    conf = f.read().replace(
                        str(tmp_path / ('idx_' + pkg)).encode(), b'@IDX')
            out[pkg] = res + (conf,)
        return out

    def same(args, **kw):
        res = run(args, **kw)
        assert res['port'] == res['ref'], (args, res)
        return res['port']

    def tree(pkg):
        return tree_bytes(str(tmp_path / ('idx_' + pkg)))
    return {'run': run, 'same': same, 'data': datafile, 'tree': tree,
            'tmp': tmp_path}


def _add(admin, name='ds', extra=()):
    rc = admin['same'](['datasource-add', '--path', admin['data'],
                        '--index-path', '@IDX', '--time-field', 'time']
                       + list(extra) + [name])[0]
    assert rc == 0


UPDATES = {
    'path': ['--path', '/var/log/other.log'],
    'index-path': ['--index-path', '/tmp/elsewhere'],
    'time': ['--time-field', 'ts', '--time-format', '%Y/%m-%d'],
    'filter': ['--filter', '{"eq": ["host", "h1"]}'],
    'format': ['--data-format', 'json-skinner'],
    'backend': ['--backend', 'file'],
    'nothing': [],
    'bad-filter': ['--filter', '{"eq": '],
    # bin/dn's update takes any backend and format (they fail at use)
    'manta-backend': ['--backend', 'manta'],
    'csv-format': ['--data-format', 'csv'],
    'unknown-option': ['--points'],
}


@pytest.mark.parametrize('case', sorted(UPDATES))
def test_datasource_update_matches_reference(admin, case):
    _add(admin)
    rc, out, err, conf = admin['same'](
        ['datasource-update'] + UPDATES[case] + ['ds'])
    assert conf is not None and json.loads(conf)
    if case in ('bad-filter', 'unknown-option'):
        assert rc == 2 and err.startswith('dn: ')
    else:
        assert (rc, out, err) == (0, '', '')
    admin['same'](['datasource-show', '-v', 'ds'])


@pytest.mark.parametrize('args', [
    ['datasource-update', 'nosuch'],
    ['datasource-update'],
    ['datasource-update', 'ds', 'extra'],
    ['datasource-remove', 'ds'],
    ['datasource-remove', 'nosuch'],
    ['datasource-remove'],
    ['datasource-remove', 'ds', 'extra'],
    ['datasource-show', 'ds'],
    ['datasource-show', '-v', 'ds'],
    ['datasource-show', '--verbose', 'other'],
    ['datasource-show', 'nosuch'],
    ['datasource-show'],
    ['datasource-show', 'ds', 'other'],
], ids=lambda a: '-'.join(a))
def test_datasource_commands_match_reference(admin, args):
    """remove, show and update's argument errors: stdout, stderr, rc and
    the written config equal bin/dn's; then the list agrees."""
    _add(admin)
    _add(admin, 'other', ['--filter', '{"ne": ["host", "zzz"]}',
                          '--data-format', 'json-skinner'])
    rc, out, err, conf = admin['same'](args)
    if args[0] == 'datasource-show' and rc == 0:
        assert out.startswith('DATASOURCE') and args[-1] in out
        assert ('dataFormat:' in out) == ('-v' in args or
                                          '--verbose' in args)
    rc, out, err, conf = admin['same'](['datasource-list', '-v'])
    assert rc == 0
    assert ('\nds ' in out) != (args == ['datasource-remove', 'ds'])


METRICS = [
    ['metric-add', '-b',
     'timestamp[date,field=time,aggr=lquantize,step=3600],host',
     'ds', 'm1'],
    ['metric-add', '-b', 'host,latency[aggr=quantize]',
     '-f', '{"eq": ["operation", "get"]}', 'ds', 'm2'],
]


@pytest.mark.parametrize('interval', ['day', 'hour', 'all'])
@pytest.mark.parametrize('fmt', ['dnc', 'sqlite'])
def test_index_read_matches_reference(admin, fmt, interval):
    """`index-scan` prints tagged points; `index-read` of them on stdin
    writes a tree byte-identical to bin/dn's (and to the port's own
    build), with equal output."""
    _add(admin)
    for args in METRICS:
        assert admin['same'](args)[0] == 0
    env = {'DN_INDEX_FORMAT': fmt}
    rc, points, err, _ = admin['same'](
        ['index-scan', '-i', interval, 'ds'], env=env)
    assert rc == 0 and '__dn_metric' in points
    res = admin['same'](['index-read', '-i', interval, 'ds'],
                        stdin=points.encode(), env=env)
    assert res[:3] == (0, '', '')
    tree = admin['tree']('port')
    assert tree == admin['tree']('ref') and len(tree) > 1
    os.rename(admin['tmp'] / 'idx_port', admin['tmp'] / 'idx_read')
    rc, out, err = run_cli('port', ['build', '-i', interval, 'ds'],
                           env=dict(env, DRAGNET_CONFIG=str(
                               admin['tmp'] / 'rc_port.json')))
    assert rc == 0, err
    assert admin['tree']('port') == tree_bytes(
        str(admin['tmp'] / 'idx_read'))


@pytest.mark.parametrize('case', ['no-metrics', 'untagged', 'bad-json',
                                  'disk-critical', 'no-index',
                                  'bad-interval', 'nosuch', 'no-args',
                                  'empty'])
def test_index_read_errors_match_reference(admin, case):
    """index-read's failures (and an empty stream): the same stdout,
    stderr, exit code and tree as bin/dn's."""
    if case == 'no-index':
        assert admin['same'](['datasource-add', '--path', admin['data'],
                              'ds'])[0] == 0
    else:
        _add(admin)
    if case != 'no-metrics':
        for args in METRICS:
            assert admin['same'](args)[0] == 0
    stdin = b''
    env = {}
    args = ['index-read', 'ds']
    if case == 'untagged':
        # a plain scan's points carry no __dn_metric tag
        rc, stdin, err, _ = admin['same'](['scan', '--points', '-b',
                                           'host', 'ds'])
        stdin = stdin.encode()
    elif case == 'bad-json':
        stdin = b'{"fields": {"__dn_metric": 0}, "value": 1}\n{oops\n'
    elif case == 'disk-critical':
        with open(os.environ['DN_DISK_SIM_FILE'], 'w') as f:
            f.write('1\n')
    elif case == 'bad-interval':
        args = ['index-read', '-i', 'decade', 'ds']
    elif case == 'nosuch':
        args = ['index-read', 'nosuch']
    elif case == 'no-args':
        args = ['index-read']
    rc, out, err, _ = admin['same'](args, stdin=stdin, env=env)
    if case == 'empty':
        assert rc == 0
    else:
        assert rc in (1, 2) and err.startswith('dn: '), err
    assert admin['tree']('port') == admin['tree']('ref')


@pytest.mark.parametrize('args', [['datasource-list'],
                                  ['datasource-show', 'ds'],
                                  ['metric-list', 'ds'],
                                  ['datasource-show', 'nosuch'],
                                  ['nosuch-command']],
                         ids=lambda a: '-'.join(a))
def test_timing_flag_matches_reference(admin, args):
    """`-t` prints bin/dn's timing block after a command that finished
    (its seconds normalized); a failed command prints none."""
    _add(admin)
    # the two packages' timings differ by a millisecond now and then:
    # compare them with their seconds normalized
    res = {pkg: r[:2] + (re.sub(r'[0-9]+\.[0-9]{3}s', 'Ns', r[2]),) +
           r[3:] for pkg, r in admin['run'](['-t'] + args).items()}
    assert res['port'] == res['ref'], res
    rc, out, times, conf = res['port']
    plain = admin['same'](args)
    assert (rc, out) == plain[:2]
    err = times
    if rc == 0:
        assert times == plain[2] + 'timing stats:\n    total:    Ns\n'
    else:
        assert err == plain[2]


def test_main_entry_reports_require_time(tmp_path, monkeypatch):
    """`python -m dragnet_tpu_torch -t` hands its module-load time to
    main, which prints the reference's `require:` line."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, '-m', 'dragnet_tpu_torch', '-t',
         'datasource-list'], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=120,
        env=dict(os.environ, DRAGNET_CONFIG=str(tmp_path / 'rc.json')))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('DATASOURCE')
    assert re.fullmatch(r'timing stats:\n    require:  [0-9.]+s\n'
                        r'    total:    [0-9.]+s\n', proc.stderr)
    assert 'datasource-show' in tcli.COMMANDS
