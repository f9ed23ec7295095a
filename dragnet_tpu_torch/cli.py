"""The port's command-line interface: `python -m dragnet_tpu_torch`.

Counterpart of dragnet_tpu/cli.py for the commands this port covers:
`scan`, `build`, `index-scan` and `query` (on the device,
DN_TORCH_DEVICE, default cuda), `datasource-add`, `datasource-list`,
`metric-add`, `metric-list`, `metric-remove` and `index-config`.
Option parsing, breakdown expansion and output are the reference CLI's,
so the port prints byte-identical results and writes byte-identical
index trees.  Options the port cannot honour yet (`--warnings`,
`--remote`, `--parse`, `--trace`, and `--assetroot` on `query`) are
unknown options: a usage error.  The configuration is the same file as bin/dn's
($DRAGNET_CONFIG or ~/.dragnetrc).

Exit codes: 2 for usage errors (with the usage text on stderr), 1 for
fatal runtime errors ("dn: <message>").
"""

import os
import sys

from .errors import DNError
from . import jsvalues as jsv
from . import attrs as mod_attrs
from . import config as mod_config
from . import query as mod_query
from . import output as mod_output
from .aggr import Aggregator
from . import datasource_for_name, metrics_for_index, index_config

ARG0 = 'dn'

USAGE_TEXT = """usage: python -m dragnet_tpu_torch SUBCOMMAND [OPTIONS] ARGS

dn datasource-add    [--backend=file] --path=DATA_PATH
                     [--index-path=INDEX_PATH] [--filter=FILTER]
                     [--time-field=FIELD] [--time-format=TIME_FORMAT]
                     [--data-format=json|json-skinner] DATASOURCE
dn datasource-list   [-v]
dn metric-add        [--breakdowns=BREAKDOWN[,...]] [--filter=FILTER]
\t\t     DATASOURCE METRIC
dn metric-list       [-v] DATASOURCE
dn metric-remove     DATASOURCE METRIC
dn build             [--before=START_TIME] [--after=END_TIME]
                     [--interval=hour|day|all] [--index-config=CONFIG_FILE]
                     [--dry-run] [--assetroot=ASSET_ROOT]
                     [--build-threads=auto|N] DATASOURCE
dn query             [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]] [--interval=hour|day|all]
                     [--raw] [--points] [--counters] [--gnuplot]
                     [--dry-run] [--iq-threads=auto|N] [--iq-stack=auto|0|1]
                     DATASOURCE
dn scan              [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]]
                     [--raw] [--points] [--counters] [--gnuplot]
                     DATASOURCE
dn index-config      DATASOURCE
dn index-scan        [--index-config=INDEX_CONFIG_FILE]
                     [--interval=hour|day|all]
                     [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]] [--counters] DATASOURCE

scan, build, index-scan and query run on DN_TORCH_DEVICE (default: cuda).
"""

# Option table (reference: bin/dn:146-215), the subset these commands
# take.  Each entry: (names, type, default)
DN_OPTIONS = [
    (['after', 'A'], 'date', None),
    (['assetroot'], 'string', '/dragnet/assets'),
    (['backend'], 'string', None),
    (['before', 'B'], 'date', None),
    (['breakdowns', 'b'], 'arrayOfString', []),
    # index-build writer pool override; DN_BUILD_THREADS for one run
    (['build-threads'], 'string', None),
    (['counters'], 'bool', None),
    (['data-format'], 'string', 'json'),
    (['dry-run', 'n'], 'bool', False),
    (['filter', 'f'], 'string', None),
    (['gnuplot'], 'bool', None),
    (['interval', 'i'], 'string', 'day'),
    (['index-config'], 'string', None),
    # index-query worker pool override; DN_IQ_THREADS for one run
    (['iq-threads'], 'string', None),
    # stacked index-query override; DN_IQ_STACK for one run: auto|0|1
    (['iq-stack'], 'string', None),
    (['index-path'], 'string', None),
    (['path'], 'string', None),
    (['points'], 'bool', None),
    (['raw'], 'bool', None),
    (['time-field'], 'string', None),
    (['time-format'], 'string', None),
    (['verbose', 'v'], 'bool', False),
]


class UsageError(Exception):
    def __init__(self, message=None):
        super(UsageError, self).__init__(message)
        self.message = message


class FatalError(Exception):
    def __init__(self, message):
        super(FatalError, self).__init__(message)
        self.message = message


def fatal(err):
    msg = err.message if hasattr(err, 'message') else str(err)
    raise FatalError(msg)


class Options(object):
    def __init__(self):
        self._args = []


def _option_config(useroptions):
    rv = []
    for name in useroptions:
        for entry in DN_OPTIONS:
            if name in entry[0]:
                rv.append(entry)
                break
        else:
            raise DNError('unknown option: "%s"' % name)
    return rv


def parse_args(argv, useroptions):
    """dashdash-style parse: long/short options, interspersed operands."""
    entries = _option_config(useroptions)
    byname = {}
    for entry in entries:
        for n in entry[0]:
            byname[n] = entry

    opts = Options()
    for entry in entries:
        key = entry[0][0].replace('-', '_')
        if entry[2] is not None or entry[1] == 'arrayOfString':
            setattr(opts, key, [] if entry[1] == 'arrayOfString'
                    else entry[2])
        else:
            setattr(opts, key, None)

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == '--':
            opts._args.extend(argv[i + 1:])
            break
        if arg.startswith('--'):
            body = arg[2:]
            if '=' in body:
                name, val = body.split('=', 1)
            else:
                name, val = body, None
            entry = byname.get(name)
            if entry is None:
                raise UsageError('unknown option: "--%s"' % name)
            if entry[1] == 'bool':
                if val is not None:
                    raise UsageError(
                        'argument not allowed for boolean arg: %s' % name)
                _set_opt(opts, entry, True)
            else:
                if val is None:
                    i += 1
                    if i >= len(argv):
                        raise UsageError(
                            'do not have enough args for "--%s" option'
                            % name)
                    val = argv[i]
                _set_opt(opts, entry, _parse_opt_value(entry, name, val))
        elif arg.startswith('-') and len(arg) > 1:
            j = 1
            while j < len(arg):
                name = arg[j]
                entry = byname.get(name)
                if entry is None:
                    raise UsageError('unknown option: "-%s"' % name)
                if entry[1] == 'bool':
                    _set_opt(opts, entry, True)
                    j += 1
                else:
                    rest = arg[j + 1:]
                    if rest == '':
                        i += 1
                        if i >= len(argv):
                            raise UsageError(
                                'do not have enough args for "-%s" option'
                                % name)
                        rest = argv[i]
                    _set_opt(opts, entry,
                             _parse_opt_value(entry, name, rest))
                    break
        else:
            opts._args.append(arg)
        i += 1
    return opts


def _set_opt(opts, entry, value):
    key = entry[0][0].replace('-', '_')
    if entry[1] == 'arrayOfString':
        getattr(opts, key).append(value)
    else:
        setattr(opts, key, value)


def _parse_opt_value(entry, name, val):
    if entry[1] == 'date':
        if val.isdigit():
            return int(val) * 1000
        ms = jsv.date_parse(val)
        if ms is None:
            raise UsageError('arg for "--%s" is not a valid date '
                             'format: "%s"' % (name, val))
        return ms
    return val


def expand_breakdowns(opts):
    """-b a,b[x=1] expansion + step validation
    (reference: bin/dn:283-309)."""
    if not hasattr(opts, 'breakdowns') or \
            not isinstance(opts.breakdowns, list):
        return
    tmp = opts.breakdowns
    opts.breakdowns = []
    for v in tmp:
        lst = mod_attrs.attrs_parse(v)
        if isinstance(lst, DNError):
            raise UsageError('bad value for "breakdowns" ("%s"): %s'
                             % (v, lst.message))
        for s in lst:
            if not s.get('field'):
                s['field'] = s['name']
            if 'step' in s:
                step = mod_query._parse_int(s['step'])
                if step is None:
                    raise UsageError('field "%s": "step" must be a number'
                                     % s['name'])
                s['step'] = step
            opts.breakdowns.append(s)


def dn_parse_args(argv, useroptions):
    opts = parse_args(argv, useroptions)
    expand_breakdowns(opts)
    if getattr(opts, 'filter', None):
        try:
            opts.filter = jsv.json_parse(opts.filter)
        except ValueError as e:
            raise UsageError('invalid filter: %s' % e)
    return opts


def _env_scope(envname, value):
    """Set `envname` for the duration of one command (None leaves it
    untouched): the datasource layer reads the env, and it must be
    restored because tests drive these entry points in-process."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        prior = os.environ.get(envname)
        if value is not None:
            os.environ[envname] = value
        try:
            yield
        finally:
            if value is not None:
                if prior is None:
                    os.environ.pop(envname, None)
                else:
                    os.environ[envname] = prior
    return scope()


def _pool_flag_env(optname, value, envname):
    """Plumb a per-run worker-pool flag (--iq-threads,
    --build-threads) through its env var for the duration of the
    command.  Unlike the env var, a bad explicit flag value is a
    usage error, not a silent fallback to sequential."""
    if value is not None and value != 'auto':
        try:
            if int(value) < 0:
                raise ValueError(value)
        except ValueError:
            raise UsageError('bad value for "%s": "%s"'
                             % (optname, value))
    return _env_scope(envname, value)


def _mode_flag_env(optname, value, envname, allowed):
    """_pool_flag_env for enumerated-mode flags (--iq-stack)."""
    if value is not None and value not in allowed:
        raise UsageError('bad value for "%s": "%s"' % (optname, value))
    return _env_scope(envname, value)


def check_arg_count(opts, expected):
    if len(opts._args) < expected:
        raise UsageError('missing arguments')
    if len(opts._args) > expected:
        raise UsageError('extra arguments')


# ---------------------------------------------------------------------------
# Config commands
# ---------------------------------------------------------------------------

def _save(ctx, newconfig):
    if isinstance(newconfig, DNError):
        fatal(newconfig)
    ctx['backend'].save(newconfig.serialize())
    ctx['config'] = newconfig


def cmd_datasource_add(ctx, argv):
    opts = dn_parse_args(argv, ['backend', 'data-format', 'filter', 'path',
                                'time-field', 'time-format', 'index-path'])
    if not opts.path:
        raise UsageError('"path" option is required')
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    dsconfig = {
        'name': dsname,
        'backend': opts.backend or 'file',
        'backend_config': {
            'path': opts.path,
            'indexPath': opts.index_path,
            'timeFormat': opts.time_format,
            'timeField': opts.time_field,
        },
        'filter': opts.filter if opts.filter is not None else None,
        'dataFormat': opts.data_format,
    }
    _save(ctx, ctx['config'].datasource_add(dsconfig))


def _datasource_print(out, dsname, ds, verbose):
    if ds['ds_backend'] == 'manta':
        location = 'manta://us-east.manta.joyent.com%s' \
            % ds['ds_backend_config'].get('path')
    else:
        location = 'file:/%s' % ds['ds_backend_config'].get('path')
    out.write('%-20s %-59s\n' % (dsname, location))
    if not verbose:
        return
    if ds['ds_filter'] is not None:
        out.write('%4s%-11s %s\n' % ('', 'filter:',
                                     jsv.json_stringify(ds['ds_filter'])))
    out.write('%4s%-11s %s\n' % ('', 'dataFormat:',
                                 jsv.json_stringify(ds['ds_format'])))
    for k, v in ds['ds_backend_config'].items():
        if k == 'path':
            continue
        sv = jsv.json_stringify(v)
        if sv is None:
            sv = 'undefined'
        out.write('%4s%-11s %s\n' % ('', k + ':', sv))


def cmd_datasource_list(ctx, argv):
    opts = dn_parse_args(argv, ['verbose'])
    check_arg_count(opts, 0)
    out = sys.stdout
    out.write('%-20s %-59s\n' % ('DATASOURCE', 'LOCATION'))
    for dsname, ds in ctx['config'].datasource_list():
        _datasource_print(out, dsname, ds, opts.verbose)


def cmd_metric_add(ctx, argv):
    opts = dn_parse_args(argv, ['breakdowns', 'filter'])
    check_arg_count(opts, 2)
    mconfig = {
        'name': opts._args[1],
        'datasource': opts._args[0],
        'filter': opts.filter or None,
        'breakdowns': opts.breakdowns,
    }
    _save(ctx, ctx['config'].metric_add(mconfig))


def cmd_metric_remove(ctx, argv):
    opts = dn_parse_args(argv, [])
    check_arg_count(opts, 2)
    _save(ctx, ctx['config'].metric_remove(opts._args[0], opts._args[1]))


def cmd_metric_list(ctx, argv):
    opts = dn_parse_args(argv, ['verbose'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    out = sys.stdout
    out.write('%-20s %-20s\n' % ('DATASOURCE', 'METRIC'))
    config = ctx['config']
    if config.datasource_get(dsname) is None:
        fatal(DNError('unknown datasource: "%s"' % dsname))
    for metname, m in config.datasource_list_metrics(dsname):
        out.write('%-20s %-20s\n' % (m.m_datasource, metname))
        if not opts.verbose:
            continue
        if m.m_filter is not None:
            out.write('%4s%-11s %s\n' % ('', 'filter:',
                                         jsv.json_stringify(m.m_filter)))
        if len(m.m_breakdowns) == 0:
            continue
        out.write('%4s%-11s %s\n' % ('', 'breakdowns:', ', '.join(
            b['b_name'] for b in m.m_breakdowns)))


# ---------------------------------------------------------------------------
# scan / query
# ---------------------------------------------------------------------------

def dn_query_config(opts):
    queryconfig = {'breakdowns': opts.breakdowns}
    if opts.after:
        queryconfig['timeAfter'] = opts.after
    if opts.before:
        queryconfig['timeBefore'] = opts.before
    if opts.filter is not None:
        queryconfig['filter'] = opts.filter
    qc = mod_query.query_load(queryconfig)
    if isinstance(qc, DNError):
        fatal(qc)
    if getattr(opts, 'gnuplot', None) and len(qc.qc_breakdowns) != 1:
        fatal(DNError(
            '--gnuplot can only be used with exactly one breakdown'))
    return qc


def dn_output(query, opts, result, dsname):
    """(reference: bin/dn:924-967)"""
    if result.dry_run_files is not None:
        sys.stderr.write('would scan files:\n')
        for path in result.dry_run_files:
            sys.stderr.write('    %s\n' % path)
        return

    points = result.points or []
    if getattr(opts, 'points', None):
        mod_output.print_points(points, sys.stdout)
    else:
        flattener = result.pipeline.stage('Flattener')
        flat = Aggregator(query)
        for fields, value in points:
            flattener.bump('ninputs')
            flat.write(fields, value)
        rows = flat.rows()
        flattener.bump('noutputs')

        if getattr(opts, 'raw', None):
            mod_output.output_raw(rows, sys.stdout)
        elif getattr(opts, 'gnuplot', None):
            mod_output.output_gnuplot(query, rows, dsname, sys.stdout)
        else:
            mod_output.output_pretty(query, rows, sys.stdout)

    if getattr(opts, 'counters', None):
        result.pipeline.dump_counters(sys.stderr)


def _device():
    return os.environ.get('DN_TORCH_DEVICE') or 'cuda'


def cmd_scan(ctx, argv):
    opts = dn_parse_args(argv, ['before', 'after', 'filter', 'breakdowns',
                                'raw', 'points', 'counters', 'gnuplot'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    query = dn_query_config(opts)
    try:
        result = ds.scan(query, device=_device())
    except DNError as e:
        fatal(e)
    dn_output(query, opts, result, dsname)


def cmd_query(ctx, argv):
    opts = dn_parse_args(argv, ['before', 'after', 'filter', 'breakdowns',
                                'raw', 'points', 'counters', 'interval',
                                'gnuplot', 'dry-run', 'iq-threads',
                                'iq-stack'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    query = dn_query_config(opts)
    with _pool_flag_env('iq-threads', opts.iq_threads, 'DN_IQ_THREADS'), \
            _mode_flag_env('iq-stack', opts.iq_stack, 'DN_IQ_STACK',
                           ('auto', '0', '1')):
        try:
            result = ds.query(query, opts.interval, dry_run=opts.dry_run,
                              device=_device())
        except DNError as e:
            fatal(e)
    dn_output(query, opts, result, dsname)


# ---------------------------------------------------------------------------
# build / index-config / index-scan
# ---------------------------------------------------------------------------

def _read_index_config(filename):
    try:
        with open(filename) as f:
            contents = f.read()
    except OSError as e:
        fatal(DNError('read "%s"' % filename, cause=DNError(str(e))))
    try:
        return jsv.json_parse(contents)
    except ValueError as e:
        fatal(DNError('parse "%s"' % filename, cause=DNError(str(e))))


def cmd_build(ctx, argv):
    opts = dn_parse_args(argv, ['after', 'before', 'counters', 'dry-run',
                                'index-config', 'interval', 'assetroot',
                                'build-threads'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    indexcfg = _read_index_config(opts.index_config) \
        if opts.index_config else None

    if opts.before is not None and opts.after is not None and \
            opts.before < opts.after:
        fatal(DNError('"before" time cannot be before "after" time'))
    if opts.interval not in ('hour', 'day', 'all'):
        fatal(DNError('interval not supported: "%s"' % opts.interval))

    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    metrics = metrics_for_index(ctx['config'], dsname,
                                index_config=indexcfg)
    if len(metrics) == 0:
        fatal(DNError('no metrics defined for dataset "%s"' % dsname))

    # the local write gate: a disk-critical index tree rejects the
    # build up front with the clean retryable disk_full error instead
    # of failing mid-publish
    if not opts.dry_run:
        from . import resources as mod_resources
        res_conf = mod_config.resources_config()
        if isinstance(res_conf, DNError):
            fatal(res_conf)
        try:
            mod_resources.check_tree_writable(ds.ds_indexpath, res_conf,
                                              what='build')
        except DNError as e:
            fatal(e)
    with _pool_flag_env('build-threads', opts.build_threads,
                        'DN_BUILD_THREADS'):
        try:
            result = ds.build(metrics, opts.interval,
                              time_after=opts.after,
                              time_before=opts.before,
                              dry_run=opts.dry_run, device=_device())
        except DNError as e:
            fatal(e)

    if opts.dry_run:
        dn_output(None, opts, result, dsname)
        return
    sys.stderr.write('indexes for "%s" built\n' % dsname)
    if getattr(opts, 'counters', None):
        result.pipeline.dump_counters(sys.stderr)


def cmd_index_config(ctx, argv):
    opts = dn_parse_args(argv, [])
    check_arg_count(opts, 1)
    import datetime
    now = datetime.datetime.now(datetime.timezone.utc)
    mtime = jsv.to_iso_string(int(now.timestamp() * 1000))
    cfg = index_config(ctx['config'], opts._args[0], mtime)
    if isinstance(cfg, DNError):
        fatal(cfg)
    sys.stdout.write(jsv.json_stringify(cfg) + '\n')


def cmd_index_scan(ctx, argv):
    opts = dn_parse_args(argv, ['before', 'after', 'filter', 'breakdowns',
                                'counters', 'index-config', 'interval'])
    opts.points = True
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    indexcfg = _read_index_config(opts.index_config) \
        if opts.index_config else None
    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    metrics = metrics_for_index(ctx['config'], dsname,
                                index_config=indexcfg)
    if len(metrics) == 0:
        fatal(DNError('no metrics defined for dataset "%s"' % dsname))
    dsfilter = None
    if indexcfg:
        dsfilter = indexcfg['datasource'].get('filter')
    try:
        result = ds.index_scan(metrics, opts.interval, filter=dsfilter,
                               time_after=opts.after,
                               time_before=opts.before, device=_device())
    except DNError as e:
        fatal(e)
    dn_output(None, opts, result, dsname)


COMMANDS = {
    'datasource-add': cmd_datasource_add,
    'datasource-list': cmd_datasource_list,
    'metric-add': cmd_metric_add,
    'metric-list': cmd_metric_list,
    'metric-remove': cmd_metric_remove,
    'build': cmd_build,
    'index-config': cmd_index_config,
    'index-scan': cmd_index_scan,
    'scan': cmd_scan,
    'query': cmd_query,
}


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    try:
        if len(argv) < 1:
            raise UsageError('no command specified')
        cmdname = argv[0]
        if cmdname not in COMMANDS:
            raise UsageError('no such command: "%s"' % cmdname)

        backend = mod_config.ConfigBackendLocal()
        err, config = backend.load()
        if err is not None and not getattr(err, 'is_enoent', False):
            fatal(err)
        ctx = {'backend': backend, 'config': config}
        COMMANDS[cmdname](ctx, argv[1:])
    except UsageError as e:
        if e.message:
            sys.stderr.write('%s: %s\n' % (ARG0, e.message))
        sys.stderr.write(USAGE_TEXT)
        return 2
    except FatalError as e:
        sys.stderr.write('%s: %s\n' % (ARG0, e.message))
        return 1
    except BrokenPipeError:
        return 0
    return 0
