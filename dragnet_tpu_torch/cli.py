"""The port's command-line interface: `python -m dragnet_tpu_torch`.

Counterpart of dragnet_tpu/cli.py for the commands this port covers:
`scan`, `build`, `index-scan`, `query` and `follow` (on
DN_TORCH_DEVICE, default cuda, with the engine DN_ENGINE names, as
bin/dn reads it: auto by default, jax for the device lane, vector for
the host engine, host for the per-record engine; `scan` and `build`
parse through the lane DN_PARSE or `--parse` names: auto, host, vector
or device), the host-side index commands `index-read`, `rollup` and
`compact`, and the configuration commands `datasource-add`,
`datasource-update`, `datasource-remove`, `datasource-list`,
`datasource-show`, `metric-add`, `metric-list`, `metric-remove` and
`index-config`.  Option parsing, breakdown expansion, warnings
(`--warnings`), output and the `-t` timing flag are the reference
CLI's, so the port prints byte-identical results and writes
byte-identical index trees.  Options the port cannot honour yet
(`--remote`, `--trace`, and `--assetroot` on `query`) are unknown
options: a usage error.  The configuration is the same file as bin/dn's
($DRAGNET_CONFIG or ~/.dragnetrc).

Exit codes: 2 for usage errors (with the usage text on stderr), 1 for
fatal runtime errors ("dn: <message>"); `follow` returns its own (1
when its --once catch-up or drain gave up).
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
dn datasource-update [--backend=file] [--path=DATA_PATH]
                     [--index-path=INDEX_PATH] [--filter=FILTER]
                     [--time-field=FIELD] [--time-format=TIME_FORMAT]
                     [--data-format=json|json-skinner] DATASOURCE
dn datasource-list   [-v]
dn datasource-remove DATASOURCE
dn datasource-show   [-v] DATASOURCE
dn metric-add        [--breakdowns=BREAKDOWN[,...]] [--filter=FILTER]
\t\t     DATASOURCE METRIC
dn metric-list       [-v] DATASOURCE
dn metric-remove     DATASOURCE METRIC
dn build             [--before=START_TIME] [--after=END_TIME]
                     [--interval=hour|day|all] [--index-config=CONFIG_FILE]
                     [--dry-run] [--assetroot=ASSET_ROOT] [--warnings]
                     [--parse=auto|host|vector|device]
                     [--build-threads=auto|N] DATASOURCE
dn query             [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]] [--interval=hour|day|all]
                     [--raw] [--points] [--counters] [--gnuplot]
                     [--dry-run] [--iq-threads=auto|N] [--iq-stack=auto|0|1]
                     DATASOURCE
dn scan              [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]]
                     [--raw] [--points] [--counters] [--warnings] [--dry-run]
                     [--gnuplot] [--parse=auto|host|vector|device]
                     DATASOURCE
dn index-config      DATASOURCE
dn index-read        [--index-config=INDEX_CONFIG_FILE]
                     [--interval=hour|day|all]
                     DATASOURCE
dn index-scan        [--index-config=INDEX_CONFIG_FILE]
                     [--interval=hour|day|all]
                     [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]] [--counters] DATASOURCE
dn follow            [--interval=hour|day|all] [--index-config=CONFIG_FILE]
                     [--once] [--validate] DATASOURCE [FILE|- ...]
dn rollup            [--tree=INDEX_PATH] [--interval=hour|day]
dn compact           [--tree=INDEX_PATH] [--interval=hour|day]
                     [--min-gens=N]

scan, build, index-scan, query and follow run on DN_TORCH_DEVICE
(default: cuda) with the engine DN_ENGINE names: auto (the default: the
multithreaded host engine, the device taking the stream over once it
wins an audition), jax (the device from the first batch), vector (the
host engine) or host (the per-record engine).  DN_PARSE or --parse picks the
parse lane of scan and build: auto (the C++ parser, or the byte lane
without it), host, vector (the byte lane) or device (the byte lane with
its quote-parity scan on DN_TORCH_DEVICE).
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
    # `dn compact`: only rewrite base shards holding at least this
    # many follow mini-generations (default 1: fold everything)
    (['min-gens'], 'string', None),
    # `dn follow` catch-up mode: ingest to the sources' current EOF,
    # publish, checkpoint, and exit instead of tailing forever
    (['once'], 'bool', None),
    (['parse'], 'string', None),
    (['path'], 'string', None),
    (['points'], 'bool', None),
    (['raw'], 'bool', None),
    (['time-field'], 'string', None),
    (['time-format'], 'string', None),
    # `dn rollup` / `dn compact`: limit the walk to one index root
    (['tree'], 'string', None),
    # `dn follow --validate`: check the knobs and sources, print the
    # resolved configuration, touch nothing
    (['validate'], 'bool', None),
    (['verbose', 'v'], 'bool', False),
    (['warnings'], 'bool', None),
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
    """_pool_flag_env for enumerated-mode flags (--iq-stack,
    --parse)."""
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


def cmd_datasource_update(ctx, argv):
    opts = dn_parse_args(argv, ['backend', 'data-format', 'filter', 'path',
                                'time-field', 'time-format', 'index-path'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    dsupdate = {
        'backend': opts.backend,
        'backend_config': {
            'path': opts.path,
            'indexPath': opts.index_path,
            'timeFormat': opts.time_format,
            'timeField': opts.time_field,
        },
        'filter': opts.filter if opts.filter is not None else None,
        'dataFormat': opts.data_format,
    }
    _save(ctx, ctx['config'].datasource_update(dsname, dsupdate))


def cmd_datasource_remove(ctx, argv):
    opts = dn_parse_args(argv, [])
    check_arg_count(opts, 1)
    _save(ctx, ctx['config'].datasource_remove(opts._args[0]))


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


def cmd_datasource_show(ctx, argv):
    opts = dn_parse_args(argv, ['verbose'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    ds = ctx['config'].datasource_get(dsname)
    if ds is None:
        fatal(DNError('unknown datasource: "%s"' % dsname))
    out = sys.stdout
    out.write('%-20s %-59s\n' % ('DATASOURCE', 'LOCATION'))
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
        # parse-lane plan line: shown when the operator asked about it
        # (an explicit DN_PARSE / --parse, or the full-counters view) —
        # the default dry-run output stays byte-pinned to the
        # reference goldens
        pp = getattr(result, 'parse_plan', None)
        if pp is not None and (os.environ.get('DN_COUNTERS_ALL') == '1'
                               or pp.get('parse_mode') != 'auto'):
            sys.stderr.write('parse lane: %s (%s)\n'
                             % (pp['parse_lane'], pp['reason']))
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
    """The device a command runs on (CUDA unless DN_TORCH_DEVICE says
    otherwise), after the device-lane knobs passed their validation
    (config.device_config): a malformed value is an error here, never
    read as its default."""
    conf = mod_config.device_config()
    if isinstance(conf, DNError):
        fatal(conf)
    return os.environ.get('DN_TORCH_DEVICE') or 'cuda'


# DN_ENGINE as bin/dn reads it (engine.engine_mode), mapped onto the
# port's engine names; any other value is the vectorized host engine
# there, and here
ENGINE_MODES = {'auto': 'auto', 'jax': 'device', 'vector': 'vector',
                'host': 'host'}
PARSE_MODES = ('auto', 'host', 'vector', 'device')


def _engine():
    from .engine import engine_mode
    return ENGINE_MODES.get(engine_mode(), 'vector')


def _warn_printer(stage, kind, error):
    sys.stderr.write('warn: %s\n' % (getattr(error, 'message', None) or
                                     str(error)))
    sys.stderr.write('    at %s\n' % stage.name)


def cmd_scan(ctx, argv):
    opts = dn_parse_args(argv, ['before', 'after', 'filter', 'breakdowns',
                                'raw', 'points', 'counters', 'warnings',
                                'gnuplot', 'dry-run', 'parse'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    query = dn_query_config(opts)
    warn_func = _warn_printer if getattr(opts, 'warnings', None) else None
    with _mode_flag_env('parse', opts.parse, 'DN_PARSE', PARSE_MODES):
        try:
            result = ds.scan(query, device=_device(), engine=_engine(),
                             dry_run=opts.dry_run, warn_func=warn_func)
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
                              device=_device(), engine=_engine())
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
                                'index-config', 'interval', 'warnings',
                                'assetroot', 'build-threads', 'parse'])
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
    warn_func = _warn_printer if getattr(opts, 'warnings', None) else None
    with _pool_flag_env('build-threads', opts.build_threads,
                        'DN_BUILD_THREADS'), \
            _mode_flag_env('parse', opts.parse, 'DN_PARSE', PARSE_MODES):
        try:
            result = ds.build(metrics, opts.interval,
                              time_after=opts.after,
                              time_before=opts.before,
                              dry_run=opts.dry_run, device=_device(),
                              engine=_engine(), warn_func=warn_func)
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
                               time_before=opts.before, device=_device(),
                               engine=_engine())
    except DNError as e:
        fatal(e)
    dn_output(None, opts, result, dsname)


def cmd_index_read(ctx, argv):
    opts = dn_parse_args(argv, ['index-config', 'interval'])
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
    # the write gate (resources.py): index-read lands shards — on a
    # disk-critical tree it rejects up front, retryably, instead of
    # consuming the stream and failing mid-publish (host work: no
    # device is touched)
    from . import resources as mod_resources
    res_conf = mod_config.resources_config()
    if isinstance(res_conf, DNError):
        fatal(res_conf)
    try:
        mod_resources.check_tree_writable(
            getattr(ds, 'ds_indexpath', None), res_conf,
            what='index-read')
        ds.index_read(metrics, opts.interval, sys.stdin.buffer)
    except DNError as e:
        fatal(e)


def cmd_follow(ctx, argv):
    """`dn follow [--interval=I] [--index-config=F] [--once]
    [--validate] DATASOURCE [FILE ...]`: the continuous-ingest daemon
    (follow/loop.py) — tail growing files (FILE of `-` reads stdin;
    default: the datasource's own data path when it is a regular
    file), cut mini-batches by DN_FOLLOW_LATENCY_MS /
    DN_FOLLOW_MAX_BYTES, and incrementally publish shard updates with
    an exactly-once checkpoint.  Each mini-batch scans on the CLI's
    engine and device (DN_ENGINE, DN_TORCH_DEVICE); a device-lane
    fault ends the loop (follow/loop.py)."""
    import os
    opts = dn_parse_args(argv, ['interval', 'index-config', 'once',
                                'validate'])
    if len(opts._args) < 1:
        raise UsageError('missing arguments')
    dsname = opts._args[0]
    sources = opts._args[1:]
    indexcfg = _read_index_config(opts.index_config) \
        if opts.index_config else None
    if opts.interval not in ('hour', 'day', 'all'):
        fatal(DNError('interval not supported: "%s"' % opts.interval))

    # the follow knobs share the fail-fast validation contract with
    # the device and fault knobs: a malformed value is caught here
    # (and by --validate), not at the first batch that needs it
    conf = mod_config.follow_config()
    if isinstance(conf, DNError):
        fatal(conf)
    faults_conf = mod_config.faults_config()
    if isinstance(faults_conf, DNError):
        fatal(faults_conf)
    obs_conf = mod_config.obs_config()
    if isinstance(obs_conf, DNError):
        fatal(obs_conf)
    res_conf = mod_config.resources_config()
    if isinstance(res_conf, DNError):
        fatal(res_conf)

    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    if getattr(ds, 'ds_indexpath', None) is None:
        fatal(DNError('datasource is missing "indexpath"'))
    if opts.interval != 'all' and \
            getattr(ds, 'ds_timefield', None) is None:
        fatal(DNError('datasource is missing "timefield"'))
    metrics = metrics_for_index(ctx['config'], dsname,
                                index_config=indexcfg)
    if len(metrics) == 0:
        fatal(DNError('no metrics defined for dataset "%s"' % dsname))

    if not sources:
        datapath = getattr(ds, 'ds_datapath', None)
        if datapath is None or not os.path.isfile(datapath):
            fatal(DNError('no sources given and the datasource path '
                          'is not a regular file; name the file(s) '
                          'to follow (or "-" for stdin)'))
        sources = [datapath]
    norm = []
    for src in sources:
        norm.append(src if src == '-' else os.path.abspath(src))
    if norm.count('-') > 1:
        raise UsageError('stdin ("-") may be named at most once')

    if getattr(opts, 'validate', None):
        # dry mode (bin/dn's): the DN_FOLLOW_* /
        # DN_FAULTS / obs knobs and the source arguments were just
        # validated through the paths the daemon uses; report the
        # resolved configuration and exit without touching anything
        sys.stdout.write(
            'follow config ok: latency_ms=%d max_bytes=%d '
            'poll_ms=%d\n'
            % (conf['latency_ms'], conf['max_bytes'],
               conf['poll_ms']))
        sys.stdout.write(
            'obs config ok: trace=%s slow_ms=%s buckets=%d\n'
            % (obs_conf['trace'] or 'off',
               obs_conf['slow_ms'] if obs_conf['slow_ms'] is not None
               else 'off', len(obs_conf['buckets'])))
        sys.stdout.write(
            'resources config ok: disk_low_pct=%g '
            'disk_critical_pct=%g poll_ms=%d\n'
            % (res_conf['disk_low_pct'],
               res_conf['disk_critical_pct'], res_conf['poll_ms']))
        sys.stdout.write(
            'follow plan: datasource=%s interval=%s index=%s '
            'sources=%s\n'
            % (dsname, opts.interval, ds.ds_indexpath,
               ','.join(norm)))
        sites = faults_conf['sites']
        if sites:
            sys.stdout.write(
                'faults armed: %s\n' % ' '.join(
                    '%s:%s:%g:%d' % (s, k, r, seed)
                    for s, (k, r, seed) in sorted(sites.items())))
        return 0

    from .follow import loop as mod_floop
    device, engine = _device(), _engine()
    if engine in mod_floop.DEVICE_ENGINES:
        # no batch is published before the device answers: CUDA asked
        # for and absent fails here, not at the first mini-batch
        from .ops import resolve_device
        try:
            resolve_device(device)
        except DNError as e:
            fatal(e)
    try:
        return mod_floop.follow_main(ds, metrics, opts.interval, norm,
                                     conf, once=bool(opts.once),
                                     device=device, engine=engine)
    except DNError as e:
        fatal(e)


def _integrity_trees(opts):
    """[(dsname-or-None, indexroot)] a rollup/compact pass covers:
    the --tree override, else every configured file datasource's
    index tree."""
    from . import integrity as mod_integrity
    if opts.tree:
        return [(None, opts.tree)]
    try:
        trees = mod_integrity.configured_index_trees()
    except DNError as e:
        fatal(e)
    if not trees:
        fatal(DNError('no index trees configured (and no --tree '
                      'given)'))
    return trees


def cmd_rollup(ctx, argv):
    """`dn rollup [--tree T] [--interval hour|day]`: build/refresh
    the multi-resolution rollup shards (day-from-hour, month-from-
    day/hour; rollup.py) for the interval's fine tree — merging
    EXISTING index shards, no raw rescan — and publish them through
    the two-phase journal + integrity catalog.  The query planner
    then answers wide-window queries from the coarsest covering
    shard set, byte-identically.  Host work: no device is touched."""
    from . import rollup as mod_rollup
    opts = dn_parse_args(argv, ['tree', 'interval'])
    check_arg_count(opts, 0)
    if opts.interval not in ('hour', 'day'):
        fatal(DNError('interval not supported: "%s"' % opts.interval))
    total = {'built': 0, 'fresh': 0, 'removed': 0}
    for dsname, root in _integrity_trees(opts):
        try:
            doc = mod_rollup.build_rollups(root, opts.interval)
        except (DNError, OSError) as e:
            fatal(e if isinstance(e, DNError) else DNError(str(e)))
        for k in total:
            total[k] += doc[k]
        if doc['paused']:
            sys.stderr.write('dn rollup: paused under resource '
                             'pressure (tree "%s")\n' % root)
    sys.stderr.write('dn rollup: %d shard(s) built, %d fresh, '
                     '%d removed\n' % (total['built'], total['fresh'],
                                       total['removed']))
    return 0


def cmd_compact(ctx, argv):
    """`dn compact [--tree T] [--interval hour|day] [--min-gens N]`:
    rewrite base shards + their `dn follow --append` mini-generations
    into single shards (rollup.compact_tree).  The consumed
    generations are deleted through the publish commit record —
    crash-safe at every instant.  Host work: no device is touched."""
    from . import rollup as mod_rollup
    opts = dn_parse_args(argv, ['tree', 'interval', 'min-gens'])
    check_arg_count(opts, 0)
    if opts.interval not in ('hour', 'day'):
        fatal(DNError('interval not supported: "%s"' % opts.interval))
    min_gens = 1
    if opts.min_gens is not None:
        try:
            min_gens = int(opts.min_gens)
            if min_gens < 1:
                raise ValueError(opts.min_gens)
        except ValueError:
            raise UsageError('bad value for "min-gens": "%s"'
                             % opts.min_gens)
    total = {'groups': 0, 'compacted': 0, 'generations_removed': 0}
    for dsname, root in _integrity_trees(opts):
        try:
            doc = mod_rollup.compact_tree(root, opts.interval,
                                          min_gens=min_gens)
        except (DNError, OSError) as e:
            fatal(e if isinstance(e, DNError) else DNError(str(e)))
        for k in total:
            total[k] += doc[k]
        if doc['paused']:
            sys.stderr.write('dn compact: paused under resource '
                             'pressure (tree "%s")\n' % root)
    sys.stderr.write('dn compact: %d group(s) compacted, %d '
                     'generation(s) removed\n'
                     % (total['compacted'],
                        total['generations_removed']))
    return 0


COMMANDS = {
    'datasource-add': cmd_datasource_add,
    'datasource-list': cmd_datasource_list,
    'datasource-remove': cmd_datasource_remove,
    'datasource-update': cmd_datasource_update,
    'datasource-show': cmd_datasource_show,
    'metric-add': cmd_metric_add,
    'metric-list': cmd_metric_list,
    'metric-remove': cmd_metric_remove,
    'build': cmd_build,
    'follow': cmd_follow,
    'index-config': cmd_index_config,
    'index-read': cmd_index_read,
    'index-scan': cmd_index_scan,
    'compact': cmd_compact,
    'query': cmd_query,
    'rollup': cmd_rollup,
    'scan': cmd_scan,
}


def main(argv=None, startup=None):
    """startup=(process_t0, require_seconds) from __main__ lets -t
    split module-load cost from total, like the reference's
    require-vs-total timing (bin/dn:80-83,1290-1296)."""
    if argv is None:
        argv = sys.argv[1:]

    track_time = False
    if argv and argv[0] == '-t':
        track_time = True
        argv = argv[1:]

    import time
    t0 = time.time()
    require_s = None
    if startup is not None:
        t0, require_s = startup[0], startup[1]

    rv = None
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
        rv = COMMANDS[cmdname](ctx, argv[1:])
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

    if track_time:
        sys.stderr.write('timing stats:\n')
        if require_s is not None:
            sys.stderr.write('    require:  %.3fs\n' % require_s)
        sys.stderr.write('    total:    %.3fs\n' % (time.time() - t0))
    # `follow` returns its exit code
    return rv if isinstance(rv, int) else 0
