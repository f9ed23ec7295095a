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
`index-config`; and the resident server: `serve` (serve/server.py, on
DN_TORCH_DEVICE), `stats` and `events`, with `--remote` and `--trace`
on `scan`, `query` and `build`.  Option parsing, breakdown expansion,
warnings (`--warnings`), output and the `-t` timing flag are the
reference CLI's, so the port prints byte-identical results and writes
byte-identical index trees, locally and over `--remote`.  `--assetroot`
on `query`, the cluster options of `serve` and `stats --cluster` are
not ported: the first is an unknown option (a usage error), the others
fail naming what is missing.  The configuration is the same file as
bin/dn's ($DRAGNET_CONFIG or ~/.dragnetrc).

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

dn datasource-add    [--backend=file|cluster] --path=DATA_PATH
                     [--index-path=INDEX_PATH] [--filter=FILTER]
                     [--time-field=FIELD] [--time-format=TIME_FORMAT]
                     [--data-format=json|json-skinner] DATASOURCE
dn datasource-update [--backend=file|cluster] [--path=DATA_PATH]
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
                     [--build-threads=auto|N]
                     [--remote=SOCKET|HOST:PORT] [--trace] DATASOURCE
dn query             [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]] [--interval=hour|day|all]
                     [--raw] [--points] [--counters] [--gnuplot]
                     [--dry-run] [--iq-threads=auto|N] [--iq-stack=auto|0|1]
                     [--remote=SOCKET|HOST:PORT] [--trace]
                     DATASOURCE
dn scan              [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]]
                     [--raw] [--points] [--counters] [--warnings] [--dry-run]
                     [--gnuplot] [--parse=auto|host|vector|device]
                     [--remote=SOCKET|HOST:PORT] [--trace]
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
dn serve             --socket=PATH | --port=N [--pidfile=PATH] [--validate]
dn stats             [--remote=SOCKET|HOST:PORT] [--prom]
dn events            [--remote=SOCKET|HOST:PORT] [--follow]

scan, build, index-scan, query and follow run on DN_TORCH_DEVICE
(default: cuda) with the engine DN_ENGINE names: auto (the default: the
multithreaded host engine, the device taking the stream over once it
wins an audition), jax (the device from the first batch), vector (the
host engine) or host (the per-record engine).  DN_PARSE or --parse picks the
parse lane of scan and build: auto (the C++ parser, or the byte lane
without it), host, vector (the byte lane) or device (the byte lane with
its quote-parity scan on DN_TORCH_DEVICE).  serve runs every request on
DN_TORCH_DEVICE; --remote ships scan, query and build to it.
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
    # `dn serve --cluster=TOPOLOGY.json --member=NAME`: parsed so the
    # refusal names what is missing (the cluster is not ported)
    (['cluster'], 'string', None),
    (['counters'], 'bool', None),
    (['data-format'], 'string', 'json'),
    (['dry-run', 'n'], 'bool', False),
    (['filter', 'f'], 'string', None),
    # `dn events --follow`: keep polling the remote journal
    (['follow'], 'bool', None),
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
    (['member'], 'string', None),
    (['min-gens'], 'string', None),
    # `dn follow` catch-up mode: ingest to the sources' current EOF,
    # publish, checkpoint, and exit instead of tailing forever
    (['once'], 'bool', None),
    (['parse'], 'string', None),
    (['path'], 'string', None),
    # `dn serve` endpoint options and the data commands' --remote
    # endpoint (a unix socket path or HOST:PORT)
    (['pidfile'], 'string', None),
    (['points'], 'bool', None),
    (['port'], 'string', None),
    # `dn stats --prom`: the Prometheus text exposition
    (['prom'], 'bool', None),
    (['raw'], 'bool', None),
    (['remote'], 'string', None),
    (['socket'], 'string', None),
    (['time-field'], 'string', None),
    (['time-format'], 'string', None),
    # `dn rollup` / `dn compact`: limit the walk to one index root
    (['tree'], 'string', None),
    # one JSON span tree per data command on stderr (DN_TRACE=stderr
    # for one run); composes with --remote — the client ships its
    # trace id and grafts the server's spans
    (['trace'], 'bool', None),
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

def dn_query_doc(opts):
    """The query document parsed options produce — query_load's input
    here, and the document `--remote` ships so the server's
    query_load yields the identical QueryConfig."""
    queryconfig = {'breakdowns': opts.breakdowns}
    if opts.after:
        queryconfig['timeAfter'] = opts.after
    if opts.before:
        queryconfig['timeBefore'] = opts.before
    if opts.filter is not None:
        queryconfig['filter'] = opts.filter
    return queryconfig


def dn_query_config(opts):
    qc = mod_query.query_load(dn_query_doc(opts))
    if isinstance(qc, DNError):
        fatal(qc)
    if getattr(opts, 'gnuplot', None) and len(qc.qc_breakdowns) != 1:
        fatal(DNError(
            '--gnuplot can only be used with exactly one breakdown'))
    return qc


def dn_output(query, opts, result, dsname):
    """(reference: bin/dn:924-967)"""
    # multi-process runs: every process computes the whole result (the
    # allgather), but only process 0 prints it.  Dry-run plans print
    # everywhere: each process's plan shows ITS partition.
    if result.dry_run_files is None:
        from .parallel import distributed as mod_dist
        if not mod_dist.is_output_process():
            return

    if result.dry_run_files is not None:
        plan = getattr(result, 'dry_run_plan', None)
        if plan is not None:
            # cluster backend: the execution plan, then the inputs (the
            # reference printed its Manta job JSON the same way)
            import json as mod_json
            partition = plan.get('partition', [])
            head = {k: v for k, v in plan.items() if k != 'partition'}
            sys.stderr.write(mod_json.dumps(head, indent=4) + '\n')
            sys.stderr.write('\nInputs:\n')
            for path in partition:
                sys.stderr.write('%s\n' % path)
            return
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


def _obs_command(op, opts):
    """Observability scope for one data command: installs a request
    trace context when asked (--trace, DN_TRACE, DN_SLOW_MS) —
    emitting one JSON span-tree line at command end — and nothing at
    all otherwise (output stays byte-identical: tracing writes to the
    DN_TRACE sink / process stderr only when armed).  --trace is
    DN_TRACE=stderr for one run, without clobbering an explicit
    DN_TRACE target."""
    import contextlib
    from .obs import trace as obs_trace

    @contextlib.contextmanager
    def scope():
        explicit = bool(getattr(opts, 'trace', None))
        value = 'stderr' if explicit and \
            not os.environ.get('DN_TRACE') else None
        with _env_scope('DN_TRACE', value):
            if explicit or obs_trace.tracing_requested():
                with obs_trace.request(op):
                    yield
            else:
                yield
    return scope()


# ---------------------------------------------------------------------------
# Remote execution (`--remote SOCK` -> a resident `dn serve`)
# ---------------------------------------------------------------------------

def _remote_output_opts(opts):
    return {
        'raw': bool(getattr(opts, 'raw', None)),
        'points': bool(getattr(opts, 'points', None)),
        'counters': bool(getattr(opts, 'counters', None)),
        'gnuplot': bool(getattr(opts, 'gnuplot', None)),
        'dry_run': bool(getattr(opts, 'dry_run', None)),
    }


# per-run execution-mode flags that scope a process-local env var for
# one command: they cannot travel to a shared server (whose process
# env governs every request), and silently dropping them would be a
# behavior change the user explicitly asked against
_LOCAL_ONLY_FLAGS = [('warnings', '--warnings'), ('parse', '--parse'),
                     ('iq_threads', '--iq-threads'),
                     ('iq_stack', '--iq-stack'),
                     ('build_threads', '--build-threads')]


def _try_remote(ctx, opts, req):
    """Ship `req` to opts.remote.  Returns the remote exit code, or
    None after the unreachable-fallback warning (the caller then runs
    the command locally, on this process's device).  Local-only flags
    must not silently go remote."""
    for attr, flag in _LOCAL_ONLY_FLAGS:
        if getattr(opts, attr, None):
            raise UsageError(
                '"%s" cannot be combined with "--remote"' % flag)
    req['config'] = ctx['backend'].cbl_path
    if req.get('op') == 'build':
        # builds are not idempotent: the key lets the transport
        # layer's retry loop re-send safely — the server replays the
        # recorded response instead of double-writing (serve/client.py)
        import uuid
        req['idempotency'] = uuid.uuid4().hex
    from .serve import client as mod_serve_client
    try:
        return mod_serve_client.run_or_fallback(opts.remote, req)
    except DNError as e:
        # transport retries exhausted or a post-commit failure: the
        # server may have acted and bytes may already be on stdout, so
        # neither another retry nor a local fallback is safe — report
        fatal(e)


def cmd_scan(ctx, argv):
    opts = dn_parse_args(argv, ['before', 'after', 'filter', 'breakdowns',
                                'raw', 'points', 'counters', 'warnings',
                                'gnuplot', 'dry-run', 'parse', 'remote',
                                'trace'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    query = dn_query_config(opts)
    with _obs_command('scan', opts):
        if opts.remote:
            rc = _try_remote(ctx, opts, {
                'op': 'scan', 'ds': dsname,
                'queryconfig': dn_query_doc(opts),
                'opts': _remote_output_opts(opts),
            })
            if rc is not None:
                return rc
        warn_func = _warn_printer if getattr(opts, 'warnings', None) \
            else None
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
                                'iq-stack', 'remote', 'trace'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    query = dn_query_config(opts)
    with _obs_command('query', opts):
        if opts.remote:
            rc = _try_remote(ctx, opts, {
                'op': 'query', 'ds': dsname,
                'interval': opts.interval,
                'queryconfig': dn_query_doc(opts),
                'opts': _remote_output_opts(opts),
            })
            if rc is not None:
                return rc
        with _pool_flag_env('iq-threads', opts.iq_threads,
                            'DN_IQ_THREADS'), \
                _mode_flag_env('iq-stack', opts.iq_stack, 'DN_IQ_STACK',
                               ('auto', '0', '1')):
            try:
                result = ds.query(query, opts.interval,
                                  dry_run=opts.dry_run, device=_device(),
                                  engine=_engine())
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
                                'assetroot', 'build-threads', 'parse',
                                'remote', 'trace'])
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
    with _obs_command('build', opts):
        if opts.remote:
            rc = _try_remote(ctx, opts, {
                'op': 'build', 'ds': dsname,
                'interval': opts.interval,
                'before': opts.before, 'after': opts.after,
                'index_config': indexcfg,
                'opts': _remote_output_opts(opts),
            })
            if rc is not None:
                return rc
        return _build_local(opts, ds, metrics, dsname)


def _build_local(opts, ds, metrics, dsname):
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
    from .parallel import distributed as mod_dist
    if mod_dist.is_output_process():
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


# ---------------------------------------------------------------------------
# The resident server: serve / stats / events
# ---------------------------------------------------------------------------

def _remote_bytes(remote, req, timeout_s):
    from .serve import client as mod_serve_client
    try:
        return mod_serve_client.request_bytes(remote, req,
                                              timeout_s=timeout_s)
    except (OSError, ValueError, DNError) as e:
        fatal(DNError('serve endpoint "%s" unreachable' % remote,
                      cause=DNError(str(e))))


def cmd_stats(ctx, argv):
    """`dn stats [--remote SOCK|HOST:PORT] [--prom]`: a resident
    server's /stats document (or its Prometheus exposition with
    --prom); without --remote, this process's own metrics registry.
    `--cluster` (the merged fleet document) needs serve/fleet.py, which
    is not ported: it fails saying so."""
    import json as mod_json
    argv = list(argv)
    if '--cluster' in argv:
        fatal(DNError('"stats --cluster" is not ported to '
                      'dragnet_tpu_torch (it needs serve/fleet.py)'))
    opts = dn_parse_args(argv, ['remote', 'prom'])
    check_arg_count(opts, 0)
    if opts.remote:
        op = 'metrics' if getattr(opts, 'prom', None) else 'stats'
        rc, header, out, err = _remote_bytes(opts.remote, {'op': op},
                                             30.0)
        sys.stderr.write(err.decode('utf-8', 'replace'))
        sys.stdout.write(out.decode('utf-8', 'replace'))
        return rc
    from . import vpipe as mod_vpipe
    from .obs import export as obs_export
    counters = mod_vpipe.global_counters()
    if getattr(opts, 'prom', None):
        sys.stdout.write(obs_export.prometheus_text(counters=counters))
        return 0
    doc = obs_export.stats_section(counters=counters)
    sys.stdout.write(mod_json.dumps(doc, sort_keys=True, indent=2) + '\n')
    return 0


def cmd_events(ctx, argv):
    """`dn events [--follow] [--remote SOCK|HOST:PORT]`: the structured
    event journal (obs/events.py), one JSON line per entry.  --remote
    reads a resident server's journal through the `events` op;
    --follow keeps polling and prints new entries as they land (the
    server's journal is armed by DN_EVENTS / DN_EVENTS_FILE).  Without
    --remote, this process's own journal."""
    import json as mod_json
    import time as mod_time
    opts = dn_parse_args(argv, ['remote', 'follow'])
    check_arg_count(opts, 0)
    obs_conf = mod_config.obs_config()
    if isinstance(obs_conf, DNError):
        fatal(obs_conf)

    def emit_lines(entries):
        for e in entries:
            sys.stdout.write(mod_json.dumps(
                e, sort_keys=True, separators=(',', ':')) + '\n')
        if entries:
            sys.stdout.flush()

    if not opts.remote:
        from .obs import events as obs_events
        j = obs_events.journal()
        if j is None:
            sys.stderr.write('dn: event journal disabled (set '
                             'DN_EVENTS or DN_EVENTS_FILE)\n')
            return 1
        emit_lines(j.tail())
        return 0

    since = 0
    poll_s = max(0.1, obs_conf['top_interval_ms'] / 1000.0)
    while True:
        rc, header, out, err = _remote_bytes(
            opts.remote, {'op': 'events', 'since': since}, 30.0)
        if rc != 0:
            sys.stderr.write(err.decode('utf-8', 'replace'))
            return rc
        doc = mod_json.loads(out.decode('utf-8'))
        if not doc.get('enabled'):
            sys.stderr.write('dn: event journal disabled on the server '
                             '(set DN_EVENTS or DN_EVENTS_FILE)\n')
            return 1
        entries = doc.get('events') or []
        emit_lines(entries)
        since = max([doc.get('seq') or 0] +
                    [e.get('seq') or 0 for e in entries])
        if not getattr(opts, 'follow', None):
            return 0
        try:
            mod_time.sleep(poll_s)
        except KeyboardInterrupt:
            return 0


def _serve_configs():
    """Every knob `dn serve` reads, validated (a malformed value is
    fatal), and the unported ones refused."""
    from .serve import server as mod_server
    confs = {}
    for name, fn in (('serve', mod_config.serve_config),
                     ('remote', mod_config.remote_config),
                     ('faults', mod_config.faults_config),
                     ('obs', mod_config.obs_config),
                     ('integrity', mod_config.integrity_config),
                     ('resources', mod_config.resources_config),
                     ('device', mod_config.device_config),
                     ('index_device', mod_config.index_device_config)):
        conf = fn()
        if isinstance(conf, DNError):
            fatal(conf)
        confs[name] = conf
    err = mod_server.check_unported_knobs(confs['integrity'],
                                          confs['obs'])
    if err is not None:
        fatal(err)
    return confs


def cmd_serve(ctx, argv):
    """`dn serve --socket PATH | --port N [--pidfile P] [--validate]`:
    the resident single-member server (serve/server.py) on
    DN_TORCH_DEVICE (CUDA unless it says cpu).  `--cluster`/`--member`
    (and DN_SERVE_TOPOLOGY) need the cluster modules, which are not
    ported: they fail saying so."""
    from .ops import resolve_device
    opts = dn_parse_args(argv, ['socket', 'port', 'pidfile', 'cluster',
                                'member', 'validate'])
    check_arg_count(opts, 0)
    confs = _serve_configs()
    if opts.cluster or opts.member or os.environ.get('DN_SERVE_TOPOLOGY'):
        fatal(DNError('"serve --cluster/--member" is not ported to '
                      'dragnet_tpu_torch (it needs the cluster router '
                      'and topology, serve/router.py and '
                      'serve/topology.py)'))
    port = None
    if opts.port is not None:
        try:
            port = int(opts.port)
            if not 0 <= port <= 65535:
                raise ValueError(opts.port)
        except ValueError:
            raise UsageError('bad value for "port": "%s"' % opts.port)
    if (opts.socket is None) == (port is None):
        raise UsageError(
            'exactly one of "--socket" and "--port" is required')
    try:
        device = str(resolve_device(_device()))
    except DNError as e:
        fatal(e)

    if getattr(opts, 'validate', None):
        # dry mode: the knobs and the endpoint arguments were just
        # validated through the same paths the daemon and client use;
        # report the resolved configuration and exit without binding
        from . import device_scan as mod_ds
        from . import scan_mt as mod_scan_mt
        conf, remote_conf = confs['serve'], confs['remote']
        obs_conf, integ_conf = confs['obs'], confs['integrity']
        res_conf, dev_conf = confs['resources'], confs['device']
        iq_conf = confs['index_device']
        w = sys.stdout.write
        w('serve config ok: max_inflight=%d queue_depth=%d '
          'deadline_ms=%d coalesce=%d drain_s=%d\n'
          % (conf['max_inflight'], conf['queue_depth'],
             conf['deadline_ms'], 1 if conf['coalesce'] else 0,
             conf['drain_s']))
        w('serve front-end ok: read_deadline_ms=%d write_deadline_ms=%d '
          'idle_ms=%d\n'
          % (conf['read_deadline_ms'], conf['write_deadline_ms'],
             conf['idle_ms']))
        w('serve tenancy ok: quota=%d default_weight=%d weights=%s\n'
          % (conf['tenant_quota'], conf['tenant_default_weight'],
             ','.join('%s:%d' % (n, v) for n, v in
                      sorted(conf['tenant_weights'].items())) or 'none'))
        w('remote config ok: retries=%d backoff_ms=%d '
          'connect_timeout_s=%d deadline_ms=%d\n'
          % (remote_conf['retries'], remote_conf['backoff_ms'],
             remote_conf['connect_timeout_s'],
             remote_conf['deadline_ms']))
        w('obs config ok: trace=%s slow_ms=%s buckets=%d\n'
          % (obs_conf['trace'] or 'off',
             obs_conf['slow_ms'] if obs_conf['slow_ms'] is not None
             else 'off', len(obs_conf['buckets'])))
        w('events ok: events=%d events_file=%s\n'
          % (obs_conf['events'], obs_conf['events_file'] or 'off'))
        w('integrity config ok: verify=%s\n' % integ_conf['verify'])
        w('resources config ok: disk_low_pct=%g disk_critical_pct=%g '
          'poll_ms=%d mem_budget_mb=%d fd_headroom=%d '
          'events_file_max_mb=%d\n'
          % (res_conf['disk_low_pct'], res_conf['disk_critical_pct'],
             res_conf['poll_ms'], res_conf['mem_budget_mb'],
             res_conf['fd_headroom'], obs_conf['events_file_max_mb']))
        apath, entries, wins = mod_ds.audition_cache_entries()
        w('device lane ok: engine=%s device=%s residency_mb=%d '
          'prewarm=%d probe_timeout_s=%d audition_cache=%s entries=%d '
          'wins=%d\n'
          % (_engine(), device, dev_conf['residency_mb'],
             1 if dev_conf['prewarm'] else 0,
             dev_conf['probe_timeout_s'], apath or 'off', entries, wins))
        w('index device lane ok: mode=%s batch_rows=%d '
          'residency_share=%.2f\n'
          % (iq_conf['mode'], iq_conf['batch_rows'],
             iq_conf['residency_share']))
        w('scan pipeline ok: pipeline_depth=%d partitions=%s '
          'scan_threads=%d\n'
          % (dev_conf['pipeline_depth'],
             '%d (auto)' % mod_scan_mt.scan_partitions()
             if dev_conf['scan_partitions'] == 'auto'
             else dev_conf['scan_partitions'],
             mod_scan_mt.scan_threads()))
        sites = confs['faults']['sites']
        if sites:
            w('faults armed: %s\n' % ' '.join(
                '%s:%s:%g:%d' % (site, k, r, seed)
                for site, (k, r, seed) in sorted(sites.items())))
        return 0

    from .serve import server as mod_server
    try:
        return mod_server.serve_main(socket_path=opts.socket, port=port,
                                     pidfile=opts.pidfile)
    except DNError as e:
        fatal(e)


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
    'serve': cmd_serve,
    'stats': cmd_stats,
    'events': cmd_events,
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
    # `follow` and the remote-executing commands return their exit code
    return rv if isinstance(rv, int) else 0
