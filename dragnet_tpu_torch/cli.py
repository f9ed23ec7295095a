"""The port's command-line interface: `python -m dragnet_tpu_torch`.

Counterpart of dragnet_tpu/cli.py for the commands this port covers:
`scan` (on the device, DN_TORCH_DEVICE, default cuda), `datasource-add`
and `datasource-list`.  Option parsing, breakdown expansion and output
are the reference CLI's, so `scan` prints byte-identical results.  The
configuration is the same file as bin/dn's ($DRAGNET_CONFIG or
~/.dragnetrc).

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
from . import datasource_for_name

ARG0 = 'dn'

USAGE_TEXT = """usage: python -m dragnet_tpu_torch SUBCOMMAND [OPTIONS] ARGS

dn datasource-add    [--backend=file] --path=DATA_PATH
                     [--index-path=INDEX_PATH] [--filter=FILTER]
                     [--time-field=FIELD] [--time-format=TIME_FORMAT]
                     [--data-format=json|json-skinner] DATASOURCE
dn datasource-list   [-v]

dn scan              [--before=START_TIME] [--after=END_TIME] [--filter=FILTER]
                     [--breakdowns=BREAKDOWN[,...]]
                     [--raw] [--points] [--counters] [--gnuplot]
                     DATASOURCE

scan runs on DN_TORCH_DEVICE (default: cuda).
"""

# Option table (reference: bin/dn:146-215), the subset these commands
# take.  Each entry: (names, type, default)
DN_OPTIONS = [
    (['after', 'A'], 'date', None),
    (['backend'], 'string', None),
    (['before', 'B'], 'date', None),
    (['breakdowns', 'b'], 'arrayOfString', []),
    (['counters'], 'bool', None),
    (['data-format'], 'string', 'json'),
    (['filter', 'f'], 'string', None),
    (['gnuplot'], 'bool', None),
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


# ---------------------------------------------------------------------------
# scan
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


def cmd_scan(ctx, argv):
    opts = dn_parse_args(argv, ['before', 'after', 'filter', 'breakdowns',
                                'raw', 'points', 'counters', 'gnuplot'])
    check_arg_count(opts, 1)
    dsname = opts._args[0]
    ds = datasource_for_name(ctx['config'], dsname)
    if isinstance(ds, DNError):
        fatal(ds)
    query = dn_query_config(opts)
    device = os.environ.get('DN_TORCH_DEVICE') or 'cuda'
    try:
        result = ds.scan(query, device=device)
    except DNError as e:
        fatal(e)
    dn_output(query, opts, result, dsname)


COMMANDS = {
    'datasource-add': cmd_datasource_add,
    'datasource-list': cmd_datasource_list,
    'scan': cmd_scan,
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
