"""Dragnet configuration: immutable in-memory model + local file backend.

Counterpart of dragnet_tpu/config.py: the configuration model, its
schema-validated load, the local file backend, and the knobs the index
build reads: DN_DISK_* (resources_config) and DN_FAULTS (faults_config).
The serve, cluster and device knobs are not ported.  Re-implements lib/config-common.js
(clone-on-write DragnetConfig, versioned vmaj/vmin 0.0, schema-validated
load) and lib/config-local.js (JSON file at $DRAGNET_CONFIG or
~/.dragnetrc, atomic tmp+rename save), so the port and bin/dn read and
write the same file.
"""

import copy
import os

from .errors import DNError
from . import jsvalues as jsv
from . import query as mod_query

CONFIG_MAJOR = 0
CONFIG_MINOR = 0


class DragnetConfig(object):
    def __init__(self):
        # dsname -> {ds_backend, ds_backend_config, ds_filter, ds_format}
        self.dc_datasources = {}
        # dsname -> {metname -> Metric}
        self.dc_metrics = {}

    def clone(self):
        rv = DragnetConfig()
        rv.dc_datasources = copy.deepcopy(self.dc_datasources)
        rv.dc_metrics = {
            ds: {name: mod_query.metric_deserialize(
                     mod_query.metric_serialize(m))
                 for name, m in mets.items()}
            for ds, mets in self.dc_metrics.items()
        }
        return rv

    def datasource_add(self, dsconfig):
        if dsconfig['name'] in self.dc_datasources:
            return DNError('datasource "%s" already exists'
                           % dsconfig['name'])
        dc = self.clone()
        dc.dc_datasources[dsconfig['name']] = {
            'ds_backend': dsconfig['backend'],
            'ds_backend_config': dict(dsconfig['backend_config']),
            'ds_filter': dsconfig.get('filter'),
            'ds_format': dsconfig.get('dataFormat'),
        }
        return dc

    def datasource_update(self, dsname, update):
        if dsname not in self.dc_datasources:
            return DNError('datasource "%s" does not exist' % dsname)
        dc = self.clone()
        config = dc.dc_datasources[dsname]
        if update.get('backend'):
            config['ds_backend'] = update['backend']
        if update.get('filter') is not None:
            config['ds_filter'] = update['filter']
        if update.get('dataFormat'):
            config['ds_format'] = update['dataFormat']
        bc = update.get('backend_config')
        if bc:
            target = config['ds_backend_config']
            for key in ('path', 'indexPath', 'timeFormat', 'timeField'):
                if bc.get(key):
                    target[key] = bc[key]
        return dc

    def datasource_remove(self, dsname):
        if dsname not in self.dc_datasources:
            return DNError('datasource "%s" does not exist' % dsname)
        dc = self.clone()
        del dc.dc_datasources[dsname]
        return dc

    def datasource_get(self, dsname):
        return self.dc_datasources.get(dsname)

    def datasource_list(self):
        return list(self.dc_datasources.items())

    def metric_add(self, metconfig):
        dsname = metconfig['datasource']
        if dsname in self.dc_metrics and \
                metconfig['name'] in self.dc_metrics[dsname]:
            return DNError('metric "%s" already exists' % metconfig['name'])
        dc = self.clone()
        dc.dc_metrics.setdefault(dsname, {})
        dc.dc_metrics[dsname][metconfig['name']] = \
            mod_query.metric_deserialize(metconfig)
        return dc

    def metric_remove(self, dsname, metname):
        if dsname not in self.dc_metrics or \
                metname not in self.dc_metrics[dsname]:
            return DNError('datasource "%s" metric "%s" does not exist'
                           % (dsname, metname))
        dc = self.clone()
        del dc.dc_metrics[dsname][metname]
        return dc

    def metric_get(self, dsname, metname):
        if dsname not in self.dc_metrics:
            return None
        return self.dc_metrics[dsname].get(metname)

    def datasource_list_metrics(self, dsname):
        assert dsname in self.dc_datasources
        if dsname not in self.dc_metrics:
            return []
        return list(self.dc_metrics[dsname].items())

    def serialize(self):
        rv = {
            'vmaj': CONFIG_MAJOR,
            'vmin': CONFIG_MINOR,
            'datasources': [],
            'metrics': [],
        }
        for dsname, ds in self.dc_datasources.items():
            bc = {k: v for k, v in ds['ds_backend_config'].items()
                  if v is not None}
            entry = {
                'name': dsname,
                'backend': ds['ds_backend'],
                'backend_config': bc,
                'filter': ds['ds_filter'],
            }
            # JSON.stringify drops undefined values: an unset
            # dataFormat is absent, not null (the schema types it as a
            # string when present; reference bin/dn:348)
            if ds['ds_format'] is not None:
                entry['dataFormat'] = ds['ds_format']
            rv['datasources'].append(entry)
            for metname, m in self.datasource_list_metrics(dsname):
                rv['metrics'].append(mod_query.metric_serialize(m))
        return rv


def create_initial_config():
    return load_config({
        'vmaj': CONFIG_MAJOR,
        'vmin': CONFIG_MINOR,
        'datasources': [],
        'metrics': [],
    })


# --- schema validation (models lib/config-common.js:19-108, whose
# jsprim.validateJsonObject wraps the json-schema library: the FIRST
# violation becomes 'property "<path>": <reason>' with json-schema's
# message strings — 'is missing and it is required' for a missing
# required property, '<typeof> value found, but a <type> is required'
# for a type mismatch) -------------------------------------------------

def _js_typeof(v):
    """JS typeof for the values JSON can produce (null and arrays are
    'object', like typeof in JS)."""
    if isinstance(v, bool):
        return 'boolean'
    if isinstance(v, (int, float)):
        return 'number'
    if isinstance(v, str):
        return 'string'
    return 'object'


def _check_type(v, typ, path):
    """json-schema checkType subset: 'string' | 'number' | 'object' |
    'array'.  Mirrors the library's JS-typeof semantics: null passes an
    'object' check (typeof null === 'object'), arrays do not."""
    if typ == 'string':
        ok = isinstance(v, str)
    elif typ == 'number':
        ok = isinstance(v, (int, float)) and not isinstance(v, bool)
    elif typ == 'array':
        ok = isinstance(v, list)
    else:  # object
        ok = v is None or isinstance(v, dict)
    if ok:
        return None
    return 'property "%s": %s value found, but a %s is required' \
        % (path, _js_typeof(v), typ)


def _check_props(value, props, path):
    """Validate an object's properties ((name, type, required) in
    schema order); returns the first violation string or None."""
    for name, typ, required in props:
        p = path + '.' + name if path else name
        if not isinstance(value, dict) or name not in value:
            if required:
                return 'property "%s": is missing and it is required' \
                    % p
            continue
        err = _check_type(value[name], typ, p)
        if err is not None:
            return err
    return None


def _check_array_of_objects(value, items_props, path):
    for i, item in enumerate(value):
        p = '%s[%d]' % (path, i)
        if not isinstance(item, dict):
            return 'property "%s": %s value found, but a object is ' \
                'required' % (p, _js_typeof(item))
        err = _check_props(item, items_props, p)
        if err is not None:
            return err
    return None


_DS_PROPS = [
    ('name', 'string', True),
    ('backend', 'string', True),
    ('backend_config', 'object', True),
    ('filter', 'object', True),
    ('dataFormat', 'string', False),
]

_BREAKDOWN_PROPS = [
    ('name', 'string', True),
    ('field', 'string', True),
    ('date', 'string', False),
    ('aggr', 'string', False),
    ('step', 'number', False),
]

_METRIC_PROPS = [
    ('name', 'string', True),
    ('datasource', 'string', True),
    ('filter', 'object', True),
    ('breakdowns', 'array', True),
]


def _validate_config(inp):
    """First schema violation of the whole document (the shape of
    lib/config-common.js:27-108), or None.  (vmaj was already
    gate-checked by the caller; the version gate runs first, like the
    reference's base-schema + version sequence.)"""
    err = _check_props(inp, [('vmin', 'number', True),
                             ('datasources', 'array', True),
                             ('metrics', 'array', True)], '')
    if err is not None:
        return err
    err = _check_array_of_objects(inp['datasources'], _DS_PROPS,
                                  'datasources')
    if err is not None:
        return err
    for i, met in enumerate(inp['metrics']):
        p = 'metrics[%d]' % i
        if not isinstance(met, dict):
            return 'property "%s": %s value found, but a object is ' \
                'required' % (p, _js_typeof(met))
        err = _check_props(met, _METRIC_PROPS, p)
        if err is not None:
            return err
        err = _check_array_of_objects(met['breakdowns'],
                                      _BREAKDOWN_PROPS,
                                      p + '.breakdowns')
        if err is not None:
            return err
    return None


def load_config(inp):
    if not isinstance(inp, dict):
        return DNError('failed to load config: not an object')
    vmaj = inp.get('vmaj')
    if vmaj != CONFIG_MAJOR or isinstance(vmaj, bool):
        shown = 'undefined' if 'vmaj' not in inp \
            else jsv.to_string(vmaj)
        return DNError('failed to load config: major version ("%s") '
                       'not supported' % shown)
    error = _validate_config(inp)
    if error is not None:
        return DNError('failed to load config: %s' % error)

    dc = DragnetConfig()
    for dsconfig in inp['datasources']:
        dc.dc_datasources[dsconfig['name']] = {
            'ds_backend': dsconfig['backend'],
            # typeof null === 'object' passes the schema (faithful to
            # the reference), but every consumer dereferences this as
            # a dict — coerce so a hand-edited null yields the normal
            # 'expected datasource "path"...' DNError, not a traceback
            'ds_backend_config': dsconfig['backend_config'] or {},
            'ds_filter': dsconfig.get('filter'),
            'ds_format': dsconfig.get('dataFormat'),
        }
    for metconfig in inp['metrics']:
        dsname = metconfig['datasource']
        dc.dc_metrics.setdefault(dsname, {})
        try:
            metric = mod_query.metric_deserialize(metconfig)
        except Exception as e:
            return DNError('failed to load config: metric "%s": %s'
                           % (metconfig.get('name'), e))
        dc.dc_metrics[dsname][metconfig['name']] = metric
    return dc


# --- resource-governance knobs (DN_DISK_* / DN_SERVE_MEM_BUDGET_MB) ---
#
# Same contract as the serve/remote knobs: parsed and validated in one
# place (resources.py consumes them; `dn serve --validate` and
# `dn follow --validate` check them up front).

_RESOURCE_KNOBS = [
    # free-space watermarks (percent of the filesystem): below LOW the
    # governor pauses background disk consumers; below CRITICAL the
    # member flips read-only (queries keep serving byte-identically)
    ('DN_DISK_LOW_PCT', 'float', 10.0, 0.0),
    ('DN_DISK_CRITICAL_PCT', 'float', 5.0, 0.0),
    # statvfs/fd poll cadence for the governor
    ('DN_RESOURCE_POLL_MS', 'int', 2000, 50),
    # admission-level memory budget: the concurrent estimated request
    # footprint `dn serve` admits before shedding with retry_after_ms
    # (0 = disabled)
    ('DN_SERVE_MEM_BUDGET_MB', 'int', 0, 0),
    # minimum spare fds before the governor reports low pressure
    # (0 disables the fd check)
    ('DN_FD_HEADROOM', 'int', 64, 0),
]


def resources_config(env=None):
    """The resolved resource-governor knobs (keys: disk_low_pct,
    disk_critical_pct, poll_ms, mem_budget_mb, fd_headroom), or
    DNError on the first malformed value — the shared fail-fast
    contract `dn serve --validate` checks.  The critical watermark
    must not exceed the low one (the mode machine is ordered)."""
    if env is None:
        env = os.environ
    keys = {'DN_DISK_LOW_PCT': 'disk_low_pct',
            'DN_DISK_CRITICAL_PCT': 'disk_critical_pct',
            'DN_RESOURCE_POLL_MS': 'poll_ms',
            'DN_SERVE_MEM_BUDGET_MB': 'mem_budget_mb',
            'DN_FD_HEADROOM': 'fd_headroom'}
    rv = {}
    for name, kind, default, minimum in _RESOURCE_KNOBS:
        key = keys[name]
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        if kind == 'float':
            try:
                value = float(raw)
            except ValueError:
                value = None
            if value is None or not minimum <= value <= 100.0:
                return DNError('%s: expected a number in [%g, 100], '
                               'got "%s"' % (name, minimum, raw))
        else:
            try:
                value = int(raw)
            except ValueError:
                value = minimum - 1
            if value < minimum:
                return DNError('%s: expected an integer >= %d, '
                               'got "%s"' % (name, minimum, raw))
        rv[key] = value
    if rv['disk_critical_pct'] > rv['disk_low_pct']:
        return DNError('DN_DISK_CRITICAL_PCT (%g) must not exceed '
                       'DN_DISK_LOW_PCT (%g)'
                       % (rv['disk_critical_pct'],
                          rv['disk_low_pct']))
    return rv


# --- fault-injection spec (DN_FAULTS) ---------------------------------

def faults_config(env=None):
    """Parse + validate DN_FAULTS=site:kind:rate[:seed],...  Returns
    {'sites': {site: (kind, rate, seed)}} (empty when unset) or the
    first violation as DNError — the same contract every other knob
    follows, checked by `dn serve --validate` and raised at the first
    armed injection seam otherwise (faults.fire)."""
    if env is None:
        env = os.environ
    spec = env.get('DN_FAULTS', '')
    sites = {}
    if not spec:
        return {'sites': sites}
    from . import faults as mod_faults
    for part in spec.split(','):
        part = part.strip()
        if not part:
            continue
        fields = part.split(':')
        if len(fields) not in (3, 4):
            return DNError('DN_FAULTS: expected site:kind:rate[:seed],'
                           ' got "%s"' % part)
        site, kind, rate = fields[0], fields[1], fields[2]
        if site not in mod_faults.SITES:
            return DNError('DN_FAULTS: unknown site "%s" (known: %s)'
                           % (site, ', '.join(mod_faults.SITES)))
        if kind not in mod_faults.KINDS:
            return DNError('DN_FAULTS: unknown kind "%s" (known: %s)'
                           % (kind, ', '.join(mod_faults.KINDS)))
        try:
            ratef = float(rate)
        except ValueError:
            ratef = -1.0
        if not 0.0 < ratef <= 1.0:
            return DNError('DN_FAULTS: rate must be in (0, 1], '
                           'got "%s"' % rate)
        seed = 0
        if len(fields) == 4:
            try:
                seed = int(fields[3])
            except ValueError:
                return DNError('DN_FAULTS: seed must be an integer, '
                               'got "%s"' % fields[3])
        if site in sites:
            return DNError('DN_FAULTS: site "%s" armed twice' % site)
        sites[site] = (kind, ratef, seed)
    return {'sites': sites}


class ConfigBackendLocal(object):
    """JSON config file with atomic tmp+rename save."""

    def __init__(self, path=None):
        if path is None:
            path = os.environ.get('DRAGNET_CONFIG') or \
                os.path.join(os.environ.get('HOME', '/'), '.dragnetrc')
        self.cbl_path = path

    def load(self):
        """Returns (error, config); on error, config is a fresh initial
        config (matching the reference's loadFinish contract)."""
        try:
            with open(self.cbl_path, 'r') as f:
                data = f.read()
        except OSError as e:
            err = DNError(str(e))
            err.code = getattr(e, 'errno', None)
            err.is_enoent = isinstance(e, FileNotFoundError)
            return (err, create_initial_config())
        try:
            parsed = jsv.json_parse(data)
        except ValueError as e:
            err = DNError(str(e))
            err.is_enoent = False
            return (err, create_initial_config())
        config = load_config(parsed)
        if isinstance(config, DNError):
            config.is_enoent = False
            return (config, create_initial_config())
        return (None, config)

    def save(self, serialized):
        tmpname = self.cbl_path + '.tmp'
        with open(tmpname, 'w') as f:
            f.write(jsv.json_stringify(serialized))
        os.rename(tmpname, self.cbl_path)
