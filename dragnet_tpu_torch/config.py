"""Dragnet configuration: immutable in-memory model + local file backend.

Counterpart of dragnet_tpu/config.py: the configuration model, its
schema-validated load and the local file backend (the serve, cluster and
device knobs are not ported).  Re-implements lib/config-common.js
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
