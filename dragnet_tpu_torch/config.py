"""Dragnet configuration: immutable in-memory model + local file backend.

Counterpart of dragnet_tpu/config.py: the configuration model, its
schema-validated load, the local file backend, and the knobs the index
build reads: DN_DISK_* (resources_config) and DN_FAULTS (faults_config),
the device-lane knobs (device_config), and the knobs `dn follow`
validates: DN_FOLLOW_* (follow_config) and the observability knobs
(obs_config), and the knobs `dn serve` validates: DN_SERVE_*
(serve_config), DN_REMOTE_* (remote_config), DN_VERIFY/DN_SCRUB_*
(integrity_config) and the index query's device lane
(index_device_config), and the standing-query knobs DN_SUB_*
(subscribe_config), and the cluster's DN_ROUTER_* (router_config) and
DN_TOPO_* (topo_config).
Re-implements lib/config-common.js (clone-on-write
DragnetConfig, versioned vmaj/vmin 0.0, schema-validated load) and
lib/config-local.js (JSON file at $DRAGNET_CONFIG or
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


# --- dn serve knobs (DN_SERVE_*) --------------------------------------
#
# Parsed and validated in ONE place so `dn serve` (and its --validate
# dry mode) fails fast with the shared DNError contract instead of at
# the first request.  Each entry: (env name, kind, default, minimum).

_SERVE_KNOBS = [
    # concurrent data-command executions; queue-full beyond this +
    # queue_depth is a fast 429-style DNError
    ('DN_SERVE_MAX_INFLIGHT', 'int', 4, 1),
    # requests allowed to WAIT for an execution slot before the
    # server starts rejecting ("429")
    ('DN_SERVE_QUEUE_DEPTH', 'int', 16, 0),
    # per-request wall-clock deadline; 0 disables
    ('DN_SERVE_DEADLINE_MS', 'int', 0, 0),
    # share one execution across identical/compatible in-flight
    # requests (admission.py); 0 disables
    ('DN_SERVE_COALESCE', 'bool', True, None),
    # how long a SIGTERM/SIGINT drain waits for in-flight requests
    ('DN_SERVE_DRAIN_S', 'int', 30, 0),
    # connection-front-end deadlines (serve/ioloop.py): a PARTIAL
    # request line older than this is reaped (the slow-loris bound);
    # 0 disables
    ('DN_SERVE_READ_DEADLINE_MS', 'int', 10000, 0),
    # a queued-but-unflushed response older than this closes the
    # connection (the slow-reader bound); 0 disables
    ('DN_SERVE_WRITE_DEADLINE_MS', 'int', 60000, 0),
    # a connection with no traffic and no in-flight work for this
    # long is closed (pooled peers just re-dial); 0 disables
    ('DN_SERVE_IDLE_MS', 'int', 300000, 0),
    # per-tenant queued-request cap (admission.py weighted-fair
    # queues); 0 = no per-tenant cap (the global DN_SERVE_QUEUE_DEPTH
    # still binds)
    ('DN_SERVE_TENANT_QUOTA', 'int', 0, 0),
    # fair-dequeue weight for tenants not named in
    # DN_SERVE_TENANT_WEIGHTS
    ('DN_SERVE_TENANT_DEFAULT_WEIGHT', 'int', 1, 1),
    # per-member fetch bound for the fleet_stats scatter
    # (serve/fleet.py): a dead member costs the fleet view at most
    # this long and shows up as unreachable, never a hang
    ('DN_SERVE_FLEET_TIMEOUT_S', 'int', 5, 1),
    # query-result cache byte budget (MB; serve/qcache.py): repeated
    # identical queries answer from memory, invalidated on any index
    # write and bounded against the SAME budget
    # DN_SERVE_MEM_BUDGET_MB admits requests under.  0 (the default)
    # disables the cache — byte-identical to the uncached path either
    # way.
    ('DN_SERVE_CACHE_MB', 'int', 0, 0),
]


def _parse_tenant_weights(raw):
    """DN_SERVE_TENANT_WEIGHTS spec: 'name:weight,name:weight,...'
    with integer weights >= 1.  Returns {name: weight} or DNError."""
    weights = {}
    for part in raw.split(','):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.rpartition(':')
        if not sep or not name:
            return DNError('DN_SERVE_TENANT_WEIGHTS: expected '
                           '"name:weight,...", got "%s"' % part)
        try:
            weight = int(w)
        except ValueError:
            weight = 0
        if weight < 1:
            return DNError('DN_SERVE_TENANT_WEIGHTS: weight for '
                           '"%s" must be an integer >= 1, got "%s"'
                           % (name, w))
        weights[name] = weight
    return weights


def serve_config(env=None):
    """The resolved DN_SERVE_* knob dict (keys: max_inflight,
    queue_depth, deadline_ms, coalesce, drain_s, read_deadline_ms,
    write_deadline_ms, idle_ms, tenant_quota, tenant_default_weight,
    tenant_weights, fleet_timeout_s, cache_mb), or DNError on the
    first malformed value — 'DN_SERVE_X: expected ..., got "v"'."""
    if env is None:
        env = os.environ
    rv = {}
    for name, kind, default, minimum in _SERVE_KNOBS:
        key = name[len('DN_SERVE_'):].lower()
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        if kind == 'bool':
            if raw not in ('0', '1'):
                return DNError('%s: expected 0 or 1, got "%s"'
                               % (name, raw))
            rv[key] = raw == '1'
            continue
        try:
            value = int(raw)
        except ValueError:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        if value < minimum:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    raw = env.get('DN_SERVE_TENANT_WEIGHTS')
    if raw is None or raw == '':
        rv['tenant_weights'] = {}
    else:
        weights = _parse_tenant_weights(raw)
        if isinstance(weights, DNError):
            return weights
        rv['tenant_weights'] = weights
    return rv


# --- standing-query subscription knobs (DN_SUB_*) ---------------------
#
# Same contract as the serve knobs: parsed and validated in one place
# (serve/subscribe.py consumes them; `dn serve --validate` checks them
# up front).  Each entry: (env name, kind, default, min).

_SUB_KNOBS = [
    # registered subscriptions across the process; 0 disables the
    # subsystem (subscribe requests answer a clean error)
    ('DN_SUB_MAX', 'int', 64, 0),
    # the push-coalesce latency: how long a dirty standing query
    # waits for more publishes before recomputing and pushing (the
    # target publish-to-push bound), and the cadence at which
    # cross-process writes are detected via the tree validators
    ('DN_SUB_COALESCE_MS', 'int', 250, 10),
    # unacked frames a subscriber may have outstanding before the
    # manager stops pushing to IT (degrading to one coalesced full
    # frame when its acks catch up) — the backpressure bound that
    # keeps one stalled dashboard from queueing unbounded frames
    ('DN_SUB_QUEUE_DEPTH', 'int', 4, 1),
    # deltas are only worth the patch bookkeeping when they shrink
    # the frame: send a delta only if the inserted span is at most
    # this percentage of the full payload (0 disables deltas —
    # every push is a full frame)
    ('DN_SUB_DELTA_PCT', 'int', 50, 0),
]


def subscribe_config(env=None):
    """The resolved DN_SUB_* knob dict (keys: max, coalesce_ms,
    queue_depth, delta_pct), or DNError on the first malformed value
    — 'DN_SUB_X: expected ..., got "v"'."""
    if env is None:
        env = os.environ
    rv = {}
    for name, kind, default, minimum in _SUB_KNOBS:
        key = name[len('DN_SUB_'):].lower()
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        try:
            value = int(raw)
        except ValueError:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        if value < minimum:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    return rv


# --- remote-client retry knobs (DN_REMOTE_*) --------------------------
#
# Same contract as the serve knobs: parsed and validated in one place
# (serve/client.py consumes them per request; `dn serve --validate`
# checks them up front).  Each entry: (env name, kind, default, min).

_REMOTE_KNOBS = [
    # transport retries AFTER the first attempt (pre-commit failures
    # and retryable server rejections); 0 disables retrying
    ('DN_REMOTE_RETRIES', 'int', 2, 0),
    # exponential-backoff base; attempt k sleeps ~base * 2^(k-1) with
    # +/-50% jitter
    ('DN_REMOTE_BACKOFF_MS', 'int', 50, 1),
    # connect() deadline per attempt (the overall request timeout,
    # DN_SERVE_CLIENT_TIMEOUT_S, still governs the exchange)
    ('DN_REMOTE_CONNECT_TIMEOUT_S', 'int', 5, 1),
    # end-to-end deadline attached to every shipped request (rides
    # client -> router -> member partials; the server sheds work it
    # cannot finish inside it); 0 = no deadline attached
    ('DN_REMOTE_DEADLINE_MS', 'int', 0, 0),
]


def remote_config(env=None):
    """The resolved DN_REMOTE_* knob dict (keys: retries, backoff_ms,
    connect_timeout_s, deadline_ms), or DNError on the first
    malformed value."""
    if env is None:
        env = os.environ
    rv = {}
    for name, kind, default, minimum in _REMOTE_KNOBS:
        key = name[len('DN_REMOTE_'):].lower()
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        try:
            value = int(raw)
        except ValueError:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        if value < minimum:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    return rv


# --- scatter-gather router knobs (DN_ROUTER_*) ------------------------
#
# Same contract as the serve/remote knobs: parsed and validated in one
# place (serve/router.py consumes them; `dn serve --validate` checks
# them up front).  Each entry: (env name, kind, default, min).

_ROUTER_KNOBS = [
    # member health-probe cadence (the breaker's recovery signal)
    ('DN_ROUTER_PROBE_MS', 'int', 500, 50),
    # consecutive probe/dispatch failures before a member's circuit
    # breaker opens
    ('DN_ROUTER_FAILURES', 'int', 3, 1),
    # how long an open breaker waits before allowing one half-open
    # trial request
    ('DN_ROUTER_COOLDOWN_MS', 'int', 2000, 1),
    # hedged reads: minimum delay before firing a duplicate partial
    # at the next replica (the effective delay is max(this, observed
    # p95 partial latency)); 0 disables hedging
    ('DN_ROUTER_HEDGE_MS', 'int', 0, 0),
    # per-partial-fetch wall-clock bound (a dead-but-accepting member
    # must cost the router a bounded wait, never a hang)
    ('DN_ROUTER_FETCH_TIMEOUT_S', 'int', 60, 1),
]


def router_config(env=None):
    """The resolved DN_ROUTER_* knob dict (keys: probe_ms, failures,
    cooldown_ms, hedge_ms, fetch_timeout_s, partial), or DNError on
    the first malformed value.  DN_ROUTER_PARTIAL picks the response
    contract when every replica of a partition is down: 'error' (the
    default — a clean retryable DNError naming the missing
    partitions) or 'allow' (a partial=true response merging the live
    partitions, missing ids named in the header)."""
    if env is None:
        env = os.environ
    rv = {}
    for name, kind, default, minimum in _ROUTER_KNOBS:
        key = name[len('DN_ROUTER_'):].lower()
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        try:
            value = int(raw)
        except ValueError:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        if value < minimum:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    raw = env.get('DN_ROUTER_PARTIAL')
    if raw is None or raw == '':
        rv['partial'] = 'error'
    elif raw in ('error', 'allow'):
        rv['partial'] = raw
    else:
        return DNError('DN_ROUTER_PARTIAL: expected "error" or '
                       '"allow", got "%s"' % raw)
    return rv


# --- dynamic-topology knobs (DN_TOPO_*) -------------------------------
#
# Same contract as the serve/router knobs: parsed and validated in one
# place (serve/coordinator.py and serve/rebalance.py consume them;
# `dn serve --validate` checks them up front).  Each entry: (env name,
# kind, default, min).

_TOPO_KNOBS = [
    # topology-file poll cadence for live membership: a cluster member
    # re-reads its --cluster file at this period and applies epoch
    # changes while serving.  0 (the default) disables polling — the
    # topology is static for the life of the process.
    ('DN_TOPO_POLL_MS', 'int', 0, 0),
    # per-shard-fetch wall-clock bound during partition handoff (a
    # wedged donor must cost the joiner a bounded wait, never a hang)
    ('DN_TOPO_HANDOFF_TIMEOUT_S', 'int', 120, 1),
    # per-shard retry budget across donor replicas before the handoff
    # records a failure for that shard
    ('DN_TOPO_HANDOFF_RETRIES', 'int', 2, 0),
    # rebalance planner: maximum partition moves per proposed epoch
    # (small steps keep each handoff window short)
    ('DN_TOPO_MAX_MOVES', 'int', 2, 1),
]


def topo_config(env=None):
    """The resolved DN_TOPO_* knob dict (keys: poll_ms,
    handoff_timeout_s, handoff_retries, max_moves), or DNError on the
    first malformed value — the shared fail-fast contract `dn serve
    --validate` checks."""
    if env is None:
        env = os.environ
    rv = {}
    for name, kind, default, minimum in _TOPO_KNOBS:
        key = name[len('DN_TOPO_'):].lower()
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        try:
            value = int(raw)
        except ValueError:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        if value < minimum:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    return rv


# --- shard-integrity knobs (DN_VERIFY / DN_SCRUB_*) -------------------
#
# Same contract as the serve/remote knobs: parsed and validated in one
# place (integrity.py reads DN_VERIFY forgivingly at runtime; THIS is
# where malformed values are rejected, checked up front by `dn serve`
# and `--validate`).

_SCRUB_KNOBS = [
    # background scrub cadence in `dn serve`: walk every configured
    # tree comparing bytes against the integrity catalog (and, in
    # cluster mode, run anti-entropy against co-replicas).  0 (the
    # default) disables the thread; `dn scrub` runs a pass on demand.
    ('DN_SCRUB_INTERVAL_S', 'int', 0, 1),
    # scrub read-bandwidth bound (MB/s); the scrub is a janitor and
    # must never compete with the serving path for disk.  0 =
    # unlimited.
    ('DN_SCRUB_RATE_MB_S', 'int', 64, 0),
    # quarantine byte budget (MB): past it the serve scrub timer
    # auto-evicts the OLDEST quarantined forensics until the
    # directory fits — quarantined corruption must never fill the
    # disk it was saved from.  0 (the default) keeps the manual-only
    # `dn quarantine clean` contract.
    ('DN_QUARANTINE_MAX_MB', 'int', 0, 0),
    # background rollup-build cadence in `dn serve` (rides the scrub
    # maintenance thread): refresh day/month rollup shards from the
    # fine tree this often.  0 (the default) disables; `dn rollup`
    # builds on demand.
    ('DN_ROLLUP_INTERVAL_S', 'int', 0, 1),
    # background compaction cadence in `dn serve`: fold follow
    # --append mini-generations back into their base shards this
    # often.  0 (the default) disables; `dn compact` runs on demand.
    ('DN_COMPACT_INTERVAL_S', 'int', 0, 1),
    # generations a base shard accumulates before the background
    # compactor bothers rewriting it (an on-demand `dn compact`
    # always folds from 1)
    ('DN_COMPACT_MIN_GENS', 'int', 4, 1),
]


def integrity_config(env=None):
    """The resolved integrity knobs (keys: verify, scrub_interval_s,
    scrub_rate_mb_s, quarantine_max_mb, rollup_interval_s,
    compact_interval_s, compact_min_gens), or DNError on the first
    malformed value.

    * DN_VERIFY: 'off' (default — byte-identical to the unverified
      path), 'open' (size+crc32 checked against the tree's integrity
      catalog on first shard-handle open, amortized by the handle
      cache), or 'full' (re-verified on every lease).
    """
    if env is None:
        env = os.environ
    rv = {}
    raw = env.get('DN_VERIFY')
    if raw is None or raw == '':
        rv['verify'] = 'off'
    elif raw in ('off', 'open', 'full'):
        rv['verify'] = raw
    else:
        return DNError('DN_VERIFY: expected "off", "open" or '
                       '"full", got "%s"' % raw)
    for name, kind, default, minimum in _SCRUB_KNOBS:
        key = name[len('DN_'):].lower()
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        try:
            value = int(raw)
        except ValueError:
            value = None
        if value is None or (value != 0 and value < minimum) or \
                value < 0:
            return DNError('%s: expected 0 or an integer >= %d, '
                           'got "%s"' % (name, minimum, raw))
        rv[key] = value
    return rv


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


# --- device-lane knobs (pipeline, probe/audition tuning) ---
#
# The reference's contract for the device knobs the port reads: parsed
# and validated in one place.  device_scan and scan_mt read the env
# forgivingly at run time (a malformed value reads as the default
# there); the CLI calls device_config before a command reaches the
# device, so a malformed value is rejected with the shared DNError
# contract instead; `dn serve --validate` checks them up front.  The
# reference's padding floor (DN_DEVICE_BATCH_FLOOR) has no reader in the
# port.

_DEVICE_KNOBS = [
    # (env name, key, kind, default, minimum)
    # device-memory byte budget for serve-time residency (pinned
    # accumulators and shard tensors, serve/residency.py); 0 disables
    # — the device lane uploads and fetches per request
    ('DN_DEVICE_RESIDENCY_MB', 'residency_mb', 'int', 0, 0),
    # run the K7a launches of the prewarm shapes and report the
    # audition cache at serve bind, before the first request
    ('DN_DEVICE_PREWARM', 'prewarm', 'bool', True, None),
    # hard deadline for backend probes (device_scan.probe_deadline_s)
    ('DN_DEVICE_PROBE_TIMEOUT', 'probe_timeout_s', 'int', 420, 1),
    # wall-clock freshness of persisted audition verdicts
    ('DN_AUDITION_TTL_S', 'audition_ttl_s', 'int', 86400, 0),
    # in-flight dispatch window of the pipelined device scan (2 =
    # double buffering: upload batch N+1 while batch N folds)
    ('DN_DEVICE_PIPELINE_DEPTH', 'pipeline_depth', 'int', 2, 1),
    # radix partition count for the MT merge (scan_mt); 'auto' = up
    # to 8, bounded by CPU count
    ('DN_SCAN_PARTITIONS', 'scan_partitions', 'intauto', 'auto', 1),
]


def device_config(env=None):
    """The resolved device-lane knobs (keys: residency_mb, prewarm,
    probe_timeout_s, audition_ttl_s, pipeline_depth, scan_partitions),
    or DNError on the first malformed value."""
    if env is None:
        env = os.environ
    rv = {}
    for name, key, kind, default, minimum in _DEVICE_KNOBS:
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        if kind == 'bool':
            low = raw.strip().lower()
            if low in ('1', 'true', 'yes', 'on'):
                rv[key] = True
            elif low in ('0', 'false', 'no', 'off'):
                rv[key] = False
            else:
                return DNError('%s: expected a boolean (0/1), got '
                               '"%s"' % (name, raw))
            continue
        if kind == 'intauto' and raw.strip().lower() == 'auto':
            rv[key] = 'auto'
            continue
        try:
            value = int(raw)
        except ValueError:
            value = minimum - 1
        if value < minimum:
            if kind == 'intauto':
                return DNError("%s: expected 'auto' or an integer "
                               '>= %d, got "%s"' % (name, minimum,
                                                    raw))
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    return rv


def index_device_config(env=None):
    """The resolved index-query device-lane knobs (keys: mode,
    batch_rows, residency_share), or DNError on the first malformed
    value — validated up front like device_config; device_index.py
    and serve/residency.py read the env forgivingly at runtime.

    * DN_INDEX_DEVICE: 'auto' (default; DN_ENGINE=jax engages, auto
      escalates on a persisted audition win), '1' (force the device
      lane), '0' (pin the host bincount).
    * DN_INDEX_DEVICE_BATCH_ROWS: padded-row budget per slot-packed
      dispatch (>= 4096; how many shards merge per launch).
    * DN_INDEX_RESIDENCY_SHARE: fraction [0, 1] of the HBM residency
      budget pinned shard tensors may occupy (accumulator pins own
      the rest)."""
    if env is None:
        env = os.environ
    rv = {}
    raw = env.get('DN_INDEX_DEVICE')
    if raw is None or raw == '':
        rv['mode'] = 'auto'
    elif raw in ('auto', '0', '1'):
        rv['mode'] = raw
    else:
        return DNError("DN_INDEX_DEVICE: expected 'auto', '0' or "
                       "'1', got \"%s\"" % raw)
    raw = env.get('DN_INDEX_DEVICE_BATCH_ROWS')
    if raw is None or raw == '':
        rv['batch_rows'] = 1 << 20
    else:
        try:
            value = int(raw)
        except ValueError:
            value = -1
        if value < 4096:
            return DNError('DN_INDEX_DEVICE_BATCH_ROWS: expected an '
                           'integer >= 4096, got "%s"' % raw)
        rv['batch_rows'] = value
    raw = env.get('DN_INDEX_RESIDENCY_SHARE')
    if raw is None or raw == '':
        rv['residency_share'] = 0.5
    else:
        try:
            value = float(raw)
        except ValueError:
            value = -1.0
        if not 0.0 <= value <= 1.0:
            return DNError('DN_INDEX_RESIDENCY_SHARE: expected a '
                           'fraction in [0, 1], got "%s"' % raw)
        rv['residency_share'] = value
    return rv


# --- continuous-ingest knobs (DN_FOLLOW_*) ----------------------------
#
# Parsed and validated in one place (follow/loop.py consumes them;
# `dn follow` checks them up front, and `--validate` prints them).
# Each entry: (env name, kind, default, min).

_FOLLOW_KNOBS = [
    # target mini-batch latency: a pending batch is cut once its
    # oldest bytes are this old (StreamBox-HBM's target-latency
    # batching); 0 cuts as soon as any complete line is pending
    ('DN_FOLLOW_LATENCY_MS', 'int', 500, 0),
    # byte budget: a pending batch is cut early once it holds this
    # many bytes, whatever its age
    ('DN_FOLLOW_MAX_BYTES', 'int', 4 << 20, 1),
    # idle poll cadence when no source produced new bytes
    ('DN_FOLLOW_POLL_MS', 'int', 50, 1),
    # append mode: land each batch as a mini-generation
    # (`<shard>.sqlite-gNNNNNN`) next to its base shard instead of
    # read-modify-rewriting the whole shard — O(batch) publishes;
    # the background compactor (`dn compact`, DN_COMPACT_INTERVAL_S)
    # folds generations back into one file
    ('DN_FOLLOW_APPEND', 'bool', False, None),
]


def follow_config(env=None):
    """The resolved DN_FOLLOW_* knob dict (keys: latency_ms,
    max_bytes, poll_ms, append), or DNError on the first malformed
    value — the shared fail-fast contract `dn follow --validate`
    checks."""
    if env is None:
        env = os.environ
    rv = {}
    for name, kind, default, minimum in _FOLLOW_KNOBS:
        key = name[len('DN_FOLLOW_'):].lower()
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        if kind == 'bool':
            if raw not in ('0', '1'):
                return DNError('%s: expected 0 or 1, got "%s"'
                               % (name, raw))
            rv[key] = raw == '1'
            continue
        try:
            value = int(raw)
        except ValueError:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        if value < minimum:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    return rv


# --- observability knobs (DN_TRACE / DN_SLOW_MS / DN_METRICS_BUCKETS) -
#
# Parsed and validated in one place, checked up front by `dn follow`
# (and printed by its `--validate`); the obs runtime reads the env
# forgivingly (a live daemon must not crash on an env edit) — THIS is
# where malformed values are rejected with the shared DNError
# contract.  The port has no tracing runtime yet: DN_TRACE and
# DN_SLOW_MS are validated and reported, as bin/dn does, and otherwise
# inert.

def obs_config(env=None):
    """The resolved observability knobs (keys: trace, slow_ms,
    buckets, history_s, events, events_file, events_file_max_mb,
    top_interval_ms), or DNError on the first malformed value.

    * DN_TRACE: '' (off), 'stderr', or a trace-file path (one JSON
      span-tree line per request is appended).
    * DN_SLOW_MS: integer >= 0; requests at/over the threshold write
      their span tree to stderr.  Empty/unset disables.
    * DN_METRICS_BUCKETS: comma-separated strictly-increasing positive
      histogram upper bounds (ms); unset uses the default ladder.
    * DN_METRICS_HISTORY_S: seconds between metric-history snapshots
      (obs/history.py); 0 (the default) disables the rings.
    * DN_EVENTS: event-journal ring capacity (obs/events.py); 0 (the
      default) disables the journal.
    * DN_EVENTS_FILE: optional JSONL spill path for the journal
      (implies a default ring when DN_EVENTS is unset); its directory
      must exist, like DN_TRACE's.
    * DN_EVENTS_FILE_MAX_MB: spill size cap before rotation to
      `<path>.1` (obs/events.py); 0 disables rotation.
    * DN_TOP_INTERVAL_MS: `dn top` poll cadence, integer >= 100.
    """
    if env is None:
        env = os.environ
    rv = {}
    trace = env.get('DN_TRACE') or ''
    if trace and trace != 'stderr':
        parent = os.path.dirname(os.path.abspath(trace))
        if not os.path.isdir(parent):
            return DNError('DN_TRACE: expected "stderr" or a path in '
                           'an existing directory, got "%s"' % trace)
    rv['trace'] = trace or None
    raw = env.get('DN_SLOW_MS')
    if raw is None or raw == '':
        rv['slow_ms'] = None
    else:
        try:
            slow = int(raw)
        except ValueError:
            slow = -1
        if slow < 0:
            return DNError('DN_SLOW_MS: expected an integer >= 0, '
                           'got "%s"' % raw)
        rv['slow_ms'] = slow
    for name, key, default, minimum in (
            ('DN_METRICS_HISTORY_S', 'history_s', 0, 0),
            ('DN_EVENTS', 'events', 0, 0),
            # size cap (MB) for the DN_EVENTS_FILE JSONL spill: past
            # it the file rotates to `<path>.1` (one predecessor
            # kept); 0 disables rotation (the pre-cap unbounded
            # growth, opt-in only)
            ('DN_EVENTS_FILE_MAX_MB', 'events_file_max_mb', 64, 0),
            ('DN_TOP_INTERVAL_MS', 'top_interval_ms', 1000, 100)):
        raw = env.get(name)
        if raw is None or raw == '':
            rv[key] = default
            continue
        try:
            value = int(raw)
        except ValueError:
            value = minimum - 1
        if value < minimum:
            return DNError('%s: expected an integer >= %d, got "%s"'
                           % (name, minimum, raw))
        rv[key] = value
    evfile = env.get('DN_EVENTS_FILE') or ''
    if evfile:
        parent = os.path.dirname(os.path.abspath(evfile))
        if not os.path.isdir(parent):
            return DNError('DN_EVENTS_FILE: expected a path in an '
                           'existing directory, got "%s"' % evfile)
    rv['events_file'] = evfile or None
    raw = env.get('DN_METRICS_BUCKETS')
    if raw is None or raw == '':
        from .obs.metrics import DEFAULT_BUCKETS_MS
        rv['buckets'] = list(DEFAULT_BUCKETS_MS)
        return rv
    try:
        bounds = [float(p) for p in raw.split(',')]
    except ValueError:
        bounds = []
    if not bounds or any(b <= 0 for b in bounds) or \
            any(b >= c for b, c in zip(bounds, bounds[1:])):
        return DNError('DN_METRICS_BUCKETS: expected a '
                       'comma-separated strictly-increasing list of '
                       'positive numbers, got "%s"' % raw)
    rv['buckets'] = bounds
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
