"""Query model: QueryConfig, field parsing, bucketizers, metric model.

Re-implements the reference's query normalization layer
(lib/dragnet.js:28-244) and the metric (de)serialization + per-metric query
synthesis of lib/dragnet-impl.js:243-323, plus the two skinner bucketizers
(power-of-two and linear) whose semantics are pinned by the golden outputs:

* p2: value 0 -> bucket 0; value v >= 1 -> bucket floor(log2(v)) + 1;
  bucket_min(0) = 0, bucket_min(i) = 2^(i-1)   (DTrace quantize shape)
* linear(step): bucket floor(v/step); bucket_min(i) = i*step

Bucket ordinals are the internal representation (skinner `ordinalBuckets`);
points and index rows carry bucket-min values so that partial aggregates
re-aggregate idempotently (the map-reduce composability seam).
"""

import math

from .errors import DNError
from . import jsvalues as jsv
from . import krill as mod_krill


class P2Bucketizer(object):
    """Power-of-two bucketizer (skinner makeP2Bucketizer)."""

    def bucketize(self, v):
        if v < 1:
            return 0
        if isinstance(v, int):
            return v.bit_length()
        return math.frexp(v)[1]

    def bucket_min(self, i):
        if i <= 0:
            return 0
        return 1 << (i - 1)


class LinearBucketizer(object):
    """Linear bucketizer with fixed step (skinner makeLinearBucketizer)."""

    def __init__(self, step):
        self.step = step

    def bucketize(self, v):
        return int(math.floor(v / self.step))

    def bucket_min(self, i):
        return i * self.step


class QueryConfig(object):
    """Immutable parameters of a query (reference: lib/dragnet.js:28-77)."""

    def __init__(self, filter=None, breakdowns=None, time_before=None,
                 time_after=None, time_field=None):
        self.qc_filter = filter if filter is not None else None
        self.qc_breakdowns = [dict(b) for b in (breakdowns or [])]
        self.qc_before = time_before
        self.qc_after = time_after
        self.qc_fieldsbyname = {}
        self.qc_bucketizers = {}
        self.qc_synthetic = []

        if time_field:
            self.qc_synthetic.append({
                'name': time_field,
                'field': time_field,
                'date': '',
            })

        for fieldconf in self.qc_breakdowns:
            self.qc_fieldsbyname[fieldconf['name']] = fieldconf
            if 'date' in fieldconf:
                self.qc_synthetic.append(fieldconf)
            if 'aggr' not in fieldconf:
                continue
            if fieldconf['aggr'] == 'quantize':
                self.qc_bucketizers[fieldconf['name']] = P2Bucketizer()
            else:
                assert fieldconf['aggr'] == 'lquantize'
                self.qc_bucketizers[fieldconf['name']] = \
                    LinearBucketizer(fieldconf['step'])

        if self.qc_before is not None:
            assert self.qc_after is not None
        else:
            assert self.qc_after is None


def query_load(query, allow_reserved=False):
    """Normalize/validate a query; returns QueryConfig or DNError.

    (reference: lib/dragnet.js:103-144)
    """
    filt = query.get('filter')
    if filt is not None:
        try:
            mod_krill.create(filt)
        except DNError as ex:
            return DNError('invalid query: invalid filter', cause=ex)
    else:
        filt = None

    breakdowns = parse_fields(query.get('breakdowns', []),
                              allow_reserved=allow_reserved)
    if isinstance(breakdowns, DNError):
        return DNError('invalid query', cause=breakdowns)

    timebounds = parse_time_bounds(query.get('timeAfter'),
                                   query.get('timeBefore'))
    if isinstance(timebounds, DNError):
        return timebounds

    return QueryConfig(filter=filt, breakdowns=breakdowns,
                       time_after=timebounds[0], time_before=timebounds[1],
                       time_field=query.get('timeField'))


def parse_time_bounds(time_after, time_before):
    """Validate before/after; both-or-neither.  Values are epoch-ms ints or
    date strings.  Returns (after_ms, before_ms) or DNError.
    (reference: lib/dragnet.js:151-186)
    """
    if time_after is not None:
        if time_before is None:
            return DNError('"after" requires specifying "before" too')
        after_ms = _to_ms(time_after)
        if after_ms is None:
            return DNError('"after": not a valid date: "%s"'
                           % jsv.to_string(time_after))
        before_ms = _to_ms(time_before)
        if before_ms is None:
            return DNError('"before": not a valid date: "%s"'
                           % jsv.to_string(time_before))
        if after_ms > before_ms:
            return DNError('"after" timestamp may not come after "before"')
        return (after_ms, before_ms)
    elif time_before is not None:
        return DNError('"before" requires specifying "after" too')
    return (None, None)


def _to_ms(v):
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    if isinstance(v, str):
        return jsv.date_parse(v)
    return None


def parse_fields(inputs, allow_reserved=False):
    fields = []
    for i, b in enumerate(inputs):
        ret = parse_field(b, allow_reserved=allow_reserved)
        if isinstance(ret, DNError):
            return DNError('field %d ("[object Object]") is invalid' % i,
                           cause=ret)
        fields.append(ret)
    return fields


def parse_field(b, allow_reserved=False):
    """(reference: lib/dragnet.js:210-244, incl. the "lquzntize" typo)"""
    b = dict(b)
    if 'aggr' in b:
        if b['aggr'] not in ('quantize', 'lquantize'):
            return DNError('unsupported aggr: "%s"' % b['aggr'])
        if b['aggr'] == 'lquantize':
            if 'step' not in b:
                return DNError('aggr "lquantize" requires "step"')
            step = _parse_int(b['step'])
            if step is None:
                return DNError('aggr "lquzntize": invalid value for '
                               '"step": "%s"' % jsv.to_string(b['step']))
            b['step'] = step

    if not allow_reserved and b['name'].startswith('__dn'):
        return DNError('field names starting with "__dn" are reserved')

    if 'field' not in b:
        b['field'] = b['name']

    return b


def _parse_int(v):
    """JS parseInt(v, 10): leading-prefix integer parse."""
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return int(v)
    s = str(v).strip()
    i = 0
    if i < len(s) and s[i] in '+-':
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return None
    return int(s[:j])


def has_date_field(columns):
    return any('date' in c for c in columns)


# ---------------------------------------------------------------------------
# Metric model (reference: lib/dragnet-impl.js:243-323)
# ---------------------------------------------------------------------------

class Metric(object):
    def __init__(self, name, datasource, filter, breakdowns):
        self.m_name = name
        self.m_datasource = datasource
        self.m_filter = filter
        # each breakdown: dict with b_name, b_field, and optional b_date,
        # b_aggr, b_step
        self.m_breakdowns = breakdowns


def metric_serialize(metric, skip_datasource=False):
    rv = {}
    rv['name'] = metric.m_name
    if not skip_datasource:
        rv['datasource'] = metric.m_datasource
    rv['filter'] = metric.m_filter
    bds = []
    for b in metric.m_breakdowns:
        brv = {}
        brv['name'] = b['b_name']
        brv['field'] = b['b_field']
        if 'b_date' in b:
            brv['date'] = b['b_date']
        if 'b_aggr' in b:
            brv['aggr'] = b['b_aggr']
        if 'b_step' in b:
            brv['step'] = b['b_step']
        bds.append(brv)
    rv['breakdowns'] = bds
    return rv


def metric_deserialize(metconfig):
    breakdowns = []
    for b in metconfig['breakdowns']:
        rv = {}
        for k, v in b.items():
            rv['b_' + k] = v
        breakdowns.append(rv)
    return Metric(metconfig['name'], metconfig.get('datasource'),
                  metconfig.get('filter'), breakdowns)


def metric_query(metric, after, before, interval, timefield):
    """Build the QueryConfig describing a metric for index construction;
    for hour/day intervals a reserved __dn_ts lquantize breakdown is
    prepended so aggregates can be demultiplexed into per-interval index
    shards.  (reference: lib/dragnet-impl.js:290-323)
    """
    queryconfig = metric_serialize(metric)
    if interval != 'all':
        step = 3600 if interval == 'hour' else 3600 * 24
        queryconfig['breakdowns'].insert(0, {
            'name': '__dn_ts',
            'aggr': 'lquantize',
            'step': step,
            'field': timefield,
            'date': '',
        })
    q = {
        'breakdowns': queryconfig['breakdowns'],
        'filter': queryconfig['filter'],
    }
    if after is not None:
        q['timeAfter'] = after
    if before is not None:
        q['timeBefore'] = before
    query = query_load(q, allow_reserved=True)
    assert not isinstance(query, DNError), query
    return query


def query_time_bounds_filter(query, timefield):
    """krill filter enforcing the query's [after, before) bounds in seconds.
    (reference: lib/dragnet-impl.js:94-125)
    """
    if query.qc_before is not None:
        assert query.qc_after is not None
        return {'and': [
            {'ge': [timefield, _ceil_div(query.qc_after, 1000)]},
            {'lt': [timefield, _ceil_div(query.qc_before, 1000)]},
        ]}
    return None


def _ceil_div(ms, div):
    return -((-ms) // div)


def filter_and(*filters):
    """AND-combine krill filters, ignoring Nones.
    (reference: lib/dragnet-impl.js:332-343)
    """
    fs = [f for f in filters if f is not None]
    if len(fs) == 0:
        return None
    if len(fs) == 1:
        return fs[0]
    return {'and': fs}
