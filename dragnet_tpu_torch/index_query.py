"""Index reader / query engine: metric selection + pushdown group-by.

Re-implements lib/index-query.js:

* semver-compatibility gate (~2) on the index's embedded version,
* metric selection (findMetric, lib/index-query.js:154-263): first metric
  whose filter matches the query's exactly (or has none while the query's
  field needs are covered), field-superset check, date-field requirement
  for time-bounded queries,
* query compilation to `SELECT cols, SUM(value) ... WHERE <filter>
  GROUP BY cols`, with krill leaves rendered C-style (SQLite accepts both
  `==` and double-quoted string literals, so semantics carry over exactly),
* NULL SUM -> 0, and re-aggregation of returned rows through the standard
  aggregator so per-bucket rows merge into proper points.

Two storage engines share the selection/compilation logic above:
the reference-compatible SQLite format (IndexQuerier) and the native
columnar DNC format (index_dnc.DncIndexQuerier, the default writer);
open_index() sniffs the file content and dispatches — index filenames
keep the reference's `.sqlite` layout either way.
"""

import copy
import re
import sqlite3

from .errors import DNError
from . import jsvalues as jsv
from . import krill as mod_krill
from . import query as mod_query
from .aggr import Aggregator
from .index_sink import sqlite3_escape

DB_VERSION_MAJOR = 2


def _semver_satisfies(version, major):
    m = re.match(r'^(\d+)\.(\d+)\.(\d+)', version or '')
    if not m:
        return False
    return int(m.group(1)) == major


def open_index(filename):
    """Open an index file with the engine matching its content."""
    from . import native_index
    try:
        with open(filename, 'rb') as f:
            head = f.read(len(native_index.MAGIC))
    except OSError as e:
        raise DNError(str(e))
    if head == native_index.MAGIC:
        from .index_dnc import DncIndexQuerier
        return DncIndexQuerier(filename)
    return IndexQuerier(filename)


class IndexQuerierBase(object):
    """Shared metric selection, filter composition, and row
    deserialization; subclasses provide _load_config (setting qi_config
    and qi_metrics) and _execute (returning grouped row dicts)."""

    qi_config = None
    qi_metrics = None

    def _check_version(self):
        if 'version' not in self.qi_config:
            raise DNError('index missing dragnet "version"')
        if not _semver_satisfies(self.qi_config['version'],
                                 DB_VERSION_MAJOR):
            raise DNError('unsupported index version: "%s"'
                          % self.qi_config['version'])

    def _add_metric(self, mid, label, filter_raw, params_raw):
        filt = None if filter_raw is None else \
            _json_parse_or_raise(filter_raw, label, 'filter')
        params = [] if params_raw is None else \
            _json_parse_or_raise(params_raw, label, 'params')
        self.qi_metrics.append({
            'qm_id': mid,
            'qm_label': label,
            'qm_filter': filt,
            'qm_params': params,
            'qm_filter_raw': filter_raw,
        })

    def find_metric(self, query):
        """(reference: lib/index-query.js:154-263)"""
        filter_raw = None
        if query.qc_filter is not None:
            filter_raw = jsv.json_stringify(query.qc_filter)

        pred = None
        for met in self.qi_metrics:
            datefield = None
            if met['qm_filter'] is not None:
                if query.qc_filter is None:
                    continue
                if met['qm_filter_raw'] != filter_raw:
                    continue

            if query.qc_before is not None or query.qc_after is not None:
                fi = None
                for i, p in enumerate(met['qm_params']):
                    if 'date' in p:
                        fi = i
                        break
                if fi is None:
                    continue
                datefield = met['qm_params'][fi]['name']

            fields_needed = {}
            fields_have = {}
            if query.qc_filter is not None and met['qm_filter'] is None:
                if pred is None:
                    pred = mod_krill.create(query.qc_filter)
                for f in pred.fields():
                    fields_needed[f] = True

            for b in query.qc_breakdowns:
                fields_needed[b['name']] = b
            for b in met['qm_params']:
                fields_have[b['name']] = b

            okay = all(qf in fields_have for qf in fields_needed)
            if okay:
                return {
                    'datefield': datefield,
                    'metric_id': met['qm_id'],
                    'table': 'dragnet_index_%s' % met['qm_id'],
                    'ignore_filter': met['qm_filter'] is not None,
                }

        return DNError('no metrics available to serve query')

    def _compose_filter(self, query, table):
        """The effective pushdown filter: user filter (unless the metric
        already applied it at build time) ANDed with the time-bounds
        filter, with column names escaped."""
        whenfilter = mod_query.query_time_bounds_filter(
            query, table['datefield'])
        qfilter = None if table['ignore_filter'] else query.qc_filter

        if qfilter is not None and whenfilter is not None:
            filt = {'and': [copy.deepcopy(qfilter), whenfilter]}
        elif whenfilter is not None:
            filt = whenfilter
        elif qfilter is not None:
            filt = copy.deepcopy(qfilter)
        else:
            filt = {}
        _escape_filter(filt)
        return filt

    def _groupby_columns(self, query):
        return [sqlite3_escape(b['name'])
                for b in query.qc_breakdowns
                if 'date' not in b or b['field'] == b['name']]

    def run(self, query, aggr=None):
        """Execute the query; returns the list of points (or raises
        DNError).  If `aggr` is given, points are merged into it instead."""
        table = self.find_metric(query)
        if isinstance(table, DNError):
            raise table

        own_aggr = aggr is None
        if own_aggr:
            aggr = Aggregator(query)

        filt = self._compose_filter(query, table)
        groupby = self._groupby_columns(query)

        if not self._execute_keys(table, filt, groupby, query, aggr):
            # column escapes hoisted out of the per-row loop (the
            # serving path deserializes tens of rows per shard across
            # hundreds of shards per query)
            cols = [(f['name'], sqlite3_escape(f['field']))
                    for f in query.qc_breakdowns]
            for rd in self._execute(table, filt, groupby):
                fields, value = self._deserialize_row(cols, rd)
                aggr.write(fields, value)
        if own_aggr:
            return aggr.points()
        return None

    def _execute_keys(self, table, filt, groupby, query, aggr):
        """Storage-engine hook: aggregate grouped rows directly as
        write_key() tuples, skipping row-dict materialization and the
        per-row pluck/coerce work of Aggregator.write — must produce
        byte-identical aggregates (differential-tested).  Returns False
        to take the row path instead (the base always does; the DNC
        engine overrides)."""
        return False

    def _deserialize_row(self, cols, rd):
        """(reference: lib/index-query.js:382-405; NULL SUM -> 0).
        `cols` is the [(name, escaped_column)] projection of the
        query's breakdowns."""
        value = rd.get('value')
        if value is None:
            value = 0
        fields = {}
        for name, col in cols:
            if col in rd:
                fields[name] = rd[col]
            # absent column: leave unset (JS undefined semantics)
        return (fields, value)


class IndexQuerier(IndexQuerierBase):
    """The reference-compatible SQLite engine."""

    def __init__(self, filename):
        self.qi_dbfilename = filename
        # check_same_thread=False: the shard-handle cache
        # (index_query_mt) leases a querier to one worker thread at a
        # time, so a connection opened on one thread is later used —
        # never concurrently — on another; read-only + serialized
        # access makes that safe.
        self.qi_db = sqlite3.connect(
            'file:%s?mode=ro' % filename.replace('?', '%3f'), uri=True,
            check_same_thread=False)
        self.qi_config = None
        self.qi_metrics = None
        self._load_config()

    def close(self):
        self.qi_db.close()

    def _load_config(self):
        cur = self.qi_db.cursor()
        try:
            rows = cur.execute('SELECT * FROM dragnet_config').fetchall()
        except sqlite3.Error as e:
            raise DNError(str(e))
        self.qi_config = {}
        names = [d[0] for d in cur.description]
        for r in rows:
            rd = dict(zip(names, r))
            self.qi_config[rd['key']] = rd['value']
        self._check_version()

        rows = cur.execute('SELECT * FROM dragnet_metrics').fetchall()
        names = [d[0] for d in cur.description]
        self.qi_metrics = []
        for r in rows:
            rd = dict(zip(names, r))
            self._add_metric(rd['id'], rd['label'], rd['filter'],
                             rd['params'])

    def _execute(self, table, filt, groupby):
        columns = list(groupby)
        columns.append('SUM(value) as value')

        sql = 'SELECT ' + ','.join(columns)
        sql += ' from ' + table['table'] + ' '
        sql += 'WHERE ' + _to_sql_string(filt) + ' '
        if groupby:
            sql += 'GROUP BY ' + ','.join(groupby)

        try:
            cur = self.qi_db.execute(sql)
        except sqlite3.Error as e:
            raise DNError('executing query "%s"' % sql,
                          cause=DNError(str(e)))
        names = [d[0] for d in cur.description]
        for row in cur.fetchall():
            yield dict(zip(names, row))

    def metric_rows(self, mi, names):
        """The append-merge read seam (`dn follow`): metric `mi`'s raw
        stored rows — one (key..., value) tuple per row, breakdown
        columns in `names` order — in INSERT order (rowid order, the
        same order stack_blocks already relies on).  A follow batch
        seeds its per-shard merge aggregator from these rows, so the
        rewritten shard preserves the original emission order
        byte-exactly."""
        cols = [sqlite3_escape(n) for n in names] + ['value']
        sql = 'SELECT %s from dragnet_index_%d' % (','.join(cols), mi)
        try:
            return self.qi_db.execute(sql).fetchall()
        except sqlite3.Error as e:
            raise DNError('executing query "%s"' % sql,
                          cause=DNError(str(e)))

    def stack_blocks(self, table, filt, groupby):
        """Columnar block export for the stacked cross-shard path
        (index_query_stack): the raw matching rows — no GROUP BY, no
        SUM; grouping happens once, across every shard.  Returns
        (nrows, [('obj', values_list)] per groupby column,
        values_list, None) — raw Python row values so SQLite's
        cross-type ordering and storage classes carry over exactly."""
        columns = list(groupby)
        columns.append('value')
        sql = 'SELECT ' + ','.join(columns)
        sql += ' from ' + table['table'] + ' '
        sql += 'WHERE ' + _to_sql_string(filt)
        try:
            rows = self.qi_db.execute(sql).fetchall()
        except sqlite3.Error as e:
            raise DNError('executing query "%s"' % sql,
                          cause=DNError(str(e)))
        cols = [('obj', [r[k] for r in rows])
                for k in range(len(groupby))]
        return (len(rows), cols, [r[-1] for r in rows], None)


def _json_parse_or_raise(text, label, what):
    try:
        import json
        return json.loads(text)
    except ValueError as e:
        raise DNError('failed to parse %s for metric "%s"' % (what, label),
                      cause=DNError(str(e)))


def _escape_filter(filt):
    if not filt:
        return
    if 'and' in filt:
        for f in filt['and']:
            _escape_filter(f)
        return
    if 'or' in filt:
        for f in filt['or']:
            _escape_filter(f)
        return
    key = next(iter(filt))
    filt[key][0] = sqlite3_escape(filt[key][0])


def _to_sql_string(filt):
    if not filt:
        return '1'
    if 'and' in filt:
        return ' AND '.join('(%s)' % _to_sql_string(c) for c in filt['and'])
    if 'or' in filt:
        return ' OR '.join('(%s)' % _to_sql_string(c) for c in filt['or'])
    return mod_krill.create(filt).to_c_style()
