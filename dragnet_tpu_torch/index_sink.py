"""Index writer: aggregated points -> self-describing index file.

Schema-compatible with the reference's SQLite index format
(lib/index-sink.js:116-230): a `dragnet_config` table (version 2.0.0 plus
extra pairs like dn_start), a `dragnet_metrics` catalog (id, label, filter
JSON, params JSON), and one `dragnet_index_<i>` table per metric with
escaped column names ('.'/'-' -> '_'), `integer` columns for aggregated
fields and varchar(128) otherwise, plus a `value` column.

Durability contract preserved: written to a tmp name (`<name>.<pid>`
by default; journaled builds pass a per-build `tmp_suffix`), fsync
disabled (pragma synchronous=off), atomically renamed into place on
flush (lib/index-sink.js:264-304) — a crash never leaves a torn
*committed* index.  A *failed* flush (or abort()) best-effort unlinks
the tmp file, so error paths leave the index directory clean too.

flush() is split into the two-phase primitives the build journal
(index_journal.py) sequences across a whole shard set: prepare()
writes and closes the complete tmp file, commit() atomically renames
it into place.  flush() == prepare()+commit() for single-shard
callers.  A SIGKILL between the phases leaves only a complete tmp
plus the journal, which the recovery sweep rolls forward or back —
a reader can only ever observe the pre-build or post-build tree.

Both storage engines share one error contract (point_metric/point_row):
a bad __dn_metric tag or a missing breakdown raises DNError — the
pre-PR-2 mix of bare asserts (stripped under -O) and IndexError is gone.
Both also share the bulk write_rows(mi, key_columns, values) entry: one
executemany per block here, a direct columnar append in the DNC sink.
"""

import os
import sqlite3

from .errors import DNError
from . import jsvalues as jsv
from . import query as mod_query

INDEX_VERSION = '2.0.0'


def sqlite3_escape(name):
    return name.replace('.', '_').replace('-', '_')


def check_metric_index(mi, nmetrics):
    """Validate a metric index; both storage engines raise the same
    DNError for a missing/mistyped/out-of-range value."""
    if not (isinstance(mi, int) and not isinstance(mi, bool)
            and 0 <= mi < nmetrics):
        raise DNError('bad __dn_metric: %r' % (mi,))
    return mi


def check_block(mi, keycols, names):
    """Shared write_rows validation: metric index + one key column per
    breakdown (`names` is the per-metric breakdown-name table)."""
    check_metric_index(mi, len(names))
    if len(keycols) != len(names[mi]):
        raise DNError('write_rows: expected %d key columns, got %d'
                      % (len(names[mi]), len(keycols)))


def point_metric(fields, nmetrics):
    """The validated __dn_metric tag of a tagged point."""
    return check_metric_index(fields.get('__dn_metric'), nmetrics)


def point_row(fields, names):
    """A point's breakdown values in column order; a missing breakdown
    raises the shared DNError contract."""
    row = []
    for name in names:
        if name not in fields:
            raise DNError('point is missing breakdown "%s"' % name)
        row.append(fields[name])
    return row


def metric_catalog_rows(metrics):
    """(id, label, filter, params) rows of the embedded metric catalog —
    identical strings in both storage engines so metric selection
    behaves the same whichever wrote the file."""
    rows = []
    for i, m in enumerate(metrics):
        ms = mod_query.metric_serialize(m, skip_datasource=True)
        rows.append((i, m.m_name, jsv.json_stringify(m.m_filter),
                     jsv.json_stringify(ms['breakdowns'])))
    return rows


def make_index_sink(metrics, filename, config=None, catalog=None,
                    tmp_suffix=None):
    """Index writer for the configured format: DN_INDEX_FORMAT=dnc (the
    native columnar store, default) or sqlite (reference-compatible
    files).  Readers dispatch on file content, so either is queryable.
    `catalog` is an optional precomputed metric_catalog_rows(metrics) —
    a 365-shard build serializes the identical catalog into every
    shard, so the caller computes it once.  `tmp_suffix` overrides the
    default `<pid>` tmp-name suffix (journaled builds use their build
    id so concurrent builds and the recovery sweep can tell tmps
    apart)."""
    fmt = os.environ.get('DN_INDEX_FORMAT', 'dnc')
    if fmt == 'sqlite':
        return IndexSink(metrics, filename, config=config,
                         catalog=catalog, tmp_suffix=tmp_suffix)
    from .index_dnc import DncIndexSink
    return DncIndexSink(metrics, filename, config=config,
                        catalog=catalog, tmp_suffix=tmp_suffix)


class IndexSink(object):
    def __init__(self, metrics, filename, config=None, catalog=None,
                 tmp_suffix=None):
        from . import faults as mod_faults
        mod_faults.fire('sink.create')
        self.is_metrics = metrics
        self.is_dbfilename = filename
        self.is_dbtmpfilename = filename + '.' + \
            (tmp_suffix or str(os.getpid()))
        self.is_config = dict(config or {})
        self.is_nwritten = 0
        self._prepared = False

        dirname = os.path.dirname(self.is_dbtmpfilename)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

        # check_same_thread=False: the build pool hands a sink to
        # exactly one flush worker (index_build_mt), so a connection
        # created on the streaming thread is later used — never
        # concurrently — on another; serialized access makes it safe.
        self.is_db = sqlite3.connect(self.is_dbtmpfilename,
                                     check_same_thread=False)
        self.is_db.execute('pragma synchronous = off;')

        cur = self.is_db.cursor()
        cur.execute('CREATE TABLE dragnet_config(\n'
                    '    key varchar(128) primary key,\n'
                    '    value varchar(128)\n);')
        cur.execute('CREATE TABLE dragnet_metrics(\n'
                    '    id integer,\n'
                    '    label varchar(64),\n'
                    '    filter varchar(1024),\n'
                    '    params varchar(1024)\n);')

        self._names = []
        self._insert_sql = []
        for i, m in enumerate(metrics):
            tblname = 'dragnet_index_%d' % i
            cols = []
            for b in m.m_breakdowns:
                ctype = 'integer' if 'b_aggr' in b else 'varchar(128)'
                cols.append('    %s %s' % (sqlite3_escape(b['b_name']),
                                           ctype))
            cols.append('    value integer')
            cur.execute('CREATE TABLE %s(\n%s\n);'
                        % (tblname, ',\n'.join(cols)))
            self._names.append([b['b_name'] for b in m.m_breakdowns])
            self._insert_sql.append(
                'INSERT INTO %s VALUES (%s)'
                % (tblname, ', '.join('?' for _ in cols)))

        configpairs = [('version', INDEX_VERSION)]
        for k, v in self.is_config.items():
            assert k != 'version'
            configpairs.append((k, v))
        cur.executemany('INSERT INTO dragnet_config VALUES (?, ?)',
                        configpairs)

        cur.executemany('INSERT INTO dragnet_metrics VALUES (?, ?, ?, ?)',
                        catalog if catalog is not None
                        else metric_catalog_rows(metrics))

    def write(self, fields, value):
        """Write one aggregated point; fields must carry __dn_metric."""
        mi = point_metric(fields, len(self.is_metrics))
        row = point_row(fields, self._names[mi])
        row.append(value)
        self.is_db.execute(self._insert_sql[mi], row)
        self.is_nwritten += 1

    def write_rows(self, mi, keycols, values):
        """Bulk append one metric's block: `keycols` is one column per
        breakdown (in breakdown order), `values` the value column —
        a single executemany, the whole sink committing as one
        transaction at flush."""
        check_block(mi, keycols, self._names)
        self.is_db.executemany(self._insert_sql[mi],
                               zip(*keycols, values))
        self.is_nwritten += len(values)

    def prepare(self):
        """Phase 1: the complete shard body lands in the tmp file and
        the connection closes.  On failure the tmp is discarded."""
        from . import faults as mod_faults
        try:
            # torn kind: the tmp already carries partial body bytes —
            # truncate-and-crash models the mid-write power cut
            mod_faults.fire('sink.flush',
                            torn_path=self.is_dbtmpfilename)
            self.is_db.commit()
            self.is_db.close()
            self._prepared = True
        except BaseException:
            self._discard_tmp()
            raise

    def commit(self, discard_on_error=True):
        """Phase 2: atomically rename the prepared tmp into place.
        (No torn kind here: past the commit record the tmp must stay
        complete so the recovery roll-forward publishes whole bytes —
        kill/error/delay still apply.  The flip kind DOES target the
        tmp: its checksum already landed in the commit record, so a
        flipped byte models post-publish rot the integrity catalog
        must catch.)  Journaled publishers pass
        discard_on_error=False: their commit record makes the tmp
        recoverable state, not litter."""
        from . import faults as mod_faults
        try:
            mod_faults.fire('sink.rename',
                            flip_path=self.is_dbtmpfilename)
            os.rename(self.is_dbtmpfilename, self.is_dbfilename)
        except BaseException:
            if discard_on_error:
                self._discard_tmp()
            raise

    def flush(self):
        if not self._prepared:
            self.prepare()
        self.commit()

    def abort(self):
        """Discard the sink: close the connection and best-effort
        unlink the tmp file (a failed build must not leave
        `<name>.<pid>` litter behind)."""
        try:
            self.is_db.close()
        except Exception:
            pass
        self._discard_tmp()

    def _discard_tmp(self):
        try:
            os.unlink(self.is_dbtmpfilename)
        except OSError:
            pass
