"""Vectorized scan engine: columnar batches -> masks -> bucketize ->
fused-key aggregation.

Counterpart of dragnet_tpu/engine.py (the per-record path in scan.py is
the semantic reference; tests hold both against the JAX package).  Per
batch:

1. evaluate datasource/user filters as ternary outcome vectors
   (TRUE/FALSE/ERROR),
2. parse synthetic date fields (vectorized, with undef/baddate drops),
3. apply the time-bounds filter,
4. bucketize aggregated columns and dictionary-encode key columns,
5. fuse per-column codes into a mixed-radix composite key and
   segment-sum the weights into a dense accumulator,
6. merge the nonzero buckets into the running Aggregator in
   first-occurrence order (reproducing the host path's JS
   nested-insertion emission order exactly).

Columns come from a *provider*: NativeColumns adapts the tagged arrays
of a columnar parser (the C++ one, native.py, or the byte lane,
byteparse.py), DictColumns plucks parsed Python records (the record
path when neither parser runs) — same downstream pipeline either way.

Step 5 runs on numpy (bincount) for the host engine, or on a torch
device when the scan was given one (`device=`): the one-hot kernel
(ops/cuda_kernels.py) for small accumulators, the i64 index_add_
segment-sum (ops/kernels.py) otherwise.  DeviceScan's host-path
batches (those that fail its exactness checks) aggregate this way.
"""

import os

import numpy as np

from . import jsvalues as jsv
from . import batch as mod_batch
from . import query as mod_query
from .aggr import Aggregator
from .ops.kernels import FALSE, TRUE, ERROR

BATCH_SIZE = 65536
MAX_DENSE_SEGMENTS = 1 << 24

# Deferred columnar merge: when a batch yields at least this many unique
# key tuples, batch results are buffered as (global-code columns, weight
# sums) and collapsed to final uniques once, at finish — Python-object
# work then scales with output tuples, not records.  The buffer is
# compacted (unique+sum) whenever it exceeds DEFER_COMPACT_ROWS, so
# memory stays bounded by unique tuples.
DEFER_UNIQUE = 4096
DEFER_COMPACT_ROWS = 1 << 21


def engine_mode():
    """DN_ENGINE as bin/dn reads it: auto (default), jax, vector, host;
    any other value is the vectorized host engine."""
    return os.environ.get('DN_ENGINE', 'auto')


def _native_str_trans(column, parser_dict):
    """Engine-dictionary codes for a native parser's per-field string
    dictionary, cached on the engine column and extended incrementally
    (both dictionaries are append-only)."""
    cache = getattr(column, '_native_trans', None)
    if cache is None:
        cache = np.zeros(0, dtype=np.int64)
    if len(cache) < len(parser_dict):
        code = column.dict.code
        new = np.array([code(s, s) for s in parser_dict[len(cache):]],
                       dtype=np.int64)
        cache = np.concatenate([cache, new])
        column._native_trans = cache
    return cache


def fuse_codes(cols):
    """One mixed-radix int64 key per row fusing equal-length int64
    code columns (range-shifted per column), or None when the span
    product could overflow int64 — THE shared fuse + overflow guard
    (an off-by-one here corrupts every downstream sort/unique, so
    there is exactly one copy).  Callers guard the empty case."""
    n = len(cols[0])
    spans = []
    prod = 1
    for arr in cols:
        lo = int(arr.min())
        span = int(arr.max()) - lo + 1
        if prod > (2 ** 62) // max(span, 1):
            return None
        prod *= span
        spans.append((lo, span))
    fused = np.zeros(n, dtype=np.int64)
    for arr, (lo, span) in zip(cols, spans):
        fused = fused * span + (arr - lo)
    return fused


def _unique_rows(gcols):
    """Unique rows of a tuple of equal-length int64 code columns.
    Returns (first_idx, inv, order): first-occurrence index per unique
    row, per-row inverse mapping, and the permutation putting uniques
    in first-occurrence order.  Fuses to one mixed-radix int64 when the
    span product fits (1-D unique is much faster); row-wise unique
    otherwise."""
    n = len(gcols[0])
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    fused = fuse_codes(gcols)
    if fused is not None:
        _, first_idx, inv = np.unique(fused, return_index=True,
                                      return_inverse=True)
    else:
        mat = np.stack(gcols, axis=1)
        _, first_idx, inv = np.unique(mat, axis=0, return_index=True,
                                      return_inverse=True)
        inv = inv.reshape(-1)
    order = np.argsort(first_idx, kind='stable')
    return first_idx, inv, order


def _compact_codes(ords):
    """np.unique(return_inverse=True) for integer arrays, O(n) via a
    dense presence table when the value range is small (bucket ordinals
    always are), falling back to np.unique otherwise."""
    if len(ords) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    mn = int(ords.min())
    mx = int(ords.max())
    span = mx - mn + 1
    if span > max(65536, 4 * len(ords)):
        uniq, codes = np.unique(ords, return_inverse=True)
        return uniq, codes.astype(np.int64)
    shifted = ords - mn
    present = np.zeros(span, dtype=bool)
    present[shifted] = True
    lut = np.cumsum(present) - 1
    return np.nonzero(present)[0] + mn, lut[shifted]


def weights_array(values):
    """Point weights -> f64 with JS Number coercion (json-skinner values
    may be strings or garbage; NaN becomes 0 rather than poisoning
    sums).  Applied identically to the dict and native ingest paths."""
    out = np.empty(len(values), dtype=np.float64)
    for i, v in enumerate(values):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[i] = jsv.as_float(v)
        else:
            f = jsv.to_number(v)
            out[i] = 0.0 if f != f else f
    return out


# ---------------------------------------------------------------------------
# Column providers
# ---------------------------------------------------------------------------

class DictColumns(object):
    """Columns plucked from a list of parsed record dicts."""

    def __init__(self, records, scan):
        self.records = records
        self.scan = scan
        self.n = len(records)
        self._raw = {}

    def raw(self, path):
        col = self._raw.get(path)
        if col is None:
            col = mod_batch.pluck_column(self.records, path)
            self._raw[path] = col
        return col

    def leaf_outcomes(self, leaf):
        rawcol = self.scan.raw_columns[leaf.field]
        codes = self.scan._dict_codes(self, leaf.field, rawcol)
        return leaf.table_for(rawcol.dict.values)[codes]

    def date_column(self, path):
        return mod_batch.date_column(self.raw(path))

    def string_codes(self, path, column):
        return column.encode(self.raw(path))

    def numeric_column(self, path):
        return mod_batch.numeric_column(self.raw(path))


class NativeColumns(object):
    """Columns adapted from the C++ parser's tagged arrays.  Scan-
    independent, so one provider instance can feed several metric scans
    in a single pass (the build fan-out)."""

    def __init__(self, parser):
        from . import native as mod_native
        self.mn = mod_native
        self.parser = parser
        self.n = parser.batch_size()
        self._cols = {}
        self._dates = {}

    def _field(self, path):
        col = self._cols.get(path)
        if col is None:
            col = self.parser.columns(path)
            self._cols[path] = col
        return col

    def leaf_outcomes(self, leaf):
        mn = self.mn
        tags, nums, strcodes = self._field(leaf.field)
        out = np.full(self.n, ERROR, dtype=np.int8)  # TAG_MISSING
        out[tags == mn.TAG_NULL] = leaf.outcome(None)
        out[tags == mn.TAG_TRUE] = leaf.outcome(True)
        out[tags == mn.TAG_FALSE] = leaf.outcome(False)
        out[tags == mn.TAG_OBJECT] = leaf.outcome({})
        m = tags == mn.TAG_ARRAY
        if m.any():
            covered = np.zeros(self.n, dtype=bool)
            for v, arr in self._array_values(leaf.field):
                hit = m & (strcodes == v)
                out[hit] = leaf.outcome(arr)
                covered |= hit
            if not covered[m].all():
                # same loud-divergence contract as string_codes: an
                # array-tagged row must decode from the dictionary
                raise RuntimeError(
                    'native parser: array-tagged row with unparseable '
                    'dictionary entry (field %r)' % leaf.field)
        m = (tags == mn.TAG_INT) | (tags == mn.TAG_NUMBER)
        if m.any():
            const = leaf.const
            if isinstance(const, bool) or \
                    not isinstance(const, (int, float)):
                # non-numeric constant: exact JS semantics per unique
                uniq, inv = np.unique(nums[m], return_inverse=True)
                table = np.array([leaf.outcome(float(u)) for u in uniq],
                                 dtype=np.int8)
                out[m] = table[inv]
            else:
                # number-vs-number compares are plain numeric compares
                # in JS; vectorize directly (no unique/sort).  as_float
                # maps ints beyond f64 range to +-inf like JS would.
                const = jsv.as_float(const)
                vals = nums[m]
                op = leaf.op
                if op == 'eq':
                    hit = vals == const
                elif op == 'ne':
                    hit = vals != const
                elif op == 'lt':
                    hit = vals < const
                elif op == 'le':
                    hit = vals <= const
                elif op == 'gt':
                    hit = vals > const
                else:
                    hit = vals >= const
                out[m] = np.where(hit, TRUE, FALSE).astype(np.int8)
        m = tags == mn.TAG_STRING
        if m.any():
            table = leaf.table_for(self.parser.dictionary(leaf.field))
            out[m] = table[strcodes[m]]
        return out

    def date_column(self, path):
        d = self._dates.get(path)
        if d is None:
            d = self.parser.date_columns(path)
            self._dates[path] = d
        return d

    def _array_values(self, path):
        """(dict_code, parsed_value) for array-tagged entries of this
        field's dictionary (raw JSON text interned by the parser).
        Cached on the parser keyed by dictionary length (the dictionary
        is append-only).  The dictionary is shared with plain string
        values, so a '['-prefixed entry may be a string that is not
        valid JSON — those are skipped (an entry referenced by an
        array-tagged row always parses, having passed the parser's
        strict validation)."""
        import json
        d = self.parser.dictionary(path)
        cache = getattr(self.parser, '_array_cache', None)
        if cache is None:
            cache = {}
            self.parser._array_cache = cache
        cached = cache.get(path)
        if cached is None:
            cached = (0, [])
        if cached[0] < len(d):
            # append-only dictionary: parse only the new entries.
            # The cache dict is shared across scan_mt worker threads, so
            # never mutate a stored list in place: extend a private copy
            # and publish a fresh (len, list) tuple — concurrent racers
            # may redo work, but every published tuple is consistent.
            out = list(cached[1])
            for i in range(cached[0], len(d)):
                raw = d[i]
                if not raw.startswith('['):
                    continue
                try:
                    out.append((i, json.loads(raw)))
                except ValueError:
                    pass  # a string value, not interned array text
            cached = (len(d), out)
            cache[path] = cached
        return cached[1]

    def string_codes(self, path, column):
        """Translate tagged values to the engine's global String(v)
        dictionary codes."""
        mn = self.mn
        tags, nums, strcodes = self._field(path)
        if (tags == mn.TAG_STRING).all():
            # all-strings column (the usual case): one translated gather
            trans = _native_str_trans(column,
                                      self.parser.dictionary(path))
            return trans[strcodes]
        out = np.empty(self.n, dtype=np.int64)
        code = column.dict.code
        out[tags == mn.TAG_MISSING] = code('undefined', 'undefined')
        out[tags == mn.TAG_NULL] = code('null', 'null')
        out[tags == mn.TAG_TRUE] = code('true', 'true')
        out[tags == mn.TAG_FALSE] = code('false', 'false')
        out[tags == mn.TAG_OBJECT] = code('[object Object]',
                                          '[object Object]')
        m = tags == mn.TAG_ARRAY
        if m.any():
            out[m] = -1  # sentinel: every array row must be covered
            for v, arr in self._array_values(path):
                s = jsv.to_string(arr)
                out[m & (strcodes == v)] = code(s, s)
            if (out[m] == -1).any():
                # an array-tagged row whose dict entry did not parse
                # would mean native/fallback divergence; fail loudly
                # rather than aggregate uninitialized codes
                raise RuntimeError(
                    'native parser: array-tagged row with unparseable '
                    'dictionary entry (field %r)' % path)
        m = (tags == mn.TAG_INT) | (tags == mn.TAG_NUMBER)
        if m.any():
            tagm = tags[m]
            uniq, inv = np.unique(nums[m], return_inverse=True)
            # TAG_INT means integral |v| <= 2^53: prints without a dot
            table = np.array([
                code(s, s) for s in
                (jsv.number_to_string(int(u) if float(u).is_integer()
                                      and abs(u) <= 2 ** 53 else u)
                 for u in uniq)], dtype=np.int64)
            out[m] = table[inv]
        m = tags == mn.TAG_STRING
        if m.any():
            d = self.parser.dictionary(path)
            trans = _native_str_trans(column, d)
            out[m] = trans[strcodes[m]]
        return out

    def numeric_column(self, path):
        mn = self.mn
        tags, nums, strcodes = self._field(path)
        out = np.zeros(self.n, dtype=np.float64)
        valid = np.zeros(self.n, dtype=bool)
        m = (tags == mn.TAG_INT) | (tags == mn.TAG_NUMBER)
        out[m] = nums[m]
        valid[m] = True
        ms = tags == mn.TAG_STRING
        if ms.any():
            d = self.parser.dictionary(path)
            fvals = np.empty(len(d), dtype=np.float64)
            fok = np.empty(len(d), dtype=bool)
            for i, s in enumerate(d):
                f = jsv.to_number(s)
                fok[i] = f == f
                fvals[i] = 0.0 if f != f else f
            out[ms] = fvals[strcodes[ms]]
            valid[ms] = fok[strcodes[ms]]
        return out, valid


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

class Leaf(object):
    """One predicate leaf; evaluates per unique value with exact JS
    semantics, memoized as lookup tables."""

    def __init__(self, field, op, const):
        self.field = field
        self.op = op
        self.const = const
        self._str_table = np.zeros(0, dtype=np.int8)

    def outcome(self, v):
        if v is jsv.UNDEFINED:
            return ERROR
        if self.op == 'eq':
            return TRUE if jsv.loose_eq(v, self.const) else FALSE
        if self.op == 'ne':
            return FALSE if jsv.loose_eq(v, self.const) else TRUE
        return TRUE if jsv.relational(v, self.const, self.op) else FALSE

    def table_for(self, values):
        """Outcome table over a growing value list (values may be raw JS
        values or strings)."""
        if len(self._str_table) < len(values):
            new = [self.outcome(v) for v in values[len(self._str_table):]]
            self._str_table = np.concatenate(
                [self._str_table, np.array(new, dtype=np.int8)])
        return self._str_table


class VectorPredicate(object):
    """Compiles a krill AST into a ternary outcome vector over a batch;
    and/or fold with JS short-circuit rules (first non-true / first
    non-false)."""

    def __init__(self, pred_ast, scan):
        self.ast = pred_ast
        self.scan = scan
        self.leaves = {}
        self._collect(pred_ast)

    def _collect(self, ast):
        if not ast:
            return
        op = next(iter(ast))
        if op in ('and', 'or'):
            for sub in ast[op]:
                self._collect(sub)
            return
        field, const = ast[op]
        key = (field, op, jsv.json_stringify(const))
        if key not in self.leaves:
            self.leaves[key] = Leaf(field, op, const)
            if field not in self.scan.raw_columns:
                self.scan.raw_columns[field] = mod_batch.RawColumn()
            if field not in self.scan.filter_fields:
                self.scan.filter_fields.append(field)

    def outcomes(self, provider):
        return self._eval(self.ast, provider)

    def _eval(self, ast, provider):
        if not ast:
            return np.full(provider.n, TRUE, dtype=np.int8)
        op = next(iter(ast))
        if op in ('and', 'or'):
            outs = [self._eval(sub, provider) for sub in ast[op]]
            state = outs[0].copy()
            stop = TRUE if op == 'and' else FALSE
            for o in outs[1:]:
                m = state == stop
                state[m] = o[m]
            return state
        field, const = ast[op]
        key = (field, op, jsv.json_stringify(const))
        return provider.leaf_outcomes(self.leaves[key])


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

class VectorScan(object):
    """Batch-at-a-time scan with results identical to scan.StreamScan."""

    def __init__(self, query, time_field, pipeline, ds_filter=None,
                 device=None):
        self.query = query
        # torch device for step 5 (None: numpy on the host).  The
        # reference runs it on the device only under its forced engine;
        # auto mode's host batches stay on numpy (AutoDeviceScan)
        self.device = device
        self.agg_device = device
        self.filter_fields = []
        self.raw_columns = {}
        self.string_columns = {}
        self._dict_code_cache = {}

        self.ds_pred = self.user_pred = None
        if ds_filter is not None:
            self.ds_pred = VectorPredicate(ds_filter, self)
            self.ds_stage = pipeline.stage('Datasource filter')
        if query.qc_filter is not None:
            self.user_pred = VectorPredicate(query.qc_filter, self)
            self.user_stage = pipeline.stage('User filter')

        self.synthetic = list(query.qc_synthetic)
        self.time_bounds = None
        if query.qc_before is not None or query.qc_after is not None:
            assert isinstance(time_field, str)
            self.synthetic.append({'name': 'dn_ts', 'field': time_field,
                                   'date': ''})
            self.time_bounds = (mod_query._ceil_div(query.qc_after, 1000),
                                mod_query._ceil_div(query.qc_before,
                                                    1000))
        self.synth_stage = pipeline.stage('Datetime parser') \
            if self.synthetic else None
        self.time_stage = pipeline.stage('Time filter') \
            if self.time_bounds else None

        self.aggr = Aggregator(query, stage=pipeline.stage('Aggregator'))
        for b in query.qc_breakdowns:
            if b['name'] not in query.qc_bucketizers:
                self.string_columns[b['name']] = mod_batch.StringColumn()

        # per-breakdown decode plan for _emit_unique: bucketized columns
        # carry raw ordinals ('ord'), string columns carry codes into
        # the (append-only) engine dictionary
        self._breakdown_cols = []
        for b in query.qc_breakdowns:
            if b['name'] in query.qc_bucketizers:
                self._breakdown_cols.append(('ord', None))
            else:
                self._breakdown_cols.append(
                    ('str', self.string_columns[b['name']]))
        self._defer = None        # ([col chunk lists], [weight chunks])
        self._defer_rows = 0
        self._defer_enabled = True

    # -- projection (what the native parser must extract) -----------------

    def projection(self):
        """[(path, date_hint, need_dict)] of every field the scan reads
        from raw records.  need_dict marks paths whose per-field string
        dictionary the engine may read (filter leaves, breakdown
        columns); date-only sources are consumed via the pre-parsed
        date columns and their dictionaries — potentially one entry per
        record for timestamp fields — must not be materialized."""
        date = {}
        need_dict = {}
        for f in self.filter_fields:
            date.setdefault(f, False)
            need_dict[f] = True
        for fieldconf in self.synthetic:
            date[fieldconf['field']] = True
            need_dict.setdefault(fieldconf['field'], False)
        for b in self.query.qc_breakdowns:
            synth = any(s['name'] == b['name'] for s in self.synthetic)
            if not synth:
                date.setdefault(b['name'], False)
                need_dict[b['name']] = True
        return [(p, date[p], need_dict[p]) for p in date]

    # -- per-batch execution ----------------------------------------------

    def _dict_codes(self, provider, field, rawcol):
        cache_key = (id(provider), field)
        codes = self._dict_code_cache.get(cache_key)
        if codes is None:
            codes = rawcol.encode(provider.raw(field))
            self._dict_code_cache[cache_key] = codes
        return codes

    def write_batch(self, records, weights):
        """One batch of parsed records (the record path: no columnar
        parser) with their point values."""
        if len(records) == 0:
            return
        self._dict_code_cache.clear()
        provider = DictColumns(records, self)
        self._process(provider, weights_array(weights))

    def write_native_batch(self, parser, weights):
        if parser.batch_size() == 0:
            return
        provider = NativeColumns(parser)
        self._process(provider, np.asarray(weights, dtype=np.float64))

    def _process(self, provider, weights, alive=None):
        n = provider.n
        alive = np.ones(n, dtype=bool) if alive is None \
            else alive.copy()

        for pred, stage in ((self.ds_pred,
                             getattr(self, 'ds_stage', None)),
                            (self.user_pred,
                             getattr(self, 'user_stage', None))):
            if pred is None:
                continue
            stage.bump('ninputs', int(alive.sum()))
            out = pred.outcomes(provider)
            nfail = int((alive & (out == ERROR)).sum())
            ndrop = int((alive & (out == FALSE)).sum())
            if nfail:
                stage.bump('nfailedeval', nfail)
            if ndrop:
                stage.bump('nfilteredout', ndrop)
            alive &= (out == TRUE)
            stage.bump('noutputs', int(alive.sum()))

        synth_values = {}
        if self.synthetic:
            self.synth_stage.bump('ninputs', int(alive.sum()))
            first_err = np.zeros(n, dtype=np.uint8)
            for fieldconf in self.synthetic:
                vals, err = provider.date_column(fieldconf['field'])
                synth_values[fieldconf['name']] = vals
                first_err = np.where(first_err == 0, err, first_err)
            nundef = int((alive & (first_err == mod_batch.UNDEF)).sum())
            nbad = int((alive & (first_err == mod_batch.BADDATE)).sum())
            if nundef:
                self.synth_stage.bump('undef', nundef)
            if nbad:
                self.synth_stage.bump('baddate', nbad)
            alive &= (first_err == 0)
            self.synth_stage.bump('noutputs', int(alive.sum()))

        if self.time_bounds is not None:
            self.time_stage.bump('ninputs', int(alive.sum()))
            ts = synth_values['dn_ts']
            ok = (ts >= self.time_bounds[0]) & (ts < self.time_bounds[1])
            ndrop = int((alive & ~ok).sum())
            if ndrop:
                self.time_stage.bump('nfilteredout', ndrop)
            alive &= ok
            self.time_stage.bump('noutputs', int(alive.sum()))

        self.aggr.stage.bump('ninputs', int(alive.sum()))

        key_codes = []
        decoders = []
        for b in self.query.qc_breakdowns:
            name = b['name']
            if name in self.query.qc_bucketizers:
                if name in synth_values:
                    vals = synth_values[name]
                    valid = np.ones(n, dtype=bool)
                else:
                    vals, valid = provider.numeric_column(name)
                nbadnum = int((alive & ~valid).sum())
                if nbadnum:
                    self.aggr.stage.bump('nnonnumeric', nbadnum)
                alive = alive & valid
                ords = self._bucketize(b, vals)
                uniq, codes = _compact_codes(ords)
                key_codes.append(codes)
                decoders.append([int(u) for u in uniq])
            else:
                col = self.string_columns[name]
                if name in synth_values:
                    vals = synth_values[name]
                    codes = col.encode([
                        int(v) if float(v).is_integer() else float(v)
                        for v in vals])
                else:
                    codes = provider.string_codes(name, col)
                key_codes.append(np.asarray(codes, dtype=np.int64))
                decoders.append(col.dict.values)

        if not key_codes:
            total = float(np.sum(np.where(alive, weights, 0.0)))
            self.aggr.write_key((), self._weight(total))
            return

        radices = [len(d) for d in decoders]
        num_segments = 1
        for r in radices:
            num_segments *= max(r, 1)
        if num_segments > MAX_DENSE_SEGMENTS or 0 in radices or \
                (num_segments > max(65536, 4 * n)
                 and self.agg_device is None):
            # high-cardinality batch: the dense accumulator would touch
            # O(num_segments) memory several times per batch (bincount +
            # first-occurrence table) for a key space far larger than
            # the batch itself — the sort-based merge is O(n log n) on
            # the batch and emits the identical first-occurrence order
            self._sparse_merge(key_codes, decoders, weights, alive)
            return

        dense = self._dense_aggregate(key_codes, radices, weights, alive,
                                      n)

        # Which keys occurred (including zero-weight ones — the host
        # reference emits those too), and in what order: inserting each
        # distinct tuple at its first-occurrence position makes the
        # walk reproduce the host path's emission order exactly.
        fused_host = np.zeros(n, dtype=np.int64)
        for codes, r in zip(key_codes, radices):
            fused_host = fused_host * r + codes
        idx = np.nonzero(alive)[0]
        if num_segments <= max(65536, 4 * n):
            # dense: reversed fancy assignment keeps each code's FIRST
            # occurrence index in O(n + segments); the sort is over
            # groups, not records
            first = np.full(num_segments, -1, dtype=np.int64)
            first[fused_host[idx[::-1]]] = idx[::-1]
            occurred = np.nonzero(first >= 0)[0]
            order = np.argsort(first[occurred], kind='stable')
            fused_order = occurred[order]
            rows = first[occurred][order]
        else:
            # sparse key space: sort only the alive records
            uniq, first_idx = np.unique(fused_host[idx],
                                        return_index=True)
            order = np.argsort(first_idx, kind='stable')
            fused_order = uniq[order]
            rows = idx[first_idx[order]]

        # read each unique's key from its first-occurrence row (no
        # per-key divmod) as GLOBAL codes: raw bucket ordinals, engine
        # dictionary codes for strings
        gcols = []
        for (kind, _), codes, dec in zip(self._breakdown_cols,
                                         key_codes, decoders):
            cc = codes[rows]
            if kind == 'ord':
                gcols.append(np.asarray(dec, dtype=np.int64)[cc])
            else:
                gcols.append(np.asarray(cc, dtype=np.int64))
        self._emit_unique(gcols, dense[fused_order])

    def _weight(self, w):
        w = float(w)  # numpy scalar -> python (affects str() rendering)
        return int(w) if w.is_integer() else w

    def _bucketize(self, b, vals):
        bz = self.query.qc_bucketizers[b['name']]
        if isinstance(bz, mod_query.P2Bucketizer):
            exp = np.frexp(vals)[1]
            return np.where(vals < 1, 0, exp).astype(np.int64)
        return np.floor(vals / bz.step).astype(np.int64)

    def _dense_aggregate(self, key_codes, radices, weights, alive, n):
        num_segments = 1
        for r in radices:
            num_segments *= r

        if self.agg_device is not None:
            # The device sums are integer and exact only when the
            # batch's total integer weight fits i32; float or oversized
            # weights use the f64 host path (the reference contract is
            # exact sums).
            int_w = bool(np.all(weights == np.floor(weights)))
            total = float(np.abs(weights).sum())
            if int_w and total < 2 ** 31:
                import torch
                from .ops import cuda_kernels
                from .ops.kernels import make_aggregate
                dev = self.agg_device
                codes = torch.from_numpy(
                    np.stack(key_codes).astype(np.int32)).to(dev)
                w = torch.from_numpy(weights.astype(np.int32)).to(dev)
                al = torch.from_numpy(np.asarray(alive, dtype=bool)).to(
                    dev)
                if cuda_kernels.should_use(num_segments, total):
                    dense = cuda_kernels.onehot_dense(radices, codes, w,
                                                      al)
                else:
                    dense = make_aggregate(tuple(radices))(codes, w, al)
                return dense.cpu().numpy().astype(np.float64)

        fused = np.zeros(n, dtype=np.int64)
        for codes, r in zip(key_codes, radices):
            fused = fused * r + codes
        w = np.where(alive, weights, 0.0)
        return np.bincount(fused, weights=w, minlength=num_segments)

    def _sparse_merge(self, key_codes, decoders, weights, alive):
        """Cardinality overflow: the composite key space exceeds
        MAX_DENSE_SEGMENTS, so no dense accumulator.  Vectorized hash
        aggregation instead: group the batch by unique key tuples
        (np.unique), sum weights per group (bincount), and merge the
        groups into the running Aggregator in first-occurrence order —
        identical emission order to the dense path and the per-record
        host reference, with Python work O(unique tuples), not
        O(records).  The spill is surfaced in --counters
        ('nspillrecords' on the aggregator stage): memory is now
        bounded by unique output tuples, the reference's scaling law
        (README.md:668-681), rather than the dense budget."""
        idx = np.nonzero(alive)[0]
        if len(idx) == 0:
            return
        self.aggr.stage.bump('nspillrecords', int(len(idx)))

        gcols = []
        for (kind, _), codes, dec in zip(self._breakdown_cols,
                                         key_codes, decoders):
            cc = np.asarray(codes, dtype=np.int64)[idx]
            if kind == 'ord':
                gcols.append(np.asarray(dec, dtype=np.int64)[cc])
            else:
                gcols.append(cc)
        sink = getattr(self.aggr, 'write_columnar', None)
        if sink is not None and len(idx) >= DEFER_UNIQUE:
            # MT worker feeding a radix merge: skip the per-batch
            # unique entirely — in a high-cardinality batch it barely
            # shrinks the rows (that is what made it spill), so hand
            # the raw rows over and dedup ONCE in the merge, whose
            # first-occurrence compaction yields the identical order
            sink(gcols, np.asarray(weights, dtype=np.float64)[idx],
                 self._breakdown_cols)
            return
        first_idx, inv, order = _unique_rows(gcols)
        wsum = np.bincount(inv, weights=weights[idx],
                           minlength=len(first_idx))
        rows = first_idx[order]
        self._emit_unique([arr[rows] for arr in gcols], wsum[order])

    # -- unique-tuple emission / deferred columnar merge -------------------

    def _emit_unique(self, gcols, wvals):
        """One batch's aggregation result: per-column GLOBAL codes (raw
        bucket ordinals / engine string-dictionary codes, both stable
        across batches) in first-occurrence order, with dense weight
        sums.  Written straight into the Aggregator, or — once a batch
        crosses DEFER_UNIQUE tuples — appended to the deferred columnar
        buffer collapsed at finish, so high-cardinality scans do
        per-tuple Python work once per OUTPUT tuple, not per batch."""
        sink = getattr(self.aggr, 'write_columnar', None)
        if sink is not None and gcols and len(wvals) >= DEFER_UNIQUE:
            # MT worker with a radix-merge sink (scan_mt.BatchRecorder):
            # hand the raw code columns across the thread boundary
            # instead of decoding per tuple; the worker's column objects
            # ride along so the merger can translate string codes into
            # the main scanner's dictionaries (scan_mt.RadixMerge)
            sink(gcols, wvals, self._breakdown_cols)
            return
        if self._defer is None and self._defer_enabled and gcols and \
                len(wvals) >= DEFER_UNIQUE:
            self._defer = ([[] for _ in gcols], [])
        if self._defer is not None:
            cols, ws = self._defer
            for lst, arr in zip(cols, gcols):
                lst.append(np.asarray(arr, dtype=np.int64))
            ws.append(np.asarray(wvals, dtype=np.float64))
            self._defer_rows += len(wvals)
            if self._defer_rows > DEFER_COMPACT_ROWS:
                self._defer_compact()
            return
        cols_vals = []
        for arr, (kind, col) in zip(gcols, self._breakdown_cols):
            if kind == 'str':
                values = col.dict.values
                cols_vals.append([values[c] for c in arr.tolist()])
            else:
                cols_vals.append(arr.tolist())
        write_key = self.aggr.write_key
        if not cols_vals:
            for w in np.asarray(wvals, dtype=np.float64).tolist():
                write_key((), self._weight(w))
            return
        for keys, w in zip(zip(*cols_vals),
                           np.asarray(wvals,
                                      dtype=np.float64).tolist()):
            write_key(keys, self._weight(w))

    def _defer_compact(self):
        """Collapse the deferred buffer to its unique tuples (weights
        summed, first-occurrence order preserved) — bounds buffer
        memory by unique tuples, the reference's scaling law
        (README.md:668-681)."""
        cols, ws = self._defer
        gcols = [c[0] if len(c) == 1 else np.concatenate(c)
                 for c in cols]
        w = ws[0] if len(ws) == 1 else np.concatenate(ws)
        first_idx, inv, order = _unique_rows(gcols)
        wsum = np.bincount(inv, weights=w, minlength=len(first_idx))
        rows = first_idx[order]
        self._defer = ([[arr[rows]] for arr in gcols], [wsum[order]])
        self._defer_rows = len(rows)

    def _defer_final(self):
        if self._defer is None:
            return
        cols, ws = self._defer
        flat = self.aggr.flat
        if flat and any(isinstance(w, int) and abs(w) > 2 ** 53
                        for w in flat.values()):
            # exact integer weights beyond f64 in the flat prefix: the
            # columnar merge would round them; keep the flat dict and
            # write the deferred tuples into it instead (rare)
            self._defer_compact()
            (dcols, dws), self._defer = self._defer, None
            self._defer_enabled = False
            self._emit_unique([c[0] for c in dcols], dws[0])
            return
        if flat:
            # tuples written before the defer engaged (small early
            # batches, MT merges): prepend them as columns — they came
            # first, so first-occurrence order survives the re-compact
            pre_cols = [[] for _ in self._breakdown_cols]
            pre_w = []
            # dict.code appends unseen values (flat keys may have been
            # decoded by an MT worker's separate dictionary)
            encoders = [(col.dict.code if kind == 'str' else None)
                        for kind, col in self._breakdown_cols]
            for keys, w in flat.items():
                for lst, enc, k in zip(pre_cols, encoders, keys):
                    lst.append(enc(k, k) if enc is not None else k)
                pre_w.append(w)
            for c, pre in zip(cols, pre_cols):
                c.insert(0, np.asarray(pre, dtype=np.int64))
            ws.insert(0, np.asarray(pre_w, dtype=np.float64))
            flat.clear()
        if len(ws) > 1:
            # a single chunk is one batch's (or one device epoch's)
            # already-unique tuples: nothing to merge
            self._defer_compact()
        cols, ws = self._defer
        self._defer = None
        self._defer_enabled = False   # direct write from here on
        decoders = [('str', col.dict.values) if kind == 'str'
                    else ('ord', None)
                    for kind, col in self._breakdown_cols]
        self.aggr.set_columnar([c[0] for c in cols], ws[0], decoders)

    def finish(self):
        self._defer_final()
        return self.aggr
