"""Stacked cross-shard index-query execution.

Counterpart of dragnet_tpu/index_query_stack.py.  Shard readers only
*load* matching column blocks (mmap'd DNC columns / raw SQLite rows;
index_query.IndexQuerier.stack_blocks, index_dnc.DncIndexQuerier.
stack_blocks); this module concatenates them — with a per-shard
provenance column — into one large columnar batch, and a single
vectorized fused-key aggregation produces the final result, installed
into the Aggregator columnarly (aggr.set_columnar).  Python-object
work is O(output tuples + dictionary entries), not O(shards x groups).

Byte parity with the sequential per-shard loop is structural:

* Within one shard, the sequential path inserts key tuples in the
  group-by kernel's ASCENDING key order (native_index.groupby_native /
  SQLite GROUP BY both sort: i64 columns numerically, text columns
  NULL-first in byte order).  Across shards, tuples first-occur in
  find order, and the final points() order depends exactly on that
  first-occurrence order plus numeric re-sorting.
* The stacked batch therefore carries, per row, the shard index and a
  per-column SORT key (raw values for i64 columns, byte-order ranks
  for dictionary columns, SQLite type-order ranks for row columns);
  one stable sort over (shard, sortkeys...) followed by
  first-occurrence unique enumerates the aggregate tuples in exactly
  the order the sequential loop inserted them.
* Key DECODE semantics (jsv.to_string of i64 values, NULL -> "null",
  the numeric-string coercion and drop rule for bucketized fields) are
  applied once per unique column value via the same jsvalues/
  bucketizer functions the per-shard lanes call per group.

Exactness gate: weight sums.  A single global sum reproduces the
per-shard f64 sums merged with Python number addition digit for digit
only when every weight is an integer and the total magnitude stays
within f64's exact-integer range (2^53).  Queries outside that
envelope fall back to the per-shard loop.

Device lane: the per-tuple weight sums go through
device_index.aggregate_weights, the slot-packed i64 fold on the card
(exact for the integer weights the gate admits, so device and host
results are bit-equal).  This module also keeps the reference's
single-dispatch lane, K7a (`_sums_program` / `_device_sums`): `dn
serve`'s residency pre-warm runs it at its two shapes.
"""

import os

import numpy as np

from . import jsvalues as jsv


def stack_mode():
    """DN_IQ_STACK: 'auto' (default) engages the stacked path whenever
    the query shape and data allow, falling back to the per-shard loop
    otherwise; '0' pins the per-shard loop; '1' forces stacking where
    eligible (same routing as auto today; reserved for auto to grow
    heuristics).  `dn query --iq-stack` overrides per run."""
    v = os.environ.get('DN_IQ_STACK', 'auto')
    return v if v in ('auto', '0', '1') else 'auto'


def stack_enabled():
    return stack_mode() != '0'


def stack_eligible(query):
    """Whether the stacked path's column mapping is provably 1:1 with
    the per-shard lanes: every breakdown selects its own column
    (field == name), so the group-by projection covers every breakdown
    in order — the same gate as the DNC _execute_keys fast lane."""
    for b in query.qc_breakdowns:
        if b.get('field', b['name']) != b['name']:
            return False
        if b['name'] == 'value':
            # a breakdown shadowing the value column aliases in the
            # SQLite SELECT; the row path's semantics are subtle
            # enough that the per-shard loop keeps that case
            return False
    return True


class _GateFailed(Exception):
    """The exactness gate rejected a shard mid-load: unwind the
    fan-out and let the per-shard path execute the query."""


class _StrDict(object):
    """Insertion-ordered final-string dictionary for one breakdown:
    every source kind (decoded DNC dictionary entries, i64 values via
    to_string, raw SQLite row values) funnels into one code space, so
    an i64 42 in one shard and a text "42" in a mixed-tree sibling
    merge exactly as the sequential loop's flat map would."""

    __slots__ = ('index', 'values')

    def __init__(self):
        self.index = {}
        self.values = []

    def code(self, s):
        c = self.index.get(s)
        if c is None:
            c = len(self.values)
            self.index[s] = c
            self.values.append(s)
        return c


def _shard_values(sh):
    """(values f64 array, all_int) for one shard's block.  SQLite rows
    carry raw Python values (int for INTEGER storage); DNC carries the
    file's integrality flags.  The gate verdict comes FIRST: a value
    column holding non-numeric storage (flexibly-typed SQLite files
    from foreign writers) must fail the gate, not crash the f64
    conversion — the per-shard path handles those via SUM coercion."""
    values, isint = sh[2], sh[3]
    if isint is None:
        if not all(type(v) is int for v in values):
            return None, False
        return (np.asarray(values, dtype=np.float64)
                if len(values) else np.zeros(0, dtype=np.float64),
                True)
    return values, (bool(np.all(isint)) if len(isint) else True)


def _sqlite_sort_key(v):
    """SQLite's cross-type ordering for a stored value: NULL, then
    numerics by value (INTEGER and REAL compare exactly), then text in
    byte (BINARY-collation) order, then BLOBs (foreign writers only;
    our sinks never store them)."""
    if v is None:
        return (0, 0)
    if isinstance(v, str):
        return (2, v.encode('utf-8', 'surrogatepass'))
    if isinstance(v, bytes):
        return (3, v)
    return (1, v)


def canonical_item_sort(items):
    """Sort (key_tuple, value) items into the per-shard emission order
    both engines produce for a GROUP BY (SQLite's ORDER BY collation;
    groupby_native matches it) — the rollup planner's merge of a
    base+generations group replays through this so its item stream is
    byte-identical to querying the compacted shard."""
    return sorted(items,
                  key=lambda kv: tuple(_sqlite_sort_key(v)
                                       for v in kv[0]))


def _coerce_bucket(v, bz):
    """One decoded value through the shared bucketized-field coercion
    (aggr.coerce_bucket_value — the same rule the per-record and
    per-shard lanes apply).  Returns the bucket ordinal or None
    (drop the tuple)."""
    from .aggr import coerce_bucket_value
    v = coerce_bucket_value(v)
    if v is None:
        return None
    return bz.bucketize(v)


class _BreakdownStack(object):
    """One breakdown's stacked columns across shards: per-shard parts
    of (sort key, aggregate code), with dictionary/row-value ranks
    resolved after every shard has loaded (ranks are global; per-shard
    parts reference them by id)."""

    def __init__(self, bz):
        self.bz = bz                       # bucketizer or None
        self.sdict = _StrDict() if bz is None else None
        self.gindex = {}                   # dict-column bytes -> gid
        self.gbytes = []
        self.gstrings = []
        self.oindex = {}                   # row-column value -> oid
        self.ovalues = []
        self.parts = []                    # per-shard ('i64'|'gid'|'oid', ...)

    # -- per-shard ingestion ------------------------------------------------

    def add_i64(self, arr):
        self.parts.append(('i64', arr))

    def add_dict(self, codes, entries, strings):
        # intern only entries REFERENCED by mask-selected rows: the
        # per-shard lane decodes (and bucket-coerces) per selected
        # group only, so an entry belonging solely to filtered-out
        # rows must never reach the coercion tables — and narrow
        # filtered queries skip O(dictionary) work per shard
        used = np.unique(codes[codes >= 0]) if len(codes) else codes
        if len(used):
            gid = np.full(len(entries), -1, dtype=np.int64)
            gindex = self.gindex
            for i in used.tolist():
                e = entries[i]
                g = gindex.get(e)
                if g is None:
                    g = len(self.gbytes)
                    gindex[e] = g
                    self.gbytes.append(e)
                    self.gstrings.append(strings[i])
                gid[i] = g
            rows = gid[np.maximum(codes, 0)]
            rows = np.where(codes >= 0, rows, np.int64(-1))
        else:
            rows = np.full(len(codes), -1, dtype=np.int64)
        self.parts.append(('gid', rows))

    def add_rows(self, lst):
        oindex = self.oindex
        ovalues = self.ovalues
        out = np.empty(len(lst), dtype=np.int64)
        for i, v in enumerate(lst):
            o = oindex.get(v)
            if o is None:
                o = len(ovalues)
                oindex[v] = o
                ovalues.append(v)
            out[i] = o
        self.parts.append(('oid', out))

    # -- global resolution --------------------------------------------------

    def _dict_tables(self):
        """(sort rank, agg code, drop) per dictionary gid; NULL (-1)
        handled by the callers via the -1 sentinel."""
        ng = len(self.gbytes)
        order = sorted(range(ng), key=self.gbytes.__getitem__)
        rank = np.empty(max(ng, 1), dtype=np.int64)
        for pos, g in enumerate(order):
            rank[g] = pos
        agg = np.empty(max(ng, 1), dtype=np.int64)
        drop = np.zeros(max(ng, 1), dtype=bool)
        for g in range(ng):
            s = self.gstrings[g]
            if self.bz is None:
                agg[g] = self.sdict.code(s)
            else:
                o = _coerce_bucket(s, self.bz)
                if o is None:
                    drop[g] = True
                    agg[g] = 0
                else:
                    agg[g] = o
        return rank, agg, drop

    def _row_tables(self):
        no = len(self.ovalues)
        order = sorted(range(no),
                       key=lambda i: _sqlite_sort_key(self.ovalues[i]))
        rank = np.empty(max(no, 1), dtype=np.int64)
        for pos, o in enumerate(order):
            rank[o] = pos
        agg = np.empty(max(no, 1), dtype=np.int64)
        drop = np.zeros(max(no, 1), dtype=bool)
        for o in range(no):
            v = self.ovalues[o]
            if self.bz is None:
                agg[o] = self.sdict.code(jsv.to_string(v))
            else:
                b = _coerce_bucket(v, self.bz)
                if b is None:
                    drop[o] = True
                    agg[o] = 0
                else:
                    agg[o] = b
        return rank, agg, drop

    def _resolve_i64(self, data):
        """(sortkey, aggcode, drop) for concatenated i64 rows."""
        if not len(data):
            return data, np.zeros(0, dtype=np.int64), None
        uv, inv = np.unique(data, return_inverse=True)
        if self.bz is None:
            tab = np.fromiter(
                (self.sdict.code(jsv.to_string(int(u))) for u in uv),
                dtype=np.int64, count=len(uv))
        else:
            # same bucketize() call per unique value the per-shard
            # lane makes per group
            tab = np.fromiter(
                (self.bz.bucketize(int(u)) for u in uv),
                dtype=np.int64, count=len(uv))
        return data, tab[inv.reshape(-1)], None

    def _resolve_gid(self, data, tables):
        # tables is None when no shard had dictionary entries (empty
        # tables, or all rows NULL) — the guarded branches below
        # synthesize the all-NULL answer
        grank, gagg, gdrop = tables if tables is not None \
            else (None, None, None)
        n = len(data)
        nullv = data < 0
        safe = np.maximum(data, 0)
        sort = (np.where(nullv, np.int64(-1), grank[safe])
                if grank is not None
                else np.full(n, -1, dtype=np.int64))
        if self.bz is None:
            null_code = self.sdict.code('null')
            agg = (np.where(nullv, np.int64(null_code), gagg[safe])
                   if gagg is not None
                   else np.full(n, null_code, dtype=np.int64))
            return sort, agg, None
        # NULL in a bucketized field: non-numeric -> drop, exactly the
        # per-group rule
        agg = (gagg[safe] if gagg is not None
               else np.zeros(n, dtype=np.int64))
        dm = nullv.copy()
        if gdrop is not None:
            dm |= gdrop[safe]
        return sort, agg, (dm if dm.any() else None)

    def _resolve_oid(self, data, tables):
        if not len(data):
            # zero rows: no values were ever interned (tables is None)
            return data, np.zeros(0, dtype=np.int64), None
        orank, oagg, odrop = tables
        dm = None
        if self.bz is not None:
            dm = odrop[data]
            if not dm.any():
                dm = None
        return orank[data], oagg[data], dm

    def resolve(self):
        """Concatenated (sortkeys, aggcodes, dropmask-or-None) across
        the shard parts, in shard order.  Sort keys only need to be
        consistent WITHIN a shard (ties across shards are broken by
        the provenance column first), so the i64/rank scales may
        coexist; aggregate codes are global.  The single-kind case —
        every shard stores this breakdown the same way, i.e. any
        non-mixed tree — concatenates first and translates once;
        mixed trees translate per part."""
        dict_tables = self._dict_tables() if self.gbytes else None
        row_tables = self._row_tables() if self.ovalues else None
        kinds = set(k for k, _ in self.parts)
        if len(kinds) == 1:
            kind = next(iter(kinds))
            cat = (np.concatenate([d for _, d in self.parts])
                   if self.parts else np.zeros(0, dtype=np.int64))
            if kind == 'i64':
                return self._resolve_i64(cat)
            if kind == 'gid':
                return self._resolve_gid(cat, dict_tables)
            return self._resolve_oid(cat, row_tables)
        sort_parts = []
        agg_parts = []
        drop_parts = []
        any_drop = False
        for kind, data in self.parts:
            if kind == 'i64':
                sk, ak, dm = self._resolve_i64(data)
            elif kind == 'gid':
                sk, ak, dm = self._resolve_gid(data, dict_tables)
            else:
                sk, ak, dm = self._resolve_oid(data, row_tables)
            sort_parts.append(sk)
            agg_parts.append(ak)
            drop_parts.append(dm)
            any_drop = any_drop or dm is not None
        cat = (np.concatenate(sort_parts) if sort_parts
               else np.zeros(0, dtype=np.int64))
        agg = (np.concatenate(agg_parts) if agg_parts
               else np.zeros(0, dtype=np.int64))
        drop = None
        if any_drop:
            drop = np.concatenate(
                [d if d is not None else np.zeros(len(p), dtype=bool)
                 for d, (k, p) in zip(drop_parts, self.parts)])
        return cat, agg, drop

    def decoder(self):
        if self.bz is not None:
            return ('ord', None)
        return ('str', self.sdict.values)


# -- device lane -----------------------------------------------------------

# -- K7a: the single-dispatch device lane ---------------------------------

# one entry per warmed (pn, pu), as the reference's jit cache: the
# serve pre-warm reports what it holds
_SUMS_CACHE = {}
# K7a launches since process start (chip_smoke.py reads it)
launches = {'sums': 0}


def _pow2(x):
    p = 8
    while p < x:
        p <<= 1
    return p


def _sums_program(pn, pu):
    """K7a: (segment ids i64[pn], weights i64[pn]) -> i64[pu] sums on
    the ids' device, one i64 `index_add_` into a zeroed accumulator
    (integer atomics on CUDA: exact, independent of order).  Replaces
    the reference's jitted `segment_sum`
    (dragnet_tpu/index_query_stack.py `_sums_program`); shapes are
    pow2-padded as there."""
    prog = _SUMS_CACHE.get((pn, pu))
    if prog is None:
        import torch

        def prog(seg, w):
            launches['sums'] += 1
            return torch.zeros(pu, dtype=torch.int64,
                               device=seg.device).index_add_(0, seg, w)
        if len(_SUMS_CACHE) >= 32:
            _SUMS_CACHE.pop(next(iter(_SUMS_CACHE)))
        _SUMS_CACHE[(pn, pu)] = prog
    return prog


def _residency():
    """The serve-installed device residency manager, or None (bare CLI
    processes never configure one)."""
    from .serve import residency as mod_residency
    return mod_residency.active()


def _device_sums(inv, weights, nuniq, device=None):
    """Per-tuple weight sums on `device` (CUDA unless the caller asks
    for the CPU) as float64, or None on the structural host routes (a
    segment count past the dense ceiling, no rows).  Sums run in i64,
    so for integer weights the result is bit-equal to the host
    bincount.  A device failure raises: unlike the reference, there is
    no host fallback and no sticky availability verdict.

    Inside a residency-armed `dn serve` (serve/residency.py), the
    accumulator stays pinned on the card keyed by the content of the
    staged host columns: a request over the same rows skips the upload,
    the launch and the fetch, and answers with a private copy of the
    host array the first execution fetched, while the writer epoch
    retires pins on any index write."""
    import torch
    from .engine import MAX_DENSE_SEGMENTS
    from .ops import resolve_device
    if nuniq > MAX_DENSE_SEGMENTS or len(inv) == 0:
        return None
    dev = resolve_device(device)
    pn = _pow2(len(inv))
    pu = _pow2(nuniq)
    seg = np.full(pn, pu - 1, dtype=np.int64)
    seg[:len(inv)] = inv
    w = np.zeros(pn, dtype=np.int64)
    w[:len(inv)] = weights.astype(np.int64)

    res = _residency()
    rkey = repoch = None
    if res is not None:
        from . import index_query_mt as mod_iqmt
        from .serve import residency as mod_residency
        rkey = mod_residency.content_key('iq-sums', (seg, w),
                                         (pn, pu, nuniq))
        repoch = mod_iqmt.cache_epoch()
        pinned = res.get(rkey, repoch)
        if pinned is not None:
            # the pinned copy is shared across requests; hand out a
            # private clone (downstream aggregation may scale it)
            return pinned.copy()
    dense = _sums_program(pn, pu)(torch.from_numpy(seg).to(dev),
                                  torch.from_numpy(w).to(dev))
    host = dense[:nuniq].cpu().numpy().astype(np.float64)
    if res is not None:
        # pin the accumulator (never written again) and its fetched
        # copy; future hits book the upload and fetch bytes paid here
        res.put(rkey, repoch, dense, host,
                h2d_bytes=seg.nbytes + w.nbytes)
        return host.copy()
    return host


def _aggregate_weights(inv, weights, nuniq, stage=None, shard_ctx=None,
                       engine='device', device=None):
    """The aggregation seam: the batched device engine
    (device_index.aggregate_weights — forced by the port's device
    engine unless DN_INDEX_DEVICE=0) or the host bincount,
    byte-identical either way.  Device engagement bumps only HIDDEN
    counters (the --counters bytes are pinned)."""
    from . import device_index as mod_di
    return mod_di.aggregate_weights(inv, weights, nuniq, stage=stage,
                                    shard_ctx=shard_ctx, engine=engine,
                                    device=device)


# -- the stacked execution -------------------------------------------------

def _order_rows(shard_ids, sort_cols):
    """Stable permutation ordering rows by (shard, sortkey_0, ...,
    sortkey_k) — shard provenance first, then the per-column sort
    scales.  Fused into one mixed-radix int64 argsort when the span
    product fits (the sort is the stacked path's largest single numpy
    op; one fused key beats a (k+1)-key lexsort ~2x here), lexsort
    otherwise."""
    from .engine import fuse_codes
    cols = [shard_ids] + sort_cols      # most significant first
    fused = fuse_codes(cols)
    if fused is None:
        return np.lexsort(tuple(reversed(cols)))
    return np.argsort(fused, kind='stable')


def _commit_counters(index_list, aggr, npts):
    """Counter parity with the per-shard merge loop: one Index List
    input/output and one aggregator-stage input per key item the
    sequential fan-in would have merged."""
    if not npts:
        return
    index_list.bump('ninputs', npts)
    index_list.bump('noutputs', npts)
    if aggr.stage is not None:
        aggr.stage.bump('ninputs', npts)


def run_stacked(paths, query, aggr, index_list, engine='device',
                device=None):
    """Execute the index query as ONE stacked aggregation over every
    shard's matching rows.  Returns True when the result (and the
    fan-in counters) were committed into `aggr`, byte-identical to the
    sequential per-shard loop; False when an exactness gate failed —
    the caller falls back to the per-shard path with `aggr` and the
    stage counters untouched.  Shard errors raise the same DNError
    contract as the sequential loop (first shard in find order).
    `engine`/`device` choose the aggregation lane
    (device_index.aggregate_weights).  Shards load on the calling
    thread, and every device call follows the loads."""
    from . import device_index as mod_di
    from . import index_query_mt as mod_iqmt
    from .engine import _unique_rows, fuse_codes

    bds = query.qc_breakdowns
    nb = len(bds)

    # exactness gate, checked per shard AS IT LOADS: all-integer
    # weights within f64's exact range, so one global sum reproduces
    # the per-shard f64 sums + Python int merge digit for digit (any
    # summation order is exact).  Aborting the fan-out at the first
    # ineligible shard keeps the fallback cheap — a float-weight tree
    # pays one shard's load, not the whole tree's, before the
    # per-shard path takes over.
    shards = []
    vals_list = []
    idents = []
    state = {'total_abs': 0.0}

    def on_blocks(sh, path, statkey):
        v, ok = _shard_values(sh)
        if ok and len(v):
            state['total_abs'] += float(np.abs(v).sum())
            ok = state['total_abs'] < 2.0 ** 53
        if not ok:
            raise _GateFailed()
        shards.append(sh)
        vals_list.append(v)
        idents.append((path, statkey))

    from .obs import metrics as obs_metrics
    try:
        with obs_metrics.timed_stage('index_query_stack.load',
                                     nshards=len(paths)):
            mod_iqmt.run_shard_loads(paths, query, on_blocks)
    except _GateFailed:
        return False
    nshards = len(shards)

    if nb == 0:
        # per-shard: write_key((), int(shard_sum)) — NULL SUM -> 0 for
        # empty shards — merged by integer addition
        total = 0
        for v in vals_list:
            if len(v):
                total += int(v.sum())
        _commit_counters(index_list, aggr, nshards)
        aggr.nrecords += nshards
        aggr.total += total
        mod_di.note_route('host: no breakdowns')
        return True

    stacks = [_BreakdownStack(query.qc_bucketizers.get(b['name']))
              for b in bds]
    for sh in shards:
        cols = sh[1]
        for st, col in zip(stacks, cols):
            if col[0] == 'i64':
                st.add_i64(col[1])
            elif col[0] == 'dict':
                st.add_dict(col[1], col[2], col[3])
            else:
                st.add_rows(col[1])

    nrows = [sh[0] for sh in shards]
    shard_ids = (np.repeat(np.arange(nshards, dtype=np.int64), nrows)
                 if nshards else np.zeros(0, dtype=np.int64))
    values = (np.concatenate(vals_list) if vals_list
              else np.zeros(0, dtype=np.float64))

    sort_cols = []
    agg_cols = []
    decoders = []
    drop = None
    for st in stacks:
        sk, ak, dm = st.resolve()
        sort_cols.append(sk)
        agg_cols.append(ak)
        decoders.append(st.decoder())
        if dm is not None:
            drop = dm if drop is None else (drop | dm)

    if drop is not None:
        keep = ~drop
        shard_ids = shard_ids[keep]
        values = values[keep]
        sort_cols = [c[keep] for c in sort_cols]
        agg_cols = [c[keep] for c in agg_cols]

    n = len(values)
    if n == 0:
        # empty result: leave the aggregator untouched — its flat path
        # already emits nothing, without the 'noutputs' counter key a
        # zero-length columnar install would create (the per-shard
        # loop never bumps it on empty results)
        mod_di.note_route('empty result')
        return True

    # one stable sort over (shard, per-column sort keys) puts rows in
    # exactly the order the sequential loop scans groups; the first
    # occurrence of each aggregate tuple in this order IS its flat-map
    # insertion position
    with obs_metrics.timed_stage('index_query_stack.sort', nrows=n):
        perm = _order_rows(shard_ids, sort_cols)
        acols = [c[perm] for c in agg_cols]
        first_idx, inv, order = _unique_rows(acols)
    nuniq = len(first_idx)

    # rows are now shard-contiguous (the perm sorts shard-first) —
    # exactly the slices the batched device engine stages per shard
    sid = shard_ids[perm]
    with obs_metrics.timed_stage('index_query_stack.aggregate',
                                 nuniq=nuniq):
        wsum = _aggregate_weights(inv, values[perm], nuniq,
                                  stage=index_list,
                                  shard_ctx=(sid, idents, query),
                                  engine=engine, device=device)
    rows = first_idx[order]
    out_cols = [np.ascontiguousarray(c[rows]) for c in acols]
    weights = [int(w) for w in wsum[order].tolist()]

    # key-item counter parity: the per-shard loop merges one item per
    # DISTINCT tuple per shard
    pair = fuse_codes([sid, inv])
    if pair is not None:
        npts = len(np.unique(pair))
    else:
        npts = len(np.unique(np.stack([sid, inv], axis=1), axis=0))
    _commit_counters(index_list, aggr, npts)
    aggr.nrecords += npts
    aggr.set_columnar(out_cols, weights, decoders)
    return True
