"""Device-resident scan, dense mode: the per-batch pipeline after the
parse runs on a torch device.

Counterpart of dragnet_tpu/device_scan.py `DeviceScan` (dense mode):

    host:    C++ parse -> tagged columns -> one-pass batch stats ->
             upload (dtype-narrowed columns + small lookup tables;
             inputs the stats prove constant are synthesized on
             device instead of uploaded — the sticky upload profile)
    device:  predicate table-gathers + numeric compares -> ternary
             and/or fold -> date-error & time-bounds masks -> p2/linear
             bucketize -> mixed-radix key fusion -> the one-hot kernel
             (ops/cuda_kernels.py, adding into the resident
             accumulator) or an i64 index_add_ segment-sum, plus a
             first-occurrence scatter-min
             -> (dense, first, stage counters)

Each batch's (dense, first, counters) triple is folded into a
device-RESIDENT i64 accumulator (dense/counters add; first-occurrence
keys take a running min over batch_base + row), so a scan fetches once
per epoch, not once per batch.  Emission order is preserved exactly:
the accumulated first-occurrence key (batch_index << 32 | row) sorts
keys by batch, then by first row within the batch, which is the order
the host engine inserts them.

Exactness contract: everything uploaded is integer (narrowed columns,
i32 weights) or a table gather, and every device sum is integer, so the
arithmetic is exact and independent of the order of CUDA's atomics.
A batch that cannot be represented exactly (non-integral weights or
values, out-of-i32-range numbers, array-typed values in filter
fields, ...) takes the host engine for that batch, after the device
buffer is flushed so insertion order survives.

A key space beyond the dense accumulator (MAX_DENSE_SEGMENTS) runs the
SPARSE program instead: fused i64 keys sort-merged into a device-resident
compacted set (keys, weight sums, first occurrence) of bounded capacity,
grown by a host-side guard that flushes before a batch could overflow it.

DeviceScanStack folds N metric scans (a `dn build`) per batch over one
staged input dict, so a column several metrics read uploads once.

Not in this port yet: the pipelined dispatch.  Batches upload with plain
synchronous copies.
"""

import os

import numpy as np
import torch

from . import jsvalues as jsv
from . import log as mod_log
from . import native as mn
from . import query as mod_query
from .engine import (VectorScan, NativeColumns, MAX_DENSE_SEGMENTS,
                     _native_str_trans)
from .ops import resolve_device
from .ops import cuda_kernels
from .ops.kernels import FALSE, TRUE, ERROR, fold_and, fold_or

I32MIN = -(2 ** 31)
I32MAX = 2 ** 31 - 1
I64MAX = 2 ** 63 - 1
I16MIN = -(2 ** 15)
I16MAX = 2 ** 15 - 1

# numeric-row plans: outcome of <leaf op const> for an exact-int32 row
NUM_FALSE, NUM_TRUE, NUM_EQ, NUM_NE, NUM_LE, NUM_GE = range(6)

# device-resident sparse set (high-cardinality mode): initial capacity,
# growth ceiling.  24 bytes/slot of device memory; the host-side
# pressure guard flushes + grows before a batch could overflow the set
SPARSE_CAP0 = 1 << 20
SPARSE_CAP_MAX = 1 << 23

LOG = mod_log.get('device-scan')

# calls of the sparse fold (torch ops, no hand kernel): a run can show
# that its batches went through the sparse program
sparse_folds = {'fold_sparse': 0}


def _pow2(x):
    p = 8
    while p < x:
        p <<= 1
    return p


def numeric_leaf_plan(op, const):
    """(mode, threshold) evaluating `value <op> const` for values that
    are exact int32 numbers, with JS coercion semantics for const.
    Returns None when no exact integer plan exists."""
    import math
    if isinstance(const, bool):
        cf = 1.0 if const else 0.0
    elif isinstance(const, (int, float)):
        cf = jsv.as_float(const)
    elif isinstance(const, str):
        # number-vs-string compares coerce the string in JS (both for
        # loose == and for relational operators)
        cf = jsv.to_number(const)
    else:
        return None
    if cf != cf:  # NaN: == false, != true, relational false
        if op == 'ne':
            return (NUM_TRUE, 0)
        return (NUM_FALSE, 0)
    if op in ('eq', 'ne'):
        if math.isinf(cf) or cf != math.floor(cf) or \
                not (I32MIN <= cf <= I32MAX):
            return ((NUM_FALSE, 0) if op == 'eq' else (NUM_TRUE, 0))
        t = int(cf)
        return ((NUM_EQ, t) if op == 'eq' else (NUM_NE, t))
    if math.isinf(cf):
        big = cf > 0
        if op in ('lt', 'le'):
            return (NUM_TRUE, 0) if big else (NUM_FALSE, 0)
        return (NUM_FALSE, 0) if big else (NUM_TRUE, 0)
    f = math.floor(cf)
    if op == 'lt':
        t = int(f) - 1 if cf == f else int(f)   # v < c  <=>  v <= t
        mode = NUM_LE
    elif op == 'le':
        t = int(f)                              # v <= floor(c)
        mode = NUM_LE
    elif op == 'gt':
        t = int(f) + 1                          # v > c  <=>  v >= t
        mode = NUM_GE
    else:  # ge
        t = int(f) if cf == f else int(f) + 1   # v >= ceil(c)
        mode = NUM_GE
    if mode == NUM_LE:
        if t >= I32MAX:
            return (NUM_TRUE, 0)
        if t < I32MIN:
            return (NUM_FALSE, 0)
    else:
        if t <= I32MIN:
            return (NUM_TRUE, 0)
        if t > I32MAX:
            return (NUM_FALSE, 0)
    return (mode, t)


class _KeyPlan(object):
    """Per-breakdown device plan + its growing window/capacity state."""

    __slots__ = ('kind', 'name', 'field', 'step', 'lo', 'cap',
                 'host_translate', 'column', 'window_set')

    def __init__(self, kind, name, field=None, step=None, column=None):
        self.kind = kind          # 'str' | 'p2' | 'lin'
        self.name = name
        self.field = field or name
        self.step = step
        self.column = column      # engine StringColumn for 'str'
        self.lo = 0
        self.cap = 8 if kind != 'p2' else 32
        self.host_translate = False
        self.window_set = False   # 'lin' window anchored to data yet?

    def sig(self):
        return (self.kind, self.lo, self.cap, self.step,
                self.host_translate)


class DeviceScan(VectorScan):
    """VectorScan whose eligible batches execute fully on the device
    (`device`: a torch device or its name; CUDA unless the caller asks
    for the CPU)."""

    # accumulators at least this large are compacted ON DEVICE before
    # the fetch (argsort by first occurrence, gather occurred segments)
    COMPACT_MIN_SEGMENTS = 16384
    # speculative compacted-fetch width: one round trip when the
    # occurred count fits (the norm); a larger refetch otherwise
    COMPACT_K = 1 << 16
    # whether DeviceScanStack may fold this scan with its siblings
    STACKABLE = True

    def __init__(self, query, time_field, pipeline, ds_filter=None,
                 device=None):
        dev = resolve_device(device)
        VectorScan.__init__(self, query, time_field, pipeline,
                            ds_filter=ds_filter, device=dev)
        # input-key namespace: '' standalone; DeviceScanStack assigns
        # 'm<i>_' so per-scan inputs (leaf tables, translate tables,
        # synth columns) coexist in one merged inputs dict while
        # parser-derived columns stay shared across metrics
        self._pfx = ''
        self._disabled = False
        self._sticky = None       # upload-profile state (_stage_device)
        self._sparse_cap = SPARSE_CAP0
        self._sparse_ub = 0       # unique-count upper bound this epoch
        self._plans = None        # built from the query
        self._epoch_sig = None
        # device-resident (dense, first, cvec), or in sparse mode
        # (keys, wsum, first, cvec, stats=[nuniq, overflow])
        self._acc = None
        self._acc_meta = None     # epoch ('caps', 'cols', 'ns', ...)
        self._acc_batch = 0       # batches folded into the acc
        self._leaf_list = []      # [(key, Leaf)] in stable order
        self._leaf_tables = {}    # leaf idx -> (host_len, device tensor)
        self._ctabs = {}          # leaf idx -> device i8[16]
        self._trans_dev = {}      # plan name -> (host_len, device tensor)
        self._num_plans = []
        self._counter_spec = None
        self._synth_names = None
        self._build_static()

    # -- static (per-query) plan -------------------------------------------

    def _build_static(self):
        """Decide, once, whether this query can have a device program
        at all, and precompute everything that doesn't depend on data."""
        synth_names = set(s['name'] for s in self.synthetic)
        plans = []
        for b in self.query.qc_breakdowns:
            name = b['name']
            if name in self.query.qc_bucketizers:
                bz = self.query.qc_bucketizers[name]
                if isinstance(bz, mod_query.P2Bucketizer):
                    kind, step = 'p2', None
                else:
                    step = bz.step
                    if not (isinstance(step, int) and
                            not isinstance(step, bool) and
                            1 <= step <= I32MAX):
                        self._disabled = True
                        return
                    kind = 'lin'
                if name in synth_names:
                    field = next(s['field'] for s in self.synthetic
                                 if s['name'] == name)
                    plans.append(_KeyPlan(kind, name, field='\0synth:' +
                                          name, step=step))
                else:
                    plans.append(_KeyPlan(kind, name, step=step))
            else:
                if name in synth_names:
                    # synthetic (date) field used as a plain string key:
                    # host path stringifies parsed seconds; rare — host
                    self._disabled = True
                    return
                plans.append(_KeyPlan('str', name,
                                      column=self.string_columns[name]))
        self._plans = plans
        self._synth_names = synth_names

        for pred in (self.ds_pred, self.user_pred):
            if pred is None:
                continue
            for key, leaf in pred.leaves.items():
                if key not in [k for k, _ in self._leaf_list]:
                    self._leaf_list.append((key, leaf))
        for _, leaf in self._leaf_list:
            self._num_plans.append(numeric_leaf_plan(leaf.op, leaf.const))

        # counters, in the exact order the host engine bumps them
        # (always=False counters are only bumped when nonzero, matching
        # the host's conditional bumps)
        spec = []
        if self.ds_pred is not None:
            s = self.ds_stage
            spec += [(s, 'ninputs', True), (s, 'nfailedeval', False),
                     (s, 'nfilteredout', False), (s, 'noutputs', True)]
        if self.user_pred is not None:
            s = self.user_stage
            spec += [(s, 'ninputs', True), (s, 'nfailedeval', False),
                     (s, 'nfilteredout', False), (s, 'noutputs', True)]
        if self.synthetic:
            s = self.synth_stage
            spec += [(s, 'ninputs', True), (s, 'undef', False),
                     (s, 'baddate', False), (s, 'noutputs', True)]
        if self.time_bounds is not None:
            s = self.time_stage
            spec += [(s, 'ninputs', True), (s, 'nfilteredout', False),
                     (s, 'noutputs', True)]
        spec.append((self.aggr.stage, 'ninputs', True))
        spec.append((self.aggr.stage, 'nnonnumeric', False))
        # records aggregated through the unbounded-cardinality path
        # (always 0 in dense mode; kept so the order matches the host)
        spec.append((self.aggr.stage, 'nspillrecords', False))
        self._counter_spec = spec

    # -- per-batch entry ---------------------------------------------------

    def _process(self, provider, weights, alive=None):
        if not self._disabled and \
                self._try_device(provider, weights, alive):
            return
        self._flush()
        VectorScan._process(self, provider, weights, alive=alive)

    def finish(self):
        self._flush()
        self._defer_final()
        return self.aggr

    def _emit_counters(self, cvec):
        for (stage, name, always), v in zip(self._counter_spec, cvec):
            v = int(v)
            if always or v:
                stage.bump(name, v)

    def _decode_emit(self, meta, segs, wsum):
        """Decode fused segment codes -> global per-column codes and
        emit."""
        if len(segs) == 0:
            return
        self._emit_cols(meta, _decode_fused(segs, meta['caps']), wsum)

    def _emit_cols(self, meta, col_codes, wsum):
        """Per-column codes -> global codes (window offsets applied)
        -> the shared emit path."""
        if len(wsum) == 0:
            return
        gcols = []
        for (kind, lo), cc in zip(meta['cols'], col_codes):
            if kind == 'str':
                gcols.append(np.asarray(cc, dtype=np.int64))
            else:
                gcols.append(np.asarray(cc, dtype=np.int64) + lo)
        self._emit_unique(gcols, wsum)

    # -- eligibility + input assembly --------------------------------------

    def _try_device(self, provider, weights, alive):
        """Assemble device inputs for this batch; True when submitted.
        Any exactness precondition failure returns False (host path)."""
        if not isinstance(provider, NativeColumns):
            return False
        inputs = {}
        staged = self._stage_device(provider, weights, alive, inputs)
        if staged is None:
            return False
        self._run_staged(staged, inputs)
        return True

    def _upload(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _stage_device(self, provider, weights, alive, inputs):
        """Eligibility checks + device-input assembly for one batch,
        writing host arrays into the caller's `inputs` (shared across
        scans under DeviceScanStack: parser-derived columns use
        unprefixed keys so N metric scans upload them once; per-scan
        inputs carry self._pfx).  Returns the staged parameters
        (n, profile, caps, ns, total_w) or None when this batch must
        take the host path.  Commits plan-state (windows/caps) and
        flushes on epoch flips as side effects — safe even if a
        sibling scan later fails staging, since the host path computes
        the same results regardless of plan state."""
        n = provider.n
        pfx = self._pfx

        w = np.asarray(weights, dtype=np.float64)
        if len(w) != n or not np.all(np.isfinite(w)) or \
                not np.all(w == np.floor(w)):
            return None
        total_w = float(np.abs(w).sum())
        if total_w >= 2 ** 31 or (len(w) and
                                  (w.min() < I32MIN or w.max() > I32MAX)):
            return None

        # Upload profile: flags that let the device synthesize constant
        # inputs instead of uploading them (all-ones weights, no alive
        # mask, all-numeric filter fields, all-valid key columns).
        # Flags are STICKY toward the most general variant, so the
        # profile only ever widens across a scan.
        sk = self._sticky
        if sk is None:
            sk = self._sticky = {'w1': True, 'gen_alive': True,
                                 'filter': {}, 'kvalid': {}}
        sk['w1'] = w1 = sk['w1'] and bool(np.all(w == 1.0))
        sk['gen_alive'] = gen_alive = sk['gen_alive'] and alive is None
        if not gen_alive:
            inputs['alive'] = np.ones(n, dtype=bool) if alive is None \
                else np.asarray(alive, dtype=bool)
        if not w1:
            inputs['weights'] = w.astype(np.int32)

        # one-pass native batch statistics make the eligibility checks
        # O(1) numpy work per field (providers without them take the
        # numpy path)
        src = provider.parser

        # per-batch memo on the SHARED provider: each parser accessor
        # materializes a fresh array (ctypes copy); a field read twice
        # (or by several stacked metrics) pays that once
        memo = provider.__dict__.setdefault('_stage_memo', {})

        def _memo1(kind, f, fn):
            key = (kind, f)
            v = memo.get(key)
            if v is None:
                v = fn(f)
                memo[key] = v
            return v

        def _stats(f):
            fn = getattr(src, 'field_stats', None)
            return _memo1('stats', f, fn) if fn is not None else None

        def _widen(table, key, has_str, has_num, all_num):
            cur = table.get(key)
            if cur is None:
                cur = table[key] = [has_str, has_num, all_num]
            else:
                cur[0] = cur[0] or has_str
                cur[1] = cur[1] or has_num
                cur[2] = cur[2] and all_num
            return cur

        # dtype narrowing: per-record int columns upload as the
        # smallest dtype their observed range fits, widened stickily;
        # the device upcasts after the transfer
        dtypes = sk.setdefault('dtypes', {})

        def _narrow(key, arr, lo, hi):
            if 0 <= lo and hi <= 255:
                need = 1
            elif I16MIN <= lo and hi <= I16MAX:
                need = 2
            else:
                need = 3
            level = max(dtypes.get(key, need), need)
            dtypes[key] = level
            if level == 1:
                return arr.astype(np.uint8)
            if level == 2:
                return arr.astype(np.int16)
            return arr if arr.dtype == np.int32 \
                else arr.astype(np.int32)

        # filter fields: tags + string codes + exact-i32 numeric
        # values, each uploaded only when this scan has seen rows of
        # that kind in the field
        filter_profile = []
        for f in self.filter_fields:
            st = _stats(f)
            if st is not None:
                narr, i32ok, nmn_f, nmx_f, nnum, nstr = st
                if narr:
                    return None
                if nnum and not i32ok:
                    return None
                has_str, has_num, all_num = _widen(
                    sk['filter'], f, nstr > 0, nnum > 0, nnum == n)
                tags = _memo1('tags', f, src.tags_col) \
                    if not all_num else None
                strcodes = _memo1('str', f, src.strcodes_col) \
                    if has_str else None
                iv = _memo1('num', f, src.nums_i32) if has_num else None
                nrange = (int(nmn_f), int(nmx_f)) if nnum else (0, 0)
            else:
                tags, nums, strcodes = provider._field(f)
                if (tags == mn.TAG_ARRAY).any():
                    return None
                m = (tags == mn.TAG_INT) | (tags == mn.TAG_NUMBER)
                obs_num = bool(m.any())
                if obs_num:
                    nm = nums[m]
                    if not (np.all(np.isfinite(nm)) and
                            np.all(nm == np.floor(nm)) and
                            nm.min() >= I32MIN and nm.max() <= I32MAX):
                        return None
                has_str, has_num, all_num = _widen(
                    sk['filter'], f, bool((tags == mn.TAG_STRING)
                                          .any()), obs_num,
                    bool(m.all()))
                iv = None
                nrange = (0, 0)
                if has_num:
                    iv = np.zeros(n, dtype=np.int32)
                    if obs_num:
                        iv[m] = nums[m].astype(np.int64).astype(
                            np.int32)
                        nrange = (int(nums[m].min()),
                                  int(nums[m].max()))
            filter_profile.append((f, has_str, has_num, all_num))
            if not all_num:
                inputs['tags_' + f] = tags.astype(np.uint8, copy=False)
            if has_str and ('str_' + f) not in inputs:
                # -1 marks non-string rows (masked on device), so the
                # floor of the range is -1
                dlen = len(src.dictionary(f))
                inputs['str_' + f] = _narrow('str_' + f, strcodes,
                                             -1, dlen - 1)
            if has_num and ('num_' + f) not in inputs:
                inputs['num_' + f] = _narrow('num_' + f, iv, *nrange)

        # synthetic date fields: combined first-error + needed ts columns
        synth_vals = {}
        use_dstats = False
        if self.synthetic:
            dstats_fn = getattr(src, 'date_stats', None)
            first_ds = _memo1('dstats', self.synthetic[0]['field'],
                              dstats_fn) \
                if dstats_fn is not None else None
            use_dstats = first_ds is not None
            errs = None
            if use_dstats:
                # SHARED keys: under dstats the ts column is a pure
                # function of its source field ('tsf_<field>') and the
                # error chain of the ordered field list, so stacked
                # sibling scans reading the same date fields reuse one
                # upload
                terr_key = 'terr_' + '|'.join(
                    fc['field'] for fc in self.synthetic)
                for i, fc in enumerate(self.synthetic):
                    all_i32, nok = first_ds if i == 0 \
                        else _memo1('dstats', fc['field'], dstats_fn)
                    if nok and not all_i32:
                        return None
                    synth_vals[fc['name']] = _memo1(
                        'date', fc['field'], src.date_i32)
                errs = inputs.get(terr_key)
                if errs is None:
                    for fc in self.synthetic:
                        err = _memo1('derr', fc['field'], src.date_err)
                        errs = err if errs is None else \
                            np.where(errs == 0, err, errs)
            else:
                terr_key = pfx + 'terr'
                for fc in self.synthetic:
                    vals, err = provider.date_column(fc['field'])
                    synth_vals[fc['name']] = vals
                    errs = err if errs is None else \
                        np.where(errs == 0, err, errs)
            ok = errs == 0
            sfield = {s['name']: s['field'] for s in self.synthetic}
            need = set()
            if self.time_bounds is not None:
                need.add('dn_ts')
            for p in self._plans:
                if p.field.startswith('\0synth:'):
                    need.add(p.field[len('\0synth:'):])
            for name in need:
                v = synth_vals[name]
                if use_dstats:
                    # already exact-i32 with error rows zeroed
                    inputs['tsf_' + sfield[name]] = v
                    continue
                vo = v[ok]
                if len(vo) and not (np.all(np.isfinite(vo)) and
                                    np.all(vo == np.floor(vo)) and
                                    vo.min() >= I32MIN and
                                    vo.max() <= I32MAX):
                    return None
                inputs[pfx + 'ts_' + name] = np.where(ok, v, 0).astype(
                    np.int64).astype(np.int32)
            inputs[terr_key] = errs

        # key columns: update windows/caps, assemble uploads
        new_caps = []
        pending = []  # deferred plan-state commits
        kvalid_profile = []   # plan names whose kvalid upload is skipped
        for p in self._plans:
            if p.kind == 'str':
                st = _stats(p.name)
                if st is not None:
                    all_str = st[5] == n
                    strcodes = None    # fetched only if needed below
                else:
                    tags, _, strcodes = provider._field(p.name)
                    all_str = bool((tags == mn.TAG_STRING).all())
                host = p.host_translate or not all_str
                if host:
                    codes = np.asarray(
                        provider.string_codes(p.name, p.column),
                        dtype=np.int64)
                    radix_now = len(p.column.dict.values)
                    inputs[pfx + 'key_' + p.name] = _narrow(
                        'key_' + p.name, codes, 0,
                        max(radix_now - 1, 0))
                else:
                    trans = _native_str_trans(
                        p.column, provider.parser.dictionary(p.name))
                    cur = self._trans_dev.get(p.name)
                    if cur is None or cur[0] < len(trans):
                        self._trans_dev[p.name] = (
                            len(trans), self._upload(
                                trans.astype(np.int32)))
                    inputs[pfx + 'trans_' + p.name] = \
                        self._trans_dev[p.name][1]
                    if ('str_' + p.name) not in inputs:
                        # (a field that is both filter and breakdown
                        # reuses the filter loop's upload)
                        if strcodes is None:
                            strcodes = _memo1('str', p.name,
                                              src.strcodes_col)
                        dlen = len(provider.parser.dictionary(p.name))
                        inputs['str_' + p.name] = _narrow(
                            'str_' + p.name, strcodes, 0,
                            max(dlen - 1, 0))
                radix = len(p.column.dict.values)
                cap = max(p.cap, _pow2(max(radix, 1)))
                new_caps.append(cap)
                pending.append((p, cap, p.lo, host, True))
            else:
                if p.field.startswith('\0synth:'):
                    sname = p.field[len('\0synth:'):]
                    # window from real (err-free) timestamps only: the
                    # zero-filled error rows are dead and must not
                    # anchor the window at ordinal 0
                    sel = synth_vals[sname][ok]
                    minmax = (int(sel.min()), int(sel.max())) \
                        if len(sel) else None
                else:
                    st = _stats(p.name)
                    if st is not None and st[0] == 0 and st[5] == 0:
                        # no strings/arrays: the numeric rows ARE the
                        # valid rows, and min/max come from the stats
                        narr, i32ok, nmn, nmx, nnum, _ = st
                        if nnum and not i32ok:
                            return None
                        if ('kv_' + p.name) not in inputs:
                            inputs['kv_' + p.name] = _narrow(
                                'kv_' + p.name,
                                _memo1('num', p.name, src.nums_i32),
                                int(nmn) if nnum else 0,
                                int(nmx) if nnum else 0)
                        kv_skip = sk['kvalid'].get(p.name, True) and \
                            nnum == n
                        sk['kvalid'][p.name] = kv_skip
                        if kv_skip:
                            # every row numeric: no validity upload
                            kvalid_profile.append(p.name)
                        elif ('kvalid_' + p.name) not in inputs:
                            tags_k = _memo1('tags', p.name,
                                            src.tags_col)
                            inputs['kvalid_' + p.name] = \
                                (tags_k == mn.TAG_INT) | \
                                (tags_k == mn.TAG_NUMBER)
                        minmax = (int(nmn), int(nmx)) if nnum else None
                    else:
                        vals, valid = provider.numeric_column(p.name)
                        vv = vals[valid]
                        if len(vv) and not (np.all(np.isfinite(vv)) and
                                            np.all(vv == np.floor(vv))
                                            and vv.min() >= I32MIN and
                                            vv.max() <= I32MAX):
                            return None
                        if ('kv_' + p.name) not in inputs:
                            fill = int(vv[0]) if len(vv) else 0
                            v = np.where(valid, vals,
                                         fill).astype(np.int64)
                            inputs['kv_' + p.name] = _narrow(
                                'kv_' + p.name, v.astype(np.int32),
                                int(vv.min()) if len(vv) else 0,
                                int(vv.max()) if len(vv) else 0)
                        kv_skip = sk['kvalid'].get(p.name, True) and \
                            bool(valid.all())
                        sk['kvalid'][p.name] = kv_skip
                        if kv_skip:
                            kvalid_profile.append(p.name)
                        elif ('kvalid_' + p.name) not in inputs:
                            inputs['kvalid_' + p.name] = valid
                        minmax = (int(vv.min()), int(vv.max())) \
                            if len(vv) else None
                if p.kind == 'p2':
                    new_caps.append(p.cap)  # fixed [0, 32)
                    pending.append((p, p.cap, 0, False, True))
                    continue
                if minmax is not None:
                    omin = int(np.floor_divide(minmax[0], p.step))
                    omax = int(np.floor_divide(minmax[1], p.step))
                    if p.window_set:
                        lo = min(p.lo, omin)
                        hi = max(p.lo + p.cap - 1, omax)
                    else:
                        lo, hi = omin, omax
                    cap = max(p.cap, _pow2(hi - lo + 1))
                    new_caps.append(cap)
                    pending.append((p, cap, lo, False, True))
                else:
                    new_caps.append(p.cap)
                    pending.append((p, p.cap, p.lo, False,
                                    p.window_set))

        ns = 1
        for c in new_caps:
            ns *= c
        sparse = False
        if ns > MAX_DENSE_SEGMENTS:
            # high-cardinality: no dense accumulator fits, so run the
            # SPARSE program (fused i64 keys sort-merged into a
            # device-resident compacted set).  Per-column codes are i32
            # on device, so a fused key beyond 2^62 or a cap beyond
            # 2^31 can never run there: host path instead.
            if ns > (1 << 62) or max(new_caps) > (1 << 31):
                self._disabled = True
                return None
            sparse = True

        # commit plan-state changes; an epoch flip flushes
        for p, cap, lo, host, wset in pending:
            p.cap, p.lo, p.host_translate = cap, lo, host
            p.window_set = wset
        sig = tuple(p.sig() for p in self._plans)
        if sig != self._epoch_sig:
            self._flush()
            self._epoch_sig = sig

        # the overflow guard runs AFTER any epoch-flip flush (a flush
        # resets the unique-count bound, which must then re-reserve
        # THIS batch or the bound undercounts by a batch)
        if sparse and not self._sparse_guard(n):
            return None

        # leaf outcome tables (grown host-side, resident on device)
        for i, (key, leaf) in enumerate(self._leaf_list):
            d = provider.parser.dictionary(leaf.field)
            table = leaf.table_for(d)
            cur = self._leaf_tables.get(i)
            if cur is None or cur[0] < len(table):
                up = table if len(table) else np.zeros(1, dtype=np.int8)
                self._leaf_tables[i] = (len(table), self._upload(up))
            inputs[pfx + 'tab_%d' % i] = self._leaf_tables[i][1]
            if i not in self._ctabs:
                ctab = np.zeros(16, dtype=np.int8)
                ctab[mn.TAG_MISSING] = ERROR
                ctab[mn.TAG_NULL] = leaf.outcome(None)
                ctab[mn.TAG_FALSE] = leaf.outcome(False)
                ctab[mn.TAG_TRUE] = leaf.outcome(True)
                ctab[mn.TAG_OBJECT] = leaf.outcome({})
                self._ctabs[i] = self._upload(ctab)
            inputs[pfx + 'ctab_%d' % i] = self._ctabs[i]

        profile = (w1, gen_alive,
                   {f: (hs, hn, an) for f, hs, hn, an in filter_profile},
                   frozenset(kvalid_profile), use_dstats,
                   self._sparse_cap if sparse else 0)
        return (n, profile, tuple(new_caps), ns, total_w)

    def _sparse_guard(self, n):
        """Prevent resident-set overflow BEFORE folding a batch: track
        an upper bound on uniques (exact count at last check + records
        since); when this batch could overflow, sync-fetch the true
        count from the accumulator, and if still at risk flush the
        (correct-so-far) epoch and grow the capacity.  Returns False
        when the scan must take the host path instead (capacity
        ceiling: device permanently disabled for this scan)."""
        while True:
            cap = self._sparse_cap
            if self._sparse_ub + n <= cap:
                self._sparse_ub += n
                return True
            if self._acc is not None and len(self._acc) == 5:
                nuniq = int(self._acc[4][0])
                if nuniq + n <= cap:
                    self._sparse_ub = nuniq + n
                    return True
            self._flush()
            if cap >= SPARSE_CAP_MAX:
                self._disabled = True
                self.aggr.stage.bump_hidden('nsparseceiling', 1)
                LOG.info('sparse set capacity ceiling reached; '
                         'host path takes over', cap=cap)
                return False
            self._sparse_cap = cap * 4
            self.aggr.stage.bump_hidden('nsparsegrow', 1)
            LOG.debug('sparse set grown', cap=self._sparse_cap)

    def _ensure_acc(self, caps, ns, sparse_cap=0):
        if self._acc is None:
            dev = self.device
            ncnt = len(self._counter_spec)
            i64 = torch.int64
            if sparse_cap:
                self._acc = (
                    torch.full((sparse_cap,), I64MAX, dtype=i64,
                               device=dev),
                    torch.zeros(sparse_cap, dtype=i64, device=dev),
                    torch.full((sparse_cap,), I64MAX, dtype=i64,
                               device=dev),
                    torch.zeros(ncnt, dtype=i64, device=dev),
                    torch.zeros(2, dtype=i64, device=dev))
            else:
                acc_ns = max(ns, 1)
                self._acc = (
                    torch.zeros(acc_ns, dtype=i64, device=dev),
                    torch.full((acc_ns,), I64MAX, dtype=i64, device=dev),
                    torch.zeros(ncnt, dtype=i64, device=dev))
            self._acc_meta = {
                'caps': tuple(caps),
                'cols': [(p.kind, p.lo) for p in self._plans],
                'ns': max(ns, 1),
                'sparse_cap': sparse_cap,
            }
            self._acc_batch = 0

    def _upload_inputs(self, inputs):
        return {k: (self._upload(v) if isinstance(v, np.ndarray) else v)
                for k, v in inputs.items()}

    def _run_staged(self, staged, inputs):
        self._fold_staged(staged, self._upload_inputs(inputs))

    def _fold_staged(self, staged, args):
        """Fold one staged batch (inputs already on the device) into
        this scan's resident accumulator: the sparse fold, or the dense
        body through the one-hot kernel or index_add_."""
        n, profile, caps, ns, total_w = staged
        sparse_cap = profile[-1]
        self._ensure_acc(caps, ns, sparse_cap=sparse_cap)
        base = self._acc_batch << 32
        if sparse_cap:
            # the guard reserved this batch in the bound already; the
            # set's occupied prefix is at most the bound before it
            self._fold_sparse(args, n, profile, caps,
                              min(sparse_cap, self._sparse_ub - n), base)
        else:
            use_kernel = bool(caps) and cuda_kernels.should_use(ns,
                                                                total_w)
            self._fold(args, n, profile, caps, ns, use_kernel, base)
        self._acc_batch += 1

    # -- the device program -------------------------------------------------

    def _body(self, args, n, profile, caps, ns, use_kernel, acc_dense):
        """One batch on the device -> (dense i64[ns], first i32[ns],
        cvec i32[ncounters]).  On the kernel route the weights go
        straight into `acc_dense` and dense is None.  In sparse mode
        -> (cvec, fused i64[n] with dead rows at I64MAX, weights
        i64[n])."""
        w1, gen_alive, fprof, kvalid_skip, use_dstats, sparse_cap = \
            profile
        pfx = self._pfx
        dev = self.device
        i32 = torch.int32
        i8 = torch.int8

        def as_i32(x):
            # uploads arrive dtype-narrowed (u8/i16); compute in i32
            return x if x.dtype == i32 else x.to(i32)

        def as_index(x):
            # gather indices are i64; -1 marks masked non-string rows
            return x.to(torch.int64).clamp_min_(0)

        def leaf_num_out(i, f):
            mode, t = self._num_plans[i]
            if mode == NUM_FALSE:
                return torch.full((n,), FALSE, dtype=i8, device=dev)
            if mode == NUM_TRUE:
                return torch.full((n,), TRUE, dtype=i8, device=dev)
            v = as_i32(args['num_' + f])
            if mode == NUM_EQ:
                hit = v == t
            elif mode == NUM_NE:
                hit = v != t
            elif mode == NUM_LE:
                hit = v <= t
            else:
                hit = v >= t
            return torch.where(hit, TRUE, FALSE).to(i8)

        leaf_index = {key: i for i, (key, _) in
                      enumerate(self._leaf_list)}

        def leaf_out(key):
            i = leaf_index[key]
            f = self._leaf_list[i][1].field
            has_str, has_num, all_num = fprof.get(f, (True, True, False))
            if all_num:
                # every row numeric: tags/str uploads were skipped
                return leaf_num_out(i, f)
            tags = args['tags_' + f].to(torch.int64)
            out = args[pfx + 'ctab_%d' % i][tags]
            if has_str:
                out = torch.where(
                    tags == mn.TAG_STRING,
                    args[pfx + 'tab_%d' % i][as_index(args['str_' + f])],
                    out)
            if not has_num:
                return out
            numm = (tags == mn.TAG_INT) | (tags == mn.TAG_NUMBER)
            return torch.where(numm, leaf_num_out(i, f), out)

        def eval_ast(ast):
            if not ast:
                return torch.full((n,), TRUE, dtype=i8, device=dev)
            op = next(iter(ast))
            if op in ('and', 'or'):
                fold = fold_and if op == 'and' else fold_or
                return fold([eval_ast(sub) for sub in ast[op]])
            field, const = ast[op]
            return leaf_out((field, op, jsv.json_stringify(const)))

        def p2_int(v):
            # bit length by a shift ladder: exact in integers
            x = torch.clamp_min(v, 0)
            bl = torch.zeros_like(v)
            for s in (16, 8, 4, 2, 1):
                big = x >= (1 << s)
                bl = bl + torch.where(big, s, 0).to(i32)
                x = torch.where(big, x >> s, x)
            bl = bl + (x >= 1).to(i32)
            return torch.where(v < 1, 0, bl).to(i32)

        alive = torch.ones(n, dtype=torch.bool, device=dev) if gen_alive \
            else args['alive']
        weights = None if w1 else args['weights']
        counters = []

        def isum(x):
            return x.sum(dtype=i32)

        for pred in (self.ds_pred, self.user_pred):
            if pred is None:
                continue
            counters.append(isum(alive))
            out = eval_ast(pred.ast)
            counters.append(isum(alive & (out == ERROR)))
            counters.append(isum(alive & (out == FALSE)))
            alive = alive & (out == TRUE)
            counters.append(isum(alive))

        # ts/terr keys mirror _stage_device: shared field-keyed
        # uploads under dstats, scan-private otherwise
        sfield = {s['name']: s['field'] for s in self.synthetic}

        def ts_arg(name):
            return args['tsf_' + sfield[name]] if use_dstats \
                else args[pfx + 'ts_' + name]

        if self.synthetic:
            counters.append(isum(alive))
            terr = args['terr_' + '|'.join(
                fc['field'] for fc in self.synthetic)] if use_dstats \
                else args[pfx + 'terr']
            counters.append(isum(alive & (terr == 1)))   # UNDEF
            counters.append(isum(alive & (terr == 2)))   # BADDATE
            alive = alive & (terr == 0)
            counters.append(isum(alive))

        if self.time_bounds is not None:
            counters.append(isum(alive))
            ts = ts_arg('dn_ts')
            lo, hi = self.time_bounds
            ok = torch.ones(n, dtype=torch.bool, device=dev)
            # uploaded ts values are exact-i32, so a bound outside i32
            # resolves statically: vacuous or nothing-passes
            if lo is not None:
                lo = int(lo)
                if lo > I32MAX:
                    ok = ok & False
                elif lo > I32MIN:
                    ok = ok & (ts >= lo)
            if hi is not None:
                hi = int(hi)
                if hi <= I32MIN:
                    ok = ok & False
                elif hi <= I32MAX:
                    ok = ok & (ts < hi)
            counters.append(isum(alive & ~ok))
            alive = alive & ok
            counters.append(isum(alive))

        counters.append(isum(alive))   # aggregator ninputs
        nnon = torch.zeros((), dtype=i32, device=dev)
        codes = []
        for p in self._plans:
            if p.kind == 'str':
                if p.host_translate:
                    codes.append(as_i32(args[pfx + 'key_' + p.name]))
                else:
                    codes.append(args[pfx + 'trans_' + p.name][
                        as_index(args['str_' + p.name])])
                continue
            if p.field.startswith('\0synth:'):
                v = as_i32(ts_arg(p.field[len('\0synth:'):]))
            else:
                if p.name not in kvalid_skip:
                    valid = args['kvalid_' + p.name]
                    nnon = nnon + isum(alive & ~valid)
                    alive = alive & valid
                v = as_i32(args['kv_' + p.name])
            if p.kind == 'p2':
                codes.append(p2_int(v))
            else:
                codes.append(torch.div(v, p.step, rounding_mode='floor')
                             - p.lo)
        counters.append(nnon)
        # nspillrecords: records aggregated through the sparse program
        counters.append(isum(alive) if sparse_cap
                        else torch.zeros((), dtype=i32, device=dev))
        cvec = torch.stack(counters)

        if sparse_cap:
            # sparse mode: fused i64 keys + weights; the fold
            # sort-merges them into the resident compacted set
            i64 = torch.int64
            fused = torch.zeros(n, dtype=i64, device=dev)
            for c, cap in zip(codes, caps):
                fused = fused * cap + c.to(i64)
            fused = torch.where(alive, fused, I64MAX)
            wb = alive.to(i64) if w1 else \
                torch.where(alive, weights, 0).to(i64)
            return cvec, fused, wb

        if not codes:
            w = alive.to(i32) if w1 else torch.where(alive, weights, 0)
            dense = w.sum(dtype=torch.int64).reshape(1)
            first = torch.zeros(1, dtype=i32, device=dev)
            return dense, first, cvec

        fused = torch.zeros(n, dtype=i32, device=dev)
        for c, cap in zip(codes, caps):
            fused = fused * cap + c
        fused32 = torch.where(alive, fused, ns)
        fused = fused32.to(torch.int64)
        gidx = torch.arange(n, dtype=i32, device=dev)
        first = torch.full((ns + 1,), I32MAX, dtype=i32, device=dev)
        first.scatter_reduce_(0, fused, gidx, 'amin', include_self=True)
        first = first[:ns]
        if use_kernel:
            # the kernel adds straight into the resident accumulator;
            # dead rows sit at ns, outside it
            cuda_kernels.onehot_dense_into(acc_dense, fused32, weights)
            dense = None
        else:
            w = alive.to(torch.int64) if w1 else \
                torch.where(alive, weights, 0).to(torch.int64)
            dense = torch.zeros(ns + 1, dtype=torch.int64, device=dev)
            dense.index_add_(0, fused, w)
            dense = dense[:ns]
        return dense, first, cvec

    def _fold(self, args, n, profile, caps, ns, use_kernel, base):
        """One batch folded into the device-resident accumulator, in
        place: dense weights and counters add; the first-occurrence key
        takes a running min over (batch_base | row), which orders keys
        exactly as the host engine inserts them."""
        acc_dense, acc_first, acc_cvec = self._acc
        dense, first, cvec = self._body(args, n, profile, caps, ns,
                                        use_kernel, acc_dense)
        bfirst = torch.where(first < I32MAX, first.to(torch.int64) + base,
                             I64MAX)
        if dense is not None:
            acc_dense += dense
        torch.minimum(acc_first, bfirst, out=acc_first)
        acc_cvec += cvec.to(torch.int64)

    def _fold_sparse(self, args, n, profile, caps, occupied, base):
        """One batch sort-merged into the resident sparse set: its row
        keys take first occurrence (batch_base | row) and weight 1 or
        its weight; see fold_sparse."""
        cvec, fused, wb = self._body(args, n, profile, caps, 0, False,
                                     None)
        first_b = torch.where(
            fused != I64MAX,
            torch.arange(n, dtype=torch.int64, device=self.device) + base,
            I64MAX)
        self._acc = fold_sparse(self._acc, cvec, fused, wb, first_b,
                                occupied)

    # -- flush: fetch + ordered merge ---------------------------------------

    def _flush(self):
        """Fetch the device accumulator (one fetch for the whole epoch)
        and merge it into the insertion-ordered Aggregator."""
        if self._acc is None:
            return
        acc = self._acc
        meta = self._acc_meta
        nbatches = self._acc_batch
        self._acc = None
        self._acc_meta = None
        self._acc_batch = 0
        # engine telemetry: batches folded on the device this epoch
        # (kept out of the --counters dump for golden byte parity)
        if nbatches:
            self.aggr.stage.bump_hidden('ndevicebatches', nbatches)
        sparse_ub = self._sparse_ub
        self._sparse_ub = 0

        if meta['sparse_cap']:
            self._flush_sparse(acc, meta, sparse_ub)
            return

        if not meta['cols']:
            self._emit_counters(acc[2].cpu().numpy())
            self.aggr.write_key((), self._weight(int(acc[0][0])))
            return

        if meta['ns'] >= self.COMPACT_MIN_SEGMENTS:
            segs, wsum, cvec = _compact_fetch(acc, self.COMPACT_K)
            self.aggr.stage.bump_hidden('ncompactflush', 1)
        else:
            segs, wsum, cvec = _dense_full_result(acc)
        self._emit_counters(cvec)
        # global codes for the shared emit path: device string codes
        # are already engine-dictionary codes; bucket codes offset
        # by the window origin give raw ordinals
        self._decode_emit(meta, segs, wsum)

    def _flush_sparse(self, acc, meta, sparse_ub):
        """Flush the sparse (high-cardinality) accumulator: the set is
        already compact, so fetch its occupied slots ordered by first
        occurrence (decoded + narrowed on device), sized by the
        epoch's unique-count upper bound."""
        k0 = _pow2(max(min(sparse_ub, meta['sparse_cap']), 1)) \
            if sparse_ub else self.COMPACT_K
        cols, wsum, cvec, stats = _sparse_fetch(acc, k0, meta['caps'])
        self.aggr.stage.bump_hidden('ncompactflush', 1)
        if int(stats[1]):
            # the host pressure guard exists to make this unreachable;
            # if it ever trips, results are incomplete — fail loudly
            raise RuntimeError(
                'device sparse aggregation overflowed its resident set'
                ' (cap=%d); results would be incomplete'
                % meta['sparse_cap'])
        self._emit_counters(cvec)
        self._emit_cols(meta, cols, wsum)


def fold_sparse(acc, cvec, fused, wb, first_b, occupied=None):
    """Sparse fold: sort-merge one batch's fused i64 keys (dead rows at
    I64MAX), i64 weights and first-occurrence keys into the resident
    compacted set `acc` = (keys, wsum, first, cvec, stats), returning
    the new accumulator.  keys/first take the per-key min
    (first-occurrence order preserved exactly), weights sum, and the
    unique count rides along in stats[0] so the host pressure guard
    can read it without a full fetch; stats[1] is the sticky overflow
    flag.

    The set keeps its occupied slots sorted by key in a prefix, with
    I64MAX / 0 / I64MAX past it, so only `occupied` (an upper bound on
    the prefix; default the whole set) plus the batch are sorted and
    rewritten.  Run ids past the capacity land in one extra slot of a
    cap + 1 buffer that is sliced off (torch's scatters would raise on
    them); the overflow flag makes that loud at flush."""
    sparse_folds['fold_sparse'] += 1
    keys0, wsum0, first0, cvec0, stats0 = acc
    cap = int(keys0.shape[0])
    occ = cap if occupied is None else max(0, min(int(occupied), cap))
    i64 = torch.int64
    k = torch.cat([keys0[:occ], fused])
    order = torch.argsort(k)
    ks = k[order]
    ws = torch.cat([wsum0[:occ], wb])[order]
    fs = torch.cat([first0[:occ], first_b])[order]
    newrun = torch.ones_like(ks, dtype=torch.bool)
    newrun[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(newrun, 0, dtype=i64) - 1
    nuniq = (newrun & (ks != I64MAX)).sum(dtype=i64)
    # the rewritten prefix: every unique of the merge fits in it when
    # the guard's bound holds (slots past it are untouched sentinels)
    m = min(cap, int(k.shape[0]))
    seg = torch.clamp_max(seg, m)
    dev = ks.device
    keys1 = torch.full((m + 1,), I64MAX, dtype=i64, device=dev)
    keys1.scatter_reduce_(0, seg, ks, 'amin', include_self=True)
    wsum1 = torch.zeros(m + 1, dtype=i64, device=dev)
    wsum1.index_add_(0, seg, ws)
    first1 = torch.full((m + 1,), I64MAX, dtype=i64, device=dev)
    first1.scatter_reduce_(0, seg, fs, 'amin', include_self=True)
    keys0[:m] = keys1[:m]
    wsum0[:m] = wsum1[:m]
    first0[:m] = first1[:m]
    over = torch.maximum(stats0[1], (nuniq > cap).to(i64))
    return (keys0, wsum0, first0, cvec0 + cvec.to(i64),
            torch.stack([nuniq, over]))


def _compact_program(acc, k):
    """Device-side compaction of a dense accumulator: (count of
    occurred segments, their ids in first-occurrence order (first k,
    -1 past the count), their weights, counters)."""
    dense, first, cvec = acc
    cnt = (first < I64MAX).sum()
    # ascending argsort puts occurred segments first, in exact
    # first-occurrence order (firsts are distinct: each global row
    # index belongs to one segment); I64MAX sentinels sort last
    order = torch.argsort(first, stable=True)[:k]
    occ = first[order] < I64MAX
    segs = torch.where(occ, order, -1)
    return cnt, segs, dense[order], cvec


def _compact_fetch(acc, k0):
    """Compacted flush fetch: (segs i64[cnt] in first-occurrence order,
    weights f64[cnt], cvec), moving O(occurred) bytes instead of O(ns).
    One extra round trip only when more than k0 segments occurred."""
    acc_len = int(acc[0].shape[0])
    k = min(acc_len, k0)
    while True:
        cnt, segs, dense, cvec = _compact_program(acc, k)
        n = int(cnt)
        if n <= k:
            return (segs[:n].cpu().numpy(),
                    dense[:n].cpu().numpy().astype(np.float64),
                    cvec.cpu().numpy())
        k = min(acc_len, _pow2(n))


def _dense_full_result(acc):
    """Full fetch of a dense accumulator in first-occurrence order."""
    dense = acc[0].cpu().numpy()
    first = acc[1].cpu().numpy()
    cvec = acc[2].cpu().numpy()
    occurred = np.nonzero(first < I64MAX)[0]
    order = np.argsort(first[occurred], kind='stable')
    segs = occurred[order]
    return segs, dense[segs].astype(np.float64), cvec


def _narrow_dtype(cap):
    if cap <= 256:
        return torch.uint8
    if cap <= 32768:
        return torch.int16
    return torch.int32


def _sparse_program(acc, k, caps):
    """Compacting fetch of the sparse set: occupied slots ordered by
    first occurrence, with the fused keys DECODED to per-column codes on
    device and every output dtype-narrowed (the fewest bytes that
    represent the result), plus a flag that triggers the full-precision
    refetch for weight sums beyond i32."""
    keys, wsum, first, cvec, stats = acc
    order = torch.argsort(first, stable=True)[:k]
    ks = keys[order]
    cols = []
    div = 1
    for cap_i in reversed(caps):
        c = torch.remainder(torch.div(ks, div, rounding_mode='floor'),
                            cap_i)
        cols.append(c.to(_narrow_dtype(cap_i)))
        div *= cap_i
    cols.reverse()
    ws = wsum[order]
    wof = ((ws > I32MAX) | (ws < I32MIN)).any()
    return cols, ws.to(torch.int32), wof, cvec, stats


def _sparse_program_full(acc, k):
    """Full-precision fetch (i64 keys + weights): used when a weight
    sum overflows i32 (the wof flag)."""
    keys, wsum, first, cvec, stats = acc
    order = torch.argsort(first, stable=True)[:k]
    return keys[order], wsum[order], cvec, stats


def _sparse_fetch(acc, k0, caps):
    """Fetch the sparse accumulator's occupied slots in exact
    first-occurrence order: (per-column code arrays i64, weights f64,
    cvec, stats).  One round trip when the unique count fits the
    speculative width."""
    cap = int(acc[0].shape[0])
    k = min(cap, k0)
    while True:
        cols, w32, wof, cvec, stats = _sparse_program(acc, k, tuple(caps))
        st = stats.cpu().numpy()
        n = int(st[0])
        if n > k:
            if k < cap:
                k = min(cap, _pow2(n))
                continue
            # n > capacity: genuine overflow — fetch what exists and
            # let the caller's stats[1] check raise loudly
            n = k
        if bool(wof):
            keys, wsum, cvec, stats = _sparse_program_full(acc, k)
            kn = keys[:n].cpu().numpy()
            return (_decode_fused(kn, caps),
                    wsum[:n].cpu().numpy().astype(np.float64),
                    cvec.cpu().numpy(), st)
        return ([c[:n].cpu().numpy().astype(np.int64) for c in cols],
                w32[:n].cpu().numpy().astype(np.float64),
                cvec.cpu().numpy(), st)


def _decode_fused(keys, caps):
    """Host-side fused-key decode."""
    rem = keys.copy()
    cols = [None] * len(caps)
    for ci in range(len(caps) - 1, -1, -1):
        cols[ci] = rem % caps[ci]
        rem = rem // caps[ci]
    return cols


class DeviceScanStack(object):
    """One staged input dict per batch for an N-metric build.

    Every scan stages its inputs into ONE merged dict (parser-derived
    columns use shared keys, so a column read by several metrics is
    uploaded once; per-scan inputs carry an 'm<i>_' prefix), then each
    scan folds the batch into its own device-resident accumulator —
    dense (one-hot kernel or index_add_) or sparse.  Scans keep their
    own accumulators, flush and emission, so per-scan results (and the
    index artifacts) are byte-identical to the unstacked path.

    The reference jits the N folds into one combined program, caches it
    across builds (_STACK_CACHE) and memoizes the program keys
    (_pkey_memo); eager torch ops compile nothing, so the port has
    neither."""

    def __init__(self, scans):
        self.scans = list(scans)
        # shared sticky upload-profile state: widening decisions apply
        # to the shared physical inputs, so all scans must agree
        shared = {'w1': True, 'gen_alive': True, 'filter': {},
                  'kvalid': {}, 'dtypes': {}}
        for i, s in enumerate(self.scans):
            assert s.STACKABLE
            s._pfx = 'm%d_' % i
            s._sticky = shared

    def process(self, provider, weights, alive):
        """Process one batch for every scan: the stacked device fold
        when every scan stages successfully, else the per-scan paths
        (each of which may still use its own device fold or the host
        engine).  Exactly one of these runs per batch, so insertion
        order and results match the unstacked path."""
        if self._device_eligible(provider) and \
                self._process_device(provider, weights, alive):
            return
        for s in self.scans:
            s._process(provider, weights, alive=alive)

    def _device_eligible(self, provider):
        # the forced lane: no escalation or audition to wait for
        return isinstance(provider, NativeColumns) and \
            not any(s._disabled for s in self.scans)

    def _process_device(self, provider, weights, alive):
        inputs = {}
        staged = []
        for s in self.scans:
            st = s._stage_device(provider, weights, alive, inputs)
            if st is None:
                return False
            staged.append(st)
        args = self.scans[0]._upload_inputs(inputs)
        for s, st in zip(self.scans, staged):
            s._fold_staged(st, args)
            # telemetry: this batch went through the stacked fold
            # (kept out of --counters for golden byte parity)
            s.aggr.stage.bump_hidden('nstackedbatches', 1)
        return True


def make_stack(scanners):
    """A DeviceScanStack when the scanner set supports it (>= 2 device
    scans), else None (callers keep the per-scan loop).  DN_STACK=0
    disables stacking (per-scan device folds still run)."""
    if os.environ.get('DN_STACK', '1') == '0':
        return None
    if len(scanners) < 2:
        return None
    if not all(isinstance(s, DeviceScan) and s.STACKABLE
               for s in scanners):
        return None
    return DeviceScanStack(scanners)
