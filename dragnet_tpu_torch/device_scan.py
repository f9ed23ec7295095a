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

Not in this port yet: the sparse (high-cardinality) program — a query
whose key space needs it raises DNError — and the pipelined dispatch.
Batches upload with plain synchronous copies.
"""

import numpy as np
import torch

from .errors import DNError
from . import jsvalues as jsv
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

    def __init__(self, query, time_field, pipeline, ds_filter=None,
                 device=None):
        dev = resolve_device(device)
        VectorScan.__init__(self, query, time_field, pipeline,
                            ds_filter=ds_filter, device=dev)
        self._disabled = False
        self._sticky = None       # upload-profile state (_stage_device)
        self._plans = None        # built from the query
        self._epoch_sig = None
        self._acc = None          # device-resident (dense, first, cvec)
        self._acc_meta = None     # epoch ('caps', 'cols', 'ns')
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
        writing host arrays into `inputs`.  Returns the staged
        parameters (n, profile, caps, ns, total_w) or None when this
        batch must take the host path.  Commits plan-state
        (windows/caps) and flushes on epoch flips as side effects."""
        n = provider.n

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

        # per-batch memo: each parser accessor materializes a fresh
        # array (ctypes copy); a field read twice pays that once
        memo = {}

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
                for i, fc in enumerate(self.synthetic):
                    all_i32, nok = first_ds if i == 0 \
                        else _memo1('dstats', fc['field'], dstats_fn)
                    if nok and not all_i32:
                        return None
                    synth_vals[fc['name']] = _memo1(
                        'date', fc['field'], src.date_i32)
                for fc in self.synthetic:
                    err = _memo1('derr', fc['field'], src.date_err)
                    errs = err if errs is None else \
                        np.where(errs == 0, err, errs)
            else:
                for fc in self.synthetic:
                    vals, err = provider.date_column(fc['field'])
                    synth_vals[fc['name']] = vals
                    errs = err if errs is None else \
                        np.where(errs == 0, err, errs)
            ok = errs == 0
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
                    inputs['ts_' + name] = v
                    continue
                vo = v[ok]
                if len(vo) and not (np.all(np.isfinite(vo)) and
                                    np.all(vo == np.floor(vo)) and
                                    vo.min() >= I32MIN and
                                    vo.max() <= I32MAX):
                    return None
                inputs['ts_' + name] = np.where(ok, v, 0).astype(
                    np.int64).astype(np.int32)
            inputs['terr'] = errs

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
                    inputs['key_' + p.name] = _narrow(
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
                    inputs['trans_' + p.name] = \
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
        if ns > MAX_DENSE_SEGMENTS:
            # per-column codes are i32 on device, so a fused key beyond
            # i64 or a cap beyond 2^31 can never run there: host path,
            # as in the reference.  Anything else needs the sparse
            # (high-cardinality) program, which this port lacks.
            if ns > (1 << 62) or max(new_caps) > (1 << 31):
                self._disabled = True
                return None
            raise DNError(
                'device scan: %d segments exceed the dense accumulator '
                '(%d); the sparse (high-cardinality) device program is '
                'not yet ported' % (ns, MAX_DENSE_SEGMENTS))

        # commit plan-state changes; an epoch flip flushes
        for p, cap, lo, host, wset in pending:
            p.cap, p.lo, p.host_translate = cap, lo, host
            p.window_set = wset
        sig = tuple(p.sig() for p in self._plans)
        if sig != self._epoch_sig:
            self._flush()
            self._epoch_sig = sig

        # leaf outcome tables (grown host-side, resident on device)
        for i, (key, leaf) in enumerate(self._leaf_list):
            d = provider.parser.dictionary(leaf.field)
            table = leaf.table_for(d)
            cur = self._leaf_tables.get(i)
            if cur is None or cur[0] < len(table):
                up = table if len(table) else np.zeros(1, dtype=np.int8)
                self._leaf_tables[i] = (len(table), self._upload(up))
            inputs['tab_%d' % i] = self._leaf_tables[i][1]
            if i not in self._ctabs:
                ctab = np.zeros(16, dtype=np.int8)
                ctab[mn.TAG_MISSING] = ERROR
                ctab[mn.TAG_NULL] = leaf.outcome(None)
                ctab[mn.TAG_FALSE] = leaf.outcome(False)
                ctab[mn.TAG_TRUE] = leaf.outcome(True)
                ctab[mn.TAG_OBJECT] = leaf.outcome({})
                self._ctabs[i] = self._upload(ctab)
            inputs['ctab_%d' % i] = self._ctabs[i]

        profile = (w1, gen_alive,
                   {f: (hs, hn, an) for f, hs, hn, an in filter_profile},
                   frozenset(kvalid_profile))
        return (n, profile, tuple(new_caps), ns, total_w)

    def _ensure_acc(self, caps, ns):
        if self._acc is None:
            ns = max(ns, 1)
            dev = self.device
            self._acc = (
                torch.zeros(ns, dtype=torch.int64, device=dev),
                torch.full((ns,), I64MAX, dtype=torch.int64, device=dev),
                torch.zeros(len(self._counter_spec), dtype=torch.int64,
                            device=dev))
            self._acc_meta = {
                'caps': tuple(caps),
                'cols': [(p.kind, p.lo) for p in self._plans],
                'ns': ns,
            }
            self._acc_batch = 0

    def _run_staged(self, staged, inputs):
        n, profile, caps, ns, total_w = staged
        use_kernel = bool(caps) and cuda_kernels.should_use(ns, total_w)
        self._ensure_acc(caps, ns)
        args = {k: (self._upload(v) if isinstance(v, np.ndarray) else v)
                for k, v in inputs.items()}
        self._fold(args, n, profile, caps, ns, use_kernel,
                   self._acc_batch << 32)
        self._acc_batch += 1

    # -- the device program -------------------------------------------------

    def _body(self, args, n, profile, caps, ns, use_kernel, acc_dense):
        """One batch on the device -> (dense i64[ns], first i32[ns],
        cvec i32[ncounters]).  On the kernel route the weights go
        straight into `acc_dense` and dense is None."""
        w1, gen_alive, fprof, kvalid_skip = profile
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
            out = args['ctab_%d' % i][tags]
            if has_str:
                out = torch.where(
                    tags == mn.TAG_STRING,
                    args['tab_%d' % i][as_index(args['str_' + f])], out)
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

        if self.synthetic:
            counters.append(isum(alive))
            terr = args['terr']
            counters.append(isum(alive & (terr == 1)))   # UNDEF
            counters.append(isum(alive & (terr == 2)))   # BADDATE
            alive = alive & (terr == 0)
            counters.append(isum(alive))

        if self.time_bounds is not None:
            counters.append(isum(alive))
            ts = args['ts_dn_ts']
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
                    codes.append(as_i32(args['key_' + p.name]))
                else:
                    codes.append(args['trans_' + p.name][
                        as_index(args['str_' + p.name])])
                continue
            if p.field.startswith('\0synth:'):
                v = as_i32(args['ts_' + p.field[len('\0synth:'):]])
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
        counters.append(torch.zeros((), dtype=i32, device=dev))
        cvec = torch.stack(counters)

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


def _decode_fused(keys, caps):
    """Host-side fused-key decode."""
    rem = keys.copy()
    cols = [None] * len(caps)
    for ci in range(len(caps) - 1, -1, -1):
        cols[ci] = rem % caps[ci]
        rem = rem // caps[ci]
    return cols
