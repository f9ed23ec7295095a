"""The scan's per-batch device program (K2): its compiled descriptor,
the Hopper kernel's wrapper, and the plain torch version.

Counterpart of the reference's jitted per-batch program
(dragnet_tpu/device_scan.py `fold` -> `run_body` -> `body`, compiled
with jax.jit at :2069-2072): predicates, the date and time masks,
bucketize, key fusion, the first-occurrence min and the fold into the
resident accumulator, one dispatch a batch.  The port compiles the same
work, once per (plan signature, upload profile, caps, output mode),
into a flat descriptor (`compile_program` -> ScanProgram) that one
hand-written kernel runs a record a thread
(ops/csrc/scan_body.cu, its descriptor and per-record evaluator in
ops/csrc/scan_body.cuh, mirrored here by ctypes).  A batch changes only
the input pointers, n and its first-occurrence base.

Output modes (DeviceScan picks one per fold):

* MODE_K1: the fused i32 key, dead rows at ns, written into a caller's
  scratch buffer; the caller's K1 (cuda_kernels.onehot_dense_into) then
  adds the weights into the dense accumulator: two launches a batch;
* MODE_DENSE: the weights added straight into the dense accumulator
  (64-bit atomics on the card): one launch;
* MODE_SPARSE: the i64 fused key (dead rows at I64MAX), the i64 weight
  and the first-occurrence row (base + row, dead rows at I64MAX) for
  device_scan.fold_sparse.

In every mode the counters add into the caller's i64 counter vector,
and on the dense routes the first occurrence takes a running min in
the caller's i64 first-occurrence accumulator (base + row).

`scan_body` launches the kernel for CUDA tensors (a failed build or
launch raises) and runs `scan_body_ref`, the plain version, only for
CPU tensors.  `scan_body_ref` interprets the same descriptor with torch
ops over the whole batch, with an explicit operand stack (no closures
over the batch's tensors, so a finished batch's inputs are freed at
once).  `cuda_kernels.launches['scan_body']` counts kernel launches.
"""

import ctypes

import torch

from . import jsvalues as jsv
from . import native as mn
from .ops import cuda_kernels
from .ops.kernels import FALSE, TRUE, ERROR

I32MIN = -(2 ** 31)
I32MAX = 2 ** 31 - 1
I64MAX = 2 ** 63 - 1

# numeric-row plans: outcome of <leaf op const> for an exact-int32 row
NUM_FALSE, NUM_TRUE, NUM_EQ, NUM_NE, NUM_LE, NUM_GE = range(6)

# mirrored from ops/csrc/scan_body.cuh
INLINE_SLOTS = 96
MAX_COUNTERS = 18
STACK_DEPTH = 32
MODE_K1, MODE_DENSE, MODE_SPARSE = 0, 1, 2
OP_TRUE, OP_LEAF, OP_AND, OP_OR, OP_AND_R, OP_OR_R = 1, 2, 3, 4, 5, 6
OP_KEY_HOST, OP_KEY_TRANS, OP_KEY_P2, OP_KEY_LIN = 10, 11, 12, 13
LEAF_HAS_STR, LEAF_HAS_NUM, LEAF_ALL_NUM = 1, 2, 4
BOUND_NONE, BOUND_NEVER, BOUND_CMP = 0, 1, 2
DTYPE_CODES = {torch.uint8: 1, torch.bool: 1, torch.int8: 2,
               torch.int16: 3, torch.int32: 4, torch.int64: 5}


class DnOp(ctypes.Structure):
    _fields_ = [('code', ctypes.c_int32), ('flags', ctypes.c_int32),
                ('slot', ctypes.c_int32 * 4), ('arg', ctypes.c_int32 * 4),
                ('cap', ctypes.c_int64)]


class DnScanProgram(ctypes.Structure):
    _fields_ = [('pred_begin', ctypes.c_int32 * 2),
                ('pred_end', ctypes.c_int32 * 2),
                ('key_begin', ctypes.c_int32), ('key_end', ctypes.c_int32),
                ('ncounters', ctypes.c_int32), ('mode', ctypes.c_int32),
                ('weights_slot', ctypes.c_int32),
                ('alive_slot', ctypes.c_int32),
                ('terr_slot', ctypes.c_int32), ('ts_slot', ctypes.c_int32),
                ('time_lo_kind', ctypes.c_int32),
                ('time_lo', ctypes.c_int32),
                ('time_hi_kind', ctypes.c_int32),
                ('time_hi', ctypes.c_int32), ('ns', ctypes.c_int64)]


class DnScanLaunch(ctypes.Structure):
    _fields_ = [('prog', DnScanProgram), ('ops', ctypes.c_void_p),
                ('n', ctypes.c_int64), ('base', ctypes.c_int64),
                ('row0', ctypes.c_int64), ('nvalid', ctypes.c_int64),
                ('acc_dense', ctypes.c_void_p),
                ('acc_first', ctypes.c_void_p),
                ('acc_cvec', ctypes.c_void_p),
                ('out_key32', ctypes.c_void_p),
                ('out_key64', ctypes.c_void_p),
                ('out_w64', ctypes.c_void_p),
                ('out_first64', ctypes.c_void_p),
                ('slot_extra', ctypes.c_void_p),
                ('slot', ctypes.c_void_p * INLINE_SLOTS)]


# the header's slot fields (slot references, -1 for none)
_SLOT_FIELDS = ('weights_slot', 'alive_slot', 'terr_slot', 'ts_slot')


class ScanProgram(object):
    """One compiled scan program.  `header` holds DnScanProgram's
    fields, `ops` the op list as (code, flags, slots, args, cap) tuples
    (slot references are indices into `slot_keys`, the input dict's
    keys; `rows` are the per-record ones, the rest are device-resident
    tables).  The dtype codes of the slots are applied per upload dtype
    set when the program is encoded for the kernel (`encoded`)."""

    __slots__ = ('mode', 'ns', 'ncounters', 'header', 'ops', 'slot_keys',
                 'rows', '_enc')

    def __init__(self, mode, ns, ncounters, header, ops, slot_keys, rows):
        self.mode = mode
        self.ns = ns
        self.ncounters = ncounters
        self.header = header
        self.ops = ops
        self.slot_keys = slot_keys
        self.rows = rows
        self._enc = {}

    def stack_depth(self):
        """The most operand-stack entries any predicate needs."""
        most = 0
        h = self.header
        for p in (0, 1):
            depth = 0
            for op in self.ops[max(h['pred_begin'][p], 0):
                               max(h['pred_end'][p], 0)]:
                depth += 1 if op[0] in (OP_TRUE, OP_LEAF) else -1
                most = max(most, depth)
        return most

    def encoded(self, dtypes):
        """(DnScanProgram, the op array's bytes, {device: tensor}) for
        slots of these dtype codes, memoised."""
        enc = self._enc.get(dtypes)
        if enc is None:
            def ref(i):
                return -1 if i < 0 else i | (dtypes[i] << 24)
            h = self.header
            hdr = DnScanProgram()
            hdr.pred_begin[:] = h['pred_begin']
            hdr.pred_end[:] = h['pred_end']
            for k in ('key_begin', 'key_end', 'time_lo_kind', 'time_lo',
                      'time_hi_kind', 'time_hi'):
                setattr(hdr, k, h[k])
            for k in _SLOT_FIELDS:
                setattr(hdr, k, ref(h[k]))
            hdr.ncounters = self.ncounters
            hdr.mode = self.mode
            hdr.ns = self.ns
            arr = (DnOp * max(1, len(self.ops)))()
            for o, (code, flags, slots, args, cap) in zip(arr, self.ops):
                o.code, o.flags, o.cap = code, flags, cap
                o.slot[:] = [ref(s) for s in slots]
                o.arg[:] = list(args)
            enc = self._enc[dtypes] = (hdr, bytes(arr), {})
        return enc


def _pack_ctab(leaf):
    """The leaf's outcome by tag for rows that are neither strings nor
    numbers, 2 bits a tag (the reference's 16-entry ctab table)."""
    ctab = {mn.TAG_MISSING: ERROR, mn.TAG_NULL: leaf.outcome(None),
            mn.TAG_FALSE: leaf.outcome(False),
            mn.TAG_TRUE: leaf.outcome(True),
            mn.TAG_OBJECT: leaf.outcome({})}
    packed = 0
    for tag, v in ctab.items():
        packed |= int(v) << (2 * tag)
    return packed - (1 << 32) if packed >= 1 << 31 else packed


def _kids(ast):
    """An and/or node's operands, or None for a leaf or an empty
    predicate."""
    op = next(iter(ast)) if ast else None
    return ast[op] if op in ('and', 'or') else None


def _need(ast, memo):
    """Operand-stack entries the postfix program of `ast` needs when
    each and/or node evaluates its heaviest operand first.  Iterative:
    a filter as deep as the query parser takes adds no recursion."""
    todo = [(ast, False)]
    while todo:
        node, ready = todo.pop()
        if id(node) in memo:
            continue
        kids = _kids(node)
        if kids is None:
            memo[id(node)] = 1
        elif not ready:
            todo.append((node, True))
            todo.extend((k, False) for k in kids)
        else:
            needs = [memo[id(k)] for k in kids]
            j = needs.index(max(needs))
            rest = needs[:j] + needs[j + 1:]
            memo[id(node)] = max(needs[j], 1 + max(rest)) if rest \
                else needs[j]
    return memo[id(ast)]


class _Compiler(object):
    """Builds one ScanProgram from a DeviceScan's static plan and one
    batch's upload profile."""

    def __init__(self, scan, fprof):
        self.scan = scan
        self.fprof = fprof
        self.pfx = scan._pfx
        self.keys = []
        self.index = {}
        self.rows = []
        self.ops = []
        self.leaf_index = {key: i for i, (key, _) in
                           enumerate(scan._leaf_list)}
        self.memo = {}

    def slot(self, key, per_record=True):
        i = self.index.get(key)
        if i is None:
            i = self.index[key] = len(self.keys)
            self.keys.append(key)
            if per_record:
                self.rows.append(i)
        return i

    def pred(self, ast):
        """Postfix ops of a predicate AST: each and/or node's heaviest
        operand first, the operands left of it folded in right to left
        (the *_R ops, left operand on top), those right of it left to
        right.  fold_and/fold_or are associative, so any such order
        gives the left fold's outcome.  Iterative, as _need."""
        _need(ast, self.memo)
        none = (-1, -1, -1, -1)
        todo = [ast]
        while todo:
            item = todo.pop()
            if isinstance(item, int):
                self.ops.append((item, 0, none, (0, 0, 0, 0), 0))
                continue
            if not item:
                self.ops.append((OP_TRUE, 0, none, (0, 0, 0, 0), 0))
                continue
            kids = _kids(item)
            if kids is None:
                op = next(iter(item))
                self.leaf(op, item[op])
                continue
            needs = [self.memo[id(k)] for k in kids]
            j = needs.index(max(needs))
            fwd, rev = (OP_AND, OP_AND_R) if 'and' in item \
                else (OP_OR, OP_OR_R)
            seq = [kids[j]]
            for i in range(j - 1, -1, -1):
                seq += [kids[i], rev]
            for i in range(j + 1, len(kids)):
                seq += [kids[i], fwd]
            todo.extend(reversed(seq))

    def leaf(self, op, operands):
        field, const = operands
        i = self.leaf_index[(field, op, jsv.json_stringify(const))]
        leaf = self.scan._leaf_list[i][1]
        f = leaf.field
        has_str, has_num, all_num = self.fprof.get(f, (True, True, False))
        slots = [-1, -1, -1, -1]
        args = [NUM_FALSE, 0, 0, 0]
        flags = 0
        if all_num or has_num:
            mode, t = self.scan._num_plans[i]
            args[0], args[1] = mode, t
            if mode not in (NUM_FALSE, NUM_TRUE):
                slots[2] = self.slot('num_' + f)
        if all_num:
            flags = LEAF_ALL_NUM
        else:
            slots[0] = self.slot('tags_' + f)
            args[2] = _pack_ctab(leaf)
            if has_str:
                flags |= LEAF_HAS_STR
                slots[1] = self.slot('str_' + f)
                slots[3] = self.slot(self.pfx + 'tab_%d' % i, False)
            if has_num:
                flags |= LEAF_HAS_NUM
        self.ops.append((OP_LEAF, flags, tuple(slots), tuple(args), 0))


def _bounds(time_bounds):
    """(lo kind, lo, hi kind, hi) of `ts >= lo` and `ts < hi`: uploaded
    ts values are exact-i32, so a bound outside i32 resolves statically
    to vacuous or nothing-passes."""
    lo, hi = time_bounds
    lo_kind, lo_v, hi_kind, hi_v = BOUND_NONE, 0, BOUND_NONE, 0
    if lo is not None:
        lo = int(lo)
        if lo > I32MAX:
            lo_kind = BOUND_NEVER
        elif lo > I32MIN:
            lo_kind, lo_v = BOUND_CMP, lo
    if hi is not None:
        hi = int(hi)
        if hi <= I32MIN:
            hi_kind = BOUND_NEVER
        elif hi <= I32MAX:
            hi_kind, hi_v = BOUND_CMP, hi
    return lo_kind, lo_v, hi_kind, hi_v


def compile_program(scan, profile, caps, ns, mode):
    """The program of DeviceScan `scan` for a batch staged with upload
    `profile` and key `caps` (ns segments) in output `mode`.  Reads the
    scan's static plan (predicates and their leaves, the synthetic date
    fields, the time bounds, the key plans' current windows) and the
    input keys its staging wrote; raises ValueError for a filter whose
    operand stack passes the kernel's register stack (2^31 leaves)."""
    w1, gen_alive, fprof, kvalid_skip, use_dstats, _ = profile
    c = _Compiler(scan, fprof)
    pfx = c.pfx
    h = {'pred_begin': [-1, -1], 'pred_end': [-1, -1]}
    nbits = 0
    for p, pred in enumerate((scan.ds_pred, scan.user_pred)):
        if pred is None:
            continue
        h['pred_begin'][p] = len(c.ops)
        c.pred(pred.ast)
        h['pred_end'][p] = len(c.ops)
        nbits += 4
    sfield = {s['name']: s['field'] for s in scan.synthetic}

    def ts_key(name):
        return 'tsf_' + sfield[name] if use_dstats \
            else pfx + 'ts_' + name
    h['terr_slot'] = -1
    if scan.synthetic:
        h['terr_slot'] = c.slot(
            'terr_' + '|'.join(fc['field'] for fc in scan.synthetic)
            if use_dstats else pfx + 'terr')
        nbits += 4
    h['ts_slot'] = -1
    h['time_lo_kind'], h['time_lo'], h['time_hi_kind'], h['time_hi'] = \
        BOUND_NONE, 0, BOUND_NONE, 0
    if scan.time_bounds is not None:
        h['ts_slot'] = c.slot(ts_key('dn_ts'))
        (h['time_lo_kind'], h['time_lo'], h['time_hi_kind'],
         h['time_hi']) = _bounds(scan.time_bounds)
        nbits += 3
    nbits += 3
    h['key_begin'] = len(c.ops)
    none = (0, 0, 0, 0)
    for plan, cap in zip(scan._plans, caps):
        if plan.kind == 'str':
            if plan.host_translate:
                c.ops.append((OP_KEY_HOST, 0,
                              (c.slot(pfx + 'key_' + plan.name), -1, -1,
                               -1), none, cap))
            else:
                c.ops.append((OP_KEY_TRANS, 0, (
                    c.slot(pfx + 'trans_' + plan.name, False),
                    c.slot('str_' + plan.name), -1, -1), none, cap))
            continue
        if plan.field.startswith('\0synth:'):
            v = c.slot(ts_key(plan.field[len('\0synth:'):]))
            kv = -1
        else:
            kv = -1 if plan.name in kvalid_skip \
                else c.slot('kvalid_' + plan.name)
            v = c.slot('kv_' + plan.name)
        if plan.kind == 'p2':
            c.ops.append((OP_KEY_P2, 0, (v, kv, -1, -1), none, cap))
        else:
            if not (I32MIN <= plan.lo <= I32MAX):
                raise ValueError('linear key window origin %d outside '
                                 'int32' % plan.lo)
            c.ops.append((OP_KEY_LIN, 0, (v, kv, -1, -1),
                          (plan.step, plan.lo, 0, 0), cap))
    h['key_end'] = len(c.ops)
    h['weights_slot'] = -1 if w1 else c.slot('weights')
    h['alive_slot'] = -1 if gen_alive else c.slot('alive')
    ncounters = len(scan._counter_spec)
    if ncounters != nbits or ncounters > MAX_COUNTERS:
        raise ValueError('scan program: %d counters, %d counter bits'
                         % (ncounters, nbits))
    prog = ScanProgram(mode, max(int(ns), 1) if mode != MODE_SPARSE else 0,
                       ncounters, h, c.ops, c.keys, c.rows)
    depth = prog.stack_depth()
    if depth > STACK_DEPTH:
        raise ValueError('filter needs %d operand-stack entries; the scan '
                         'kernel holds %d' % (depth, STACK_DEPTH))
    return prog


# -- the plain version ---------------------------------------------------

def _ref_num(mode, t, v, n, dev):
    """A numeric leaf's outcome over a batch (v: the i32 values, None in
    a constant mode)."""
    if mode == NUM_FALSE:
        return torch.full((n,), FALSE, dtype=torch.int8, device=dev)
    if mode == NUM_TRUE:
        return torch.full((n,), TRUE, dtype=torch.int8, device=dev)
    v = v.to(torch.int32)
    if mode == NUM_EQ:
        hit = v == t
    elif mode == NUM_NE:
        hit = v != t
    elif mode == NUM_LE:
        hit = v <= t
    else:
        hit = v >= t
    return torch.where(hit, TRUE, FALSE).to(torch.int8)


def _ref_leaf(op, args, keys, n, dev):
    _, flags, slots, a, _ = op
    mode, t, ctab = a[0], a[1], a[2] & 0xffffffff
    num = args[keys[slots[2]]] if slots[2] >= 0 else None
    if flags & LEAF_ALL_NUM:
        return _ref_num(mode, t, num, n, dev)
    tags = args[keys[slots[0]]].to(torch.int64)
    table = torch.tensor([(ctab >> (2 * i)) & 3 for i in range(16)],
                         dtype=torch.int8, device=dev)
    out = table[tags & 15]
    if flags & LEAF_HAS_STR:
        codes = args[keys[slots[1]]].to(torch.int64).clamp_min_(0)
        out = torch.where(tags == mn.TAG_STRING,
                          args[keys[slots[3]]][codes], out)
    if flags & LEAF_HAS_NUM:
        numm = (tags == mn.TAG_INT) | (tags == mn.TAG_NUMBER)
        out = torch.where(numm, _ref_num(mode, t, num, n, dev), out)
    return out


def _ref_pred(ops, begin, end, args, keys, n, dev):
    """A predicate's postfix program over the batch, on an explicit
    stack of i8 outcome tensors."""
    stack = []
    for op in ops[begin:end]:
        code = op[0]
        if code == OP_TRUE:
            stack.append(torch.full((n,), TRUE, dtype=torch.int8,
                                    device=dev))
        elif code == OP_LEAF:
            stack.append(_ref_leaf(op, args, keys, n, dev))
        else:
            top = stack.pop()
            below = stack.pop()
            a, b = (top, below) if code in (OP_AND_R, OP_OR_R) \
                else (below, top)
            passing = TRUE if code in (OP_AND, OP_AND_R) else FALSE
            stack.append(torch.where(a == passing, b, a))
    return stack[0]


def _ref_p2(v):
    """Bit length for v >= 1, else 0, by a shift ladder (exact)."""
    x = torch.clamp_min(v, 0)
    bl = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        bl = bl + torch.where(big, s, 0).to(v.dtype)
        x = torch.where(big, x >> s, x)
    bl = bl + (x >= 1).to(v.dtype)
    return torch.where(v < 1, 0, bl)


def scan_body_ref(prog, args, n, dense, first, cvec, base=0, row0=0,
                  nvalid=None, key_out=None):
    """Plain version of `scan_body`, in torch ops over the batch, on any
    device: the same descriptor, the same outputs."""
    h = prog.header
    keys = prog.slot_keys
    ops = prog.ops
    dev = cvec.device
    i64 = torch.int64
    rows = torch.arange(row0, row0 + n, dtype=i64, device=dev)
    if h['alive_slot'] < 0:
        alive = rows < (row0 + n if nvalid is None else nvalid)
    else:
        alive = args[keys[h['alive_slot']]].to(torch.bool)
    bits = []
    for p in (0, 1):
        if h['pred_begin'][p] < 0:
            continue
        bits.append(alive)
        out = _ref_pred(ops, h['pred_begin'][p], h['pred_end'][p], args,
                        keys, n, dev)
        bits.append(alive & (out == ERROR))
        bits.append(alive & (out == FALSE))
        alive = alive & (out == TRUE)
        bits.append(alive)
    if h['terr_slot'] >= 0:
        terr = args[keys[h['terr_slot']]].to(torch.int32)
        bits.append(alive)
        bits.append(alive & (terr == 1))     # undef
        bits.append(alive & (terr == 2))     # baddate
        alive = alive & (terr == 0)
        bits.append(alive)
    if h['ts_slot'] >= 0:
        ts = args[keys[h['ts_slot']]].to(torch.int32)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        for kind, bound, lower in ((h['time_lo_kind'], h['time_lo'], True),
                                   (h['time_hi_kind'], h['time_hi'],
                                    False)):
            if kind == BOUND_NEVER:
                ok = ok & False
            elif kind == BOUND_CMP:
                ok = ok & ((ts >= bound) if lower else (ts < bound))
        bits.append(alive)
        bits.append(alive & ~ok)
        alive = alive & ok
        bits.append(alive)
    bits.append(alive)                        # aggregator ninputs
    key = torch.zeros(n, dtype=i64, device=dev)
    nnon = torch.zeros(n, dtype=torch.bool, device=dev)
    for code, _, slots, a, cap in ops[h['key_begin']:h['key_end']]:
        if code == OP_KEY_HOST:
            kc = args[keys[slots[0]]].to(i64)
        elif code == OP_KEY_TRANS:
            sc = args[keys[slots[1]]].to(i64).clamp_min_(0)
            kc = args[keys[slots[0]]][sc].to(i64)
        else:
            if slots[1] >= 0:
                valid = args[keys[slots[1]]].to(torch.bool)
                nnon = nnon | (alive & ~valid)
                alive = alive & valid
            v = args[keys[slots[0]]].to(i64)
            if code == OP_KEY_P2:
                kc = _ref_p2(v)
            else:
                kc = torch.div(v, a[0], rounding_mode='floor') - a[1]
        key = key * cap + kc
    bits.append(nnon)
    bits.append(alive if prog.mode == MODE_SPARSE else
                torch.zeros(n, dtype=torch.bool, device=dev))
    cvec += torch.stack([b.sum(dtype=i64) for b in bits])
    w = alive.to(i64) if h['weights_slot'] < 0 else torch.where(
        alive, args[keys[h['weights_slot']]].to(i64), 0)
    if prog.mode == MODE_SPARSE:
        return (torch.where(alive, key, I64MAX), w,
                torch.where(alive, rows + base, I64MAX))
    ns = prog.ns
    # dead rows go to bin ns, sliced off
    k = torch.where(alive, key, ns)
    fb = torch.full((ns + 1,), I64MAX, dtype=i64, device=dev)
    fb.scatter_reduce_(0, k, rows + base, 'amin', include_self=True)
    torch.minimum(first, fb[:ns], out=first)
    if prog.mode == MODE_K1:
        out = key_out[:n]
        out.copy_(k)
        return out
    db = torch.zeros(ns + 1, dtype=i64, device=dev)
    db.index_add_(0, k, w)
    dense += db[:ns]
    return None


# -- the kernel's wrapper ------------------------------------------------

_lib = None


def _setup(lib):
    fn = lib.dn_scan_body
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    size = lib.dn_scan_launch_bytes
    size.restype = ctypes.c_int64
    size.argtypes = []
    if size() != ctypes.sizeof(DnScanLaunch):
        raise RuntimeError('scan kernel: DnScanLaunch is %d bytes in '
                           'scan_body.cuh, %d in its ctypes mirror'
                           % (size(), ctypes.sizeof(DnScanLaunch)))


def _load():
    global _lib
    _lib = cuda_kernels.load_library('scan_body', _setup)
    return _lib


def _check_acc(name, t, size, dev):
    if t is None or t.dtype != torch.int64 or t.dim() != 1 or \
            not t.is_contiguous() or t.device != dev or t.numel() < size:
        raise ValueError('scan kernel: %s must be a contiguous 1-d int64 '
                         'tensor of at least %d entries on %s'
                         % (name, size, dev))


def scan_body(prog, args, n, dense, first, cvec, base=0, row0=0,
              nvalid=None, key_out=None):
    """Run program `prog` over one batch: `args` maps the program's
    slot keys to tensors (per-record inputs of n rows, device-resident
    tables), `cvec` (i64[ncounters]) takes the counters; on the dense
    routes `first` (i64[ns]) the first occurrence, base + row, by a
    running min, and in MODE_DENSE `dense` (i64[ns]) the weights.
    `row0` and `nvalid` place a mesh shard's rows in its batch (rows
    from nvalid on are padding).  Returns the fused i32 key in
    `key_out` (MODE_K1: i32, at least n entries), (key, weight, first
    row) i64[n] each (MODE_SPARSE), or None (MODE_DENSE).

    CPU tensors take scan_body_ref; CUDA tensors launch the kernel on
    the device's current stream, without synchronising.  Raises on a
    failed build or launch and on arguments the kernel does not take."""
    dev = cvec.device
    if dev.type == 'cpu':
        return scan_body_ref(prog, args, n, dense, first, cvec, base,
                             row0, nvalid, key_out)
    if dev.type != 'cuda':
        raise ValueError('scan kernel: unsupported device %s' % dev)
    mode = prog.mode
    _check_acc('cvec', cvec, prog.ncounters, dev)
    if mode != MODE_SPARSE:
        _check_acc('first', first, prog.ns, dev)
    if mode == MODE_DENSE:
        _check_acc('dense', dense, prog.ns, dev)
    ts = [args[k] for k in prog.slot_keys]
    dtypes = []
    for t in ts:
        code = DTYPE_CODES.get(t.dtype)
        if code is None or t.device != dev or not t.is_contiguous():
            raise ValueError('scan kernel: an input of dtype %s on %s '
                             '(contiguous: %s); the kernel takes '
                             'contiguous 8-64 bit integer or bool inputs '
                             'on %s' % (t.dtype, t.device,
                                        t.is_contiguous(), dev))
        dtypes.append(code)
    for i in prog.rows:
        if ts[i].numel() < n:
            raise ValueError('scan kernel: input %r has %d rows, the '
                             'batch %d' % (prog.slot_keys[i],
                                           ts[i].numel(), n))
    hdr, opbytes, ondev = prog.encoded(tuple(dtypes))
    ops = ondev.get(dev)
    if ops is None:
        # from page-locked memory, without blocking the host (the
        # caching host allocator keeps the buffer until the copy ran)
        ops = ondev[dev] = torch.frombuffer(
            bytearray(opbytes), dtype=torch.uint8).pin_memory().to(
                dev, non_blocking=True)
    L = DnScanLaunch()
    L.prog = hdr
    L.ops = ops.data_ptr()
    L.n, L.base, L.row0 = n, base, row0
    L.nvalid = row0 + n if nvalid is None else nvalid
    ptrs = [t.data_ptr() for t in ts]
    m = min(len(ptrs), INLINE_SLOTS)
    L.slot[:m] = ptrs[:m]
    extra = None
    if len(ptrs) > INLINE_SLOTS:
        # a program past the inline slots: the rest through a device
        # array, copied a batch (page-locked, as the op array)
        extra = torch.tensor(ptrs[INLINE_SLOTS:], dtype=torch.int64
                             ).pin_memory().to(dev, non_blocking=True)
        L.slot_extra = extra.data_ptr()
    out = None
    if mode == MODE_K1:
        if key_out is None or key_out.dtype != torch.int32 or \
                key_out.device != dev or not key_out.is_contiguous() or \
                key_out.numel() < n:
            raise ValueError('scan kernel: key_out must be a contiguous '
                             'int32 tensor of at least %d entries on %s'
                             % (n, dev))
        out = key_out[:n]
        L.out_key32 = out.data_ptr()
        L.acc_first = first.data_ptr()
    elif mode == MODE_DENSE:
        L.acc_dense = dense.data_ptr()
        L.acc_first = first.data_ptr()
    else:
        out = tuple(torch.empty(n, dtype=torch.int64, device=dev)
                    for _ in range(3))
        L.out_key64, L.out_w64, L.out_first64 = \
            [t.data_ptr() for t in out]
    L.acc_cvec = cvec.data_ptr()
    lib = _lib or _load()
    rc = lib.dn_scan_body(ctypes.byref(L), dev.index,
                          cuda_kernels.current_stream_handle(dev.index))
    if rc != 0:
        raise RuntimeError('scan kernel launch failed: CUDA error %d' % rc)
    cuda_kernels.launches['scan_body'] += 1
    del extra
    return out
