// The scan program's descriptor and its per-record evaluator, shared by
// the Hopper kernel K2 (scan_body.cu) and a host build of the same
// evaluator (tests/helpers/scan_body_host.cc, compiled with g++ by the
// CPU tests, which also hold these structs' layout against the ctypes
// mirror in dragnet_tpu_torch/scan_program.py).  Every struct here is
// plain data: change a field and change the mirror with it.
//
// A program is compiled once per (plan signature, upload profile, caps,
// output mode, upload dtypes) by scan_program.compile_program; a batch
// changes only the input pointers, n and the batch's first-occurrence
// base.  Its parts, in the order DeviceScan's counters are appended:
//   - both predicates (ds_pred, user_pred) as postfix op ranges over a
//     2-bit stack of ternary outcomes (FALSE 0, TRUE 1, ERROR 2) held in
//     one 64-bit register: 32 entries.  The compiler emits each and/or
//     node's heaviest operand first (Sethi-Ullman order), so a filter of
//     L leaves needs at most floor(log2 L) + 1 entries;
//   - the synthetic date stage (the `terr` slot) and the time bounds,
//     resolved statically to a compare, nothing-passes or vacuous;
//   - the key plans in breakdown order (host-translated codes, a gather
//     of the native string code through a translation table, p2 or
//     linear bucketize), each with its radix (cap) for the mixed-radix
//     key, and a numeric plan's kvalid mask or none;
//   - the output mode: the fused i32 key for K1, the weights added into
//     the dense accumulator, or the sparse mode's i64 key, weight and
//     first-occurrence rows.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define DN_HD __host__ __device__ __forceinline__
#else
#define DN_HD inline
#endif

// slot pointers passed by value in the launch; a program with more
// slots passes the rest through a device array (slot_extra)
#define DN_INLINE_SLOTS 96
// DeviceScan's counter layout has at most 4 + 4 + 4 + 3 + 3 entries
#define DN_MAX_COUNTERS 18

// ternary predicate outcomes (ops/kernels.py)
#define DN_FALSE 0
#define DN_TRUE 1
#define DN_ERROR 2

// the native parser's value tags (native.py)
#define DN_TAG_NUMBER 4
#define DN_TAG_INT 5
#define DN_TAG_STRING 6

// input dtype codes, kept in the top byte of a slot reference:
// ref = index | code << 24; -1 is no slot
#define DN_U8 1   // uint8 and bool
#define DN_I8 2
#define DN_I16 3
#define DN_I32 4
#define DN_I64 5

// output modes
#define DN_MODE_K1 0      // fused i32 key (dead rows at ns) for K1
#define DN_MODE_DENSE 1   // weights added into acc_dense
#define DN_MODE_SPARSE 2  // i64 key (dead at INT64_MAX), weight, first row

// op codes
#define DN_OP_TRUE 1      // push TRUE (an empty predicate)
#define DN_OP_LEAF 2      // push one leaf's outcome
#define DN_OP_AND 3       // pop b, pop a; push a == TRUE ? b : a
#define DN_OP_OR 4        // pop b, pop a; push a == FALSE ? b : a
#define DN_OP_AND_R 5     // the same with the left operand a on top
#define DN_OP_OR_R 6
#define DN_OP_KEY_HOST 10   // slot[0]: host-translated code
#define DN_OP_KEY_TRANS 11  // slot[0]: translation table, slot[1]: string
#define DN_OP_KEY_P2 12     // slot[0]: value, slot[1]: kvalid or -1
#define DN_OP_KEY_LIN 13    // the same; arg[0]: step, arg[1]: lo

// LEAF flags
#define DN_LEAF_HAS_STR 1
#define DN_LEAF_HAS_NUM 2
#define DN_LEAF_ALL_NUM 4

// numeric leaf modes (device_scan.NUM_*)
#define DN_NUM_FALSE 0
#define DN_NUM_TRUE 1
#define DN_NUM_EQ 2
#define DN_NUM_NE 3
#define DN_NUM_LE 4
#define DN_NUM_GE 5

// time-bound kinds
#define DN_BOUND_NONE 0
#define DN_BOUND_NEVER 1
#define DN_BOUND_CMP 2

// One op.  LEAF: slot = {tags, str, num, tab}, arg = {numeric mode,
// threshold, outcome by tag for the non-string, non-numeric tags (2 bits
// a tag, 16 tags), 0}.  KEY_*: see the op codes; cap is the column's
// radix.
typedef struct DnOp {
  int32_t code;
  int32_t flags;
  int32_t slot[4];
  int32_t arg[4];
  int64_t cap;
} DnOp;

// The program's header, by value in every launch.
typedef struct DnScanProgram {
  int32_t pred_begin[2];  // op ranges of ds_pred, user_pred; begin -1:
  int32_t pred_end[2];    // no such predicate
  int32_t key_begin;      // op range of the key plans
  int32_t key_end;
  int32_t ncounters;
  int32_t mode;           // DN_MODE_*
  int32_t weights_slot;   // -1: every weight is 1
  int32_t alive_slot;     // -1: alive is synthesized (row0 + r < nvalid)
  int32_t terr_slot;      // -1: no synthetic date stage
  int32_t ts_slot;        // -1: no time bounds
  int32_t time_lo_kind;   // DN_BOUND_*: ts >= time_lo
  int32_t time_lo;
  int32_t time_hi_kind;   // DN_BOUND_*: ts < time_hi
  int32_t time_hi;
  int64_t ns;             // dense segments: K1's dead key
} DnScanProgram;

// One launch: the program, the batch, and where the results go.
typedef struct DnScanLaunch {
  DnScanProgram prog;
  const DnOp* ops;
  int64_t n;        // records of this launch
  int64_t base;     // added to every first-occurrence row (batch << 32)
  int64_t row0;     // this launch's first row within the batch
  int64_t nvalid;   // rows from nvalid on are padding (synthesized alive)
  int64_t* acc_dense;   // DENSE: [ns], added into (K1 adds it there)
  int64_t* acc_first;   // K1, DENSE: [ns], a running min of base + row
  int64_t* acc_cvec;    // [ncounters], added into
  int32_t* out_key32;   // K1: [n]
  int64_t* out_key64;   // SPARSE: [n] each
  int64_t* out_w64;
  int64_t* out_first64;
  const void* const* slot_extra;  // slots DN_INLINE_SLOTS and up
  const void* slot[DN_INLINE_SLOTS];
} DnScanLaunch;

// One record's results.
typedef struct DnRecord {
  uint32_t cbits;   // bit k: the record counts in counter k
  int alive;
  int32_t w;        // its weight when alive, else 0
  int64_t key;      // the fused key (meaningful when alive)
} DnRecord;

DN_HD int32_t dn_load(const DnScanLaunch& L, int32_t ref, int64_t r) {
  const int32_t idx = ref & 0xffffff;
  const int code = (ref >> 24) & 0xff;
  const void* p = idx < DN_INLINE_SLOTS
                      ? L.slot[idx]
                      : L.slot_extra[idx - DN_INLINE_SLOTS];
  switch (code) {
    case DN_U8: return ((const uint8_t*)p)[r];
    case DN_I8: return ((const int8_t*)p)[r];
    case DN_I16: return ((const int16_t*)p)[r];
    case DN_I32: return ((const int32_t*)p)[r];
    default: return (int32_t)((const int64_t*)p)[r];
  }
}

DN_HD int dn_num_outcome(int mode, int32_t t, int32_t v) {
  bool hit;
  switch (mode) {
    case DN_NUM_FALSE: return DN_FALSE;
    case DN_NUM_TRUE: return DN_TRUE;
    case DN_NUM_EQ: hit = v == t; break;
    case DN_NUM_NE: hit = v != t; break;
    case DN_NUM_LE: hit = v <= t; break;
    default: hit = v >= t; break;
  }
  return hit ? DN_TRUE : DN_FALSE;
}

// A leaf's outcome: the outcome by tag; where the tag is a string, the
// leaf's outcome table at the string's code (-1 reads as 0); where it
// is a number, the numeric plan.  ALL_NUM: every row is a number and no
// tags were uploaded.
DN_HD int dn_leaf(const DnScanLaunch& L, const DnOp& op, int64_t r) {
  const int mode = op.arg[0];
  const bool const_mode = mode == DN_NUM_FALSE || mode == DN_NUM_TRUE;
  if (op.flags & DN_LEAF_ALL_NUM)
    return dn_num_outcome(mode, op.arg[1],
                          const_mode ? 0 : dn_load(L, op.slot[2], r));
  const int tag = dn_load(L, op.slot[0], r);
  if ((op.flags & DN_LEAF_HAS_STR) && tag == DN_TAG_STRING) {
    int32_t c = dn_load(L, op.slot[1], r);
    return dn_load(L, op.slot[3], c < 0 ? 0 : c);
  }
  if ((op.flags & DN_LEAF_HAS_NUM) &&
      (tag == DN_TAG_INT || tag == DN_TAG_NUMBER))
    return dn_num_outcome(mode, op.arg[1],
                          const_mode ? 0 : dn_load(L, op.slot[2], r));
  return ((uint32_t)op.arg[2] >> (2 * (tag & 15))) & 3;
}

// One predicate's postfix program over ops [begin, end).
DN_HD int dn_pred(const DnScanLaunch& L, int32_t begin, int32_t end,
                  int64_t r) {
  uint64_t st = 0;
  for (int32_t i = begin; i < end; i++) {
    const DnOp& op = L.ops[i];
    const int code = op.code;
    if (code == DN_OP_TRUE) {
      st = (st << 2) | DN_TRUE;
    } else if (code == DN_OP_LEAF) {
      st = (st << 2) | (uint64_t)dn_leaf(L, op, r);
    } else {
      const int top = (int)(st & 3);
      const int below = (int)((st >> 2) & 3);
      const bool rev = code == DN_OP_AND_R || code == DN_OP_OR_R;
      const int a = rev ? top : below;
      const int b = rev ? below : top;
      const int pass =
          (code == DN_OP_AND || code == DN_OP_AND_R) ? DN_TRUE : DN_FALSE;
      st = ((st >> 4) << 2) | (uint64_t)(a == pass ? b : a);
    }
  }
  return (int)(st & 3);
}

// floor(v / step) for step >= 1 (C's / truncates toward zero)
DN_HD int64_t dn_floordiv(int32_t v, int32_t step) {
  int32_t q = v / step;
  if (v % step < 0) q -= 1;
  return q;
}

// DTrace quantize: 0 for v < 1, else the bit length of v
DN_HD int64_t dn_p2(int32_t v) {
  if (v < 1) return 0;
#ifdef __CUDA_ARCH__
  return 32 - __clz(v);
#else
  return 32 - __builtin_clz((uint32_t)v);
#endif
}

// The whole per-record program: predicates, the date and time stages,
// the key plans, and the counter bits, in DeviceScan's counter order.
DN_HD void dn_eval(const DnScanLaunch& L, int64_t r, DnRecord& o) {
  const DnScanProgram& P = L.prog;
  bool alive = P.alive_slot < 0 ? L.row0 + r < L.nvalid
                                : dn_load(L, P.alive_slot, r) != 0;
  uint32_t cb = 0;
  int k = 0;
  for (int p = 0; p < 2; p++) {
    if (P.pred_begin[p] < 0) continue;
    cb |= (uint32_t)alive << k++;
    const int out = dn_pred(L, P.pred_begin[p], P.pred_end[p], r);
    cb |= (uint32_t)(alive && out == DN_ERROR) << k++;
    cb |= (uint32_t)(alive && out == DN_FALSE) << k++;
    alive = alive && out == DN_TRUE;
    cb |= (uint32_t)alive << k++;
  }
  if (P.terr_slot >= 0) {
    const int32_t te = dn_load(L, P.terr_slot, r);
    cb |= (uint32_t)alive << k++;
    cb |= (uint32_t)(alive && te == 1) << k++;   // undef
    cb |= (uint32_t)(alive && te == 2) << k++;   // baddate
    alive = alive && te == 0;
    cb |= (uint32_t)alive << k++;
  }
  if (P.ts_slot >= 0) {
    const int32_t ts = dn_load(L, P.ts_slot, r);
    bool ok = true;
    if (P.time_lo_kind == DN_BOUND_NEVER) ok = false;
    else if (P.time_lo_kind == DN_BOUND_CMP) ok = ok && ts >= P.time_lo;
    if (P.time_hi_kind == DN_BOUND_NEVER) ok = false;
    else if (P.time_hi_kind == DN_BOUND_CMP) ok = ok && ts < P.time_hi;
    cb |= (uint32_t)alive << k++;
    cb |= (uint32_t)(alive && !ok) << k++;
    alive = alive && ok;
    cb |= (uint32_t)alive << k++;
  }
  cb |= (uint32_t)alive << k++;   // the aggregator's ninputs
  // the key, in unsigned arithmetic: a dead row's key may wrap, and is
  // never used
  uint64_t key = 0;
  bool nnon = false;
  for (int32_t i = P.key_begin; i < P.key_end; i++) {
    const DnOp& op = L.ops[i];
    int64_t code;
    if (op.code == DN_OP_KEY_HOST) {
      code = dn_load(L, op.slot[0], r);
    } else if (op.code == DN_OP_KEY_TRANS) {
      const int32_t c = dn_load(L, op.slot[1], r);
      code = dn_load(L, op.slot[0], c < 0 ? 0 : c);
    } else {
      if (op.slot[1] >= 0) {
        const bool valid = dn_load(L, op.slot[1], r) != 0;
        nnon = nnon || (alive && !valid);
        alive = alive && valid;
      }
      const int32_t v = dn_load(L, op.slot[0], r);
      code = op.code == DN_OP_KEY_P2
                 ? dn_p2(v)
                 : dn_floordiv(v, op.arg[0]) - (int64_t)op.arg[1];
    }
    key = key * (uint64_t)op.cap + (uint64_t)code;
  }
  cb |= (uint32_t)nnon << k++;                                // nnonnumeric
  cb |= (uint32_t)(P.mode == DN_MODE_SPARSE && alive) << k++;  // nspill
  o.cbits = cb;
  o.alive = alive;
  o.key = (int64_t)key;
  o.w = !alive ? 0 : P.weights_slot < 0 ? 1 : dn_load(L, P.weights_slot, r);
}
