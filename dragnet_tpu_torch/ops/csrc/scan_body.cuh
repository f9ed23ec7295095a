// The scan program's descriptor and its evaluator, shared by the Hopper
// kernel K2 (scan_body.cu) and a host build of the same code
// (tests/helpers/scan_body_host.cc, compiled with g++ by the CPU tests,
// which also hold these structs' layout against the ctypes mirror in
// dragnet_tpu_torch/scan_program.py).  Every struct here is plain data:
// change a field and change the mirror with it.
//
// A program is compiled once per (plan signature, upload profile, caps,
// output mode) by scan_program.compile_program and encoded once per
// upload dtype set; a batch changes only the input pointers, n and the
// batch's first-occurrence base.  Its parts, in the order DeviceScan's
// counters are appended:
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
// The per-record slots are numbered first (0 .. nrows - 1), the
// device-resident tables after them.
//
// The kernel runs the program over tiles of records, one record a
// thread.  A tile's per-record columns are staged in shared memory first
// (all of them in flight together, dn_stage_copy), and so are the small
// device-resident tables and the op array, once per block; the evaluator
// then reads every slot through the loader (DnLoader): a staged slot
// from shared memory, any other in place through the launch's pointers.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define DN_HD __host__ __device__ __forceinline__
#else
#define DN_HD inline
#endif

// slot pointers passed by value in the launch; a program with more
// slots passes the rest through a device array (slot_extra)
#define DN_INLINE_SLOTS 96
// slots a block maps in shared memory (a staged slot's offset there, two
// a slot: for the tile being evaluated and the one being staged); a
// program's slots past these are read in place, never staged
#define DN_MAP_SLOTS 256
// per-record slots staged in shared memory a tile, and their bytes a
// record; the rest are read from device memory
#define DN_MAX_STAGE 32
#define DN_STAGE_BYTES 64
// device-resident tables staged in shared memory a block, and their
// bytes (each rounded up to 16)
#define DN_MAX_TABS 32
#define DN_TAB_BYTES 16384
// DeviceScan's counter layout has at most 4 + 4 + 4 + 3 + 3 entries
#define DN_MAX_COUNTERS 18
// the stage profile's clock readings (DnScanLaunch.prof)
#define DN_PROF_STAGES 6

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
  int32_t nops;           // ops in the op array
  int32_t nslots;         // slots of the program
  int32_t nrows;          // its per-record slots: 0 .. nrows - 1
  int32_t nstage;         // per-record slots staged a tile (stage_ref)
  int32_t stage_bpr;      // their bytes a record
  int32_t stage_ref[DN_MAX_STAGE];  // a staged slot's reference
  int32_t stage_pre[DN_MAX_STAGE];  // bytes a record of the staged
                                    // slots before it
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
  // null, or [DN_PROF_STAGES]: block 0's first thread writes its clock
  // at the start and at the end of each stage (scan_body.cu)
  int64_t* prof;
  const void* const* slot_extra;  // slots DN_INLINE_SLOTS and up
  int32_t ntabs;                  // tables staged a block
  int32_t tab_bytes;              // their shared bytes
  int32_t tab_ref[DN_MAX_TABS];   // a staged table's slot reference
  int32_t tab_len[DN_MAX_TABS];   // its entries
  int32_t tab_off[DN_MAX_TABS];   // its offset in shared memory
  const void* slot[DN_INLINE_SLOTS];
} DnScanLaunch;

// One record's results.
typedef struct DnRecord {
  uint32_t cbits;   // bit k: the record counts in counter k
  int alive;
  int32_t w;        // its weight when alive, else 0
  int64_t key;      // the fused key (meaningful when alive)
} DnRecord;

DN_HD int dn_code_bytes(int code) {
  return code == DN_I64 ? 8 : code == DN_I32 ? 4 : code == DN_I16 ? 2 : 1;
}

// slot `idx`'s pointer as the launch passes it
DN_HD const void* dn_slot_ptr(const DnScanLaunch& L, int32_t idx) {
  return idx < DN_INLINE_SLOTS ? L.slot[idx]
                               : L.slot_extra[idx - DN_INLINE_SLOTS];
}

// The evaluator reads slot `ref` at index `at` through the loader: a
// per-record slot at the record's place in its tile, a table at a code.
// A slot below nmap with an offset in `map` lies in the shared buffer
// `smem` (the tile's staged column, or a staged table): its entry is
// read as the aligned 32-bit word that holds it and cut out with shifts
// (an i64 entry as its low word), the same few instructions whatever the
// dtype; every staged region is a multiple of 16 bytes from a 16-byte
// aligned start, so the word lies inside it.  Any other slot (map entry
// -1, or past the map) is read in place through the launch's pointers,
// a per-record one from the tile's first record, and the dtype picks
// the load.  kStaged: every slot of the program is staged (the main
// path's programs), so a load takes no branch at all.
template <bool kStaged>
struct DnLoader {
  const int32_t* map;       // [nmap]: a slot's offset in smem, or -1
  int32_t nmap;
  const unsigned char* smem;
  const DnScanLaunch* L;
  int64_t start;            // the tile's first record
  DN_HD int32_t operator()(int32_t ref, int32_t at) const {
    const int32_t idx = ref & 0xffffff;
    const int code = (ref >> 24) & 0xff;
    const int32_t off = kStaged ? map[idx] : idx < nmap ? map[idx] : -1;
    if (kStaged || off >= 0) {
      const int lg = code == DN_I64 ? 3 : code == DN_I32 ? 2
                   : code == DN_I16 ? 1 : 0;
      const int ls = lg >= 2 ? 0 : 32 - (8 << lg);   // 24, 16 or 0
      const uint32_t byte = (uint32_t)off + ((uint32_t)at << lg);
      const uint32_t w = *(const uint32_t*)(smem + (byte & ~3u));
      const uint32_t x = (w >> ((byte & 3) * 8)) << ls;
      return code != DN_U8 ? (int32_t)x >> ls : (int32_t)(x >> ls);
    }
    const char* p = (const char*)dn_slot_ptr(*L, idx);
    if (idx < L->prog.nrows) p += start * dn_code_bytes(code);
    switch (code) {
      case DN_U8: return ((const uint8_t*)p)[at];
      case DN_I8: return ((const int8_t*)p)[at];
      case DN_I16: return ((const int16_t*)p)[at];
      case DN_I32: return ((const int32_t*)p)[at];
      default: return (int32_t)((const int64_t*)p)[at];
    }
  }
};

// One chunk of a staged copy: `len` (1..csz) bytes of a csz-byte chunk.
// On the card an asynchronous copy (cp.async: only src's own `len` bytes
// are read, and the rest of the chunk is written with zeros) or, for a
// 1-byte chunk, a load and a store; on the host a memcpy and the same
// zeros.  So a copy writes up to its length rounded up to its chunk:
// every region it copies into (a tile's column, a table, the op array)
// is a multiple of 16 bytes from a 16-byte aligned start.
DN_HD void dn_copy_chunk(void* dst, const void* src, int csz, int len) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (csz == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(len));
  else if (csz == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(len));
  else
    *(uint8_t*)dst = *(const uint8_t*)src;
#else
  memcpy(dst, src, (size_t)len);
  memset((char*)dst + len, 0, (size_t)(csz - len));
#endif
}

// This thread's share (of nthreads, as thread tid) of copying nbytes
// (below 2^31) from src into dst: 16-byte chunks where both are 16-byte
// aligned, 4 where both are 4-byte aligned, else single bytes (a mesh
// shard's view at an odd row); the last chunk is cut to what remains,
// so nothing past src + nbytes is read.  32-bit shifts, no division.
DN_HD void dn_stage_copy(void* dst, const void* src, int32_t nbytes,
                         int tid, int nthreads) {
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src;
  const int lg = (a & 15) == 0 ? 4 : (a & 3) == 0 ? 2 : 0;
  const int csz = 1 << lg;
  for (int32_t off = tid << lg; off < nbytes; off += nthreads << lg) {
    const int32_t left = nbytes - off;
    dn_copy_chunk((char*)dst + off, (const char*)src + off, csz,
                  left < csz ? left : csz);
  }
}

DN_HD int dn_num_outcome(int mode, int32_t t, int32_t v) {
  const bool hit = mode == DN_NUM_EQ ? v == t
                 : mode == DN_NUM_NE ? v != t
                 : mode == DN_NUM_LE ? v <= t : v >= t;
  return mode == DN_NUM_FALSE ? DN_FALSE
       : mode == DN_NUM_TRUE ? DN_TRUE : hit ? DN_TRUE : DN_FALSE;
}

// A leaf's outcome for the record at rt: the outcome by tag; where the
// tag is a string, the leaf's outcome table at the string's code (-1
// reads as 0); where it is a number, the numeric plan.  ALL_NUM: every
// row is a number and no tags were uploaded.  The string code and the
// number are loaded whatever the tag (a non-string row gathers table
// entry 0, unused), so those loads do not wait on the tag's.
template <class Ld>
DN_HD int dn_leaf(const DnOp& op, const Ld& ld, int32_t rt) {
  const int mode = op.arg[0];
  const int32_t t = op.arg[1];
  const int32_t num =
      op.slot[2] >= 0 && mode != DN_NUM_FALSE && mode != DN_NUM_TRUE
          ? ld(op.slot[2], rt) : 0;
  if (op.flags & DN_LEAF_ALL_NUM) return dn_num_outcome(mode, t, num);
  const int32_t tag = ld(op.slot[0], rt);
  const bool has_str = (op.flags & DN_LEAF_HAS_STR) != 0;
  int32_t tab = 0;
  if (has_str) {
    const int32_t c = ld(op.slot[1], rt);
    tab = ld(op.slot[3], tag == DN_TAG_STRING && c > 0 ? c : 0);
  }
  if (has_str && tag == DN_TAG_STRING) return tab;
  if ((op.flags & DN_LEAF_HAS_NUM) &&
      (tag == DN_TAG_INT || tag == DN_TAG_NUMBER))
    return dn_num_outcome(mode, t, num);
  return ((uint32_t)op.arg[2] >> (2 * (tag & 15))) & 3;
}

// One predicate's postfix program over ops [begin, end).
template <class Ld>
DN_HD int dn_pred(const DnOp* ops, int32_t begin, int32_t end,
                  const Ld& ld, int32_t rt) {
  uint64_t st = 0;
  for (int32_t i = begin; i < end; i++) {
    const DnOp& op = ops[i];
    const int code = op.code;
    if (code == DN_OP_TRUE) {
      st = (st << 2) | DN_TRUE;
    } else if (code == DN_OP_LEAF) {
      st = (st << 2) | (uint64_t)dn_leaf(op, ld, rt);
    } else {
      const bool rev = code == DN_OP_AND_R || code == DN_OP_OR_R;
      const int pass =
          (code == DN_OP_AND || code == DN_OP_AND_R) ? DN_TRUE : DN_FALSE;
      const int top = (int)(st & 3);
      const int below = (int)((st >> 2) & 3);
      const int a = rev ? top : below;
      const int b = rev ? below : top;
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

// The whole per-record program for one record: predicates, the date and
// time stages, the key plans, and the counter bits, in DeviceScan's
// counter order.  rt: the record's index in its tile (a valid one where
// `valid` is false); row: its row in the batch (row0 + r), for a
// synthesized alive.  A record that is not valid is dead and counts
// nowhere.
template <class Ld>
DN_HD DnRecord dn_eval(const DnScanLaunch& L, const DnOp* ops, const Ld& ld,
                       int32_t rt, bool valid, int64_t row) {
  const DnScanProgram& P = L.prog;
  bool alive = valid && (P.alive_slot < 0 ? row < L.nvalid
                                          : ld(P.alive_slot, rt) != 0);
  uint32_t cb = 0;
  int k = 0;
  for (int p = 0; p < 2; p++) {
    if (P.pred_begin[p] < 0) continue;
    const int out = dn_pred(ops, P.pred_begin[p], P.pred_end[p], ld, rt);
    cb |= (uint32_t)alive << k;
    cb |= (uint32_t)(alive && out == DN_ERROR) << (k + 1);
    cb |= (uint32_t)(alive && out == DN_FALSE) << (k + 2);
    alive = alive && out == DN_TRUE;
    cb |= (uint32_t)alive << (k + 3);
    k += 4;
  }
  if (P.terr_slot >= 0) {
    const int32_t v = ld(P.terr_slot, rt);
    cb |= (uint32_t)alive << k;
    cb |= (uint32_t)(alive && v == 1) << (k + 1);   // undef
    cb |= (uint32_t)(alive && v == 2) << (k + 2);   // baddate
    alive = alive && v == 0;
    cb |= (uint32_t)alive << (k + 3);
    k += 4;
  }
  if (P.ts_slot >= 0) {
    const int32_t v = ld(P.ts_slot, rt);
    bool ok = true;
    if (P.time_lo_kind == DN_BOUND_NEVER) ok = false;
    else if (P.time_lo_kind == DN_BOUND_CMP) ok = ok && v >= P.time_lo;
    if (P.time_hi_kind == DN_BOUND_NEVER) ok = false;
    else if (P.time_hi_kind == DN_BOUND_CMP) ok = ok && v < P.time_hi;
    cb |= (uint32_t)alive << k;
    cb |= (uint32_t)(alive && !ok) << (k + 1);
    alive = alive && ok;
    cb |= (uint32_t)alive << (k + 2);
    k += 3;
  }
  cb |= (uint32_t)alive << k;   // the aggregator's ninputs
  k++;
  // the key, in unsigned arithmetic: a dead row's key may wrap, and is
  // never used
  uint64_t key = 0;
  bool nnon = false;
  for (int32_t i = P.key_begin; i < P.key_end; i++) {
    const DnOp& op = ops[i];
    int64_t code;
    if (op.code == DN_OP_KEY_HOST) {
      code = ld(op.slot[0], rt);
    } else if (op.code == DN_OP_KEY_TRANS) {
      const int32_t c = ld(op.slot[1], rt);
      code = ld(op.slot[0], c < 0 ? 0 : c);
    } else {
      if (op.slot[1] >= 0) {
        const int32_t kv = ld(op.slot[1], rt);
        nnon = nnon || (alive && kv == 0);
        alive = alive && kv != 0;
      }
      const int32_t v = ld(op.slot[0], rt);
      code = op.code == DN_OP_KEY_P2
                 ? dn_p2(v)
                 : dn_floordiv(v, op.arg[0]) - (int64_t)op.arg[1];
    }
    key = key * (uint64_t)op.cap + (uint64_t)code;
  }
  const int32_t w = P.weights_slot >= 0 ? ld(P.weights_slot, rt) : 1;
  cb |= (uint32_t)nnon << k;   // nnonnumeric
  cb |= (uint32_t)(P.mode == DN_MODE_SPARSE && alive) << (k + 1);  // nspill
  DnRecord o;
  o.cbits = cb;
  o.alive = alive;
  o.key = (int64_t)key;
  o.w = alive ? w : 0;
  return o;
}
