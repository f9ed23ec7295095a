// A host build of the scan program's evaluator and staging
// (dragnet_tpu_torch/ops/csrc/scan_body.cuh), for the CPU tests: g++
// compiles it into a shared library, and tests/test_torch_scan_body.py
// runs it on numpy inputs against scan_program.scan_body_ref and reads
// the descriptor structs' layout to hold the ctypes mirror to it.
// dn_scan_body_host_tiled is K2 (ops/csrc/scan_body.cu) with one block of
// `nthreads` threads run one thread after another: the same tiles of
// nthreads records, one a thread, the same slot map, the same staging of
// the tables, the op array and each tile's columns (dn_stage_copy,
// memcpy and zeros for cp.async), the same evaluator (dn_eval) through
// the same loader (DnLoader, in either case), and the warp reductions
// and atomics replaced by a loop over the records.  Every pointer in *L
// is a host pointer.

#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "../../dragnet_tpu_torch/ops/csrc/scan_body.cuh"

namespace {

struct Buf {              // a 16-byte aligned host buffer
  explicit Buf(int64_t n)
      : p((unsigned char*)aligned_alloc(16, (size_t)((n + 16) & ~15))) {}
  ~Buf() { free(p); }
  unsigned char* p;
};

void stage_all(void* dst, const void* src, int64_t nbytes, int nthreads) {
  for (int tid = 0; tid < nthreads; tid++)
    dn_stage_copy(dst, src, (int32_t)nbytes, tid, nthreads);
}

int64_t align16(int64_t x) { return (x + 15) & ~(int64_t)15; }

// K2's block on the host, one thread after another.  A tile's staged
// column i starts at stride * stage_pre[i], the tile's records rounded
// up to 16 as in the kernel's 128-record tiles, so each region is a
// multiple of 16 bytes from a 16-byte aligned start.  kStaged: the
// loader for a program whose every slot is staged.  Returns 0, or -1 if
// a record past the batch counted.
template <bool kStaged>
int run_tiles(const DnScanLaunch& L, int nthreads) {
  const DnScanProgram& P = L.prog;
  const int T = nthreads;
  const int64_t stride = align16(T);
  // the op array staged as the kernel stages it (up to 256 ops)
  const int64_t nops_b =
      P.nops <= 256 ? align16(P.nops * (int64_t)sizeof(DnOp)) : 0;
  // one buffer as the kernel's shared memory: ops, tables, a tile
  Buf smem(nops_b + L.tab_bytes + stride * P.stage_bpr);
  unsigned char* s_tabs = smem.p + nops_b;
  unsigned char* stage = s_tabs + L.tab_bytes;
  // the slot map: a staged slot's offset in smem, else -1
  const int nmap = P.nslots < DN_MAP_SLOTS ? P.nslots : DN_MAP_SLOTS;
  std::vector<int32_t> map(nmap + 1, -1);
  for (int i = 0; i < P.nstage; i++) {
    const int32_t idx = P.stage_ref[i] & 0xffffff;
    if (idx < nmap)
      map[idx] = (int32_t)(stage + stride * P.stage_pre[i] - smem.p);
  }
  if (nops_b)
    stage_all(smem.p, L.ops, P.nops * (int64_t)sizeof(DnOp), nthreads);
  const DnOp* ops = nops_b ? (const DnOp*)smem.p : L.ops;
  for (int i = 0; i < L.ntabs; i++) {
    const int32_t ref = L.tab_ref[i];
    const int32_t idx = ref & 0xffffff;
    unsigned char* dst = s_tabs + L.tab_off[i];
    stage_all(dst, dn_slot_ptr(L, idx),
              (int64_t)L.tab_len[i] * dn_code_bytes((ref >> 24) & 0xff),
              nthreads);
    if (idx < nmap) map[idx] = (int32_t)(dst - smem.p);
  }
  for (int64_t start = 0; start < L.n; start += T) {
    const int valid_n = L.n - start < T ? (int)(L.n - start) : T;
    for (int i = 0; i < P.nstage; i++) {
      const int32_t ref = P.stage_ref[i];
      const int es = dn_code_bytes((ref >> 24) & 0xff);
      stage_all(stage + stride * P.stage_pre[i],
                (const char*)dn_slot_ptr(L, ref & 0xffffff) + start * es,
                (int64_t)valid_n * es, nthreads);
    }
    const DnLoader<kStaged> ld = {map.data(), nmap, smem.p, &L, start};
    for (int tid = 0; tid < nthreads; tid++) {
      const bool valid = tid < valid_n;
      const int64_t row = L.row0 + start + tid;
      const DnRecord o = dn_eval(L, ops, ld, valid ? tid : 0, valid, row);
      if (!valid) {
        if (o.cbits != 0 || o.alive) return -1;
        continue;
      }
      const int64_t r = start + tid;
      for (int c = 0; c < P.ncounters; c++)
        L.acc_cvec[c] += (o.cbits >> c) & 1u;
      if (P.mode == DN_MODE_SPARSE) {
        L.out_key64[r] = o.alive ? o.key : INT64_MAX;
        L.out_w64[r] = o.w;
        L.out_first64[r] = o.alive ? L.base + row : INT64_MAX;
        continue;
      }
      if (P.mode == DN_MODE_K1)
        L.out_key32[r] = o.alive ? (int32_t)o.key : (int32_t)P.ns;
      if (!o.alive) continue;
      // (a program without keys fuses every row to key 0)
      if (P.mode == DN_MODE_DENSE) L.acc_dense[o.key] += o.w;
      if (L.base + row < L.acc_first[o.key])
        L.acc_first[o.key] = L.base + row;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// K2 on the host: tiles of `nthreads` records, one a thread; with
// `staged`, the loader of a program whose every slot is staged where the
// kernel takes it (as scan_body.cu's all_staged).  Returns the loader it
// ran (0 the general one, 1 the staged one), or -1 if a record past the
// batch counted.
int dn_scan_body_host_tiled(const DnScanLaunch* L, int nthreads,
                            int staged) {
  const bool all = L->ntabs + L->prog.nstage == L->prog.nslots;
  if (staged && all) {
    const int rc = run_tiles<true>(*L, nthreads);
    return rc < 0 ? rc : 1;
  }
  return run_tiles<false>(*L, nthreads);
}

// one thread a block, the general loader
int dn_scan_body_host(const DnScanLaunch* L) {
  return dn_scan_body_host_tiled(L, 1, 0) < 0;
}

// dn_stage_copy for every thread of `nthreads`; returns the chunk size
// it chose (16, 4 or 1)
int dn_stage_copy_host(void* dst, const void* src, int64_t nbytes,
                       int nthreads) {
  stage_all(dst, src, nbytes, nthreads);
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src;
  return (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
}

#define DN_FIELD(T, f) n += snprintf(buf + n, cap - n, "%s.%s=%zu;", #T, \
                                     #f, offsetof(T, f))
#define DN_SIZE(T) n += snprintf(buf + n, cap - n, "%s=%zu;", #T, sizeof(T))

// "Struct=size;Struct.field=offset;..." for every descriptor struct
int dn_scan_layout(char* buf, int cap) {
  int n = 0;
  DN_SIZE(DnOp);
  DN_FIELD(DnOp, code); DN_FIELD(DnOp, flags); DN_FIELD(DnOp, slot);
  DN_FIELD(DnOp, arg); DN_FIELD(DnOp, cap);
  DN_SIZE(DnScanProgram);
  DN_FIELD(DnScanProgram, pred_begin); DN_FIELD(DnScanProgram, pred_end);
  DN_FIELD(DnScanProgram, key_begin); DN_FIELD(DnScanProgram, key_end);
  DN_FIELD(DnScanProgram, ncounters); DN_FIELD(DnScanProgram, mode);
  DN_FIELD(DnScanProgram, weights_slot);
  DN_FIELD(DnScanProgram, alive_slot);
  DN_FIELD(DnScanProgram, terr_slot); DN_FIELD(DnScanProgram, ts_slot);
  DN_FIELD(DnScanProgram, time_lo_kind);
  DN_FIELD(DnScanProgram, time_lo);
  DN_FIELD(DnScanProgram, time_hi_kind);
  DN_FIELD(DnScanProgram, time_hi); DN_FIELD(DnScanProgram, nops);
  DN_FIELD(DnScanProgram, nslots); DN_FIELD(DnScanProgram, nrows);
  DN_FIELD(DnScanProgram, nstage);
  DN_FIELD(DnScanProgram, stage_bpr);
  DN_FIELD(DnScanProgram, stage_ref); DN_FIELD(DnScanProgram, stage_pre);
  DN_FIELD(DnScanProgram, ns);
  DN_SIZE(DnScanLaunch);
  DN_FIELD(DnScanLaunch, prog); DN_FIELD(DnScanLaunch, ops);
  DN_FIELD(DnScanLaunch, n); DN_FIELD(DnScanLaunch, base);
  DN_FIELD(DnScanLaunch, row0); DN_FIELD(DnScanLaunch, nvalid);
  DN_FIELD(DnScanLaunch, acc_dense); DN_FIELD(DnScanLaunch, acc_first);
  DN_FIELD(DnScanLaunch, acc_cvec); DN_FIELD(DnScanLaunch, out_key32);
  DN_FIELD(DnScanLaunch, out_key64); DN_FIELD(DnScanLaunch, out_w64);
  DN_FIELD(DnScanLaunch, out_first64); DN_FIELD(DnScanLaunch, prof);
  DN_FIELD(DnScanLaunch, slot_extra); DN_FIELD(DnScanLaunch, ntabs);
  DN_FIELD(DnScanLaunch, tab_bytes); DN_FIELD(DnScanLaunch, tab_ref);
  DN_FIELD(DnScanLaunch, tab_len); DN_FIELD(DnScanLaunch, tab_off);
  DN_FIELD(DnScanLaunch, slot);
  return n;
}

// the evaluator's integer helpers alone: floor division and bit length
int64_t dn_floordiv_host(int32_t v, int32_t step) {
  return dn_floordiv(v, step);
}

int64_t dn_p2_host(int32_t v) { return dn_p2(v); }

}  // extern "C"
