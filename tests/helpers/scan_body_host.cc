// A host build of the scan program's per-record evaluator
// (dragnet_tpu_torch/ops/csrc/scan_body.cuh), for the CPU tests: g++
// compiles it into a shared library, and tests/test_torch_scan_body.py
// runs it on numpy inputs against scan_program.scan_body_ref and reads
// the descriptor structs' layout to hold the ctypes mirror to it.
// dn_scan_body_host is K2 (ops/csrc/scan_body.cu) with its grid, warp
// reductions and atomics replaced by one loop over the records: every
// pointer in *L is a host pointer.

#include <cstddef>
#include <cstdio>
#include <cstring>

#include "../../dragnet_tpu_torch/ops/csrc/scan_body.cuh"

extern "C" {

int dn_scan_body_host(const DnScanLaunch* L) {
  const DnScanProgram& P = L->prog;
  for (int64_t r = 0; r < L->n; r++) {
    DnRecord o;
    dn_eval(*L, r, o);
    for (int j = 0; j < P.ncounters; j++)
      L->acc_cvec[j] += (o.cbits >> j) & 1u;
    const int64_t row = L->row0 + r;
    if (P.mode == DN_MODE_SPARSE) {
      L->out_key64[r] = o.alive ? o.key : INT64_MAX;
      L->out_w64[r] = o.w;
      L->out_first64[r] = o.alive ? L->base + row : INT64_MAX;
      continue;
    }
    if (P.mode == DN_MODE_K1)
      L->out_key32[r] = o.alive ? (int32_t)o.key : (int32_t)P.ns;
    if (!o.alive) continue;
    // (a program without keys fuses every row to key 0)
    if (P.mode == DN_MODE_DENSE) L->acc_dense[o.key] += o.w;
    if (L->base + row < L->acc_first[o.key])
      L->acc_first[o.key] = L->base + row;
  }
  return 0;
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
  DN_FIELD(DnScanProgram, time_hi); DN_FIELD(DnScanProgram, ns);
  DN_SIZE(DnScanLaunch);
  DN_FIELD(DnScanLaunch, prog); DN_FIELD(DnScanLaunch, ops);
  DN_FIELD(DnScanLaunch, n); DN_FIELD(DnScanLaunch, base);
  DN_FIELD(DnScanLaunch, row0); DN_FIELD(DnScanLaunch, nvalid);
  DN_FIELD(DnScanLaunch, acc_dense); DN_FIELD(DnScanLaunch, acc_first);
  DN_FIELD(DnScanLaunch, acc_cvec); DN_FIELD(DnScanLaunch, out_key32);
  DN_FIELD(DnScanLaunch, out_key64); DN_FIELD(DnScanLaunch, out_w64);
  DN_FIELD(DnScanLaunch, out_first64);
  DN_FIELD(DnScanLaunch, slot_extra); DN_FIELD(DnScanLaunch, slot);
  return n;
}

// the evaluator's integer helpers alone: floor division and bit length
int64_t dn_floordiv_host(int32_t v, int32_t step) {
  return dn_floordiv(v, step);
}

int64_t dn_p2_host(int32_t v) { return dn_p2(v); }

}  // extern "C"
