// The scan's per-batch device program (K2) for Hopper (sm_90a): one
// thread a record, grid-strided, runs the whole program of one batch
// (the descriptor and its per-record evaluator are in scan_body.cuh).
//
// Replaces the reference's jitted per-batch program,
// dragnet_tpu/device_scan.py `DeviceScan._compile` -> `fold` (:1975) ->
// `run_body` (:1954) -> `body` (:1797), compiled with
// jax.jit(_tokenized(...)) at :2069-2072 and, for a build, the N
// metrics' folds in one program (:2618-2631).  XLA fuses that program
// into one dispatch a batch; torch runs it as some 78 eager ops, whose
// host launches kept the card idle about 90 % of a fold (NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md).  Here it is one launch (two on K1's
// route, where K1 then adds the fused key into the accumulator).
//
// What it does per record: both predicates (leaf tables gathered by
// string code, numeric compares, the ternary and/or fold on a 2-bit
// register stack), the date-error and time-bound masks, the kvalid
// masks, p2 or floor-division bucketize and the mixed-radix key; then
// per output mode: the i32 fused key for K1 (dead rows at ns); 64-bit
// atomic adds of the weights into the resident dense accumulator; or
// the sparse program's i64 key, weight and first-occurrence row.  On
// the dense routes the first occurrence goes into the resident i64
// acc_first as base + row: the bin is read first and atomicMin runs only
// when the row is lower, so after a key's first batch its bin costs no
// atomic.  The counters are bits of one word a record, summed a thread
// over its records, then per warp (__reduce_add_sync), per block in
// shared memory, and added with one 64-bit atomic per counter per block.
// A program without keys (no breakdowns) sums its weights and takes its
// first row by the same reductions instead of contended atomics.
//
// Every sum is an integer sum, so the result is exact and independent
// of the order of the atomics.  Signed weights wrap correctly in two's
// complement (the caller keeps a batch's total |weight| below 2^31).
//
// Bound on this card: the bytes.  Each per-record input byte read once
// (3-7 B a record on the main path's queries), the outputs written once
// (4 B a record on K1's route, 24 on the sparse one) and the
// accumulator's touched bins: at 65,536 records well under a
// microsecond at 3.35 TB/s, below the launch latency.  chip_smoke.py
// reports the bound of each shape it times.
//
// Simple first: one record a thread, the op stream read from global
// memory (the same address across a warp), 256 threads a block.
// Warp-aggregated atomics, vector loads and a shared histogram for
// large accumulators are later work.
//
// ptxas -v (sm_90a): printed by chip_smoke.py's build phase.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_body.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
scan_body_kernel(const __grid_constant__ DnScanLaunch L) {
  __shared__ unsigned long long s_cnt[DN_MAX_COUNTERS];
  __shared__ long long s_wsum;
  __shared__ unsigned s_minrow;
  if (threadIdx.x < DN_MAX_COUNTERS) s_cnt[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    s_wsum = 0;
    s_minrow = kFull;
  }
  __syncthreads();

  const int ncnt = L.prog.ncounters;
  const bool keyless = L.prog.key_begin == L.prog.key_end;
  uint32_t cnt[DN_MAX_COUNTERS];
#pragma unroll
  for (int j = 0; j < DN_MAX_COUNTERS; j++) cnt[j] = 0;
  int wsum = 0;            // keyless: the weights of alive rows
  unsigned minrow = kFull;  // keyless: the first alive row

  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < L.n;
       r += stride) {
    DnRecord o;
    dn_eval(L, r, o);
#pragma unroll
    for (int j = 0; j < DN_MAX_COUNTERS; j++) cnt[j] += (o.cbits >> j) & 1u;
    const int64_t row = L.row0 + r;
    if (kMode == DN_MODE_SPARSE) {
      L.out_key64[r] = o.alive ? o.key : INT64_MAX;
      L.out_w64[r] = o.w;
      L.out_first64[r] = o.alive ? L.base + row : INT64_MAX;
      continue;
    }
    if (kMode == DN_MODE_K1)
      L.out_key32[r] = o.alive ? (int32_t)o.key : (int32_t)L.prog.ns;
    if (!o.alive) continue;
    if (keyless) {
      wsum += o.w;
      if ((unsigned)row < minrow) minrow = (unsigned)row;
      continue;
    }
    if (kMode == DN_MODE_DENSE && o.w != 0)
      atomicAdd((unsigned long long*)&L.acc_dense[o.key],
                (unsigned long long)(long long)o.w);
    const long long v = L.base + row;
    long long* f = (long long*)&L.acc_first[o.key];
    if (v < *f) atomicMin(f, v);
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < DN_MAX_COUNTERS; j++) {
    if (j < ncnt) {
      const unsigned s = __reduce_add_sync(kFull, cnt[j]);
      if (lane == 0 && s) atomicAdd(&s_cnt[j], (unsigned long long)s);
    }
  }
  if (kMode != DN_MODE_SPARSE && keyless) {
    const int s = (int)__reduce_add_sync(kFull, (unsigned)wsum);
    const unsigned m = __reduce_min_sync(kFull, minrow);
    if (lane == 0) {
      if (s) atomicAdd((unsigned long long*)&s_wsum,
                       (unsigned long long)(long long)s);
      if (m != kFull) atomicMin(&s_minrow, m);
    }
  }
  __syncthreads();
  if (threadIdx.x < ncnt && s_cnt[threadIdx.x])
    atomicAdd((unsigned long long*)&L.acc_cvec[threadIdx.x],
              s_cnt[threadIdx.x]);
  if (kMode != DN_MODE_SPARSE && keyless && threadIdx.x == kWarps) {
    if (s_wsum && kMode == DN_MODE_DENSE)
      atomicAdd((unsigned long long*)&L.acc_dense[0],
                (unsigned long long)s_wsum);
    if (s_minrow != kFull) {
      const long long v = L.base + (long long)s_minrow;
      long long* f = (long long*)&L.acc_first[0];
      if (v < *f) atomicMin(f, v);
    }
  }
}

template <int kMode>
cudaError_t launch(const DnScanLaunch& L, int device, cudaStream_t stream) {
  static int sms[kMaxDevices];
  if (sms[device] == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int64_t blocks = (L.n + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sms[device] * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  scan_body_kernel<kMode><<<(unsigned)blocks, kThreads, 0, stream>>>(L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs one launch of the scan program on `stream` of `device` without
// synchronising; returns the CUDA error code (0 on success): a refused
// launch, a bad argument.  Every pointer in *L is a device pointer.
int dn_scan_body(const DnScanLaunch* L, int device, void* stream) {
  if (L == nullptr || L->n < 0 || L->ops == nullptr ||
      L->prog.ncounters < 0 || L->prog.ncounters > DN_MAX_COUNTERS ||
      device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L->prog.mode) {
    case DN_MODE_K1: err = launch<DN_MODE_K1>(*L, device, s); break;
    case DN_MODE_DENSE: err = launch<DN_MODE_DENSE>(*L, device, s); break;
    case DN_MODE_SPARSE: err = launch<DN_MODE_SPARSE>(*L, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// sizeof(DnScanLaunch), for the wrapper's check of its ctypes mirror
int64_t dn_scan_launch_bytes(void) { return (int64_t)sizeof(DnScanLaunch); }

}  // extern "C"
