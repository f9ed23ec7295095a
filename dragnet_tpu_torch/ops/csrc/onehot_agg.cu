// One-hot aggregation for Hopper (sm_90a): dense[s] = sum of w[r] over
// alive records r whose mixed-radix fused key equals s.
//
// Replaces the TPU kernel dragnet_tpu/ops/pallas_kernels.py
// `_make_call.kernel` (reached through `onehot_dense`).  On the TPU the
// sum is a one-hot (512 x 512 tile) reduced on the MXU at
// Precision.HIGHEST into a VMEM-resident f32 block.  That formulation is
// wrong for this card: a float32 tensor-core product runs in TF32 and
// would break the exact sums HIGHEST protects, and the one-hot does
// records x segments work for a function that needs one pass.
//
// Here each block keeps a private histogram of <= 4096 int32 bins in
// shared memory (16 KB), walks its records in a grid-stride loop,
// computes the fused key in registers from the code rows, skips dead
// rows and keys outside [0, ns), and adds the integral weight with a
// shared-memory atomicAdd.  The block then merges its non-zero bins into
// the global int64 output with atomicAdd on unsigned long long.
// Integer atomics make the sum exact and independent of order.  The
// caller guarantees the batch's total |weight| is below 2^24, so an
// int32 bin cannot overflow.
//
// Bound: the kernel reads 4*ncols + 4 + 1 bytes per record (codes,
// weights, alive) once and writes 8*ns bytes; it is memory-bound on the
// card, and at one batch (65,536 records) its launch overhead is larger
// than the time the bytes take.

#include <cstdint>
#include <cuda_runtime.h>

#define DN_MAX_BINS 4096
#define DN_MAX_COLS 32
#define DN_THREADS 256
#define DN_RECORDS_PER_THREAD 8

struct Radices {
  int32_t r[DN_MAX_COLS];
};

__global__ void __launch_bounds__(DN_THREADS)
onehot_agg_kernel(const int32_t* __restrict__ codes, int ncols, int64_t n,
                  Radices rad, int ns, const int32_t* __restrict__ weights,
                  const bool* __restrict__ alive,
                  unsigned long long* __restrict__ out) {
  __shared__ int32_t hist[DN_MAX_BINS];
  for (int i = threadIdx.x; i < ns; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!alive[r]) continue;
    int64_t key = 0;
    for (int c = 0; c < ncols; c++)
      key = key * rad.r[c] + codes[(int64_t)c * n + r];
    if (key < 0 || key >= ns) continue;
    atomicAdd(&hist[key], weights ? weights[r] : 1);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    int32_t v = hist[i];
    if (v != 0)
      atomicAdd(&out[i], (unsigned long long)(long long)v);
  }
}

extern "C" {

// codes: [ncols, n] int32, row-major; weights: [n] int32 or null (every
// weight 1); alive: [n] bool; out: [ns] int64, zeroed by the caller.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int dn_onehot_dense(const void* codes, int ncols, int64_t n,
                    const int32_t* radices, int ns, const void* weights,
                    const void* alive, void* out, void* stream) {
  if (ncols < 1 || ncols > DN_MAX_COLS || ns < 1 || ns > DN_MAX_BINS ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  Radices rad;
  for (int c = 0; c < DN_MAX_COLS; c++) rad.r[c] = c < ncols ? radices[c] : 1;
  int64_t per_block = (int64_t)DN_THREADS * DN_RECORDS_PER_THREAD;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  onehot_agg_kernel<<<(unsigned)blocks, DN_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)codes, ncols, n, rad, ns, (const int32_t*)weights,
      (const bool*)alive, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
