// One-hot aggregation for Hopper (sm_90a): out[s] += sum of w[r] over
// the records r whose fused key equals s, for s in [0, ns).
//
// Replaces the TPU kernel dragnet_tpu/ops/pallas_kernels.py
// `_make_call.kernel` (:70-102, reached through `onehot_dense`).  On the
// TPU the sum is a one-hot (512 x 512 tile) reduced on the MXU at
// Precision.HIGHEST into a VMEM-resident f32 block, from the fused key
// the caller computed.  A float32 tensor-core product on this card runs
// in TF32 and would break the exact sums HIGHEST protects, and the
// one-hot does records x segments work for a function that needs one
// pass, so this is a histogram with integer atomics instead: exact and
// independent of order.  The caller keeps the batch's total |weight|
// below 2^24, so no int32 bin can overflow.
//
// Input: the fused key (int32 or int64; dead rows carry any value
// outside [0, ns)) and optional int32 weights.  Output: the caller's
// int64 accumulator, added into; nothing is zeroed here.
//
// Bound on this card: the bytes.  4 B per fused key (+4 B per weight
// when weighted) read once and 16 B per segment (read and write the
// int64 accumulator), at 3.35 TB/s: 0.09 us at one main-path batch
// (74,800 keys, 256 segments), below the launch latency, and 2.41 us at
// 2,000,000 keys x 4,096 segments.
//
// Design, against what held the first version back (numbers: NVIDIA
// H100 80GB HBM3, 700.00 W, device time per call from CUDA-graph
// replay, chip_smoke.py; PERF.md has the tables):
// - Fused-key input, added into the caller's accumulator: no radix
//   arithmetic, no zero-fill, no separate fold add.
// - Each block builds a private int32 histogram in shared memory and
//   the kCluster blocks of a thread-block cluster merge it once: after
//   cluster.sync() block k sums bin slice k across the cluster's
//   histograms through distributed shared memory and adds it into the
//   accumulator with one 64-bit atomic per bin.  That is ns x clusters
//   global atomics, where the first version paid ns x blocks.  The grid
//   takes one cluster per kCluster x kThreads x kKeysPerThread keys
//   (16,384), up to four blocks an SM: 5 clusters at the main path's
//   batch.  A sweep of cluster sizes (4, 8, 16), block sizes (256, 512,
//   1,024) and one cluster covering the whole batch (whose merge needs
//   no atomic) found none faster than these constants.
// - Hot bins: the main path's keys are skewed (5 live hosts; linear
//   timestamps put a warp's records in one or two minute buckets).  On
//   this card plain shared atomics take them at no extra cost: 0.0034
//   ms with every live key on one bin and 0.0034 uniform, at 74,800
//   keys and 256 segments.  Combining a warp's equal keys first
//   (__match_any_sync, one atomic per group) was measured slower at
//   every shape of that sweep, so the kernel does not.
// - Loads: 4 keys per 16-byte vector load, kUnroll loads in flight per
//   thread before any atomic.
//
// ptxas -v (sm_90a): 40 registers (i32 or i64 keys, unit weights), 40
// (i32, weighted), 52 (i64, weighted); no spills; shared memory ns x
// 4 B, dynamic (at most 16 KB).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCluster = 8;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 2;
// keys one thread takes before the grid grows by another cluster
constexpr int kKeysPerThread = 8;
constexpr int kMaxBins = 4096;
constexpr int kVec = 4;
constexpr int kMaxDevices = 64;

// Keys [4 * v, 4 * v + 4) of the batch and their weights, as loaded
// (past n a key reads -1, outside every accumulator).  Nothing here uses
// the loaded values, so a thread's kUnroll calls have their loads in
// flight together.
template <typename K, bool kWeighted>
__device__ __forceinline__ void load4(const K* __restrict__ fused,
                                      const int32_t* __restrict__ w,
                                      int64_t v, int64_t n, bool aligned,
                                      K (&k)[kVec], int (&wt)[kVec]) {
  const int64_t j = v * kVec;
  if (aligned && j + kVec <= n) {
    if constexpr (sizeof(K) == 4) {
      int4 q = reinterpret_cast<const int4*>(fused)[v];
      k[0] = q.x; k[1] = q.y; k[2] = q.z; k[3] = q.w;
    } else {
      longlong2 a = reinterpret_cast<const longlong2*>(fused)[2 * v];
      longlong2 b = reinterpret_cast<const longlong2*>(fused)[2 * v + 1];
      k[0] = a.x; k[1] = a.y; k[2] = b.x; k[3] = b.y;
    }
    if constexpr (kWeighted) {
      int4 q = reinterpret_cast<const int4*>(w)[v];
      wt[0] = q.x; wt[1] = q.y; wt[2] = q.z; wt[3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; e++) {
      k[e] = j + e < n ? fused[j + e] : (K)-1;
      if constexpr (kWeighted) wt[e] = j + e < n ? w[j + e] : 0;
    }
  }
}

template <typename K, bool kWeighted>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
onehot_into_kernel(unsigned long long* __restrict__ out, int ns,
                   const K* __restrict__ fused,
                   const int32_t* __restrict__ weights, int64_t n,
                   bool aligned) {
  extern __shared__ int32_t hist[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < ns; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  const int64_t nvec = (n + kVec - 1) / kVec;
  // `warp0` is the warp's first vector: every branch on it is uniform
  // across the warp
  for (int64_t warp0 = (int64_t)blockIdx.x * kThreads + threadIdx.x - lane;
       warp0 < nvec; warp0 += nthreads * kUnroll) {
    K k[kUnroll][kVec];
    int wt[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; u++)
      if (warp0 + u * nthreads < nvec)
        load4<K, kWeighted>(fused, weights, warp0 + lane + u * nthreads, n,
                            aligned, k[u], wt[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; u++)
      if (warp0 + u * nthreads < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; e++) {
          // keys outside [0, ns) drop out
          const K key = k[u][e];
          if (key >= 0 && key < ns)
            atomicAdd(&hist[(int)key], kWeighted ? wt[u][e] : 1);
        }
      }
  }

  // every histogram of the cluster is complete; block `rank` owns bins
  // [lo, hi) and sums them across the cluster
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  const int lo = (int)((int64_t)ns * rank / kCluster);
  const int hi = (int)((int64_t)ns * (rank + 1) / kCluster);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    int32_t s = 0;
#pragma unroll
    for (int r = 0; r < kCluster; r++)
      s += cluster.map_shared_rank(hist, r)[i];
    if (s != 0)
      atomicAdd(&out[i], (unsigned long long)(long long)s);
  }
  // keep this block's histogram alive until the cluster has read it
  cluster.sync();
}

template <typename K, bool kWeighted>
static cudaError_t launch(void* out, int ns, const void* fused,
                          const void* weights, int64_t n, int device,
                          cudaStream_t stream) {
  static int sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int64_t per_cluster = (int64_t)kCluster * kThreads * kKeysPerThread;
  const int64_t most = sms[device] * kBlocksPerSm / kCluster;
  int64_t clusters = (n + per_cluster - 1) / per_cluster;
  if (clusters > most) clusters = most;
  if (clusters < 1) clusters = 1;
  const bool aligned =
      (((uintptr_t)fused | (uintptr_t)weights) & 15) == 0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kCluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)ns * sizeof(int32_t);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, onehot_into_kernel<K, kWeighted>, (unsigned long long*)out, ns,
      (const K*)fused, (const int32_t*)weights, n, aligned);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" {

// out: [ns] int64, added into; fused: [n] int32 (key_bytes 4) or int64
// (key_bytes 8); weights: [n] int32, or null for every weight 1.  All on
// `device`, contiguous.  Launches on `stream` without synchronising and
// returns the CUDA error code (0 on success): a refused launch, a
// cluster that cannot be placed, a bad argument.
int dn_onehot_dense_into(void* out, int ns, const void* fused,
                         int key_bytes, int64_t n, const void* weights,
                         int device, void* stream) {
  if (ns < 1 || ns > kMaxBins || n < 0 ||
      (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (key_bytes == 4)
    err = weights ? launch<int32_t, true>(out, ns, fused, weights, n,
                                          device, s)
                  : launch<int32_t, false>(out, ns, fused, weights, n,
                                           device, s);
  else
    err = weights ? launch<int64_t, true>(out, ns, fused, weights, n,
                                          device, s)
                  : launch<int64_t, false>(out, ns, fused, weights, n,
                                           device, s);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
