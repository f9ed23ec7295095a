// Exclusive quote parity for Hopper (sm_90a): bit i of the output is 1
// when an odd number of '"' bytes come before byte i of the input.  The
// bits are packed 8 to a byte, MSB first (the np.packbits layout), so
// the output is ceil(n / 8) bytes; bits past n are unspecified.
//
// Replaces dragnet_tpu/ops/byteparse_kernels.py `_jax_fn.parity`
// (:94-104, jitted XLA, reached through `parity_device` :131): a cumsum
// of the quote indicator, mod 2, then a reshape-multiply-sum to pack.
// That cumsum keeps an int32 per byte (4n bytes of intermediate); here
// the scan is an XOR over bit masks in registers and nothing but the
// packed result is written.
//
// Bound on this card: the bytes.  n read once and n / 8 written, at
// 3.35 TB/s: 0.22 us for a parse block of 640 KiB and 0.15 ms for the
// 2M-record muskie file (449 MB) in one call.  The parse calls it once
// a block, so the launch and the copies around it, not the kernel,
// set the time a call takes.
//
// Design (simple and exact first; a single-pass look-back is later
// work):
// - Per thread: 32 input bytes, two 16-byte loads where the input is
//   16-byte aligned and the tile is full (byte loads at the ragged
//   end).  __vcmpeq4 marks the quote bytes of each word exactly and one
//   multiply gathers their flags into a 32-bit mask q, bit j for byte j
//   (LSB first).  The inclusive prefix XOR inside the word is
//   p ^= p << 1, 2, 4, 8, 16; the exclusive one is p << 1.  The
//   thread's total is popc(q) & 1.
// - Across a block (one tile, kThreads x 32 bytes): an XOR scan of the
//   thread totals, by warp shuffles and then over the warp totals in
//   shared memory, gives each thread its carry in, which flips all 32
//   of its bits.
// - Across blocks: the carry is never reset at a line or tile boundary
//   (an odd number of quotes on a malformed line carries into the
//   lines after it, as in the reference).  Pass 1 writes each tile's
//   output with its in-tile carry and the tile's own parity; pass 2,
//   one block, scans the tile parities into each tile's carry in;
//   pass 3 flips the output bytes of the tiles whose carry in is odd
//   (n / 8 bytes read and written at most).  One tile needs neither.
// - Bit order: the mask is LSB first within each byte; __brev reverses
//   all 32 bits and a byte swap puts the bytes back in order, which
//   leaves each byte MSB first.
// - 64-bit offsets throughout; n = 0 launches nothing.
//
// ptxas -v (sm_90a): printed by chip_smoke.py's build phase.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 32;
constexpr int64_t kTileBytes = (int64_t)kThreads * kBytesPerThread;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// 4 quote flags of one little-endian word, as bits 0..3
__device__ __forceinline__ uint32_t quote_bits(uint32_t w) {
  uint32_t m = __vcmpeq4(w, 0x22222222u) & 0x01010101u;
  return (m * 0x01020408u) >> 24;
}

// XOR scan of one bit per thread over the block: returns this thread's
// exclusive value; *total gets the block's parity
__device__ __forceinline__ uint32_t block_xor_scan(uint32_t v,
                                                   uint32_t* warp_sh,
                                                   uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc ^= y;
  }
  if (lane == 31) warp_sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < nwarps ? warp_sh[lane] : 0u;
    uint32_t winc = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t y = __shfl_up_sync(kFull, winc, d);
      if (lane >= d) winc ^= y;
    }
    if (lane < nwarps) warp_sh[32 + lane] = winc ^ w;   // exclusive
    if (lane == nwarps - 1) warp_sh[64] = winc;          // block total
  }
  __syncthreads();
  uint32_t out = (inc ^ v) ^ warp_sh[32 + warp];
  *total = warp_sh[64];
  __syncthreads();   // warp_sh may be reused by the caller's next scan
  return out;
}

// pass 1: each tile's packed parity with its in-tile carry, and the
// tile's own parity
__global__ void __launch_bounds__(kThreads)
parity_tiles(const uint8_t* __restrict__ in, int64_t n,
             uint8_t* __restrict__ out, uint8_t* __restrict__ tile_par,
             int aligned) {
  __shared__ uint32_t warp_sh[65];
  const int64_t tile = blockIdx.x;
  const int64_t start = tile * kTileBytes + (int64_t)threadIdx.x *
                        kBytesPerThread;
  uint32_t q = 0;
  if (start + kBytesPerThread <= n && aligned) {
    const uint4* p = reinterpret_cast<const uint4*>(in + start);
    uint4 a = __ldg(p);
    uint4 b = __ldg(p + 1);
    q = quote_bits(a.x) | quote_bits(a.y) << 4 | quote_bits(a.z) << 8 |
        quote_bits(a.w) << 12 | quote_bits(b.x) << 16 |
        quote_bits(b.y) << 20 | quote_bits(b.z) << 24 |
        quote_bits(b.w) << 28;
  } else if (start < n) {
    const int64_t lim = n - start;
#pragma unroll
    for (int j = 0; j < kBytesPerThread; ++j)
      if (j < lim && in[start + j] == '"') q |= 1u << j;
  }
  uint32_t p = q;
  p ^= p << 1;
  p ^= p << 2;
  p ^= p << 4;
  p ^= p << 8;
  p ^= p << 16;
  uint32_t e = p << 1;                               // exclusive
  uint32_t total;
  uint32_t carry = block_xor_scan(__popc(q) & 1u, warp_sh, &total);
  if (carry) e = ~e;
  // LSB-first bits to MSB-first bytes, byte order kept
  uint32_t packed = __byte_perm(__brev(e), 0, 0x0123);
  const int64_t nout = (n + 7) >> 3;
  const int64_t o = start >> 3;                      // 4 bytes a thread
  if (o + 4 <= nout) {
    *reinterpret_cast<uint32_t*>(out + o) = packed;
  } else {
    for (int j = 0; j < 4; ++j)
      if (o + j < nout) out[o + j] = (uint8_t)(packed >> (8 * j));
  }
  if (threadIdx.x == 0) tile_par[tile] = (uint8_t)total;
}

// pass 2, one block: tile parities -> each tile's exclusive carry in
__global__ void __launch_bounds__(kScanThreads)
scan_tiles(uint8_t* __restrict__ tile_par, int64_t ntiles) {
  __shared__ uint32_t warp_sh[65];
  uint32_t run = 0;
  for (int64_t base = 0; base < ntiles; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    uint32_t v = i < ntiles ? tile_par[i] : 0u;
    uint32_t total;
    uint32_t ex = block_xor_scan(v, warp_sh, &total);
    if (i < ntiles) tile_par[i] = (uint8_t)(ex ^ run);
    run ^= total;
  }
}

// pass 3: flip the output of every tile whose carry in is odd
__global__ void __launch_bounds__(kThreads)
apply_carry(uint8_t* __restrict__ out, int64_t n,
            const uint8_t* __restrict__ tile_par) {
  const int64_t tile = blockIdx.x;
  if (!tile_par[tile]) return;
  const int64_t nout = (n + 7) >> 3;
  const int64_t o = (tile * kTileBytes + (int64_t)threadIdx.x *
                     kBytesPerThread) >> 3;
  if (o + 4 <= nout) {
    *reinterpret_cast<uint32_t*>(out + o) ^= kFull;
  } else {
    for (int j = 0; j < 4; ++j)
      if (o + j < nout) out[o + j] ^= 0xff;
  }
}

}  // namespace

extern "C" {

// Bytes of input one tile (one block of pass 1) covers; the caller
// sizes `tile_par` to ceil(n / dn_quote_parity_tile_bytes()).
int64_t dn_quote_parity_tile_bytes() { return kTileBytes; }

// in: [n] uint8; out: [ceil(n / 8)] uint8, 4-byte aligned; tile_par:
// [ceil(n / tile bytes)] uint8 scratch.  All on `device`.  Launches on
// `stream` without synchronising and returns the CUDA error code (0 on
// success).  n = 0 launches nothing.
int dn_quote_parity(const void* in, int64_t n, void* out, void* tile_par,
                    int device, void* stream) {
  if (n < 0 || ((uintptr_t)out & 3)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t ntiles = (n + kTileBytes - 1) / kTileBytes;
  const int aligned = ((uintptr_t)in & 15) == 0;
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  uint8_t* tp = static_cast<uint8_t*>(tile_par);
  parity_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(src, n, dst, tp,
                                                      aligned);
  err = cudaGetLastError();
  if (err == cudaSuccess && ntiles > 1) {
    scan_tiles<<<1, kScanThreads, 0, s>>>(tp, ntiles);
    err = cudaGetLastError();
    if (err == cudaSuccess) {
      apply_carry<<<(unsigned)ntiles, kThreads, 0, s>>>(dst, n, tp);
      err = cudaGetLastError();
    }
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
