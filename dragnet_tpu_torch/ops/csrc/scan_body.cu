// The scan's per-batch device program (K2) for Hopper (sm_90a): one
// launch runs the whole program of one batch over tiles of records (the
// descriptor and its evaluator are in scan_body.cuh).
//
// Replaces the reference's jitted per-batch program,
// dragnet_tpu/device_scan.py `DeviceScan._compile` -> `fold` (:1975) ->
// `run_body` (:1954) -> `body` (:1797), compiled with
// jax.jit(_tokenized(...)) at :2069-2072 and, for a build, the N
// metrics' folds in one program (:2618-2631).  XLA fuses that program
// into one dispatch a batch; here it is one launch (two on K1's route,
// where K1 then adds the fused key into the accumulator).
//
// What it does per record: both predicates (leaf tables gathered by
// string code, numeric compares, the ternary and/or fold on a 2-bit
// register stack), the date-error and time-bound masks, the kvalid
// masks, p2 or floor-division bucketize and the mixed-radix key; then
// per output mode: the i32 fused key for K1 (dead rows at ns); the
// weights added into the resident dense accumulator; or the sparse
// program's i64 key, weight and first-occurrence row.  On the dense
// routes the first occurrence goes into the resident i64 acc_first as
// base + row: the bin is read first and atomicMin runs only when the
// row is lower, so after a key's first batch its bin costs no atomic.
// The counters are bits of one word a record, summed per warp
// (__reduce_add_sync) over a block's tiles, then per block in shared
// memory, and added with one 64-bit atomic per counter per block.  A
// program without keys sums its weights and takes its first row by the
// same reductions instead of contended atomics.
//
// Every sum is an integer sum, so the result is exact and independent
// of the order of the atomics.  Signed weights wrap correctly in two's
// complement (the caller keeps a batch's total |weight| below 2^31, so
// a warp's partial sum fits an int32).
//
// Bound on this card: the bytes.  Each per-record input byte read once
// (3-8 B a record on the main path's queries), the outputs written once
// (4 B a record on K1's route, 24 on the sparse one) and the
// accumulator's touched bins: at the main path's 65,536 records well
// under a microsecond at 3.35 TB/s, below a launch's own latency; at
// 2,097,152 records 5-6 us.  chip_smoke.py reports the bound of each
// shape it times.
//
// What held the first design back (one record a thread, the op stream
// and every input read from device memory): the whole 65,536-record
// batch is one wave, so a launch took one record's latency, and that
// record ran a chain of dependent loads (an op, then a tag, then a
// string code, then a table entry, op after op): on the card a 1-record
// launch cost 0.0049-0.0154 ms, 64-88 % of the full batch's time.
// Skewed keys added contention: 64-bit atomics of many lanes on a few
// hot bins (PALLAS_QUERY's 256 bins in dense mode 0.0193 ms against
// 0.0058 in K1 mode; one hot bin 0.0513 ms).  So this design, one
// configuration at every batch size:
//   - stages each tile's per-record columns in shared memory with
//     cp.async (16-byte chunks where aligned, a cut last chunk for the
//     ragged tail), all columns in flight together, a warp a column,
//     and the small device-resident tables (leaf outcomes, string
//     translations) and the op array once per block, in the same group:
//     one round trip to device memory before the program runs, whatever
//     its length; the evaluator's loads are then shared-memory loads of
//     an aligned word and shifts, with no branch on the dtype.  A
//     program's slots past the staging budget, or past the slot map
//     (DN_MAP_SLOTS), are read in place; where none is (the main path's
//     programs) the kernel is instantiated with a loader that takes no
//     branch at all (PERF.md section 6 times the general loader beside
//     it on the same programs);
//   - keeps one record a thread in 128-thread tiles: a main-path batch
//     is a single wave of the card, so its launch lasts one thread's
//     path through the program, which more records a thread would only
//     lengthen;
//   - runs persistent blocks over the tiles, up to kBlocksPerSm an SM,
//     double-buffered: a block issues the next tile's copies before it
//     evaluates this one;
//   - aggregates the dense route per warp: the alive lanes with equal
//     keys (__match_any_sync) combine their weights and lowest row, and
//     one lane a key does the 64-bit add and the read-then-atomicMin of
//     the first occurrence (K1's route keeps one read a record: after a
//     key's first batch it finds the bin lower and writes nothing).  A
//     warp whose keys are all distinct skips the combining; otherwise it
//     walks either its groups or its largest group's members, whichever
//     is fewer (at most 5 steps).  No block-private histogram: a block
//     of a main-path batch sees 128 records, which hold most of their
//     keys once, so a shared table would cost its clearing and flush
//     for little, while the warp's combining already takes one hot bin
//     to the cost of K1's route (chip_smoke.py phase 3b's one-hot-bin
//     batch).
// What bounds it: the program's evaluation, one thread's chain of
// dependent shared loads and compares, some 450 cycles an op; on the
// main path's programs 39-71 % of a 1-record launch's cycles, the wait
// for the staged copies 2-6 % (NVIDIA H100 80GB HBM3, 700 W).
// chip_smoke.py phase 3b reads that from the stage profile
// (DnScanLaunch.prof) of block 0's first thread: the prologue, the wait
// for the staged copies, the evaluation, the record's output, and the
// rest; a launch that does not ask for it pays one test of L.prof a
// stage.  At 2,097,152 records one record a thread reaches 4-10 % of
// the bound; more records a thread would overlap more loads there, but
// no main-path batch is that large (PERF.md section 6).
//
// ptxas -v (sm_90a): printed by chip_smoke.py's build phase.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_body.cuh"

namespace {

constexpr int kThreads = 128;           // a tile's records, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxSharedOps = 256;      // op arrays up to this are staged
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int64_t align16(int64_t x) {
  return (x + 15) & ~(int64_t)15;
}

// shared bytes of the op array when it is staged, else 0
__host__ __device__ inline int32_t ops_bytes(const DnScanLaunch& L) {
  return L.prog.nops <= kMaxSharedOps
             ? (int32_t)align16((int64_t)L.prog.nops * sizeof(DnOp))
             : 0;
}

// the most dynamic shared memory a launch takes: the op array, the
// tables, two tiles of staged columns and the slot map; with the
// kernel's static partials (under 512 bytes) under the 48 KiB a launch
// may take without opting in
constexpr int64_t kSmemMost =
    kMaxSharedOps * sizeof(DnOp) + DN_TAB_BYTES +
    2 * kThreads * DN_STAGE_BYTES + 2 * DN_MAP_SLOTS * sizeof(int32_t);
static_assert(kSmemMost + 512 <= 48 * 1024,
              "K2's shared memory past 48 KiB");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The dense route's (and K1's first-occurrence) update of one key.
template <int kMode>
__device__ __forceinline__ void dn_add(const DnScanLaunch& L, uint32_t key,
                                       int32_t w, uint32_t row) {
  if (kMode == DN_MODE_DENSE && w != 0)
    atomicAdd((unsigned long long*)&L.acc_dense[key],
              (unsigned long long)(long long)w);
  const long long v = L.base + (long long)row;
  long long* f = (long long*)&L.acc_first[key];
  if (v < *f) atomicMin(f, v);
}

// One warp step of the dense route: lane `lane`'s record (alive, key,
// weight, row), combined with the warp's other records of its key.
__device__ __forceinline__ void dn_accumulate(const DnScanLaunch& L,
                                              bool alive, uint32_t key,
                                              int32_t w, uint32_t row,
                                              int lane) {
  const unsigned live = __ballot_sync(kFull, alive);
  if (live == 0) return;
  // dead lanes share a key no alive lane has (keys are below ns <= 2^24)
  const unsigned k = alive ? key : kFull;
  const unsigned peers = __match_any_sync(kFull, k);
  const bool lead = alive && __ffs(peers) - 1 == lane;
  const unsigned leads = __ballot_sync(kFull, lead);
  if (leads == live) {       // every alive key once in this warp
    if (alive) dn_add<DN_MODE_DENSE>(L, key, w, row);
    return;
  }
  const int groups = __popc(leads);
  const int most = (int)__reduce_max_sync(
      kFull, alive ? (unsigned)__popc(peers) : 0u);
  if (groups <= most) {
    // walk the groups: each a full-warp sum and min
    unsigned todo = leads;
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned lk = __shfl_sync(kFull, k, l);
      const bool in = k == lk;
      const int s = __reduce_add_sync(kFull, in ? w : 0);
      const unsigned m = __reduce_min_sync(kFull, in ? row : kFull);
      if (lane == l) dn_add<DN_MODE_DENSE>(L, key, s, m);
    }
    return;
  }
  // walk the members: every lane sums its own group, `most` steps
  int s = 0;
  unsigned m = kFull;
  unsigned rem = peers;
  for (int i = 0; i < most; i++) {
    const int src = rem ? __ffs(rem) - 1 : lane;
    const int ws = __shfl_sync(kFull, w, src);
    const unsigned rs = __shfl_sync(kFull, row, src);
    if (rem) {
      s += ws;
      m = rs < m ? rs : m;
      rem &= rem - 1;
    }
  }
  if (lead) dn_add<DN_MODE_DENSE>(L, key, s, m);
}

// Start the copies of the tile of records from `start` into `stage`:
// staged column i is warp i's job (modulo the warps), its lanes taking
// 16-byte chunks.
__device__ __forceinline__ void dn_stage_tile(const DnScanLaunch& L,
                                              unsigned char* stage,
                                              int64_t start) {
  const DnScanProgram& P = L.prog;
  const int64_t left = L.n - start;
  const int valid = left < kThreads ? (int)left : kThreads;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < P.nstage; i += kWarps) {
    const int32_t ref = P.stage_ref[i];
    const int es = dn_code_bytes((ref >> 24) & 0xff);
    dn_stage_copy(stage + kThreads * P.stage_pre[i],
                  (const char*)dn_slot_ptr(L, ref & 0xffffff) + start * es,
                  valid * es, lane, 32);
  }
}

// whether every slot of the program is staged: each per-record slot
// and each table (the loader's kStaged case)
__host__ __device__ inline bool all_staged(const DnScanLaunch& L) {
  return L.ntabs + L.prog.nstage == L.prog.nslots;
}

// One launch over tiles of kThreads records; kStaged: all_staged(L).
template <int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads, 4)
scan_body_kernel(const __grid_constant__ DnScanLaunch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_part[kWarps][DN_MAX_COUNTERS];
  __shared__ int32_t s_wpart[kWarps];
  __shared__ uint32_t s_mpart[kWarps];
  const DnScanProgram& P = L.prog;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // block 0's first thread, when the launch asks for the stage profile:
  // its clock at the start and at the end of each stage
  const bool prof = L.prof != nullptr && blockIdx.x == 0 && tid == 0;
  if (prof) L.prof[0] = clock64();
  const int32_t nops_b = ops_bytes(L);
  DnOp* s_ops = (DnOp*)smem;
  unsigned char* s_tabs = smem + nops_b;
  unsigned char* s_stage[2];
  s_stage[0] = s_tabs + L.tab_bytes;
  s_stage[1] = s_stage[0] + kThreads * P.stage_bpr;
  // the slot map, a row of nmap offsets a buffer: -1 (read in place)
  // until the staged columns and tables below take theirs (every slot
  // takes one where kStaged)
  const int nmap = P.nslots < DN_MAP_SLOTS ? P.nslots : DN_MAP_SLOTS;
  int32_t* map = (int32_t*)(s_stage[1] + kThreads * P.stage_bpr);
  if (!kStaged) {
    for (int i = tid; i < 2 * nmap; i += kThreads) map[i] = -1;
    __syncthreads();
  }
  for (int i = tid; i < P.nstage; i += kThreads) {
    const int32_t idx = P.stage_ref[i] & 0xffffff;
    if (idx < nmap)
      for (int b = 0; b < 2; b++)
        map[b * nmap + idx] =
            (int32_t)(s_stage[b] + kThreads * P.stage_pre[i] - smem);
  }
  // the op array and the tables, once a block, with the first tile:
  // job 0 the op array, job 1 + i table i, a warp's jobs modulo the
  // warps
  const DnOp* ops = nops_b ? s_ops : L.ops;
  for (int j = warp; j <= L.ntabs; j += kWarps) {
    if (j == 0) {
      if (nops_b)
        dn_stage_copy(s_ops, L.ops, P.nops * (int32_t)sizeof(DnOp), lane,
                      32);
      continue;
    }
    const int32_t ref = L.tab_ref[j - 1];
    const int32_t idx = ref & 0xffffff;
    unsigned char* dst = s_tabs + L.tab_off[j - 1];
    if (lane == 0 && idx < nmap)
      map[idx] = map[nmap + idx] = (int32_t)(dst - smem);
    dn_stage_copy(dst, dn_slot_ptr(L, idx),
                  L.tab_len[j - 1] * dn_code_bytes((ref >> 24) & 0xff),
                  lane, 32);
  }
  // tiles blockIdx.x, + gridDim.x, ...: a tile's first record
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t start = (int64_t)blockIdx.x * kThreads;
  int buf = 0;
  if (start < L.n) dn_stage_tile(L, s_stage[0], start);
  cp_async_commit();
  if (prof) L.prof[1] = clock64();   // the prologue: the copies issued

  const bool keyless = P.key_begin == P.key_end;
  uint32_t cnt[DN_MAX_COUNTERS];
#pragma unroll
  for (int c = 0; c < DN_MAX_COUNTERS; c++) cnt[c] = 0;
  int wsum = 0;            // keyless: the weights of alive rows
  unsigned minrow = kFull;  // keyless: the first alive row
  bool first_tile = true;

  for (; start < L.n; start += stride) {
    if (start + stride < L.n)
      dn_stage_tile(L, s_stage[buf ^ 1], start + stride);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    if (prof && first_tile) L.prof[2] = clock64();   // the copies landed

    const bool valid = tid < L.n - start;
    const int64_t row = L.row0 + start + tid;
    const DnLoader<kStaged> ld = {map + buf * nmap, nmap, smem, &L, start};
    const DnRecord o = dn_eval(L, ops, ld, valid ? tid : 0, valid, row);
    if (prof && first_tile) L.prof[3] = clock64();   // evaluated

#pragma unroll
    for (int c = 0; c < DN_MAX_COUNTERS; c++) cnt[c] += (o.cbits >> c) & 1u;
    const int64_t r = start + tid;
    if (kMode == DN_MODE_SPARSE) {
      if (valid) {
        L.out_key64[r] = o.alive ? o.key : INT64_MAX;
        L.out_w64[r] = o.w;
        L.out_first64[r] = o.alive ? L.base + row : INT64_MAX;
      }
    } else {
      if (kMode == DN_MODE_K1 && valid)
        L.out_key32[r] = o.alive ? (int32_t)o.key : (int32_t)P.ns;
      if (keyless) {
        if (o.alive) {
          wsum += o.w;
          if ((unsigned)row < minrow) minrow = (unsigned)row;
        }
      } else if (kMode == DN_MODE_DENSE) {
        dn_accumulate(L, o.alive, (uint32_t)o.key, o.w, (uint32_t)row,
                      lane);
      } else if (o.alive) {   // K1: the first occurrence alone
        dn_add<DN_MODE_K1>(L, (uint32_t)o.key, 0, (uint32_t)row);
      }
    }
    if (prof && first_tile) L.prof[4] = clock64();   // its output
    first_tile = false;
    __syncthreads();   // this buffer is the one the next tile refills
    buf ^= 1;
  }
  cp_async_wait_all();   // (a block without a tile: its first copies)

  // the counters: a warp's sums into its row of partials (lane c holds
  // counter c), then a thread a counter adds the block's into the result
  const int ncnt = P.ncounters;
  uint32_t mine = 0;
#pragma unroll
  for (int c = 0; c < DN_MAX_COUNTERS; c++) {
    if (c < ncnt) {
      const uint32_t s = __reduce_add_sync(kFull, cnt[c]);
      if (lane == c) mine = s;
    }
  }
  if (lane < ncnt) s_part[warp][lane] = mine;
  if (kMode != DN_MODE_SPARSE && keyless) {
    const int s = (int)__reduce_add_sync(kFull, (unsigned)wsum);
    const unsigned m = __reduce_min_sync(kFull, minrow);
    if (lane == 0) {
      s_wpart[warp] = s;
      s_mpart[warp] = m;
    }
  }
  __syncthreads();
  if (tid < ncnt) {
    unsigned long long s = 0;
    for (int w = 0; w < kWarps; w++) s += s_part[w][tid];
    if (s) atomicAdd((unsigned long long*)&L.acc_cvec[tid], s);
  }
  if (kMode != DN_MODE_SPARSE && keyless && tid == 32) {
    long long s = 0;
    unsigned m = kFull;
    for (int w = 0; w < kWarps; w++) {
      s += s_wpart[w];
      m = s_mpart[w] < m ? s_mpart[w] : m;
    }
    if (s && kMode == DN_MODE_DENSE)
      atomicAdd((unsigned long long*)&L.acc_dense[0],
                (unsigned long long)s);
    if (m != kFull) {
      const long long v = L.base + (long long)m;
      long long* f = (long long*)&L.acc_first[0];
      if (v < *f) atomicMin(f, v);
    }
  }
  if (prof) {
    if (first_tile) L.prof[2] = L.prof[3] = L.prof[4] = L.prof[1];
    L.prof[5] = clock64();   // the rest: later tiles, the counters
  }
}

template <int kMode>
cudaError_t launch(const DnScanLaunch& L, int device, cudaStream_t stream) {
  static int sms[kMaxDevices];
  if (sms[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int nmap = L.prog.nslots < DN_MAP_SLOTS ? L.prog.nslots
                                                : DN_MAP_SLOTS;
  const int64_t smem = ops_bytes(L) + L.tab_bytes +
                       2 * (int64_t)kThreads * L.prog.stage_bpr +
                       2 * (int64_t)nmap * sizeof(int32_t);
  const int64_t tiles = (L.n + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sms[device] * kBlocksPerSm;
  int64_t blocks = tiles < most ? tiles : most;
  if (blocks < 1) blocks = 1;
  if (all_staged(L))
    scan_body_kernel<kMode, true>
        <<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(L);
  else
    scan_body_kernel<kMode, false>
        <<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(L);
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
      L->prog.nslots < 0 || L->prog.nrows < 0 ||
      L->prog.nrows > L->prog.nslots || L->prog.nstage < 0 ||
      L->prog.nstage > DN_MAX_STAGE || L->prog.stage_bpr < 0 ||
      L->prog.stage_bpr > DN_STAGE_BYTES || L->ntabs < 0 ||
      L->ntabs > DN_MAX_TABS || L->tab_bytes < 0 ||
      L->tab_bytes > DN_TAB_BYTES || device < 0 || device >= kMaxDevices)
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
