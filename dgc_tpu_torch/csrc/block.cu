// The attempt block's kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (dgc_tpu_torch/kernels/block.py).
//
// Replace the parts of the JAX package's attempt-block program
// (dgc_tpu/engine/compact.py:1741 _block_kernel_body, jitted as
// _block_kernel_staged[_donated] at :1826-1853) that run between two
// chained attempts; the attempts themselves run K3-K8:
//   K9  block_record — the body's epilogue (compact.py:1799-1808): the color
//                      count `used` of the state, the attempt's row
//                      [k, steps, status, used], the best row on a success,
//                      and the stopping rule (k - 1 strict, used - 1 jump;
//                      stop on a non-success or below k_min).
//   K10 block_start  — the body's prologue (compact.py:1784-1786):
//                      _default_init (:983) and restore_from_ring (:1031,
//                      first = False) into both state buffers, a fresh live
//                      table and a reset control block.
// Their recording variants (kRecord, B11) carry the block's stacked
// trajectory buffers int32[A, cap, cols] (compact.py:1770-1772, 1806;
// layout.BK_TRAJ): the attempt's stage ladder records into one scratch
// buffer `traj` (K6, compact.cu); K9 closes the attempt's span, copying
// `traj` into its slot of the stack, and K10 starts the next attempt's
// buffer, filling `traj` with the -1 of unwritten rows. The stack comes
// home with the block's last colors row.
// The JAX program's donated twin has no counterpart: the carry (best row,
// ring) lives in tensors the engine passes from block to block, updated in
// place.
//
// The block record `blk` (BLK_* in kernels/block.py): int32[kBlkHead +
// A * kAttCols] — the attempts recorded, the next budget, the stop flag,
// K9's running max color (-1 between launches) and its block counter (0
// between launches), then one row per attempt. Both kernels return at once
// when the block is done or full, so the host launches them after every
// attempt without reading anything first.
//
// Bounds (1M vertices). K9 must read the V+2 words of the current state
// once, and on a success write them into the best row: 4 MB, or 8 MB, about
// 1.2 or 2.4 us at 3.35 TB/s. K10 must read a ring row (or the V degrees on
// a miss) and write two state rows: 12 MB, about 3.6 us. Both are one
// grid-stride pass, one thread per word; K9 reduces the max in each block
// (warp reduce, then shared memory) and the last block to finish (a ticket
// in blk) folds the result, as K6 does.

#include <cuda_runtime.h>

#include "rule.cuh"

namespace {

using namespace dgc;  // the control block's first slots and statuses

// the compact engine's control-block slots (CTRL_* in kernels/compact.py)
constexpr int kRecCnt = 8;
constexpr int kDone = 10;
constexpr int kRecSlots = 4;
constexpr int kMetaCols = 5;

// the block record (BLK_* and BKC_* in kernels/block.py)
constexpr int kBlkNAtt = 0;
constexpr int kBlkK = 1;
constexpr int kBlkDone = 2;
constexpr int kBlkUsed = 3;
constexpr int kBlkTicket = 4;
constexpr int kBlkHead = 5;
constexpr int kBkcK = 0;
constexpr int kBkcSteps = 1;
constexpr int kBkcStatus = 2;
constexpr int kBkcUsed = 3;
constexpr int kAttCols = 4;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 528;  // 4 per SM; the grid strides the rest

__device__ __forceinline__ bool block_open(const int* blk, int attempts) {
  return blk[kBlkDone] == 0 && blk[kBlkNAtt] < attempts;
}

// ---- K9: record the attempt, apply the stopping rule ----------------------

template <bool kRecord>
__global__ void __launch_bounds__(kThreads)
block_record_kernel(const int* ctrl, const int* state, size_t stride, int v,
                    int* blk, int attempts, int* __restrict__ best_pe,
                    int k_min, int strict, const int* __restrict__ traj,
                    int* __restrict__ tstack, int traj_words) {
  // K9 writes these slots only in the last block, after every block has
  // taken its ticket: the exit is uniform
  if (!block_open(blk, attempts)) return;
  if constexpr (kRecord) {
    // the attempt's span into its slot of the stack (blk[kBlkNAtt] moves
    // only in the last block, after every block's ticket)
    int* __restrict__ out =
        tstack + static_cast<size_t>(blk[kBlkNAtt]) * traj_words;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < traj_words;
         i += gridDim.x * kThreads) {
      out[i] = traj[i];
    }
  }
  int status = ctrl[kStatus];
  if (status == kRunning) {  // nothing left to do, or out of steps
    status = ctrl[kPrevActive] == 0 ? kSuccess : kStalled;
  }
  const bool success = status == kSuccess;
  const int* __restrict__ pe = state + ctrl[kCur] * stride;
  const int words = v + 2;

  int m = -1;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < words;
       i += gridDim.x * kThreads) {
    const int w = pe[i];
    if (i < v && w >= 0) m = max(m, w >> 1);
    if (success) best_pe[i] = w;
  }
  const int wmax = __reduce_max_sync(0xFFFFFFFFu, m);
  __shared__ int warp_max[kThreads / 32];
  __shared__ bool s_last;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = wmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bmax = warp_max[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) bmax = max(bmax, warp_max[i]);
    if (bmax >= 0) atomicMax(blk + kBlkUsed, bmax);
    __threadfence();
    s_last = atomicAdd(blk + kBlkTicket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;

  __threadfence();
  const int used = atomicAdd(blk + kBlkUsed, 0) + 1;
  const int ai = blk[kBlkNAtt];
  const int k = blk[kBlkK];
  int* row = blk + kBlkHead + ai * kAttCols;
  row[kBkcK] = k;
  row[kBkcSteps] = ctrl[kStep];
  row[kBkcStatus] = status;
  row[kBkcUsed] = used;
  const long long k_dec = strict ? k - 1LL : used - 1LL;
  blk[kBlkK] = success ? static_cast<int>(k_dec) : k;
  blk[kBlkDone] = (!success || k_dec < k_min) ? 1 : 0;
  blk[kBlkNAtt] = ai + 1;
  blk[kBlkUsed] = -1;
  blk[kBlkTicket] = 0;
}

// ---- K10: start the next attempt --------------------------------------------

template <bool kRecord>
__global__ void __launch_bounds__(kThreads)
block_start_kernel(int* ctrl, const int* blk, int attempts, int* state,
                   size_t stride, int v, int* __restrict__ live, int nb,
                   const int* __restrict__ ring_pe,
                   const int* __restrict__ ring_ba,
                   const int* __restrict__ ring_meta,
                   const int* __restrict__ degrees,
                   const int* __restrict__ init_ba, int* __restrict__ traj,
                   int traj_words) {
  // K10 writes neither blk nor the ring count: every block reads the same
  if (!block_open(blk, attempts)) return;
  if constexpr (kRecord) {  // the next attempt's buffer: every row unwritten
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < traj_words;
         i += gridDim.x * kThreads) {
      traj[i] = -1;
    }
  }
  const int k = blk[kBlkK];
  const int cnt = ctrl[kRecCnt];
  int hit = -1;  // the last slot whose (best, mc] bracket holds k wins
#pragma unroll
  for (int j = 0; j < kRecSlots; ++j) {
    const int* meta = ring_meta + j * kMetaCols;
    if (j < cnt && meta[1] < k && k <= meta[2]) hit = j;
  }
  const int words = v + 2;
  const int* __restrict__ src =
      hit >= 0 ? ring_pe + static_cast<size_t>(hit) * words : nullptr;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < words;
       i += gridDim.x * kThreads) {
    int w;
    if (src != nullptr) {
      w = src[i];
    } else if (i < v) {
      w = degrees[i] == 0 ? 0 : 1;  // isolated: confirmed at color 0
    } else {
      w = i == v ? -1 : 0;  // the pad sentinel, the dummy row
    }
    state[i] = w;
    state[stride + i] = w;
  }
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < kLiveRows * nb; i += kThreads) {
    const int col = i % nb;
    live[i] = i / nb != kLiveBa ? 0
              : hit >= 0 ? ring_ba[hit * nb + col] : init_ba[col];
  }
  if (threadIdx.x == 0) {
    const int* meta = ring_meta + (hit >= 0 ? hit : 0) * kMetaCols;
    ctrl[kStatus] = kRunning;
    ctrl[kStep] = hit >= 0 ? meta[0] : 1;
    ctrl[kPrevActive] = hit >= 0 ? meta[4] : v + 1;
    ctrl[kStall] = hit >= 0 ? meta[3] : 0;
    ctrl[kCur] = 0;
    ctrl[kFail] = 0;
    ctrl[kActive] = 0;
    ctrl[kMc] = -1;
    ctrl[kDone] = 0;  // K6's block counter; the ring count and best stay
  }
}

unsigned grid_for(long long words) {
  long long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// ctrl: int32[11]; state: int32[2, stride], stride = V+2; blk:
// int32[5 + 4 * attempts]; best_pe: int32[stride]. The recording variant
// (kRecord) when traj is not null: traj int32[traj_words] (one attempt's
// buffer), tstack int32[attempts, traj_words].
int dgc_block_record(const void* ctrl, const void* state, int stride,
                     void* blk, int attempts, void* best_pe, int k_min,
                     int strict, const void* traj, void* tstack,
                     int traj_words, void* stream) {
  if (stride < 2 || attempts < 1 ||
      (traj != nullptr && (tstack == nullptr || traj_words < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const int*>(ctrl);
  const auto* s = static_cast<const int*>(state);
  const auto words = static_cast<size_t>(stride);
  auto* b = static_cast<int*>(blk);
  auto* best = static_cast<int*>(best_pe);
  auto st = static_cast<cudaStream_t>(stream);
  if (traj == nullptr) {
    block_record_kernel<false><<<grid_for(stride), kThreads, 0, st>>>(
        c, s, words, stride - 2, b, attempts, best, k_min, strict, nullptr,
        nullptr, 0);
  } else {
    const long long work = stride > traj_words ? stride : traj_words;
    block_record_kernel<true><<<grid_for(work), kThreads, 0, st>>>(
        c, s, words, stride - 2, b, attempts, best, k_min, strict,
        static_cast<const int*>(traj), static_cast<int*>(tstack),
        traj_words);
  }
  return static_cast<int>(cudaGetLastError());
}

// live: int32[5, nb]; ring_pe: int32[4, stride]; ring_ba: int32[4, nb];
// ring_meta: int32[4, 5]; degrees: int32[V]; init_ba: int32[nb]. The
// recording variant (kRecord) when traj is not null: traj
// int32[traj_words], the next attempt's buffer.
int dgc_block_start(void* ctrl, const void* blk, int attempts, void* state,
                    int stride, void* live, int nb, const void* ring_pe,
                    const void* ring_ba, const void* ring_meta,
                    const void* degrees, const void* init_ba, void* traj,
                    int traj_words, void* stream) {
  if (stride < 2 || attempts < 1 || nb < 1 ||
      (traj != nullptr && traj_words < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int*>(ctrl);
  const auto* b = static_cast<const int*>(blk);
  auto* s = static_cast<int*>(state);
  const auto words = static_cast<size_t>(stride);
  auto* lv = static_cast<int*>(live);
  const auto* rp = static_cast<const int*>(ring_pe);
  const auto* rb = static_cast<const int*>(ring_ba);
  const auto* rm = static_cast<const int*>(ring_meta);
  const auto* deg = static_cast<const int*>(degrees);
  const auto* iba = static_cast<const int*>(init_ba);
  auto st = static_cast<cudaStream_t>(stream);
  if (traj == nullptr) {
    block_start_kernel<false><<<grid_for(stride), kThreads, 0, st>>>(
        c, b, attempts, s, words, stride - 2, lv, nb, rp, rb, rm, deg, iba,
        nullptr, 0);
  } else {
    const long long work = stride > traj_words ? stride : traj_words;
    block_start_kernel<true><<<grid_for(work), kThreads, 0, st>>>(
        c, b, attempts, s, words, stride - 2, lv, nb, rp, rb, rm, deg, iba,
        static_cast<int*>(traj), traj_words);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
