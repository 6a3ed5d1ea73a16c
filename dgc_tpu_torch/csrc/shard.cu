// The vertex-sharded engines' kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (dgc_tpu_torch/kernels/shard.py).
//
// Replaces the per-shard parts of the jitted shard_map programs of the JAX
// package's all-gather engines:
//   K20 shard_superstep — B13a, dgc_tpu/engine/sharded.py:64
//                         _shard_superstep (the rule against the
//                         all-gathered state), with B13b's loop-invariant
//                         priority (sharded.py:107-111 pre_beats) read from
//                         the degrees instead of a precomputed mask, where
//                         the clash test needs it.
//   K21 shard_finish    — B13b's loop tail and B13d's: the epilogue of
//                         dgc_tpu/engine/fused.py:127 shard_superstep_epilogue
//                         (the prefix-resume ring push of compact.py:1004
//                         _make_recstep, stall and status of :1048
//                         _superstep_epilogue, the capped-window and
//                         max-steps rules, the fail revert) and the
//                         trajectory row (dgc_tpu/obs/kernel.py:95, traj.cuh).
//   K22 shard_pair      — B13f, fused.py:205-246 device_sweep_pair_resumable's
//                         phase step: `used` from the max-reduced max color,
//                         k2 = used - 1 and run2, and the confirm's start
//                         restored from the ring (compact.py:1031
//                         restore_from_ring) or from scratch.
// The sharded-bucketed engine's superstep (B13c) runs the compact engine's
// K5 (segmented_superstep, compact.cu) over its unconditioned slices and the
// hub kernels K7/K8 (hub.cu) over the rest, on the same state layout; K21
// and K22 close its supersteps and its pair too.
//
// State, on each rank (shard s of n, V_l rows, global ids s*V_l + r):
// `state` int32[2, V+2], V the padded vertex count. Buffer 0 is the
// all-gathered state of the superstep (written by the all-gather of
// `packed`, the shard's int32[V_l] carry, before the kernels run), with the
// pad sentinel -1 at slot V and the dummy row 0 at V+1; buffer 1 receives
// the shard's new words at their global rows. The kernels read buffer 0
// only, so `cur` stays 0. The collectives between the kernels and K21 are
// the host's (torch.distributed): SUM over the control block's [fail,
// active] and MAX over [mc, gc, maxc], so every rank decides the ring push,
// the status and the pair from the same reduced values.
//
// The control block int32[19] (SC_* in kernels/shard.py): the first eight
// slots of rule.cuh; the step's gather calls (gc) and the max color at the
// attempt's end (maxc); the finish kernels' block counter; the ring's count
// and best candidate; the live budget and the pair's phase; phase 0's
// steps, status and `used`; the step the confirm resumed from (-1: none).
// Its first eleven slots are the compact engine's control block for K5,
// K7 and K8, which read none of slots 8-10.
//
// Bounds (1M vertices, average degree 16, width 32, one shard; PERF.md has
// the measured times). K20 must read each unconfirmed row's real neighbor
// entries (the table's sentinel padding past a row's length is not work:
// ~16M entries of the V*W table, 64 MB), the state words through them,
// each row's length, word and degree, and write its word: ~76 MB, ~23 us
// at 3.35 TB/s (PERF.md counts the launch's own entries). K21 reads the
// back buffer and the carry and writes the carry (12 MB, ~3.6 us), plus
// V_l words into the ring on a push. K22 copies the carry into the result
// slot and writes the start (12 MB). K21 and K22 are one thread a word,
// written to be right and simple.
//
// K20 gives a row K1's team walk (rule.cuh team_lanes, walk_row,
// group_passes), since a thread a row walking all W entries, the padding
// included, one dependent gather after another, is held by latency, not
// bandwidth. A group of team_lanes(W) lanes (at most a warp) reads only the
// row's real entries, up to the length the engine's plan took once from
// the table, in 16-byte quads with eight gathers in flight a lane; a
// confirmed row reads no entry and copies its word into buffer 1 (K21
// reads buffer 1 for every row). The priority is read from the degrees
// only for a fresh neighbor of the row's own color, the one place the
// clash test needs it (BeatsByDegree). One atomic a block for each of
// fail, active and mc.

#include <cuda_runtime.h>

#include <cstdint>

#include "rule.cuh"
#include "traj.cuh"

namespace {

using namespace dgc;  // the control block's first slots and statuses

// the slots the shard control block appends (SC_* in kernels/shard.py)
constexpr int kGc = 8;
constexpr int kMaxc = 9;
constexpr int kDone = 10;
constexpr int kRecCnt = 11;
constexpr int kRecBest = 12;
constexpr int kK = 13;
constexpr int kPhase = 14;
constexpr int kSteps1 = 15;
constexpr int kStatus1 = 16;
constexpr int kUsed = 17;
constexpr int kResumed = 18;

constexpr int kRecSlots = 4;
constexpr int kMetaCols = 5;
constexpr int kThreads = 256;

// The status dgc::finish_step will fold this superstep into, read-only, so
// every block of K21 knows whether the attempt ends here.
__device__ __forceinline__ int next_status(const int* ctrl, int max_steps,
                                           int stall_window) {
  const int active = ctrl[kActive];
  const int stall = active < ctrl[kPrevActive] ? 0 : ctrl[kStall] + 1;
  if (ctrl[kFail] > 0) return kFailure;
  if (active == 0) return kSuccess;
  if (stall >= stall_window || ctrl[kStep] + 1 >= max_steps) return kStalled;
  return kRunning;
}

// The block's max of `value` on thread 0 (every thread must call it).
__device__ __forceinline__ int block_max(int value) {
  __shared__ int warp_max[kThreads / 32];
  const int wmax = __reduce_max_sync(0xFFFFFFFFu, value);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = wmax;
  __syncthreads();
  int bmax = warp_max[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) bmax = max(bmax, warp_max[i]);
  __syncthreads();
  return bmax;
}

// Is this the last block to get here? Every block's writes before the call
// are visible to the last one; it resets the counter.
__device__ __forceinline__ bool last_block(int* ctrl) {
  __threadfence();
  __syncthreads();
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + kDone, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  return s_last;
}

// The gather calls of the next superstep: gc_const and one for each of the
// nh conditioned buckets with live rows; -1 (not recorded) when gc_const is.
__device__ __forceinline__ int next_gcalls(const int* live, int nh, int nb,
                                           int gc_const) {
  if (gc_const < 0) return -1;
  int gc = gc_const;
  for (int i = 0; i < nh; ++i) {
    if (live[kLiveBa * nb + i] > 0) ++gc;
  }
  return gc;
}

// ---- K20: one superstep on a shard's rows ---------------------------------

constexpr int kWarps = kThreads / 32;

// B13b's priority (dgc_tpu/ops/speculative.py beats_rule): the neighbor of
// entry `e` (a plain id) beats the row when its degree is larger, or equal
// with a smaller id. `deg` holds -1 at the pad sentinel's slot.
struct BeatsByDegree {
  const int* deg;
  int my_deg;
  int my_id;
  __device__ __forceinline__ bool operator()(int e) const {
    const int nd = __ldg(deg + e);
    return nd > my_deg || (nd == my_deg && e < my_id);
  }
};

// A group of team_lanes(width) lanes a row, 32 / lanes rows a warp side by
// side; each group's shared plane words are `lanes` of fa and `lanes` of
// fo. Rows past `rows` walk nothing but keep the warp's loops uniform.
__global__ void __launch_bounds__(kThreads)
shard_superstep_kernel(int* ctrl, int* state, size_t stride,
                       const int* __restrict__ nbrs,
                       const int* __restrict__ lens, int rows, int width,
                       const int* __restrict__ deg, int row_off, int planes,
                       int k, int fail_valid) {
  // the status is the same for every thread of the grid: a uniform exit
  if (ctrl[kStatus] != kRunning) return;
  __shared__ uint32_t s_rows[kWarps * kTeamWords];
  const int* __restrict__ src = state;  // the gathered state
  int* __restrict__ dst = state + stride;
  const int pad = static_cast<int>(stride) - 2;  // the pad sentinel V

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = team_lanes(width);
  const int sub = lane / lanes;       // the warp's row of this lane
  const int gl = lane & (lanes - 1);  // the lane in its row's group
  const int r = (blockIdx.x * kWarps + warp) * (32 / lanes) + sub;
  const bool valid = r < rows;
  const int v = row_off + r;
  const int me = valid ? src[v] : 0;
  const bool walk = valid && !is_confirmed(me);  // uniform over the group
  const int* __restrict__ row =
      nbrs + static_cast<size_t>(valid ? r : 0) * width;
  uint32_t* s_fa = s_rows + warp * kTeamWords + sub * 2 * lanes;
  const BeatsByDegree beats{deg, walk ? __ldg(deg + v) : 0, v};
  bool clash = false;
  bool found = false;     // a color under k is free of every neighbor
  int cand = k;           // first-fit over all colored neighbors
  bool old_free = false;  // a color under k is free of confirmed ones
  const int done = group_passes(
      src, row, walk ? __ldg(lens + r) : 0, gl, lanes, pad, walk, planes,
      me >> 1, s_fa, s_fa + lanes, clash,
      [&](int pg, uint32_t fa, uint32_t fo) {
        fold_plane(fa, fo, pg, k, found, cand, old_free);
      },
      beats);
  bool fail = false;
  bool active = false;
  int mc = -1;
  if (valid && gl == 0) {
    int next = me;  // a confirmed row transitions to itself
    if (walk) {
      if (done < planes) fold_plane(0u, 0u, done, k, found, cand, old_free);
      const RowResult res = finish_rule(me, clash, found, cand, old_free);
      next = res.next;
      fail = res.fail && fail_valid != 0;
      active = res.active;
      mc = res.mc;
    }
    dst[v] = next;
  }
  const int nfail = __syncthreads_count(fail);
  const int nactive = __syncthreads_count(active);
  const int bmax = block_max(mc);
  if (threadIdx.x == 0) {
    if (nfail) atomicAdd(ctrl + kFail, nfail);
    if (nactive) atomicAdd(ctrl + kActive, nactive);
    if (bmax >= 0) atomicMax(ctrl + kMc, bmax);
  }
}

// ---- K21: the superstep's tail, after the collectives ---------------------
//
// Every block takes its share of the shard's words: the pre-step word into
// the ring when the step pushes, the new word (buffer 1) into the carry
// unless the step failed, and, when the attempt ends here, the max color of
// the words it keeps. The last block writes the trajectory row (kRecord),
// the ring's meta and live counts, commits the staged live counts and tiers
// of the nh conditioned buckets unless the step failed, computes the next
// step's gather calls and folds the counters (dgc::finish_step, `cur` kept
// at 0). Every block reads the control block before it counts itself done.

template <bool kRecord>
__global__ void __launch_bounds__(kThreads)
shard_finish_kernel(int* ctrl, int* __restrict__ packed,
                    const int* __restrict__ back, int vl,
                    int* __restrict__ ring_pe, int* __restrict__ ring_ba,
                    int* __restrict__ ring_meta, int record,
                    int* __restrict__ live, int nh, int nb, int gc_const,
                    int max_steps, int stall_window, int* __restrict__ traj,
                    int cap, int cols) {
  if (ctrl[kStatus] != kRunning) return;
  const int fail = ctrl[kFail];
  const int mc = ctrl[kMc];
  const int best = ctrl[kRecBest];
  const int cnt = ctrl[kRecCnt];
  const bool push = record != 0 && fail == 0 && mc > best;
  const int slot = cnt % kRecSlots;
  const bool ends = next_status(ctrl, max_steps, stall_window) != kRunning;
  int* __restrict__ out =
      push ? ring_pe + static_cast<size_t>(slot) * vl : nullptr;
  int cmax = -1;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < vl;
       i += gridDim.x * kThreads) {
    const int pre = packed[i];
    if (push) out[i] = pre;
    const int word = fail == 0 ? back[i] : pre;
    if (fail == 0) packed[i] = word;
    if (ends && word >= 0) cmax = max(cmax, word >> 1);
  }
  if (ends) {  // uniform over the grid
    const int bmax = block_max(cmax);
    if (threadIdx.x == 0 && bmax >= 0) atomicMax(ctrl + kMaxc, bmax);
  }
  if (!last_block(ctrl) || threadIdx.x != 0) return;

  const int step = ctrl[kStep];
  if constexpr (kRecord) {
    if (step >= 0 && step < cap) {
      int* row = traj + static_cast<size_t>(step) * cols;
      row[kColActive] = ctrl[kActive];
      row[kColFail] = fail > 0 ? 1 : 0;
      row[kColMc] = mc;
      row[kColGatherCalls] = ctrl[kGc];
      row[kColMaxUnconf] = -1;
      row[kColTsUs] = -1;
    }
  }
  if (push) {
    int* meta = ring_meta + slot * kMetaCols;
    meta[0] = step;
    meta[1] = best;
    meta[2] = mc;
    meta[3] = ctrl[kStall];
    meta[4] = ctrl[kPrevActive];
    for (int i = 0; i < nb; ++i) {
      ring_ba[slot * nb + i] = live != nullptr ? live[kLiveBa * nb + i] : 0;
    }
    ctrl[kRecCnt] = cnt + 1;
    ctrl[kRecBest] = mc;
  }
  int gc = gc_const < 0 ? -1 : gc_const;
  if (live != nullptr) {
    if (fail == 0) {
      for (int i = 0; i < nh; ++i) {
        live[kLiveBa * nb + i] = live[kLiveBaNext * nb + i];
        live[kLiveTier * nb + i] = live[kLiveTierNext * nb + i];
      }
    }
    gc = next_gcalls(live, nh, nb, gc_const);
  }
  finish_step(ctrl, max_steps, stall_window);
  ctrl[kCur] = 0;
  ctrl[kGc] = gc;
  ctrl[kDone] = 0;
}

// ---- K22: the fused pair's phase step --------------------------------------
//
// After phase 0 (the attempt at k0) has ended and [mc, gc, maxc] has been
// max-reduced: used = maxc + 1, k2 = used - 1, and the confirm runs iff the
// attempt succeeded and k2 >= 1. Every block copies its share of the carry
// into the result slot `p1` and, when the confirm runs, writes its start:
// the ring entry whose (best, mc] bracket holds k2 (the latest such), or
// the scratch start (a row of degree 0 confirms 0, any other takes
// `init_word`). The last block writes phase 0's result slots and the
// confirm's loop carry (from the entry's meta, or init_step/init_prev),
// its live counts (the entry's, or init_ba) and its budget; or phase 2
// (done) when the confirm does not run. A launch in any other phase does
// nothing.

__global__ void __launch_bounds__(kThreads)
shard_pair_kernel(int* ctrl, int* __restrict__ packed, int* __restrict__ p1,
                  const int* __restrict__ deg, int vl, int init_word,
                  const int* __restrict__ ring_pe,
                  const int* __restrict__ ring_ba,
                  const int* __restrict__ ring_meta, int* __restrict__ live,
                  int nh, int nb, const int* __restrict__ init_ba,
                  int init_step, int init_prev, int gc_const) {
  if (ctrl[kPhase] != 0 || ctrl[kStatus] == kRunning) return;
  const int status1 = ctrl[kStatus];
  const int used = ctrl[kMaxc] + 1;
  const int k2 = used - 1;
  const bool run2 = status1 == kSuccess && k2 >= 1;
  const int cnt = ctrl[kRecCnt];
  int hit = -1;
  for (int j = 0; j < kRecSlots; ++j) {
    const int* m = ring_meta + j * kMetaCols;
    if (j < cnt && m[1] < k2 && k2 <= m[2]) hit = j;
  }
  const int* __restrict__ src =
      hit >= 0 ? ring_pe + static_cast<size_t>(hit) * vl : nullptr;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < vl;
       i += gridDim.x * kThreads) {
    p1[i] = packed[i];
    if (run2) {
      packed[i] = src != nullptr ? src[i] : (deg[i] == 0 ? 0 : init_word);
    }
  }
  if (!last_block(ctrl) || threadIdx.x != 0) return;

  ctrl[kSteps1] = ctrl[kStep];
  ctrl[kStatus1] = status1;
  ctrl[kUsed] = used;
  ctrl[kDone] = 0;
  if (!run2) {
    ctrl[kPhase] = 2;
    return;
  }
  const int* meta = hit >= 0 ? ring_meta + hit * kMetaCols : nullptr;
  ctrl[kStatus] = kRunning;
  ctrl[kStep] = meta != nullptr ? meta[0] : init_step;
  ctrl[kPrevActive] = meta != nullptr ? meta[4] : init_prev;
  ctrl[kStall] = meta != nullptr ? meta[3] : 0;
  ctrl[kCur] = 0;
  ctrl[kFail] = 0;
  ctrl[kActive] = 0;
  ctrl[kMc] = -1;
  ctrl[kMaxc] = -1;
  ctrl[kK] = k2;
  ctrl[kPhase] = 1;
  ctrl[kResumed] = meta != nullptr ? meta[0] : -1;
  int gc = gc_const < 0 ? -1 : gc_const;
  if (live != nullptr) {
    for (int i = 0; i < nb; ++i) {
      live[kLiveBa * nb + i] = hit >= 0 ? ring_ba[hit * nb + i] : init_ba[i];
      live[kLiveBaNext * nb + i] = 0;
      live[kLiveTier * nb + i] = 0;  // the prune state is fresh in every run
      live[kLiveTierNext * nb + i] = 0;
      live[kLiveBranch * nb + i] = 0;
    }
    gc = next_gcalls(live, nh, nb, gc_const);
  }
  ctrl[kGc] = gc;
}

unsigned word_blocks(int words) {
  const int per_block = kThreads * 4;
  unsigned blocks = static_cast<unsigned>((words + per_block - 1) / per_block);
  if (blocks < 1) blocks = 1;
  return blocks > 528 ? 528 : blocks;  // 4 per SM; the loop strides the rest
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// ctrl: int32[19]; state: int32[2, stride], stride = V+2; nbrs: int32[rows,
// width] of global ids (sentinel V); lens: int32[rows], each row's real
// length (every entry past it the sentinel); deg: int32[V+1], -1 at V; the
// rows are the global rows [row_off, row_off + rows).
int dgc_shard_superstep(void* ctrl, void* state, int stride, const void* nbrs,
                        const void* lens, int rows, int width,
                        const void* deg, int row_off, int planes, int k,
                        int fail_valid, void* stream) {
  if (rows <= 0 || width <= 0 || planes <= 0 || row_off < 0 ||
      lens == nullptr || row_off + rows > stride - 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_warp = 32 / team_lanes(width);
  const long long warps = (rows + per_warp - 1) / per_warp;
  const auto blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  shard_superstep_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<int*>(state),
      static_cast<size_t>(stride), static_cast<const int*>(nbrs),
      static_cast<const int*>(lens), rows, width,
      static_cast<const int*>(deg), row_off, planes, k, fail_valid);
  return static_cast<int>(cudaGetLastError());
}

// packed: int32[vl], the carry; back: int32[vl], the shard's rows of
// buffer 1; ring_pe int32[4, vl], ring_ba int32[4, nb], ring_meta
// int32[4, 5], or null when record is 0; live: int32[5, nb] or null (no
// conditioned buckets; nh = 0); traj: int32[cap, cols], cols >= 6, for the
// recording variant (kRecord), or null.
int dgc_shard_finish(void* ctrl, void* packed, const void* back, int vl,
                     void* ring_pe, void* ring_ba, void* ring_meta, int record,
                     void* live, int nh, int nb, int gc_const, int max_steps,
                     int stall_window, void* traj, int cap, int cols,
                     void* stream) {
  if (vl <= 0 || nb < 1 || nh < 0 || nh > nb ||
      (record != 0 && (ring_pe == nullptr || ring_ba == nullptr ||
                       ring_meta == nullptr)) ||
      (live == nullptr && nh != 0) ||
      (traj != nullptr && (cap < 1 || cols < kTrajCols))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int*>(ctrl);
  auto* pk = static_cast<int*>(packed);
  const auto* bk = static_cast<const int*>(back);
  auto* rp = static_cast<int*>(ring_pe);
  auto* rb = static_cast<int*>(ring_ba);
  auto* rm = static_cast<int*>(ring_meta);
  auto* lv = static_cast<int*>(live);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = word_blocks(vl);
  if (traj == nullptr) {
    shard_finish_kernel<false><<<blocks, kThreads, 0, st>>>(
        c, pk, bk, vl, rp, rb, rm, record, lv, nh, nb, gc_const, max_steps,
        stall_window, nullptr, 0, 0);
  } else {
    shard_finish_kernel<true><<<blocks, kThreads, 0, st>>>(
        c, pk, bk, vl, rp, rb, rm, record, lv, nh, nb, gc_const, max_steps,
        stall_window, static_cast<int*>(traj), cap, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed, p1, deg: int32[vl] (deg: the shard's degrees); the ring as for
// dgc_shard_finish (not null); live int32[5, nb] and init_ba int32[nb], or
// both null (nh = 0).
int dgc_shard_pair(void* ctrl, void* packed, void* p1, const void* deg,
                   int vl, int init_word, const void* ring_pe,
                   const void* ring_ba, const void* ring_meta, void* live,
                   int nh, int nb, const void* init_ba, int init_step,
                   int init_prev, int gc_const, void* stream) {
  if (vl <= 0 || nb < 1 || nh < 0 || nh > nb || ring_pe == nullptr ||
      ring_ba == nullptr || ring_meta == nullptr ||
      (live == nullptr) != (init_ba == nullptr) ||
      (live == nullptr && nh != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shard_pair_kernel<<<word_blocks(vl), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<int*>(packed),
      static_cast<int*>(p1), static_cast<const int*>(deg), vl, init_word,
      static_cast<const int*>(ring_pe), static_cast<const int*>(ring_ba),
      static_cast<const int*>(ring_meta), static_cast<int*>(live), nh, nb,
      static_cast<const int*>(init_ba), init_step, init_prev, gc_const);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
