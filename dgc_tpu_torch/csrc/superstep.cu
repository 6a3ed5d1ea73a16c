// The speculative BSP superstep for Hopper (sm_90a), with a plain C
// interface for ctypes (dgc_tpu_torch/kernels/superstep.py).
//
// Replaces the jitted XLA programs of the JAX package:
//   K1 superstep_rows   — B1, the superstep rule fused with its gather:
//                         dgc_tpu/ops/speculative.py:40 neighbor_stats,
//                         :67 apply_update_mc, :124 speculative_update and
//                         dgc_tpu/ops/bitmask.py:28 plane_masks,
//                         :37 forbidden_planes, :75 first_fit, as gathered
//                         by dgc_tpu/engine/superstep.py:69 superstep and
//                         dgc_tpu/engine/bucketed.py:235 bucketed_superstep.
//   K2 superstep_finish — the loop control of B2/B3: the while-loop bodies
//                         of dgc_tpu/engine/superstep.py:82 _attempt_kernel
//                         and dgc_tpu/engine/bucketed.py:273
//                         _attempt_kernel_bucketed (status_step, :193).
//                         Its recording variant (kRecord, B11) also writes
//                         the superstep's trajectory row, as those loops'
//                         trajstep calls do (superstep.py:118,
//                         bucketed.py:310): the active count, the fail
//                         flag, the gather calls the host passes (the
//                         bucket count, -1 for ELL), -1 elsewhere.
//
// State. Two int32[V+1] buffers of packed words (color*2 + fresh, -1 for
// uncolored); slot V of both holds -1 for good, so the pad sentinel needs
// no per-step concatenation. A control block int32[8] (the slots in
// rule.cuh) holds the attempt's loop carry and this superstep's counters. K1
// reads buffer `cur` and writes the other one, for every bucket of the
// superstep (BSP: every row reads the pre-step state); K2 flips `cur`
// only when the step did not fail, so a failed step leaves the pre-step
// state current (superstep.py:130, bucketed.py:313). K1 returns at once
// when the status is no longer RUNNING, so the host enqueues a whole chunk
// of supersteps and syncs once per chunk.
//
// Bound. A superstep must read each vertex's real neighbor entries once
// (sum of degrees * 4 bytes; the sentinel padding past a row's degree is
// not needed work), its degree and its state, and write the new state: at
// 1M vertices and average degree 16 that is 16M entries (64 MB) plus
// 12 MB, ~76 MB, ~23 us at the H100's 3.35 TB/s. The padded bucket tables
// hold ~17.5M entries, the plain ELL table V*Delta. The 4 MB state fits the
// 50 MB L2, so the random neighbor gathers should hit L2.
//
// The design (K5's and K8's team walk, rule.cuh walk_row/add_word/
// fold_plane, team_lanes, group_passes). A table's rows get a team sized by
// its width: a group of `lanes` lanes (the least power of two, at most 32,
// whose lanes hold the row at kLaneEntries entries each: one lane reads a
// row of up to 32 in 16-byte quads, a warp one up to 1,024 and wider) or,
// from kBlockWidth entries, a block of kBlockThreads. A team walks only
// its row's real
// entries, up to the length the plan took once from the table (`lens`:
// one past the last entry that is not the pad sentinel V), with eight
// gathers in flight a thread, and skips a confirmed row's entries: such a
// row transitions to itself and counts nothing (finish_rule), so its word
// is copied over. A pass holds two planes in registers (OR-reduced over
// the team) and the rest in shared words (atomicOr): 2 + lanes planes for
// a group, 32 for a block. A pass also takes the highest plane any color
// of the team's rows falls in (over the warp or the block, so the loop
// stays uniform); the planes above it are zero for every one of those
// rows, so no further pass reads the row: the first of them folds as an
// empty plane (every color of it free) and decides the rest. One atomic a
// block for each of fail, active and mc.

#include <cuda_runtime.h>

#include <cstdint>

#include "rule.cuh"
#include "traj.cuh"

namespace {

using namespace dgc;  // the control block's slots and statuses

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// from this width a row takes a block of kBlockThreads (K1_BLOCK_WIDTH in
// kernels/superstep.py)
constexpr int kBlockWidth = 4096;
constexpr int kBlockThreads = 512;
// a block's pass: kRegPlanes in registers, the rest in shared words
constexpr int kPassPlanes = 32;
constexpr int kPassShared = kPassPlanes - kRegPlanes;

// A group of `lanes` lanes a row: a warp reads 32 / lanes rows side by
// side. Each group's shared words are `lanes` of fa and `lanes` of fo.
__global__ void __launch_bounds__(kThreads)
superstep_rows_kernel(int* ctrl, int* state, size_t stride,
                      const int* __restrict__ table,
                      const int* __restrict__ lens, int row0, int rows,
                      int width, int planes, int k, int fail_valid) {
  // the status is the same for every thread of the grid: a uniform exit
  if (ctrl[kStatus] != kRunning) return;
  __shared__ uint32_t s_rows[kWarps * kTeamWords];
  const int cur = ctrl[kCur];
  // the two buffers never overlap, so src and dst do not alias
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ dst = state + (1 - cur) * stride;
  const int pad = static_cast<int>(stride) - 1;  // the pad sentinel V

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = team_lanes(width);
  const int sub = lane / lanes;       // the warp's row of this lane
  const int gl = lane & (lanes - 1);  // the lane in its row's group
  const int rs = (blockIdx.x * kWarps + warp) * (32 / lanes) + sub;
  const bool valid = rs < rows;
  const int v = row0 + rs;
  const int me = valid ? src[v] : 0;
  const bool walk = valid && !is_confirmed(me);  // uniform over the group
  const int* __restrict__ row =
      table + static_cast<size_t>(valid ? rs : 0) * width;
  uint32_t* s_fa = s_rows + warp * kTeamWords + sub * 2 * lanes;
  bool clash = false;
  bool found = false;     // a color under k is free of every neighbor
  int cand = k;           // first-fit over all colored neighbors
  bool old_free = false;  // a color under k is free of confirmed ones
  const int done = group_passes(
      src, row, walk ? lens[rs] : 0, gl, lanes, pad, walk, planes, me >> 1,
      s_fa, s_fa + lanes, clash, [&](int pg, uint32_t fa, uint32_t fo) {
        fold_plane(fa, fo, pg, k, found, cand, old_free);
      });
  bool fail = false;
  bool active = false;
  int mc = -1;
  if (valid && gl == 0) {
    int next = me;
    if (walk) {
      if (done < planes) fold_plane(0u, 0u, done, k, found, cand, old_free);
      const dgc::RowResult res = finish_rule(me, clash, found, cand, old_free);
      next = res.next;
      fail = res.fail && fail_valid != 0;
      active = res.active;
      mc = res.mc;
    }
    dst[v] = next;
  }

  // one atomic per block and counter
  const int nfail = __syncthreads_count(fail);
  const int nactive = __syncthreads_count(active);
  const int wmax = __reduce_max_sync(0xFFFFFFFFu, mc);
  __shared__ int warp_max[kWarps];
  if (lane == 0) warp_max[warp] = wmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bmax = warp_max[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) bmax = max(bmax, warp_max[i]);
    if (nfail) atomicAdd(ctrl + kFail, nfail);
    if (nactive) atomicAdd(ctrl + kActive, nactive);
    if (bmax >= 0) atomicMax(ctrl + kMc, bmax);
  }
}

// A block of kBlockThreads a row: its warps OR their register planes into
// the block's shared words beside the others, every thread folds the
// pass, thread 0 writes the row and counts it. The ORs are order-free, so
// a replay gives the same bytes.
__global__ void __launch_bounds__(kBlockThreads)
superstep_rows_block_kernel(int* ctrl, int* state, size_t stride,
                            const int* __restrict__ table,
                            const int* __restrict__ lens, int row0,
                            int width, int planes, int k, int fail_valid) {
  if (ctrl[kStatus] != kRunning) return;
  __shared__ uint32_t s_fa[kPassShared];
  __shared__ uint32_t s_fo[kPassShared];
  // the pass's register planes: fa of planes 0 and 1, then their fo
  __shared__ uint32_t s_lo[2 * kRegPlanes];
  __shared__ int s_clash;
  __shared__ int s_top;
  const int cur = ctrl[kCur];
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ dst = state + (1 - cur) * stride;
  const int pad = static_cast<int>(stride) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rs = blockIdx.x;
  const int v = row0 + rs;
  const int me = src[v];
  if (is_confirmed(me)) {  // uniform over the block
    if (tid == 0) dst[v] = me;
    return;
  }
  const int len = lens[rs];
  const int* __restrict__ row = table + static_cast<size_t>(rs) * width;
  const int mycol = me >> 1;
  bool clash_all = false;
  bool found = false;
  int cand = k;
  bool old_free = false;
  int top = -1;
  int done = planes;
  for (int base = 0; base < planes; base += kPassPlanes) {
    const int gp = min(kPassPlanes, planes - base);
    if (tid < kPassShared) {
      s_fa[tid] = 0u;
      s_fo[tid] = 0u;
    }
    if (tid < 2 * kRegPlanes) s_lo[tid] = 0u;
    if (tid == 0) {
      s_clash = 0;
      s_top = -1;
    }
    __syncthreads();
    PlaneRegs pl;
    bool clash = false;
    int wtop = -1;
    walk_row(src, row, len, tid, kBlockThreads, pad, [&](int e, int word) {
      add_word(e, word, base, gp, mycol, pl, s_fa, s_fo, clash);
      if (base == 0 && word >= 0) wtop = max(wtop, word >> 6);
    });
    pl.or_warp();
    clash = __any_sync(0xFFFFFFFFu, clash);
    wtop = __reduce_max_sync(0xFFFFFFFFu, wtop);
    if (lane == 0) {
      for (int p = 0; p < kRegPlanes; ++p) {
        if (pl.fa(p) != 0u) atomicOr(s_lo + p, pl.fa(p));
        if (pl.fo(p) != 0u) atomicOr(s_lo + kRegPlanes + p, pl.fo(p));
      }
      if (clash) atomicOr(&s_clash, 1);
      if (base == 0 && wtop >= 0) atomicMax(&s_top, wtop);
    }
    __syncthreads();
    for (int p = 0; p < gp; ++p) {  // every thread folds the same planes
      const bool reg = p < kRegPlanes;
      const uint32_t fa = reg ? s_lo[p] : s_fa[p - kRegPlanes];
      const uint32_t fo = reg ? s_lo[kRegPlanes + p] : s_fo[p - kRegPlanes];
      fold_plane(fa, fo, base + p, k, found, cand, old_free);
    }
    clash_all = clash_all || s_clash != 0;
    if (base == 0) top = s_top;
    __syncthreads();  // read before the next pass clears them
    if (top < base + gp) {  // uniform over the block
      done = base + gp;
      break;
    }
  }
  if (tid == 0) {
    if (done < planes) fold_plane(0u, 0u, done, k, found, cand, old_free);
    const dgc::RowResult res =
        finish_rule(me, clash_all, found, cand, old_free);
    dst[v] = res.next;
    if (res.fail && fail_valid != 0) atomicAdd(ctrl + kFail, 1);
    if (res.active) atomicAdd(ctrl + kActive, 1);
    if (res.mc >= 0) atomicMax(ctrl + kMc, res.mc);
  }
}

// One thread: fold this superstep's counters into the loop carry
// (dgc::finish_step: the status order, both stall rules, the flip). With
// kRecord, first write the step's row of `traj` (int32[cap, cols]) from the
// counters, before the fold clears them; a step past cap is dropped.
template <bool kRecord>
__global__ void superstep_finish_kernel(int* ctrl, int max_steps,
                                        int stall_window, int* traj, int cap,
                                        int cols, int gcalls) {
  if (ctrl[kStatus] != kRunning) return;
  if constexpr (kRecord) {
    const int step = ctrl[kStep];
    if (step >= 0 && step < cap) {
      int* row = traj + static_cast<size_t>(step) * cols;
      row[kColActive] = ctrl[kActive];
      row[kColFail] = ctrl[kFail] > 0 ? 1 : 0;
      row[kColMc] = -1;
      row[kColGatherCalls] = gcalls;
      row[kColMaxUnconf] = -1;
      row[kColTsUs] = -1;
    }
  }
  finish_step(ctrl, max_steps, stall_window);
}

}  // namespace

extern "C" {

// state: int32[2, stride] (stride = V+1); table: int32[rows, width] for
// rows [row0, row0+rows); lens: int32[rows], each row's real length.
// Returns the launch's cudaError_t (0 = launched).
int dgc_superstep_rows(void* ctrl, void* state, const void* table,
                       const void* lens, int row0, int rows, int width,
                       int planes, int k, int fail_valid, int stride,
                       void* stream) {
  if (rows <= 0 || width <= 0 || planes <= 0 || lens == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int*>(ctrl);
  auto* s = static_cast<int*>(state);
  const auto* t = static_cast<const int*>(table);
  const auto* ln = static_cast<const int*>(lens);
  auto st = static_cast<cudaStream_t>(stream);
  const auto words = static_cast<size_t>(stride);
  if (width >= kBlockWidth) {
    superstep_rows_block_kernel<<<static_cast<unsigned>(rows), kBlockThreads,
                                  0, st>>>(c, s, words, t, ln, row0, width,
                                           planes, k, fail_valid);
  } else {
    const long long per_warp = 32 / team_lanes(width);
    const long long warps = (rows + per_warp - 1) / per_warp;
    const auto blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
    superstep_rows_kernel<<<blocks, kThreads, 0, st>>>(
        c, s, words, t, ln, row0, rows, width, planes, k, fail_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// traj: int32[cap, cols], cols >= 6, for the recording variant (kRecord),
// or null for the plain K2.
int dgc_superstep_finish(void* ctrl, int max_steps, int stall_window,
                         void* traj, int cap, int cols, int gcalls,
                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(ctrl);
  if (traj == nullptr) {
    superstep_finish_kernel<false><<<1, 1, 0, st>>>(c, max_steps,
                                                    stall_window, nullptr, 0,
                                                    0, -1);
  } else if (cap < 1 || cols < kTrajCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    superstep_finish_kernel<true><<<1, 1, 0, st>>>(
        c, max_steps, stall_window, static_cast<int*>(traj), cap, cols,
        gcalls);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
