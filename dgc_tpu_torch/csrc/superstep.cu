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
// 50 MB L2, so the random neighbor gathers should hit L2. This first
// kernel is one thread per row with its planes in registers (templated on
// the plane count), reading the row-major table row by row, padding
// included: simple and exact, not yet shaped for coalesced table reads
// (PERF.md has its measured time against the bound).

#include <cuda_runtime.h>

#include <cstdint>

#include "rule.cuh"
#include "traj.cuh"

namespace {

using namespace dgc;  // the control block's slots and statuses

constexpr int kThreads = 256;

// One thread per table row; the rule itself is dgc::row_rule (rule.cuh),
// PB planes in registers at a time.
template <int PB>
__global__ void __launch_bounds__(kThreads)
superstep_rows_kernel(int* ctrl, int* state, size_t stride,
                      const int* __restrict__ table, int row0, int rows,
                      int width, int planes, int k, int fail_valid) {
  // the status is the same for every thread of the grid: a uniform exit
  if (ctrl[kStatus] != kRunning) return;
  const int cur = ctrl[kCur];
  // the two buffers never overlap, so src and dst do not alias
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ dst = state + (1 - cur) * stride;

  const int r = blockIdx.x * kThreads + threadIdx.x;
  bool fail = false;
  bool active = false;
  int mc = -1;
  if (r < rows) {
    const int v = row0 + r;
    const int* __restrict__ row = table + static_cast<size_t>(r) * width;
    const dgc::RowResult res =
        dgc::row_rule<PB>(src, row, width, planes, k, src[v]);
    dst[v] = res.next;
    fail = res.fail;
    active = res.active;
    mc = res.mc;
  }

  // one atomic per block and counter
  const int nfail = __syncthreads_count(fail && fail_valid != 0);
  const int nactive = __syncthreads_count(active);
  const int wmax = __reduce_max_sync(0xFFFFFFFFu, mc);
  __shared__ int warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = wmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bmax = warp_max[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) bmax = max(bmax, warp_max[i]);
    if (nfail) atomicAdd(ctrl + kFail, nfail);
    if (nactive) atomicAdd(ctrl + kActive, nactive);
    if (bmax >= 0) atomicMax(ctrl + kMc, bmax);
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

template <int PB>
void launch_rows(int* ctrl, int* state, const int* table, int row0, int rows,
                 int width, int planes, int k, int fail_valid, int stride,
                 cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  superstep_rows_kernel<PB><<<blocks, kThreads, 0, stream>>>(
      ctrl, state, static_cast<size_t>(stride), table, row0, rows, width,
      planes, k, fail_valid);
}

}  // namespace

extern "C" {

// state: int32[2, stride] (stride = V+1); table: int32[rows, width] for
// rows [row0, row0+rows). Returns the launch's cudaError_t (0 = launched).
int dgc_superstep_rows(void* ctrl, void* state, const void* table, int row0,
                       int rows, int width, int planes, int k, int fail_valid,
                       int stride, void* stream) {
  if (rows <= 0 || width <= 0 || planes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int*>(ctrl);
  auto* s = static_cast<int*>(state);
  const auto* t = static_cast<const int*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  if (planes <= 1) {
    launch_rows<1>(c, s, t, row0, rows, width, planes, k, fail_valid, stride, st);
  } else if (planes <= 2) {
    launch_rows<2>(c, s, t, row0, rows, width, planes, k, fail_valid, stride, st);
  } else if (planes <= 4) {
    launch_rows<4>(c, s, t, row0, rows, width, planes, k, fail_valid, stride, st);
  } else if (planes <= 8) {
    launch_rows<8>(c, s, t, row0, rows, width, planes, k, fail_valid, stride, st);
  } else if (planes <= 16) {
    launch_rows<16>(c, s, t, row0, rows, width, planes, k, fail_valid, stride, st);
  } else {
    launch_rows<32>(c, s, t, row0, rows, width, planes, k, fail_valid, stride, st);
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
