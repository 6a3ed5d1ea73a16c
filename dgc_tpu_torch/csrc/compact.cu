// The frontier-compacted engine's kernels for Hopper (sm_90a), with a
// plain C interface for ctypes (dgc_tpu_torch/kernels/compact.py).
//
// Replaces the jitted XLA programs of the JAX package's hub-free staged
// pipeline (dgc_tpu/engine/compact.py:1411 _staged_pipeline, :1470-1604):
//   K3 compact_slots       — B5, dgc_tpu/engine/compact.py:288 _compact_idx:
//                            the ordered list of a stage's active rows.
//   K4 stage_rows          — B5, the stage-entry row gather
//                            (compact.py:1526-1541): each slot's row of the
//                            flat table, clipped to its range's width, into
//                            one flat layout, and the slots' state indices.
//   K5 segmented_superstep — B4, dgc_tpu/ops/segmented_gather.py:237
//                            segmented_update and :279 _parts with :121
//                            fail_gate, as run at compact.py:959 (the
//                            full-table phase) and :1557-1564 (a stage).
//   K6 stage_finish        — B7/B8, compact.py:1004 _make_recstep (the
//                            prefix-resume ring push, the live counts
//                            `ba` included) and :1048 _superstep_epilogue
//                            (stall, status, and the commit of the hub
//                            region's staged live counts and prune tiers
//                            unless the step failed).
//
// Their recording variants (B11: dgc_tpu/obs/kernel.py:95 make_trajstep as
// called at compact.py:1063, with the unconf columns of :257 _unconf_max
// and dgc_tpu/ops/segmented_gather.py:203) are template instances with
// kRecord set; without it they compile to the kernels above:
//   K5 with kRecord also takes, over the rows it evaluates that were active
//   before the step, the max count of unconfirmed real neighbors, into its
//   column of the unconf vector `umax` (the flat region's column; the hub
//   kernels fill the hub buckets' columns, hub.cu).
//   K6 with kRecord writes the superstep's trajectory row in its last
//   block, from the counters it folds, before the fold clears them and
//   before the commit or the flip: the active count, the fail flag, mc,
//   the gather calls (a constant and one per bucket with weight and live
//   rows), max(umax), the timestamp (kTiming: %globaltimer, traj.cuh;
//   else -1), the bucket tail (the hub buckets' staged counts, then the
//   flat region's total) and the unconf tail `umax`, which it then clears.
//   The row is dropped past the buffer's cap.
//
// State. Two int32[V+2] buffers (packed words): slot V holds -1 (the pad
// sentinel) and slot V+1 holds 0 (the dummy row of unused slots), in both
// buffers for good. A control block int32[11] (CTRL_* in compact.py) holds
// the loop carry, this superstep's counters, the ring's count and best
// candidate, and K6's block counter. K5 reads buffer `cur` and writes the
// other one; K6 flips `cur` unless the step failed. A stage writes only its
// slot rows, so K3 copies the current buffer over the other one at stage
// entry: rows outside the slot list then hold the same word in both. (The
// hub region's rows are copied by K7 every superstep, csrc/hub.cu.)
//
// Loop control. A superstep runs iff the attempt is RUNNING, its carried
// active count is above the stage's threshold and its step is below
// max_steps (the while conds at compact.py:1484-1486, 1543-1545). K5 and
// K6 test that from the control block and return at once when it fails, so
// the host enqueues a chunk of supersteps and syncs once per chunk; the
// test never changes the status, so a stage that ends leaves the attempt
// RUNNING for the next stage.
//
// Bounds (1M vertices, average degree 16, the main path; PERF.md has the
// measured times). K5 must read each row's real neighbor entries once plus
// the state gathered through them and the row's own word, and write the
// row: ~76 MB for the full table, ~23 us at 3.35 TB/s, less in the stages
// as the frontier shrinks. K3 reads and writes V words (8 MB, ~2.4 us) and
// writes the slot list. K4 reads the slots' rows (at most pad x 32 words)
// and writes them once. K6 is one control-block update, plus a copy of V
// words into the ring when it pushes. These first kernels are one thread
// per row (K5), per item (K3, K4) or per word (K6), written to be right and
// simple, not yet shaped for coalesced table reads.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "rule.cuh"
#include "traj.cuh"

namespace {

using namespace dgc;  // the control block's first slots and statuses

// the slots the compact engine's control block appends (CTRL_* in
// kernels/compact.py)
constexpr int kRecCnt = 8;
constexpr int kRecBest = 9;
constexpr int kDone = 10;

constexpr int kRecSlots = 4;
constexpr int kMetaCols = 5;
constexpr int kThreads = 256;
constexpr int kMaxSegs = 64;    // segments of one plan (the wrapper checks)
constexpr int kDescCols = 5;    // row0, rows, width, planes, flat0
constexpr int kScanItems = 8;   // K3: items per thread
constexpr int kScanTile = kThreads * kScanItems;

__device__ __forceinline__ void load_desc(int* s_desc, const int* desc,
                                          int nseg) {
  for (int i = threadIdx.x; i < nseg * kDescCols; i += blockDim.x) {
    s_desc[i] = desc[i];
  }
  __syncthreads();
}

// ---- K3: ordered stream compaction ------------------------------------
//
// Tiles of kScanTile items, in the order of a ticket taken at block start
// (so a tile only waits on tiles that already run), scanned with a
// decoupled look-back: each tile publishes its count at once and its
// inclusive prefix when it knows it, one 64-bit word (state << 32 | value)
// per tile in `scratch[1 + tile]`. The last tile fills the unused slots
// with the dummy index n.

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__global__ void __launch_bounds__(kThreads)
compact_slots_kernel(const int* ctrl, int* state, size_t stride, int row0,
                     int n, int pad, int* idx, unsigned long long* scratch) {
  __shared__ int s_tile;
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_prefix;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1ULL));
  __syncthreads();
  const int tile = s_tile;
  const int cur = ctrl[kCur];
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ other = state + (1 - cur) * stride;

  const int base = tile * kScanTile + threadIdx.x * kScanItems;
  unsigned bits = 0u;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int pos = base + i;
    if (pos < n) {
      const int w = src[row0 + pos];
      other[row0 + pos] = w;
      if (w < 0 || (w & 1) != 0) {
        bits |= 1u << i;
        ++cnt;
      }
    }
  }

  // block-wide exclusive scan of the per-thread counts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kThreads / 32) s_warp[lane] = t;
  }
  __syncthreads();
  const int excl = x - cnt + (warp > 0 ? s_warp[warp - 1] : 0);
  const int total = s_warp[kThreads / 32 - 1];

  if (threadIdx.x == 0) {
    unsigned long long* flags = scratch + 1;
    int prefix = 0;
    if (tile == 0) {
      store_flag(flags, (2ULL << 32) | static_cast<unsigned>(total));
    } else {
      store_flag(flags + tile, (1ULL << 32) | static_cast<unsigned>(total));
      int j = tile - 1;
      while (true) {
        const unsigned long long f = load_flag(flags + j);
        const unsigned st = static_cast<unsigned>(f >> 32);
        if (st == 0u) continue;  // tile j has not counted yet
        prefix += static_cast<int>(f & 0xFFFFFFFFULL);
        if (st == 2u) break;     // an inclusive prefix: done
        --j;
      }
      store_flag(flags + tile,
                 (2ULL << 32) | static_cast<unsigned>(prefix + total));
    }
    s_prefix = prefix;
  }
  __syncthreads();

  int off = s_prefix + excl;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if ((bits >> i) & 1u) {
      if (off < pad) idx[off] = base + i;  // actives past pad are dropped
      ++off;
    }
  }
  if (tile == static_cast<int>(gridDim.x) - 1) {
    const int count = s_prefix + total;
    for (int i = count + threadIdx.x; i < pad; i += kThreads) idx[i] = n;
  }
}

// ---- K4: the stage's flat layout ----------------------------------------

__global__ void __launch_bounds__(kThreads)
stage_rows_kernel(const int* __restrict__ flat_ext, int w_flat, int n,
                  const int* __restrict__ idx, int pad,
                  const int* __restrict__ desc, int nseg, long long total,
                  int row0, int v, int* __restrict__ seg,
                  int* __restrict__ gidx) {
  __shared__ int s_desc[kMaxSegs * kDescCols];
  load_desc(s_desc, desc, nseg);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < total; t += step) {
    int s = 0;
    while (s + 1 < nseg && s_desc[(s + 1) * kDescCols + 4] <= t) ++s;
    const int* d = s_desc + s * kDescCols;
    const long long rel = t - d[4];
    const int slot = d[0] + static_cast<int>(rel / d[2]);
    const int col = static_cast<int>(rel % d[2]);
    seg[t] = flat_ext[static_cast<size_t>(idx[slot]) * w_flat + col];
  }
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < pad; i += step) {
    const int r = idx[i];
    gidx[i] = r == n ? v + 1 : r + row0;
  }
}

// ---- K5: one superstep over a whole plan ---------------------------------

template <int PB, bool kRecord>
__global__ void __launch_bounds__(kThreads)
segmented_superstep_kernel(int* ctrl, int* state, size_t stride,
                           const int* __restrict__ seg,
                           const int* __restrict__ desc, int nseg, int rows,
                           const int* __restrict__ gidx, int row_base,
                           int dummy, int k, int thresh, int max_steps,
                           int* umax, int ucol) {
  // the predicate reads slots this kernel never writes: uniform exit
  if (!stage_live(ctrl, thresh, max_steps)) return;
  __shared__ int s_desc[kMaxSegs * kDescCols];
  load_desc(s_desc, desc, nseg);
  const int cur = ctrl[kCur];
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ dst = state + (1 - cur) * stride;

  const int r = blockIdx.x * kThreads + threadIdx.x;
  bool fail = false;
  bool active = false;
  int mc = -1;
  int unconf = 0;  // kRecord: the row's unconfirmed real neighbors
  if (r < rows) {
    int s = 0;
    while (s + 1 < nseg && s_desc[(s + 1) * kDescCols] <= r) ++s;
    const int* d = s_desc + s * kDescCols;
    const int g = gidx != nullptr ? gidx[r] : row_base + r;
    // an unused slot is the dummy row: it changes nothing, counts nothing
    if (gidx == nullptr || g != dummy) {
      const int width = d[2];
      const int planes = d[3];
      const int* __restrict__ row =
          seg + d[4] + static_cast<size_t>(r - d[0]) * width;
      const int me = src[g];
      const dgc::RowResult res =
          dgc::row_rule<PB>(src, row, width, planes, k, me);
      dst[g] = res.next;
      const long long window = 32LL * planes;
      const bool fail_valid = window >= width + 1LL || k <= window;
      fail = res.fail && fail_valid;
      active = res.active;
      mc = res.mc;
      if constexpr (kRecord) {
        // the pad sentinel is V = dummy - 1; rows inactive before the
        // step count 0
        if (!is_confirmed(me)) unconf = row_unconf(src, row, width, dummy - 1);
      }
    }
  }

  const int nfail = __syncthreads_count(fail);
  const int nactive = __syncthreads_count(active);
  const int wmax = __reduce_max_sync(0xFFFFFFFFu, mc);
  __shared__ int warp_max[kThreads / 32];
  __shared__ int warp_unconf[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = wmax;
  if constexpr (kRecord) {
    const int wun = __reduce_max_sync(0xFFFFFFFFu, unconf);
    if ((threadIdx.x & 31) == 0) warp_unconf[threadIdx.x >> 5] = wun;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bmax = warp_max[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) bmax = max(bmax, warp_max[i]);
    if (nfail) atomicAdd(ctrl + kFail, nfail);
    if (nactive) atomicAdd(ctrl + kActive, nactive);
    if (bmax >= 0) atomicMax(ctrl + kMc, bmax);
    if constexpr (kRecord) {
      int bun = 0;
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) bun = max(bun, warp_unconf[i]);
      if (bun > 0) atomicMax(umax + ucol, bun);
    }
  }
}

// ---- K6: the superstep epilogue -------------------------------------------
//
// Every block copies its share of the pre-step state into the ring when the
// step pushes; the last block to finish (a counter in the control block)
// writes the ring meta and the pre-step live counts, commits the staged
// live counts and tiers of the `nh` hub buckets (and the flat region's
// total, the step's active count less theirs, when the live table has a
// column for it) unless the step failed, and folds the counters into the
// loop carry with K2's dgc::finish_step (rule.cuh). Every block reads the
// control block before it counts itself done, so none sees the last
// block's writes.

template <bool kRecord, bool kTiming>
__global__ void __launch_bounds__(kThreads)
stage_finish_kernel(int* ctrl, const int* state, size_t stride,
                    int* __restrict__ ring_pe, int* __restrict__ ring_ba,
                    int* __restrict__ ring_meta, int* __restrict__ live,
                    int nh, int nb, int words, int thresh, int max_steps,
                    int stall_window, int record, int* __restrict__ traj,
                    int cap, int cols, int* __restrict__ umax,
                    const int* __restrict__ gc_w, int gc_const, int nt) {
  if (!stage_live(ctrl, thresh, max_steps)) return;
  const int fail = ctrl[kFail];
  const int mc = ctrl[kMc];
  const int best = ctrl[kRecBest];
  const int cnt = ctrl[kRecCnt];
  const bool push = record != 0 && fail == 0 && mc > best;
  const int slot = cnt % kRecSlots;
  if (push) {
    const int* __restrict__ src = state + ctrl[kCur] * stride;
    int* __restrict__ out = ring_pe + static_cast<size_t>(slot) * words;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < words;
         i += gridDim.x * kThreads) {
      out[i] = src[i];
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + kDone, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;

  if constexpr (kRecord) {
    // the row of the step just finished, from the pre-commit live table
    const int step = ctrl[kStep];
    if (step >= 0 && step < cap) {
      int* row = traj + static_cast<size_t>(step) * cols;
      const int active = ctrl[kActive];
      int gcalls = gc_const;
      int unconf = 0;
      int hub_active = 0;
      for (int i = 0; i < nt; ++i) {
        if (gc_w[i] != 0 && live[kLiveBa * nb + i] > 0) ++gcalls;
        unconf = max(unconf, umax[i]);
        int a = active - hub_active;  // the flat region's total (i == nh)
        if (i < nh) {
          a = live[kLiveBaNext * nb + i];
          hub_active += a;
        }
        row[kTrajCols + i] = a;
        row[kTrajCols + nt + i] = umax[i];
      }
      row[kColActive] = active;
      row[kColFail] = fail > 0 ? 1 : 0;
      row[kColMc] = mc;
      row[kColGatherCalls] = gcalls;
      row[kColMaxUnconf] = unconf;
      int ts = -1;
      if constexpr (kTiming) ts = globaltimer_us();
      row[kColTsUs] = ts;
    }
    for (int i = 0; i < nt; ++i) umax[i] = 0;
  }

  if (push) {
    int* meta = ring_meta + slot * kMetaCols;
    meta[0] = ctrl[kStep];
    meta[1] = best;
    meta[2] = mc;
    meta[3] = ctrl[kStall];
    meta[4] = ctrl[kPrevActive];
    ctrl[kRecCnt] = cnt + 1;
    ctrl[kRecBest] = mc;
    for (int i = 0; i < nb; ++i) {
      ring_ba[slot * nb + i] = live[kLiveBa * nb + i];
    }
  }
  if (fail == 0) {
    int hub_active = 0;
    for (int i = 0; i < nh; ++i) {
      const int a = live[kLiveBaNext * nb + i];
      live[kLiveBa * nb + i] = a;
      live[kLiveTier * nb + i] = live[kLiveTierNext * nb + i];
      hub_active += a;
    }
    if (nb > nh) live[kLiveBa * nb + nh] = ctrl[kActive] - hub_active;
  }
  // max_steps was tested before the step (stage_live): no ELL stall rule
  finish_step(ctrl, INT_MAX, stall_window);
  ctrl[kDone] = 0;
}

template <int PB, bool kRecord>
void launch_segmented(int* ctrl, int* state, int stride, const int* seg,
                      const int* desc, int nseg, int rows, const int* gidx,
                      int row_base, int dummy, int k, int thresh,
                      int max_steps, int* umax, int ucol,
                      cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  segmented_superstep_kernel<PB, kRecord><<<blocks, kThreads, 0, stream>>>(
      ctrl, state, static_cast<size_t>(stride), seg, desc, nseg, rows, gidx,
      row_base, dummy, k, thresh, max_steps, umax, ucol);
}

// K5 at the plane count that holds max_planes
template <bool kRecord>
void dispatch_segmented(int* c, int* s, int stride, const int* t,
                        const int* d, int nseg, int rows, int max_planes,
                        const int* g, int row_base, int dummy, int k,
                        int thresh, int max_steps, int* umax, int ucol,
                        cudaStream_t st) {
  if (max_planes <= 1) {
    launch_segmented<1, kRecord>(c, s, stride, t, d, nseg, rows, g, row_base,
                                 dummy, k, thresh, max_steps, umax, ucol, st);
  } else if (max_planes <= 2) {
    launch_segmented<2, kRecord>(c, s, stride, t, d, nseg, rows, g, row_base,
                                 dummy, k, thresh, max_steps, umax, ucol, st);
  } else if (max_planes <= 4) {
    launch_segmented<4, kRecord>(c, s, stride, t, d, nseg, rows, g, row_base,
                                 dummy, k, thresh, max_steps, umax, ucol, st);
  } else if (max_planes <= 8) {
    launch_segmented<8, kRecord>(c, s, stride, t, d, nseg, rows, g, row_base,
                                 dummy, k, thresh, max_steps, umax, ucol, st);
  } else if (max_planes <= 16) {
    launch_segmented<16, kRecord>(c, s, stride, t, d, nseg, rows, g, row_base,
                                  dummy, k, thresh, max_steps, umax, ucol, st);
  } else {
    launch_segmented<32, kRecord>(c, s, stride, t, d, nseg, rows, g, row_base,
                                  dummy, k, thresh, max_steps, umax, ucol, st);
  }
}

unsigned finish_blocks(int stride, int record) {
  if (record == 0) return 1;
  const int per_block = kThreads * 4;
  unsigned blocks = static_cast<unsigned>((stride + per_block - 1) / per_block);
  return blocks > 528 ? 528 : blocks;  // 4 per SM; the copy strides the rest
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// state: int32[2, stride]; idx: int32[pad]; scratch: uint64[1 + tiles],
// zeroed, tiles = ceil(n / 2048) (dgc_compact_slots_tiles).
int dgc_compact_slots_tiles(int n) { return (n + kScanTile - 1) / kScanTile; }

int dgc_compact_slots(const void* ctrl, void* state, int stride, int row0,
                      int n, int pad, void* idx, void* scratch,
                      void* stream) {
  if (n <= 0 || pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>(dgc_compact_slots_tiles(n));
  compact_slots_kernel<<<tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ctrl), static_cast<int*>(state),
      static_cast<size_t>(stride), row0, n, pad, static_cast<int*>(idx),
      static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// flat_ext: int32[n+1, w_flat]; desc: int32[nseg, 5] of the stage plan;
// seg: int32[total]; gidx: int32[pad].
int dgc_stage_rows(const void* flat_ext, int w_flat, int n, const void* idx,
                   int pad, const void* desc, int nseg, long long total,
                   int row0, int v, void* seg, void* gidx, void* stream) {
  if (nseg <= 0 || nseg > kMaxSegs || pad <= 0 || total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long work = total > pad ? total : pad;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  stage_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flat_ext), w_flat, n,
      static_cast<const int*>(idx), pad, static_cast<const int*>(desc), nseg,
      total, row0, v, static_cast<int*>(seg), static_cast<int*>(gidx));
  return static_cast<int>(cudaGetLastError());
}

// seg: the plan's flat table; desc: int32[nseg, 5]; gidx: int32[rows] state
// indices, or null for rows row_base + r; dummy: the dummy slot (V+1);
// umax: int32[>= ucol + 1], the unconf vector of the recording variant
// (kRecord), or null for the plain K5.
int dgc_segmented_superstep(void* ctrl, void* state, int stride,
                            const void* seg, const void* desc, int nseg,
                            int rows, int max_planes, const void* gidx,
                            int row_base, int dummy, int k, int thresh,
                            int max_steps, void* umax, int ucol,
                            void* stream) {
  if (rows <= 0 || nseg <= 0 || nseg > kMaxSegs || max_planes <= 0 ||
      ucol < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int*>(ctrl);
  auto* s = static_cast<int*>(state);
  const auto* sg = static_cast<const int*>(seg);
  const auto* d = static_cast<const int*>(desc);
  const auto* gi = static_cast<const int*>(gidx);
  auto st = static_cast<cudaStream_t>(stream);
  if (umax == nullptr) {
    dispatch_segmented<false>(c, s, stride, sg, d, nseg, rows, max_planes, gi,
                              row_base, dummy, k, thresh, max_steps, nullptr,
                              0, st);
  } else {
    dispatch_segmented<true>(c, s, stride, sg, d, nseg, rows, max_planes, gi,
                             row_base, dummy, k, thresh, max_steps,
                             static_cast<int*>(umax), ucol, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// ring_pe: int32[4, words], ring_ba: int32[4, nb] and ring_meta:
// int32[4, 5], or null when record is 0 (one block then); words = stride =
// V+2; live: int32[5, nb], nb = nh or nh + 1. The recording variant
// (kRecord, kTiming = timing) when traj is not null: traj int32[cap, cols],
// cols = 6 + 2 * nt; umax and gc_w int32[nt], nt = nh or nh + 1 (nt <= nb).
int dgc_stage_finish(void* ctrl, const void* state, int stride, void* ring_pe,
                     void* ring_ba, void* ring_meta, void* live, int nh,
                     int nb, int thresh, int max_steps, int stall_window,
                     int record, void* traj, int cap, int cols, void* umax,
                     const void* gc_w, int gc_const, int nt, int timing,
                     void* stream) {
  if ((record != 0 && (ring_pe == nullptr || ring_ba == nullptr ||
                       ring_meta == nullptr)) ||
      live == nullptr || nh < 0 || nb < nh || nb > nh + 1 ||
      (traj != nullptr &&
       (umax == nullptr || gc_w == nullptr || cap < 1 || nt < nh ||
        nt > nb || cols != kTrajCols + 2 * nt))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int*>(ctrl);
  const auto* pe = static_cast<const int*>(state);
  auto* rp = static_cast<int*>(ring_pe);
  auto* rb = static_cast<int*>(ring_ba);
  auto* rm = static_cast<int*>(ring_meta);
  auto* lv = static_cast<int*>(live);
  auto* tr = static_cast<int*>(traj);
  auto* um = static_cast<int*>(umax);
  const auto* gw = static_cast<const int*>(gc_w);
  const unsigned blocks = finish_blocks(stride, record);
  auto st = static_cast<cudaStream_t>(stream);
  const auto words = static_cast<size_t>(stride);
  if (traj == nullptr) {
    stage_finish_kernel<false, false><<<blocks, kThreads, 0, st>>>(
        c, pe, words, rp, rb, rm, lv, nh, nb, stride, thresh, max_steps,
        stall_window, record, nullptr, 0, 0, nullptr, nullptr, 0, 0);
  } else if (timing != 0) {
    stage_finish_kernel<true, true><<<blocks, kThreads, 0, st>>>(
        c, pe, words, rp, rb, rm, lv, nh, nb, stride, thresh, max_steps,
        stall_window, record, tr, cap, cols, um, gw, gc_const, nt);
  } else {
    stage_finish_kernel<true, false><<<blocks, kThreads, 0, st>>>(
        c, pe, words, rp, rb, rm, lv, nh, nb, stride, thresh, max_steps,
        stall_window, record, tr, cap, cols, um, gw, gc_const, nt);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
