// The ring-halo engine's per-rotation kernels for Hopper (sm_90a), with a
// plain C interface for ctypes (dgc_tpu_torch/kernels/ring.py).
//
// Replaces the per-shard parts of the jitted shard_map programs of the JAX
// package's ring engine (dgc_tpu/engine/ring.py):
//   K23 ring_stats      — B13g, ring.py:303-307 (flat: neighbor_stats of the
//                         shard's rows against the held block through
//                         rotation r's table, OR-folded into forb_all,
//                         forb_old and clash) and ring.py:355-368 (bucketed:
//                         the same on one bucket's row list, its
//                         gather-modify-scatter); one thread per row.
//   K24 ring_stats_wide — the same function, one warp per row, for the
//                         tables the engine finds wider than
//                         kernels.ring.WIDE_WIDTH (the heavy-tail buckets);
//                         the planes are OR-reduced over the warp as in
//                         rule.cuh's warp_row_rule.
//   K25 ring_apply      — ring.py:310-316 (and :371-377): apply_update_mc
//                         from the accumulated planes, the new words into
//                         `back`, and the fail (where fail_valid), active and
//                         mc counters into the control block, in the slots
//                         K20 (shard.cu) writes, so the host's SUM/MAX
//                         reductions and K21 close the superstep unchanged.
// The rotations between the stats launches are the host's
// (parallel.mesh.VertexMesh.rotate, torch.distributed point-to-point).
//
// Layout on each rank (V_l rows): `block` int32[V_l + 1], the words of the
// shard the rank holds after r rotations, slot V_l fixed at -1 (the tables'
// sentinel); `packed` int32[V_l], the rank's own words (its rows' colors);
// `acc` int32[2P + 1, V_l], plane-major: P planes of forb_all, P of
// forb_old (as uint32 bit patterns), then the clash flags (0 or 1). A
// table is int32[rows, W] of combined entries, the block-local neighbor id
// with the beats bit at 30 (rule.cuh kBeatsBit; V_l < 2^30); with a rows
// list (int32[rows], sentinel V_l: a padding row, skipped) table row j
// belongs to local row rows[j], else to local row j. Every row appears at
// most once in the tables of one rotation, so K23/K24 OR into its
// accumulators without atomics. K25 reads them and writes them back to 0,
// so they are zero at every superstep's start (and after a launch past the
// attempt's end, which returns at once as every kernel here does).
//
// Bounds (PERF.md has the measured times): K23/K24 read the real entries
// of their table (the flat layout's padding is not work, as for K1), a
// block word per real entry, a packed word per row, and read and write
// the accumulator words the row's stats make nonzero (write the clash
// flag where set); K25 reads each row's word and 2P + 1 accumulators and
// writes its new word (the zeroing is the split's cost, not the
// function's).
// These first kernels are one thread (K23, K25) or one warp (K24) per
// row, written to be right and simple.

#include <cuda_runtime.h>

#include <cstdint>

#include "rule.cuh"

namespace {

using namespace dgc;  // the control block's first slots and statuses

constexpr int kThreads = 256;

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

// OR one plane group of a row's stats into its accumulators.
template <int PB>
__device__ __forceinline__ void or_planes(int* __restrict__ acc, int vl,
                                          int r, int base, int planes,
                                          const uint32_t (&fa)[PB],
                                          const uint32_t (&fo)[PB]) {
  const size_t stride = static_cast<size_t>(vl);
#pragma unroll
  for (int p = 0; p < PB; ++p) {
    const int pg = base + p;
    if (pg < planes) {
      if (fa[p] != 0u) acc[pg * stride + r] |= static_cast<int>(fa[p]);
      if (fo[p] != 0u) {
        acc[(planes + pg) * stride + r] |= static_cast<int>(fo[p]);
      }
    }
  }
}

// ---- K23: one rotation's stats, one thread per row ------------------------

template <int PB>
__global__ void __launch_bounds__(kThreads)
ring_stats_kernel(const int* ctrl, const int* __restrict__ block,
                  const int* __restrict__ packed,
                  const int* __restrict__ table,
                  const int* __restrict__ rows, int nrows, int width, int vl,
                  int* __restrict__ acc, int planes) {
  if (ctrl[kStatus] != kRunning) return;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nrows) return;
  const int r = rows != nullptr ? rows[j] : j;
  if (r >= vl) return;  // a padding row of the bucket
  const int mycol = packed[r] >> 1;  // arithmetic: -1 stays -1
  const int* __restrict__ row = table + static_cast<size_t>(j) * width;
  bool clash = false;
  const int groups = (planes + PB - 1) / PB;
  for (int g = 0; g < groups; ++g) {
    const int base = g * PB;
    uint32_t fa[PB];
    uint32_t fo[PB];
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      fa[p] = 0u;
      fo[p] = 0u;
    }
    for (int e = 0; e < width; ++e) {
      add_neighbor<PB>(block, row[e], base, mycol, fa, fo, clash);
    }
    or_planes<PB>(acc, vl, r, base, planes, fa, fo);
  }
  if (clash) acc[2 * planes * static_cast<size_t>(vl) + r] = 1;
}

// ---- K24: the same, one warp per row --------------------------------------

template <int PB>
__global__ void __launch_bounds__(kThreads)
ring_stats_wide_kernel(const int* ctrl, const int* __restrict__ block,
                       const int* __restrict__ packed,
                       const int* __restrict__ table,
                       const int* __restrict__ rows, int nrows, int width,
                       int vl, int* __restrict__ acc, int planes) {
  if (ctrl[kStatus] != kRunning) return;
  const int j = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= nrows) return;  // uniform over the warp
  const int r = rows != nullptr ? rows[j] : j;
  if (r >= vl) return;     // uniform over the warp
  const int mycol = packed[r] >> 1;
  const int* __restrict__ row = table + static_cast<size_t>(j) * width;
  bool clash = false;
  const int groups = (planes + PB - 1) / PB;
  for (int g = 0; g < groups; ++g) {
    const int base = g * PB;
    uint32_t fa[PB];
    uint32_t fo[PB];
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      fa[p] = 0u;
      fo[p] = 0u;
    }
#pragma unroll 4
    for (int e = lane; e < width; e += 32) {
      add_neighbor<PB>(block, row[e], base, mycol, fa, fo, clash);
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      fa[p] = __reduce_or_sync(0xFFFFFFFFu, fa[p]);
      fo[p] = __reduce_or_sync(0xFFFFFFFFu, fo[p]);
    }
    if (lane == 0) or_planes<PB>(acc, vl, r, base, planes, fa, fo);
  }
  clash = __any_sync(0xFFFFFFFFu, clash);
  if (lane == 0 && clash) acc[2 * planes * static_cast<size_t>(vl) + r] = 1;
}

// ---- K25: the state transition from the accumulated stats -----------------

template <int PB>
__global__ void __launch_bounds__(kThreads)
ring_apply_kernel(int* ctrl, const int* __restrict__ packed,
                  int* __restrict__ acc, int* __restrict__ back, int vl,
                  int planes, int k, int fail_valid) {
  // the status is the same for every thread of the grid: a uniform exit
  if (ctrl[kStatus] != kRunning) return;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  bool fail = false;
  bool active = false;
  int mc = -1;
  if (r < vl) {
    const size_t stride = static_cast<size_t>(vl);
    bool found = false;
    int cand = k;
    bool old_free = false;
    const int groups = (planes + PB - 1) / PB;
    for (int g = 0; g < groups; ++g) {
      const int base = g * PB;
      uint32_t fa[PB];
      uint32_t fo[PB];
#pragma unroll
      for (int p = 0; p < PB; ++p) {
        const int pg = base + p;
        fa[p] = 0u;
        fo[p] = 0u;
        if (pg < planes) {
          int* a = acc + pg * stride + r;
          int* o = acc + (planes + pg) * stride + r;
          fa[p] = static_cast<uint32_t>(*a);
          fo[p] = static_cast<uint32_t>(*o);
          *a = 0;
          *o = 0;
        }
      }
      fold_planes<PB>(fa, fo, base, planes, k, found, cand, old_free);
    }
    int* c = acc + 2 * planes * stride + r;
    const bool clash = *c != 0;
    *c = 0;
    const RowResult res = finish_rule(packed[r], clash, found, cand, old_free);
    back[r] = res.next;
    fail = res.fail && fail_valid != 0;
    active = res.active;
    mc = res.mc;
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

template <int PB>
void launch_stats(bool wide, const int* ctrl, const int* block,
                  const int* packed, const int* table, const int* rows,
                  int nrows, int width, int vl, int* acc, int planes,
                  cudaStream_t stream) {
  if (wide) {
    const long long threads = 32LL * nrows;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    ring_stats_wide_kernel<PB><<<blocks, kThreads, 0, stream>>>(
        ctrl, block, packed, table, rows, nrows, width, vl, acc, planes);
  } else {
    const unsigned blocks =
        static_cast<unsigned>((nrows + kThreads - 1) / kThreads);
    ring_stats_kernel<PB><<<blocks, kThreads, 0, stream>>>(
        ctrl, block, packed, table, rows, nrows, width, vl, acc, planes);
  }
}

int stats(bool wide, const void* ctrl, const void* block, const void* packed,
          const void* table, const void* rows, int nrows, int width, int vl,
          void* acc, int planes, void* stream) {
  if (nrows <= 0 || width <= 0 || vl <= 0 || planes <= 0 ||
      (rows == nullptr && nrows != vl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const int*>(ctrl);
  const auto* b = static_cast<const int*>(block);
  const auto* pk = static_cast<const int*>(packed);
  const auto* t = static_cast<const int*>(table);
  const auto* rw = static_cast<const int*>(rows);
  auto* a = static_cast<int*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (planes <= 1) {
    launch_stats<1>(wide, c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 2) {
    launch_stats<2>(wide, c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 4) {
    launch_stats<4>(wide, c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 8) {
    launch_stats<8>(wide, c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 16) {
    launch_stats<16>(wide, c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else {
    launch_stats<32>(wide, c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int PB>
void launch_apply(int* ctrl, const int* packed, int* acc, int* back, int vl,
                  int planes, int k, int fail_valid, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((vl + kThreads - 1) / kThreads);
  ring_apply_kernel<PB><<<blocks, kThreads, 0, stream>>>(
      ctrl, packed, acc, back, vl, planes, k, fail_valid);
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// ctrl: int32[19] (kernels/shard.py's control block; read only);
// block: int32[vl + 1]; packed: int32[vl]; table: int32[nrows, width] of
// combined entries; rows: int32[nrows] local row ids (sentinel vl) or null
// (then nrows == vl); acc: int32[2 * planes + 1, vl]; wide: K24 (one warp
// per row) rather than K23.
int dgc_ring_stats(const void* ctrl, const void* block, const void* packed,
                   const void* table, const void* rows, int nrows, int width,
                   int vl, void* acc, int planes, int wide, void* stream) {
  return stats(wide != 0, ctrl, block, packed, table, rows, nrows, width, vl,
               acc, planes, stream);
}

// ctrl: int32[19]; packed, back: int32[vl]; acc: int32[2 * planes + 1, vl]
// (read, then zeroed).
int dgc_ring_apply(void* ctrl, const void* packed, void* acc, void* back,
                   int vl, int planes, int k, int fail_valid, void* stream) {
  if (vl <= 0 || planes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* c = static_cast<int*>(ctrl);
  const auto* pk = static_cast<const int*>(packed);
  auto* a = static_cast<int*>(acc);
  auto* bk = static_cast<int*>(back);
  auto st = static_cast<cudaStream_t>(stream);
  if (planes <= 1) {
    launch_apply<1>(c, pk, a, bk, vl, planes, k, fail_valid, st);
  } else if (planes <= 2) {
    launch_apply<2>(c, pk, a, bk, vl, planes, k, fail_valid, st);
  } else if (planes <= 4) {
    launch_apply<4>(c, pk, a, bk, vl, planes, k, fail_valid, st);
  } else if (planes <= 8) {
    launch_apply<8>(c, pk, a, bk, vl, planes, k, fail_valid, st);
  } else if (planes <= 16) {
    launch_apply<16>(c, pk, a, bk, vl, planes, k, fail_valid, st);
  } else {
    launch_apply<32>(c, pk, a, bk, vl, planes, k, fail_valid, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
