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
//   K24 ring_stats_wide — the same function over all of a rotation's
//                         tables wider than kernels.ring.WIDE_WIDTH (the
//                         heavy-tail buckets), in one launch: one block per
//                         item of a work list of (row, chunk of at most C
//                         real entries), so a hub row is split over as
//                         many blocks as its real length needs and no
//                         sentinel chunk is read.
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
// `acc` int32[2P + 2, V_l], plane-major: P planes of forb_all, P of
// forb_old (as uint32 bit patterns), the clash flags (0 or 1), then the
// touched-plane masks: bit b of a row's mask is set once a stats kernel
// ORed a nonzero word into plane p of its forb_all or forb_old, b = p >> S
// with S the least shift such that 32 << S >= P (one plane a bit up to 32
// planes). A table is int32[rows, W] of combined entries, the block-local
// neighbor id with the beats bit at 30 (rule.cuh kBeatsBit; V_l < 2^30);
// with a rows list (int32[rows], sentinel V_l: a padding row, skipped)
// table row j belongs to local row rows[j], else to local row j. Every
// row appears at most once in the tables of one rotation, so K23 ORs into
// its accumulators without atomics; K24's blocks of one row OR theirs with
// atomicOr. K25 reads the touched planes, the clash flag and the mask and
// writes them back to 0, so every accumulator is zero at every
// superstep's start (and after a launch past the attempt's end, which
// returns at once as every kernel here does).
//
// K24's work list (kernels.ring.wide_work_list, built once on the host
// from the static tables): int32[items, 4] of (local row, entry count n,
// the low and high words of the offset of the chunk's first entry in the
// rotation's wide entries, the wide tables concatenated), a row's chunks
// of C entries over its real length (up to its last non-sentinel entry).
//
// Bounds (PERF.md has the measured times): K23/K24 read the real entries
// of their table (the flat layout's padding is not work, as for K1), a
// block word per real entry, a packed word per row, and read and write
// the accumulator words and the mask the row's stats make nonzero (write
// the clash flag where set); K25 reads each row's word, mask and clash
// flag and the accumulator words of its touched planes, zeroes those that
// are nonzero, and writes its new word. Design: K23 is one thread per row;
// K24 reads a chunk with 16-byte loads (each thread's four gathers into
// the L2-resident block independent), folds colors below 64 in registers
// (OR-reduced over the warp) and the higher planes into a shared bitmask,
// and flushes each nonzero word with one atomicOr; K25 walks only the set
// bits of the mask, with no plane registers, so a row whose mask is 0 or
// 1 costs a few words. What still holds K24 above its byte bound is the
// gathers: each takes a whole 32-byte sector of the block from the L2
// (PERF.md §6).

#include <cuda_runtime.h>

#include <cstdint>

#include "rule.cuh"

namespace {

using namespace dgc;  // the control block's first slots and statuses

constexpr int kThreads = 256;
// K24's planes held in shared memory; a color at or past 32 * this (only
// in a window widened past 32 planes) is ORed into the accumulators
// directly
constexpr int kSharedPlanes = 32;

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

// log2 of the planes a bit of the touched-plane mask covers.
__device__ __forceinline__ int mask_shift(int planes) {
  int shift = 0;
  while ((32 << shift) < planes) ++shift;
  return shift;
}

// The mask bits of the planes base + p for the bits p of `planes_set`.
__device__ __forceinline__ uint32_t mask_bits(uint32_t planes_set, int base,
                                              int planes) {
  if (planes <= 32) return planes_set << base;  // one plane a bit
  const int shift = mask_shift(planes);
  uint32_t bits = 0u;
  for (; planes_set != 0u; planes_set &= planes_set - 1u) {
    bits |= 1u << ((base + __ffs(planes_set) - 1) >> shift);
  }
  return bits;
}

// OR one plane group of a row's stats into its accumulators; the mask
// bits of the planes it touched into `touched`.
template <int PB>
__device__ __forceinline__ void or_planes(int* __restrict__ acc, int vl,
                                          int r, int base, int planes,
                                          const uint32_t (&fa)[PB],
                                          const uint32_t (&fo)[PB],
                                          uint32_t& touched) {
  const size_t stride = static_cast<size_t>(vl);
  uint32_t planes_set = 0u;  // bit p: plane base + p took a nonzero word
#pragma unroll
  for (int p = 0; p < PB; ++p) {
    const int pg = base + p;
    if (pg < planes) {
      if (fa[p] != 0u) acc[pg * stride + r] |= static_cast<int>(fa[p]);
      if (fo[p] != 0u) {
        acc[(planes + pg) * stride + r] |= static_cast<int>(fo[p]);
      }
      if ((fa[p] | fo[p]) != 0u) planes_set |= 1u << p;
    }
  }
  if (planes_set != 0u) touched |= mask_bits(planes_set, base, planes);
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
  uint32_t touched = 0u;
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
    or_planes<PB>(acc, vl, r, base, planes, fa, fo, touched);
  }
  const size_t stride = static_cast<size_t>(vl);
  if (clash) acc[2 * planes * stride + r] = 1;
  if (touched != 0u) {
    acc[(2 * planes + 1) * stride + r] |= static_cast<int>(touched);
  }
}

// ---- K24: a rotation's wide tables, one block per (row, chunk) ------------

__global__ void __launch_bounds__(kThreads)
ring_stats_wide_kernel(const int* ctrl, const int* __restrict__ block,
                       const int* __restrict__ packed,
                       const int* __restrict__ entries,
                       const int4* __restrict__ work, int vl,
                       int* __restrict__ acc, int planes) {
  if (ctrl[kStatus] != kRunning) return;  // uniform over the grid
  __shared__ uint32_t s_fa[kSharedPlanes];
  __shared__ uint32_t s_fo[kSharedPlanes];
  __shared__ int s_clash;
  const int tid = threadIdx.x;
  if (tid < kSharedPlanes) {
    s_fa[tid] = 0u;
    s_fo[tid] = 0u;
  }
  if (tid == 0) s_clash = 0;
  const int4 item = __ldg(work + blockIdx.x);
  const int r = item.x;
  const int n = item.y;
  const long long off = static_cast<long long>(
      static_cast<unsigned long long>(static_cast<unsigned>(item.z)) |
      (static_cast<unsigned long long>(static_cast<unsigned>(item.w)) << 32));
  const int* __restrict__ chunk = entries + off;
  const int mycol = __ldg(packed + r) >> 1;
  const int window = 32 * planes;
  const int shift = mask_shift(planes);
  const size_t stride = static_cast<size_t>(vl);
  __syncthreads();  // the shared planes are zero before any thread ORs

  uint32_t fa0 = 0u, fa1 = 0u, fo0 = 0u, fo1 = 0u;
  bool clash = false;
  auto add = [&](int e) {
    const int word = __ldg(block + (e & kNbrMask));
    if (word < 0) return;  // uncolored neighbor or the sentinel's slot
    const int c = word >> 1;
    const bool fresh = (word & 1) != 0;
    if (fresh && c == mycol && (e >> kBeatsBit) != 0) clash = true;
    if (c >= window) return;  // past the window: no plane
    const uint32_t bit = 1u << (c & 31);
    const int p = c >> 5;
    if (p == 0) {
      fa0 |= bit;
      if (!fresh) fo0 |= bit;
    } else if (p == 1) {
      fa1 |= bit;
      if (!fresh) fo1 |= bit;
    } else if (p < kSharedPlanes) {
      atomicOr(s_fa + p, bit);
      if (!fresh) atomicOr(s_fo + p, bit);
    } else {
      atomicOr(acc + p * stride + r, static_cast<int>(bit));
      if (!fresh) {
        atomicOr(acc + (planes + p) * stride + r, static_cast<int>(bit));
      }
      atomicOr(acc + (2 * planes + 1) * stride + r,
               static_cast<int>(1u << (p >> shift)));
    }
  };
  // 16-byte loads over the chunk's whole quads when it is aligned, the
  // rest one entry a thread
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(chunk) & 15u) == 0u) {
    head = n & ~3;
    const int4* __restrict__ quads = reinterpret_cast<const int4*>(chunk);
#pragma unroll 2
    for (int i = tid; i < (head >> 2); i += kThreads) {
      const int4 q = __ldg(quads + i);
      add(q.x);
      add(q.y);
      add(q.z);
      add(q.w);
    }
  }
  for (int i = head + tid; i < n; i += kThreads) add(__ldg(chunk + i));

  fa0 = __reduce_or_sync(0xFFFFFFFFu, fa0);
  fa1 = __reduce_or_sync(0xFFFFFFFFu, fa1);
  fo0 = __reduce_or_sync(0xFFFFFFFFu, fo0);
  fo1 = __reduce_or_sync(0xFFFFFFFFu, fo1);
  clash = __any_sync(0xFFFFFFFFu, clash);
  if ((tid & 31) == 0) {
    if (fa0 != 0u) atomicOr(s_fa, fa0);
    if (fo0 != 0u) atomicOr(s_fo, fo0);
    if (fa1 != 0u) atomicOr(s_fa + 1, fa1);
    if (fo1 != 0u) atomicOr(s_fo + 1, fo1);
    if (clash) s_clash = 1;
  }
  __syncthreads();
  if (tid < 32) {  // warp 0 flushes the shared planes, one a lane
    uint32_t a = 0u;
    uint32_t o = 0u;
    if (tid < planes) {  // tid < kSharedPlanes == 32
      a = s_fa[tid];
      o = s_fo[tid];
      if (a != 0u) atomicOr(acc + tid * stride + r, static_cast<int>(a));
      if (o != 0u) {
        atomicOr(acc + (planes + tid) * stride + r, static_cast<int>(o));
      }
    }
    const uint32_t touched = __reduce_or_sync(
        0xFFFFFFFFu, (a | o) != 0u ? 1u << (tid >> shift) : 0u);
    if (tid == 0) {
      if (touched != 0u) {
        atomicOr(acc + (2 * planes + 1) * stride + r,
                 static_cast<int>(touched));
      }
      if (s_clash) acc[2 * planes * stride + r] = 1;
    }
  }
}

// ---- K25: the state transition from the accumulated stats -----------------

// One touched plane p into the first fit: its words read and, where
// nonzero, zeroed.
__device__ __forceinline__ void fold_touched(int* __restrict__ acc,
                                             size_t stride, int r, int p,
                                             int planes, int k, bool& found,
                                             int& cand, bool& old_free) {
  int* a = acc + p * stride + r;
  int* o = acc + (planes + p) * stride + r;
  const uint32_t fa = static_cast<uint32_t>(*a);
  const uint32_t fo = static_cast<uint32_t>(*o);
  if (fa != 0u) *a = 0;
  if (fo != 0u) *o = 0;
  const uint32_t m = plane_mask(k, p);
  const uint32_t free_all = ~fa & m;
  if (!found && free_all != 0u) {  // the planes come in ascending order
    found = true;
    cand = 32 * p + __ffs(free_all) - 1;
  }
  if ((~fo & m) != 0u) old_free = true;
}

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
    const int shift = mask_shift(planes);
    const int ngroups = ((planes - 1) >> shift) + 1;
    const uint32_t live = ngroups >= 32 ? 0xFFFFFFFFu : (1u << ngroups) - 1u;
    int* mrow = acc + (2 * planes + 1) * stride + r;
    int* crow = acc + 2 * planes * stride + r;
    const uint32_t mask = static_cast<uint32_t>(*mrow);
    const bool clash = *crow != 0;
    if (mask != 0u) *mrow = 0;
    if (clash) *crow = 0;
    bool found = false;
    int cand = k;
    bool old_free = false;
    for (uint32_t bits = mask & live; bits != 0u; bits &= bits - 1u) {
      const int b = __ffs(bits) - 1;
      const int stop = min((b + 1) << shift, planes);
      for (int p = b << shift; p < stop; ++p) {
        fold_touched(acc, stride, r, p, planes, k, found, cand, old_free);
      }
    }
    // the first untouched plane folds as zero: every color of it is free
    // under k, and every later untouched plane's colors are larger
    const uint32_t untouched = ~mask & live;
    if (untouched != 0u) {
      const int u = (__ffs(untouched) - 1) << shift;
      if (plane_mask(k, u) != 0u) {
        if (!found || 32 * u < cand) cand = 32 * u;
        found = true;
        old_free = true;
      }
    }
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
void launch_stats(const int* ctrl, const int* block, const int* packed,
                  const int* table, const int* rows, int nrows, int width,
                  int vl, int* acc, int planes, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((nrows + kThreads - 1) / kThreads);
  ring_stats_kernel<PB><<<blocks, kThreads, 0, stream>>>(
      ctrl, block, packed, table, rows, nrows, width, vl, acc, planes);
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// K23. ctrl: int32[19] (kernels/shard.py's control block; read only);
// block: int32[vl + 1]; packed: int32[vl]; table: int32[nrows, width] of
// combined entries; rows: int32[nrows] local row ids (sentinel vl) or null
// (then nrows == vl); acc: int32[2 * planes + 2, vl].
int dgc_ring_stats(const void* ctrl, const void* block, const void* packed,
                   const void* table, const void* rows, int nrows, int width,
                   int vl, void* acc, int planes, void* stream) {
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
    launch_stats<1>(c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 2) {
    launch_stats<2>(c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 4) {
    launch_stats<4>(c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 8) {
    launch_stats<8>(c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else if (planes <= 16) {
    launch_stats<16>(c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  } else {
    launch_stats<32>(c, b, pk, t, rw, nrows, width, vl, a, planes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// K24. entries: the rotation's wide tables' entries, concatenated; work:
// int32[nitems, 4] (row, count, offset low, offset high; 16-byte aligned);
// the rest as dgc_ring_stats.
int dgc_ring_stats_wide(const void* ctrl, const void* block,
                        const void* packed, const void* entries,
                        const void* work, int nitems, int vl, void* acc,
                        int planes, void* stream) {
  if (nitems <= 0 || vl <= 0 || planes <= 0 ||
      (reinterpret_cast<uintptr_t>(work) & 15u) != 0u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ring_stats_wide_kernel<<<static_cast<unsigned>(nitems), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ctrl), static_cast<const int*>(block),
      static_cast<const int*>(packed), static_cast<const int*>(entries),
      static_cast<const int4*>(work), vl, static_cast<int*>(acc), planes);
  return static_cast<int>(cudaGetLastError());
}

// K25. ctrl: int32[19]; packed, back: int32[vl]; acc: int32[2 * planes +
// 2, vl] (the touched planes, the clash flags and the masks read, then
// zeroed).
int dgc_ring_apply(void* ctrl, const void* packed, void* acc, void* back,
                   int vl, int planes, int k, int fail_valid, void* stream) {
  if (vl <= 0 || planes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((vl + kThreads - 1) / kThreads);
  ring_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<const int*>(packed),
      static_cast<int*>(acc), static_cast<int*>(back), vl, planes, k,
      fail_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
