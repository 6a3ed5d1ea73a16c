// The ring-halo engine's per-rotation kernels for Hopper (sm_90a), with a
// plain C interface for ctypes (dgc_tpu_torch/kernels/ring.py).
//
// Replaces the per-shard parts of the jitted shard_map programs of the JAX
// package's ring engine (dgc_tpu/engine/ring.py):
//   K23 ring_stats      — B13g, ring.py:303-307 (flat: neighbor_stats of the
//                         shard's rows against the held block through
//                         rotation r's table, OR-folded into forb_all,
//                         forb_old and clash) and ring.py:355-368 (bucketed:
//                         the same on each bucket's row list, its
//                         gather-modify-scatter), over all of a rotation's
//                         tables of at most kernels.ring.WIDE_WIDTH in one
//                         launch: a team of lanes a row, sized by its
//                         table's width.
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
// atomicOr. Both skip a confirmed row (its word colored and not fresh):
// its accumulators and mask stay 0, and K25 transitions it to itself
// whatever they hold. K25 reads the touched planes, the clash flag and
// the mask and writes them back to 0, so every accumulator is zero at
// every superstep's start (and after a launch past the attempt's end,
// which returns at once as every kernel here does).
//
// K23's narrow layout (kernels.ring.NarrowTables, built once on the host
// from the static tables): the tables concatenated (`entries`), their row
// lists (`rows`, a flat table's 0 .. V_l - 1) and each table row's real
// length (`lens`, up to its last non-sentinel entry), and a descriptor a
// table, int64[nseg, 5] (its first row in `rows`, its rows, width, offset
// in `entries`, first warp). A table's rows take whole warps of 32 / lanes
// rows, lanes = team_lanes(width) (rule.cuh); a warp finds its table by a
// binary search over the first warps.
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
// are nonzero, and writes its new word. Design: K23 walks a row's real
// entries with its team in 16-byte quads, eight gathers in flight a lane
// (rule.cuh walk_row), two planes in registers OR-reduced over the team
// and 1-32 more in the team's shared words (add_word), a pass a group of
// 2 + lanes planes; the first pass takes the highest plane of any
// neighbor color over the warp, and no pass above it reads the row again
// (its planes are zero); the team's first lane ORs each nonzero plane
// into the accumulators and sets the mask. K24 reads a chunk with
// 16-byte loads (each thread's four gathers into the L2-resident block
// independent), folds colors below 64 in registers
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

// ---- K23: one rotation's narrow tables, a team of lanes a row -----------

// a descriptor row (NarrowTables.desc), int64
constexpr int dJ0 = 0;
constexpr int dRows = 1;
constexpr int dWidth = 2;
constexpr int dOff = 3;
constexpr int dWarp0 = 4;
constexpr int kDescCols = 5;

__global__ void __launch_bounds__(kThreads)
ring_stats_kernel(const int* ctrl, const int* __restrict__ block,
                  const int* __restrict__ packed,
                  const int* __restrict__ entries,
                  const int* __restrict__ rows, const int* __restrict__ lens,
                  const long long* __restrict__ desc, int nseg, int warps,
                  int vl, int* __restrict__ acc, int planes) {
  if (ctrl[kStatus] != kRunning) return;  // uniform over the grid
  __shared__ uint32_t s_rows[(kThreads / 32) * kTeamWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * (kThreads / 32) + warp;
  if (gw >= warps) return;  // a whole warp: no block-wide barrier follows
  int lo = 0;  // the table of this warp: the last whose first warp <= gw
  int hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(desc + static_cast<size_t>(mid) * kDescCols + dWarp0) <= gw) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long* d = desc + static_cast<size_t>(lo) * kDescCols;
  const int nrows = static_cast<int>(__ldg(d + dRows));
  const int width = static_cast<int>(__ldg(d + dWidth));
  const int lanes = team_lanes(width);
  const int sub = lane / lanes;       // the warp's row of this lane
  const int gl = lane & (lanes - 1);  // the lane in its row's group
  const int rs = static_cast<int>(gw - __ldg(d + dWarp0)) * (32 / lanes) + sub;
  const bool valid = rs < nrows;
  const long long j = __ldg(d + dJ0) + (valid ? rs : 0);
  const int r = valid ? __ldg(rows + j) : vl;
  const int me = r < vl ? __ldg(packed + r) : 0;
  // a padding row or a confirmed one reads nothing (uniform over the group)
  const bool walk = r < vl && !(me >= 0 && (me & 1) == 0);
  const int* __restrict__ row =
      entries + __ldg(d + dOff) + static_cast<size_t>(valid ? rs : 0) * width;
  uint32_t* s_fa = s_rows + warp * kTeamWords + sub * 2 * lanes;
  const int shift = mask_shift(planes);
  const size_t stride = static_cast<size_t>(vl);
  bool clash = false;
  uint32_t touched = 0u;
  group_passes(block, row, walk ? __ldg(lens + j) : 0, gl, lanes, vl, walk,
               planes, me >> 1, s_fa, s_fa + lanes, clash,
               [&](int pg, uint32_t fa, uint32_t fo) {
                 if (fa != 0u) acc[pg * stride + r] |= static_cast<int>(fa);
                 if (fo != 0u) {
                   acc[(planes + pg) * stride + r] |= static_cast<int>(fo);
                 }
                 if ((fa | fo) != 0u) touched |= 1u << (pg >> shift);
               });
  if (walk && gl == 0) {
    if (clash) acc[2 * planes * stride + r] = 1;
    if (touched != 0u) {
      acc[(2 * planes + 1) * stride + r] |= static_cast<int>(touched);
    }
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
  const int4 item = __ldg(work + blockIdx.x);
  const int r = item.x;
  const int me = __ldg(packed + r);
  if (me >= 0 && (me & 1) == 0) return;  // a confirmed row: uniform
  const int tid = threadIdx.x;
  if (tid < kSharedPlanes) {
    s_fa[tid] = 0u;
    s_fo[tid] = 0u;
  }
  if (tid == 0) s_clash = 0;
  const int n = item.y;
  const long long off = static_cast<long long>(
      static_cast<unsigned long long>(static_cast<unsigned>(item.z)) |
      (static_cast<unsigned long long>(static_cast<unsigned>(item.w)) << 32));
  const int* __restrict__ chunk = entries + off;
  const int mycol = me >> 1;
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

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// K23. ctrl: int32[19] (kernels/shard.py's control block; read only);
// block: int32[vl + 1]; packed: int32[vl]; entries, rows, lens, desc: the
// narrow layout (above), desc int64[nseg, 5]; warps: the last table's
// first warp plus its warps; acc: int32[2 * planes + 2, vl].
int dgc_ring_stats(const void* ctrl, const void* block, const void* packed,
                   const void* entries, const void* rows, const void* lens,
                   const void* desc, int nseg, int warps, int vl, void* acc,
                   int planes, void* stream) {
  if (nseg <= 0 || warps <= 0 || vl <= 0 || planes <= 0 ||
      rows == nullptr || lens == nullptr || desc == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kThreads / 32;
  ring_stats_kernel<<<static_cast<unsigned>((warps + per_block - 1) /
                                            per_block),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ctrl), static_cast<const int*>(block),
      static_cast<const int*>(packed), static_cast<const int*>(entries),
      static_cast<const int*>(rows), static_cast<const int*>(lens),
      static_cast<const long long*>(desc), nseg, warps, vl,
      static_cast<int*>(acc), planes);
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
