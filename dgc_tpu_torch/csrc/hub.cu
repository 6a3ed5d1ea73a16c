// The hub region's kernels for Hopper (sm_90a), with a plain C interface
// for ctypes (dgc_tpu_torch/kernels/hub.py).
//
// Replaces the hub ladder of the JAX package's staged engine (B6):
// dgc_tpu/engine/compact.py:713 _hub_dispatch with its branches (:274
// _bucket_update, :691 _compact_core / :672 _bucket_update_compact, :637
// _bucket_update_rebase, :573 _bucket_update_pruned, :608
// _bucket_update_shrink), :854 _uncond_hub_step, and the hub loops of
// :891 _hybrid_superstep and :1074 _hub_region_step:
//   K7 hub_slots     — one block per hub bucket: the branch of its ladder
//                      from its live count and prune tier (:776-809), the
//                      copy of its rows from buffer `cur` into the other
//                      one, and the slot list the branch needs (:288
//                      _compact_idx over its active rows for compact and
//                      rebase, over tier 1's active slots for shrink,
//                      :626-631).
//   K8 hub_superstep — a warp per row (or slot) of every bucket's branch:
//                      the rule of rule.cuh's warp_row_rule against the
//                      `cur` snapshot, seeded with the captured confirmed
//                      planes on the pruned branches; the rebase capture
//                      (:646-663) and the shrink copy (:629-631); the
//                      fail, active and mc counts into the control block
//                      and the bucket's active count into the live table.
//                      Its recording variant (kRecord, B11: the unconf
//                      telemetry of compact.py:257 _unconf_max as every
//                      branch computes it, :274-284, :574-604, :715-795)
//                      also takes, over the rows a branch evaluates that
//                      were active before the step, the max count of
//                      unconfirmed real neighbors among the entries the
//                      branch reads (the table row, or the pruned row's
//                      captured list), into the bucket's column of the
//                      unconf vector `umax`; K6 writes it into the
//                      trajectory row (compact.cu).
//
// Why the copy. Every branch but full updates only some rows of a bucket,
// and the state buffers flip after each superstep, so K7 copies the whole
// bucket from `cur` into the other buffer before K8 writes the rows it
// evaluates: rows it skips then hold their current word in both buffers.
// A confirmed row transitions to itself and counts nothing
// (dgc_tpu/ops/speculative.py:80-107), so K8 returns before reading its
// entries: an inert bucket costs its copy only.
//
// Unconditioned buckets (tables <= HUB_UNCOND_ENTRIES) take full every
// superstep with no gate, as _uncond_hub_step does, in the same launches.
// The branch is chosen on the card: the host enqueues K7 and K8 with the
// flat region's K5 and K6 and syncs once per chunk of supersteps. K7 and K8
// return at once when the stage is not live (rule.cuh stage_live).
//
// Bounds (PERF.md has the measured times). K8 must read each evaluated
// row's entries once, the state word behind each and the row's own word,
// and write the row; K7 reads and writes each hub row's word. At 1M RMAT
// (7 hub buckets, 6,203 rows, 9.3M table entries) a full superstep of the
// hub region is ~74 MB (~22 us at 3.35 TB/s); once the hubs confirm it is
// their ~50 KB copy. A hub row is 512 to 65,536 entries wide and a bucket
// may hold one row, so K8 gives each row a warp: lanes read strided
// entries, the planes are OR-reduced over the warp (__reduce_or_sync) and
// the clash any-reduced; the rebase capture's column order comes from a
// ballot and a popcount prefix. Written to be right and simple: one warp
// per row, not yet a block per very wide row.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "rule.cuh"
#include "traj.cuh"

namespace {

using namespace dgc;  // control block, statuses, live table, stage_live

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the branches (BRANCH_* in engine/hub.py)
constexpr int kSkip = 0;
constexpr int kFull = 1;
constexpr int kCompact = 2;
constexpr int kRebase = 3;
constexpr int kPruned = 4;
constexpr int kShrink = 5;
constexpr int kPruned2 = 6;

// the ladders (KIND_* in kernels/hub.py)
constexpr int kUncond = 0;
constexpr int kPadLadder = 1;

// a descriptor row (HubBucket in kernels/hub.py), int64
constexpr int dRow0 = 0;
constexpr int dRows = 1;
constexpr int dWidth = 2;
constexpr int dPlanes = 3;
constexpr int dCb = 4;
constexpr int dKind = 5;
constexpr int dPad = 6;
constexpr int dU = 7;
constexpr int dP2 = 8;
constexpr int dSlots = 9;
constexpr int dSel = 10;
constexpr int dSlots1 = 11;
constexpr int dComb1 = 12;
constexpr int dConf1 = 13;
constexpr int dSlots2 = 14;
constexpr int dComb2 = 15;
constexpr int dConf2 = 16;
constexpr int kDescCols = 17;

__device__ __forceinline__ bool is_active(int word) {
  return word < 0 || (word & 1) != 0;
}

// engine/hub.py hub_branch: the index of _hub_dispatch (compact.py:746-809)
__device__ __forceinline__ int hub_branch(int kind, int ba, int tier,
                                          int rows, int pad, int p2) {
  if (kind == kUncond) return kFull;
  if (ba == 0) return kSkip;
  if (kind == kPadLadder) {
    return pad > 0 && ba <= pad ? kCompact : kFull;
  }
  if (p2 > 0) {
    if (tier == 2) return kPruned2;
    if (tier == 1) return ba <= p2 ? kShrink : kPruned;
  } else if (tier == 1) {
    return kPruned;
  }
  return ba <= pad || pad >= rows ? kRebase : kFull;
}

// Ordered compaction of the positions i < n where pred(i) holds into
// out[0, pad), the rest of out set to `dummy` (_compact_idx), by one block.
template <class Pred>
__device__ void block_compact(int n, Pred pred, int* __restrict__ out,
                              int pad, int dummy) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const bool a = i < n && pred(i);
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, a);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int off = s_base;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += s_warp[w];
      total += s_warp[w];
    }
    if (a) {
      const int pos = off + __popc(bal & ((1u << lane) - 1u));
      if (pos < pad) out[pos] = i;  // actives past pad are dropped
    }
    __syncthreads();
    if (threadIdx.x == 0) s_base += total;
    __syncthreads();
  }
  const int count = s_base;
  for (int i = min(count, pad) + threadIdx.x; i < pad; i += kThreads) {
    out[i] = dummy;
  }
}

// ---- K7: branch, copy, slot lists -----------------------------------------

__global__ void __launch_bounds__(kThreads)
hub_slots_kernel(const int* ctrl, int* state, size_t stride,
                 const long long* __restrict__ desc, int* __restrict__ live,
                 int nb, int* __restrict__ pool, int thresh, int max_steps) {
  if (!stage_live(ctrl, thresh, max_steps)) return;
  const int bi = blockIdx.x;
  const long long* d = desc + static_cast<size_t>(bi) * kDescCols;
  const int row0 = static_cast<int>(d[dRow0]);
  const int rows = static_cast<int>(d[dRows]);
  const int pad = static_cast<int>(d[dPad]);
  const int p2 = static_cast<int>(d[dP2]);
  const int tier = live[kLiveTier * nb + bi];
  const int branch = hub_branch(static_cast<int>(d[dKind]),
                                live[kLiveBa * nb + bi], tier, rows, pad, p2);
  const int cur = ctrl[kCur];
  const int* __restrict__ src = state + cur * stride + row0;
  int* __restrict__ dst = state + (1 - cur) * stride + row0;
  for (int i = threadIdx.x; i < rows; i += kThreads) dst[i] = src[i];
  if (threadIdx.x == 0) {
    live[kLiveBranch * nb + bi] = branch;
    live[kLiveBaNext * nb + bi] = 0;
    live[kLiveTierNext * nb + bi] =
        branch == kRebase ? 1 : (branch == kShrink ? 2 : tier);
  }
  if (branch == kCompact || branch == kRebase) {
    block_compact(
        rows, [&](int i) { return is_active(src[i]); }, pool + d[dSlots],
        pad, rows);
  } else if (branch == kShrink) {
    const int* slots1 = pool + d[dSlots1];
    block_compact(
        pad,
        [&](int j) {
          const int s = slots1[j];
          return s < rows && is_active(src[s]);
        },
        pool + d[dSel], p2, pad);
  }
}

// ---- K8: the branches' rows ----------------------------------------------

template <int PB, bool kRecord>
__global__ void __launch_bounds__(kThreads)
hub_superstep_kernel(int* ctrl, int* state, size_t stride,
                     const int* __restrict__ table,
                     const long long* __restrict__ desc, int* live, int nb,
                     int* __restrict__ pool, int v, int k, int thresh,
                     int max_steps, int* umax) {
  if (!stage_live(ctrl, thresh, max_steps)) return;
  const int bi = blockIdx.y;
  const int branch = live[kLiveBranch * nb + bi];
  if (branch == kSkip) return;
  const long long* d = desc + static_cast<size_t>(bi) * kDescCols;
  const int rows = static_cast<int>(d[dRows]);
  const int pad = static_cast<int>(d[dPad]);
  const int p2 = static_cast<int>(d[dP2]);
  const int items = branch == kFull ? rows
                    : (branch == kShrink || branch == kPruned2) ? p2 : pad;
  if (static_cast<int>(blockIdx.x) * kWarps >= items) return;  // uniform

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kWarps + warp;
  const int row0 = static_cast<int>(d[dRow0]);
  const int w = static_cast<int>(d[dWidth]);
  const int planes = static_cast<int>(d[dPlanes]);
  const int u = static_cast<int>(d[dU]);
  const int* __restrict__ cb = table + d[dCb];
  const int cur = ctrl[kCur];
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ dst = state + (1 - cur) * stride;

  // the warp's row r of the bucket (-1: none or a dummy slot), its entries
  // and the planes it is seeded with
  int r = -1;
  const int* row = nullptr;
  int width = w;
  const uint32_t* seed = nullptr;
  int* comb_out = nullptr;      // rebase: the capture's neighbor list
  uint32_t* conf_out = nullptr;  // rebase: its confirmed planes
  if (item < items) {
    if (branch == kFull) {
      r = item;
    } else if (branch == kCompact || branch == kRebase) {
      r = pool[d[dSlots] + item];
      if (branch == kRebase) {
        comb_out = pool + d[dComb1] + static_cast<size_t>(item) * u;
        conf_out = reinterpret_cast<uint32_t*>(
            pool + d[dConf1] + static_cast<size_t>(item) * planes);
      }
    } else if (branch == kPruned || branch == kPruned2) {
      const bool t2 = branch == kPruned2;
      const long long j = item;
      r = pool[d[t2 ? dSlots2 : dSlots1] + j];
      row = pool + d[t2 ? dComb2 : dComb1] + j * u;
      seed = reinterpret_cast<const uint32_t*>(
          pool + d[t2 ? dConf2 : dConf1] + j * planes);
      width = u;
    } else {  // shrink: tier 1's slot sel[item] into tier 2's slot item
      const int s = pool[d[dSel] + item];
      int* comb2 = pool + d[dComb2] + static_cast<size_t>(item) * u;
      int* conf2 = pool + d[dConf2] + static_cast<size_t>(item) * planes;
      if (s < pad) {
        const int* comb1 = pool + d[dComb1] + static_cast<size_t>(s) * u;
        const int* conf1 = pool + d[dConf1] + static_cast<size_t>(s) * planes;
        for (int j = lane; j < u; j += 32) comb2[j] = comb1[j];
        for (int p = lane; p < planes; p += 32) conf2[p] = conf1[p];
        r = pool[d[dSlots1] + s];
        row = comb1;
        seed = reinterpret_cast<const uint32_t*>(conf1);
        width = u;
      } else {
        for (int j = lane; j < u; j += 32) comb2[j] = v;
        for (int p = lane; p < planes; p += 32) conf2[p] = 0;
        r = rows;
      }
      if (lane == 0) pool[d[dSlots2] + item] = r;
    }
    if (r >= rows) {  // a dummy slot: confirmed color 0, no write
      if (comb_out != nullptr) {
        for (int j = lane; j < u; j += 32) comb_out[j] = v;
        for (int p = lane; p < planes; p += 32) conf_out[p] = 0u;
      }
      r = -1;
    } else if (row == nullptr) {
      row = cb + static_cast<size_t>(r) * w;
    }
  }

  bool fail = false;
  bool active = false;
  int mc = -1;
  int unconf = 0;  // kRecord: the row's unconfirmed real neighbors (lane 0)
  const int me = r >= 0 ? src[row0 + r] : 0;
  if constexpr (kRecord) {
    if (r >= 0 && is_active(me)) {  // uniform over the warp
      int cnt = 0;
      for (int j = lane; j < width; j += 32) {
        const int nbr = row[j] & kNbrMask;
        if (nbr < v && !is_confirmed(src[nbr])) ++cnt;
      }
      unconf = static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, cnt));
    }
  }
  // a confirmed row changes nothing and counts nothing; a rebase slot is
  // evaluated all the same, for its capture
  if (r >= 0 && (is_active(me) || comb_out != nullptr)) {
    const RowResult res =
        warp_row_rule<PB>(src, row, width, planes, k, me, seed, conf_out);
    if (lane == 0) dst[row0 + r] = res.next;
    const long long window = 32LL * planes;
    fail = res.fail && (window >= w + 1LL || k <= window);
    active = res.active;
    mc = res.mc;
    if (comb_out != nullptr) {
      // the unconfirmed real neighbors, in column order, into the first
      // u slots of the capture; the rest the pad sentinel v
      int cnt = 0;
      for (int j0 = 0; j0 < w; j0 += 32) {
        const int j = j0 + lane;
        bool un = false;
        int e = 0;
        if (j < w) {
          e = row[j];
          const int nbr = e & kNbrMask;
          if (nbr < v) {
            const int word = src[nbr];
            un = !(word >= 0 && (word & 1) == 0);
          }
        }
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, un);
        if (un) {
          const int pos = cnt + __popc(bal & ((1u << lane) - 1u));
          if (pos < u) comb_out[pos] = e;
        }
        cnt += __popc(bal);
      }
      for (int j = min(cnt, u) + lane; j < u; j += 32) comb_out[j] = v;
      if (lane == 0 && cnt > u) live[kLiveTierNext * nb + bi] = 0;
    }
  }

  __shared__ int s_fail[kWarps];
  __shared__ int s_active[kWarps];
  __shared__ int s_mc[kWarps];
  __shared__ int s_unconf[kWarps];
  if (lane == 0) {
    s_fail[warp] = fail;
    s_active[warp] = active;
    s_mc[warp] = mc;
    if constexpr (kRecord) s_unconf[warp] = unconf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nfail = 0;
    int nactive = 0;
    int bmax = -1;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      nfail += s_fail[i];
      nactive += s_active[i];
      bmax = max(bmax, s_mc[i]);
    }
    if (nfail) atomicAdd(ctrl + kFail, nfail);
    if (nactive) {
      atomicAdd(ctrl + kActive, nactive);
      atomicAdd(live + kLiveBaNext * nb + bi, nactive);
    }
    if (bmax >= 0) atomicMax(ctrl + kMc, bmax);
    if constexpr (kRecord) {
      int bun = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) bun = max(bun, s_unconf[i]);
      if (bun > 0) atomicMax(umax + bi, bun);
    }
  }
}

template <int PB, bool kRecord>
void launch_hub(dim3 grid, cudaStream_t stream, int* ctrl, int* state,
                int stride, const int* table, const long long* desc,
                int* live, int nb, int* pool, int k, int thresh,
                int max_steps, int* umax) {
  hub_superstep_kernel<PB, kRecord><<<grid, kThreads, 0, stream>>>(
      ctrl, state, static_cast<size_t>(stride), table, desc, live, nb, pool,
      stride - 2, k, thresh, max_steps, umax);
}

// K8 at the plane count that holds max_planes
template <bool kRecord>
int dispatch_hub(void* ctrl, void* state, int stride, const void* table,
                 const void* desc, int nh, void* live, int nb, void* pool,
                 int max_rows, int max_planes, int k, int thresh,
                 int max_steps, int* umax, void* stream) {
  if (nh <= 0 || nh > 65535 || nb < nh || max_rows <= 0 || max_planes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((max_rows + kWarps - 1) / kWarps),
                  static_cast<unsigned>(nh));
  auto* c = static_cast<int*>(ctrl);
  auto* s = static_cast<int*>(state);
  const auto* t = static_cast<const int*>(table);
  const auto* dd = static_cast<const long long*>(desc);
  auto* l = static_cast<int*>(live);
  auto* p = static_cast<int*>(pool);
  auto st = static_cast<cudaStream_t>(stream);
  if (max_planes <= 1) {
    launch_hub<1, kRecord>(grid, st, c, s, stride, t, dd, l, nb, p, k, thresh,
                           max_steps, umax);
  } else if (max_planes <= 2) {
    launch_hub<2, kRecord>(grid, st, c, s, stride, t, dd, l, nb, p, k, thresh,
                           max_steps, umax);
  } else if (max_planes <= 4) {
    launch_hub<4, kRecord>(grid, st, c, s, stride, t, dd, l, nb, p, k, thresh,
                           max_steps, umax);
  } else if (max_planes <= 8) {
    launch_hub<8, kRecord>(grid, st, c, s, stride, t, dd, l, nb, p, k, thresh,
                           max_steps, umax);
  } else if (max_planes <= 16) {
    launch_hub<16, kRecord>(grid, st, c, s, stride, t, dd, l, nb, p, k,
                            thresh, max_steps, umax);
  } else {
    launch_hub<32, kRecord>(grid, st, c, s, stride, t, dd, l, nb, p, k,
                            thresh, max_steps, umax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// state: int32[2, stride]; desc: int64[nh, 17]; live: int32[5, nb];
// pool: the plan's int32 pool.
int dgc_hub_slots(const void* ctrl, void* state, int stride, const void* desc,
                  int nh, void* live, int nb, void* pool, int thresh,
                  int max_steps, void* stream) {
  if (nh <= 0 || nb < nh) return static_cast<int>(cudaErrorInvalidValue);
  hub_slots_kernel<<<static_cast<unsigned>(nh), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ctrl), static_cast<int*>(state),
      static_cast<size_t>(stride), static_cast<const long long*>(desc),
      static_cast<int*>(live), nb, static_cast<int*>(pool), thresh,
      max_steps);
  return static_cast<int>(cudaGetLastError());
}

// table: the hub buckets' tables (int32, at each descriptor's offset);
// max_rows: the most rows of a bucket; max_planes: the widest window;
// umax: int32[>= nh], the unconf vector of the recording variant (kRecord),
// or null for the plain K8.
int dgc_hub_superstep(void* ctrl, void* state, int stride, const void* table,
                      const void* desc, int nh, void* live, int nb,
                      void* pool, int max_rows, int max_planes, int k,
                      int thresh, int max_steps, void* umax, void* stream) {
  if (umax == nullptr) {
    return dispatch_hub<false>(ctrl, state, stride, table, desc, nh, live, nb,
                               pool, max_rows, max_planes, k, thresh,
                               max_steps, nullptr, stream);
  }
  return dispatch_hub<true>(ctrl, state, stride, table, desc, nh, live, nb,
                            pool, max_rows, max_planes, k, thresh, max_steps,
                            static_cast<int*>(umax), stream);
}

}  // extern "C"
