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
//   K8 hub_superstep — a warp or a block per row (or slot) of every
//                      bucket's branch (the design below):
//                      the rule against the `cur` snapshot, seeded
//                      with the captured confirmed planes on the pruned
//                      branches; the rebase capture
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
// may hold one row, and an unconditioned row is walked every superstep
// until it confirms, so one thread team's latency on the widest row sets
// the launch's time, not the bytes.
//
// The design. A bucket's items go one a warp or, from K8_BLOCK_WIDTH
// entries wide, one a block of 512 threads (kernels/hub.py lays the
// buckets' blocks out in the plan: dBlock0, dMode). A team walks only a
// row's real entries, up to the length the plan took once from the table
// (dLen0, `lens`: the last entry that is not the pad sentinel; the rest add
// no color, capture or count), in quads of 16-byte loads with eight gathers
// in flight a thread (rule.cuh walk_row); the fail gate still reads the
// padded width. A pass holds 32 planes, two in registers (OR-reduced over
// each warp, then into the block's shared words) and 30 in shared words
// (atomicOr). The recording variant counts in the same pass. The rebase capture keeps its column order by a
// ballot and popcount prefix a warp, or a block-wide prefix of the
// threads' counts per tile of quads.

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
constexpr int dLen0 = 17;    // the bucket's first row in `lens`
constexpr int dBlock0 = 18;  // its first block in K8's grid
constexpr int dMode = 19;    // how K8 deals its items (below)
constexpr int kDescCols = 20;

// K8: 512 threads a block; a bucket's items one a warp (kWarpItems) or one
// a block (kBlockItems), by its width (K8_* in kernels/hub.py)
constexpr int kK8Threads = 512;
constexpr int kK8Warps = kK8Threads / 32;
constexpr int kWarpItems = 0;
constexpr int kBlockItems = 1;
// a pass over a row holds 32 planes (1,024 colors, the widest window
// before one widens): kRegPlanes (2) in registers, 30 in shared words
constexpr int kPassPlanes = 32;
constexpr int kPassShared = kPassPlanes - kRegPlanes;

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

// An item of a bucket's branch: its row of the bucket (-1: none, or a
// dummy slot), the entries to walk (the table row up to its real length,
// or a pruned row's captured list of u), the planes it is seeded with and
// the rebase capture it writes.
struct Item {
  int r = -1;
  const int* row = nullptr;
  int len = 0;
  const uint32_t* seed = nullptr;
  int* comb_out = nullptr;       // rebase: the capture's neighbor list
  uint32_t* conf_out = nullptr;  // rebase: its confirmed planes
};

// Item `item` of bucket `d`'s branch; thread t of the item's team of n
// shares the shrink copy (tier 1's slot sel[item] into tier 2's slot item)
// and a dummy rebase slot's fill. Every thread of the team gets the same
// item.
__device__ Item hub_item(const long long* d, int branch, int item, int t,
                         int n, int* pool, const int* __restrict__ table,
                         const int* __restrict__ lens, int v) {
  Item it;
  const int rows = static_cast<int>(d[dRows]);
  const int pad = static_cast<int>(d[dPad]);
  const int w = static_cast<int>(d[dWidth]);
  const int planes = static_cast<int>(d[dPlanes]);
  const int u = static_cast<int>(d[dU]);
  int r;
  if (branch == kFull) {
    r = item;
  } else if (branch == kCompact || branch == kRebase) {
    r = pool[d[dSlots] + item];
    if (branch == kRebase) {
      it.comb_out = pool + d[dComb1] + static_cast<size_t>(item) * u;
      it.conf_out = reinterpret_cast<uint32_t*>(
          pool + d[dConf1] + static_cast<size_t>(item) * planes);
    }
  } else if (branch == kPruned || branch == kPruned2) {
    const bool t2 = branch == kPruned2;
    r = pool[d[t2 ? dSlots2 : dSlots1] + item];
    it.row = pool + d[t2 ? dComb2 : dComb1] + static_cast<size_t>(item) * u;
    it.seed = reinterpret_cast<const uint32_t*>(
        pool + d[t2 ? dConf2 : dConf1] + static_cast<size_t>(item) * planes);
    it.len = u;
  } else {  // shrink
    const int s = pool[d[dSel] + item];
    int* comb2 = pool + d[dComb2] + static_cast<size_t>(item) * u;
    int* conf2 = pool + d[dConf2] + static_cast<size_t>(item) * planes;
    if (s < pad) {
      const int* comb1 = pool + d[dComb1] + static_cast<size_t>(s) * u;
      const int* conf1 = pool + d[dConf1] + static_cast<size_t>(s) * planes;
      for (int j = t; j < u; j += n) comb2[j] = comb1[j];
      for (int p = t; p < planes; p += n) conf2[p] = conf1[p];
      r = pool[d[dSlots1] + s];
      it.row = comb1;
      it.seed = reinterpret_cast<const uint32_t*>(conf1);
      it.len = u;
    } else {
      for (int j = t; j < u; j += n) comb2[j] = v;
      for (int p = t; p < planes; p += n) conf2[p] = 0;
      r = rows;
    }
    if (t == 0) pool[d[dSlots2] + item] = r;
  }
  if (r >= rows) {  // a dummy slot: confirmed color 0, no write
    if (it.comb_out != nullptr) {
      for (int j = t; j < u; j += n) it.comb_out[j] = v;
      for (int p = t; p < planes; p += n) it.conf_out[p] = 0u;
    }
    return Item{};
  }
  it.r = r;
  if (it.row == nullptr) {
    it.row = table + d[dCb] + static_cast<size_t>(r) * w;
    it.len = lens[d[dLen0] + r];
  }
  return it;
}

// The block's counters into the control block and the bucket's staged
// live count; each warp's lane 0 holds its warp's (or the defaults).
template <bool kRecord>
__device__ void fold_counts(int* ctrl, int* live, int nb, int bi, int* umax,
                            bool fail, bool active, int mc, int unconf) {
  __shared__ int s_fail[kK8Warps];
  __shared__ int s_active[kK8Warps];
  __shared__ int s_mc[kK8Warps];
  __shared__ int s_unconf[kK8Warps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
    for (int i = 0; i < kK8Warps; ++i) {
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
      for (int i = 0; i < kK8Warps; ++i) bun = max(bun, s_unconf[i]);
      if (bun > 0) atomicMax(umax + bi, bun);
    }
  }
}

// A warp an item: kK8Warps items of the bucket from `first`.
template <bool kRecord>
__device__ void warp_items(int* ctrl, const int* __restrict__ src,
                           int* __restrict__ dst, const long long* d, int bi,
                           int branch, int first, int items, int* live,
                           int nb, int* pool, const int* __restrict__ table,
                           const int* __restrict__ lens, int v, int k,
                           int* umax) {
  __shared__ uint32_t s_rows[kK8Warps][2 * kPassShared];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = first + warp;
  const Item it = item < items
                      ? hub_item(d, branch, item, lane, 32, pool, table,
                                 lens, v)
                      : Item{};
  const int row0 = static_cast<int>(d[dRow0]);
  const int w = static_cast<int>(d[dWidth]);
  const int planes = static_cast<int>(d[dPlanes]);
  const int u = static_cast<int>(d[dU]);
  bool fail = false;
  bool active = false;
  int mc = -1;
  int unconf = 0;  // kRecord: the row's unconfirmed real neighbors
  const int me = it.r >= 0 ? src[row0 + it.r] : 0;
  // a confirmed row changes nothing and counts nothing; a rebase slot is
  // evaluated all the same, for its capture (uniform over the warp)
  if (it.r >= 0 && (is_active(me) || it.comb_out != nullptr)) {
    uint32_t* s_fa = s_rows[warp];
    uint32_t* s_fo = s_fa + kPassShared;
    const bool count = kRecord && is_active(me);
    const int mycol = me >> 1;
    bool clash = false;
    bool found = false;
    int cand = k;
    bool old_free = false;
    int cnt = 0;
    for (int base = 0; base < planes; base += kPassPlanes) {
      const int gp = min(kPassPlanes, planes - base);
      if (lane < kPassShared) {
        s_fa[lane] = 0u;
        s_fo[lane] = 0u;
      }
      __syncwarp();
      PlaneRegs pl;
      walk_row(src, it.row, it.len, lane, 32, v, [&](int e, int word) {
        add_word(e, word, base, gp, mycol, pl, s_fa, s_fo, clash);
        if (count && base == 0 && (e & kNbrMask) < v && !is_confirmed(word)) {
          ++cnt;
        }
      });
      pl.or_warp();
      __syncwarp();
      // every lane folds the same planes
      for (int p = 0; p < gp; ++p) {
        const bool reg = p < kRegPlanes;
        uint32_t fa = reg ? pl.fa(p) : s_fa[p - kRegPlanes];
        uint32_t fo = reg ? pl.fo(p) : s_fo[p - kRegPlanes];
        const int pg = base + p;
        if (it.conf_out != nullptr && lane == 0) it.conf_out[pg] = fo;
        if (it.seed != nullptr) {
          fa |= it.seed[pg];
          fo |= it.seed[pg];
        }
        fold_plane(fa, fo, pg, k, found, cand, old_free);
      }
      __syncwarp();
    }
    clash = __any_sync(0xFFFFFFFFu, clash);
    const RowResult res = finish_rule(me, clash, found, cand, old_free);
    if (lane == 0) dst[row0 + it.r] = res.next;
    const long long window = 32LL * planes;
    fail = res.fail && (window >= w + 1LL || k <= window);
    active = res.active;
    mc = res.mc;
    if constexpr (kRecord) {
      unconf = static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, cnt));
    }
    if (it.comb_out != nullptr) {
      // the unconfirmed real neighbors, in column order, into the first
      // u slots of the capture; the rest the pad sentinel v
      int nun = 0;
      for (int j0 = 0; j0 < it.len; j0 += 32) {
        const int j = j0 + lane;
        bool un = false;
        int e = 0;
        if (j < it.len) {
          e = it.row[j];
          const int nbr = e & kNbrMask;
          if (nbr < v) un = !is_confirmed(src[nbr]);
        }
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, un);
        if (un) {
          const int pos = nun + __popc(bal & ((1u << lane) - 1u));
          if (pos < u) it.comb_out[pos] = e;
        }
        nun += __popc(bal);
      }
      for (int j = min(nun, u) + lane; j < u; j += 32) it.comb_out[j] = v;
      if (lane == 0 && nun > u) live[kLiveTierNext * nb + bi] = 0;
    }
  }
  fold_counts<kRecord>(ctrl, live, nb, bi, umax, fail, active, mc, unconf);
}

// The rebase capture of a row by one block: tiles of a quad a thread in
// column order, each thread's place from a block-wide prefix of the
// threads' counts. Returns the row's unconfirmed real neighbors.
__device__ int block_capture(const int* __restrict__ src, const int* row,
                             int len, int u, int v, int* comb_out) {
  __shared__ int s_warp[kK8Warps];
  __shared__ int s_base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (int j0 = 0; j0 < len; j0 += 4 * kK8Threads) {
    const int j = j0 + 4 * tid;
    int e[4];
    bool un[4];
    int c = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      e[q] = 0;
      un[q] = false;
      if (j + q < len) {
        e[q] = row[j + q];
        const int nbr = e[q] & kNbrMask;
        if (nbr < v) un[q] = !is_confirmed(src[nbr]);
      }
      c += un[q] ? 1 : 0;
    }
    int x = c;  // inclusive over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int pos = s_base + x - c;
    int total = 0;
#pragma unroll
    for (int i = 0; i < kK8Warps; ++i) {
      if (i < warp) pos += s_warp[i];
      total += s_warp[i];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (un[q]) {
        if (pos < u) comb_out[pos] = e[q];
        ++pos;
      }
    }
    __syncthreads();
    if (tid == 0) s_base += total;
    __syncthreads();
  }
  const int nun = s_base;
  for (int j = min(nun, u) + tid; j < u; j += kK8Threads) comb_out[j] = v;
  return nun;
}

// A block an item. Its warps OR their register planes into the block's
// shared words beside the others, which then fold the row; thread 0 writes
// it and counts it. The ORs and the count's adds are order-free, so a
// replay gives the same bytes.
template <bool kRecord>
__device__ void block_item(int* ctrl, const int* __restrict__ src,
                           int* __restrict__ dst, const long long* d, int bi,
                           int branch, int item, int* live, int nb,
                           int* pool, const int* __restrict__ table,
                           const int* __restrict__ lens, int v, int k,
                           int* umax) {
  __shared__ uint32_t s_fa[kPassShared];
  __shared__ uint32_t s_fo[kPassShared];
  // the pass's register planes: fa of planes 0 and 1, then their fo
  __shared__ uint32_t s_lo[2 * kRegPlanes];
  __shared__ int s_clash;
  __shared__ int s_cnt;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const Item it =
      hub_item(d, branch, item, tid, kK8Threads, pool, table, lens, v);
  const int row0 = static_cast<int>(d[dRow0]);
  const int me = it.r >= 0 ? src[row0 + it.r] : 0;
  // uniform over the block
  if (!(it.r >= 0 && (is_active(me) || it.comb_out != nullptr))) return;
  const int w = static_cast<int>(d[dWidth]);
  const int planes = static_cast<int>(d[dPlanes]);
  const bool count = kRecord && is_active(me);
  const int mycol = me >> 1;
  bool clash_all = false;
  bool found = false;
  int cand = k;
  bool old_free = false;
  int cnt_all = 0;
  for (int base = 0; base < planes; base += kPassPlanes) {
    const int gp = min(kPassPlanes, planes - base);
    if (tid < kPassShared) {
      s_fa[tid] = 0u;
      s_fo[tid] = 0u;
    }
    if (tid < 2 * kRegPlanes) s_lo[tid] = 0u;
    if (tid == 0) {
      s_clash = 0;
      s_cnt = 0;
    }
    __syncthreads();
    PlaneRegs pl;
    bool clash = false;
    int cnt = 0;
    walk_row(src, it.row, it.len, tid, kK8Threads, v, [&](int e, int word) {
      add_word(e, word, base, gp, mycol, pl, s_fa, s_fo, clash);
      if (count && base == 0 && (e & kNbrMask) < v && !is_confirmed(word)) {
        ++cnt;
      }
    });
    pl.or_warp();
    clash = __any_sync(0xFFFFFFFFu, clash);
    cnt = static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, cnt));
    if (lane == 0) {
      for (int p = 0; p < kRegPlanes; ++p) {
        if (pl.fa(p) != 0u) atomicOr(s_lo + p, pl.fa(p));
        if (pl.fo(p) != 0u) atomicOr(s_lo + kRegPlanes + p, pl.fo(p));
      }
      if (clash) atomicOr(&s_clash, 1);
      if (cnt != 0) atomicAdd(&s_cnt, cnt);
    }
    __syncthreads();
    for (int p = 0; p < gp; ++p) {  // every thread folds the same planes
      const bool reg = p < kRegPlanes;
      uint32_t fa = reg ? s_lo[p] : s_fa[p - kRegPlanes];
      uint32_t fo = reg ? s_lo[kRegPlanes + p] : s_fo[p - kRegPlanes];
      const int pg = base + p;
      if (it.conf_out != nullptr && tid == 0) it.conf_out[pg] = fo;
      if (it.seed != nullptr) {
        fa |= it.seed[pg];
        fo |= it.seed[pg];
      }
      fold_plane(fa, fo, pg, k, found, cand, old_free);
    }
    clash_all = clash_all || s_clash != 0;
    cnt_all += s_cnt;
    __syncthreads();  // read before the next pass clears them
  }
  const RowResult res = finish_rule(me, clash_all, found, cand, old_free);
  bool fail = false;
  bool active = false;
  int mc = -1;
  int unconf = 0;
  if (tid == 0) {
    dst[row0 + it.r] = res.next;
    const long long window = 32LL * planes;
    fail = res.fail && (window >= w + 1LL || k <= window);
    active = res.active;
    mc = res.mc;
    if constexpr (kRecord) unconf = cnt_all;
  }
  if (it.comb_out != nullptr) {
    const int nun = block_capture(src, it.row, it.len,
                                  static_cast<int>(d[dU]), v, it.comb_out);
    if (tid == 0 && nun > static_cast<int>(d[dU])) {
      live[kLiveTierNext * nb + bi] = 0;
    }
  }
  fold_counts<kRecord>(ctrl, live, nb, bi, umax, fail, active, mc, unconf);
}

// The bucket of this block: the last whose first block is at or before it.
__device__ __forceinline__ int block_bucket(const long long* desc, int nh) {
  int lo = 0;
  int hi = nh - 1;
  const long long b = blockIdx.x;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[static_cast<size_t>(mid) * kDescCols + dBlock0] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <bool kRecord>
__global__ void __launch_bounds__(kK8Threads)
hub_superstep_kernel(int* ctrl, int* state, size_t stride,
                     const int* __restrict__ table,
                     const long long* __restrict__ desc, int nh, int* live,
                     int nb, int* pool, const int* __restrict__ lens, int v,
                     int k, int thresh, int max_steps, int* umax) {
  if (!stage_live(ctrl, thresh, max_steps)) return;
  const int bi = block_bucket(desc, nh);
  const int branch = live[kLiveBranch * nb + bi];
  if (branch == kSkip) return;  // uniform over the block
  const long long* d = desc + static_cast<size_t>(bi) * kDescCols;
  const int rows = static_cast<int>(d[dRows]);
  const int pad = static_cast<int>(d[dPad]);
  const int p2 = static_cast<int>(d[dP2]);
  const int items = branch == kFull ? rows
                    : (branch == kShrink || branch == kPruned2) ? p2 : pad;
  const int rel = static_cast<int>(blockIdx.x - d[dBlock0]);
  const int cur = ctrl[kCur];
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ dst = state + (1 - cur) * stride;
  if (d[dMode] == kWarpItems) {
    if (rel * kK8Warps >= items) return;  // uniform
    warp_items<kRecord>(ctrl, src, dst, d, bi, branch, rel * kK8Warps, items,
                        live, nb, pool, table, lens, v, k, umax);
  } else {
    if (rel >= items) return;  // uniform
    block_item<kRecord>(ctrl, src, dst, d, bi, branch, rel, live, nb, pool,
                        table, lens, v, k, umax);
  }
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// state: int32[2, stride]; desc: int64[nh, 20]; live: int32[5, nb];
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
// desc: int64[nh, 20]; lens: int32, each hub row's real length at its
// bucket's dLen0; blocks: K8's grid, the last bucket's dBlock0 plus its
// blocks; umax: int32[>= nh], the unconf vector of the recording variant
// (kRecord), or null for the plain K8.
int dgc_hub_superstep(void* ctrl, void* state, int stride, const void* table,
                      const void* desc, int nh, void* live, int nb,
                      void* pool, const void* lens, int blocks, int k,
                      int thresh, int max_steps, void* umax, void* stream) {
  if (nh <= 0 || nb < nh || blocks <= 0 || lens == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* c = static_cast<int*>(ctrl);
  auto* s = static_cast<int*>(state);
  const auto* t = static_cast<const int*>(table);
  const auto* dd = static_cast<const long long*>(desc);
  auto* l = static_cast<int*>(live);
  auto* p = static_cast<int*>(pool);
  const auto* ln = static_cast<const int*>(lens);
  auto st = static_cast<cudaStream_t>(stream);
  const auto words = static_cast<size_t>(stride);
  const auto grid = static_cast<unsigned>(blocks);
  if (umax == nullptr) {
    hub_superstep_kernel<false><<<grid, kK8Threads, 0, st>>>(
        c, s, words, t, dd, nh, l, nb, p, ln, stride - 2, k, thresh,
        max_steps, nullptr);
  } else {
    hub_superstep_kernel<true><<<grid, kK8Threads, 0, st>>>(
        c, s, words, t, dd, nh, l, nb, p, ln, stride - 2, k, thresh,
        max_steps, static_cast<int*>(umax));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
