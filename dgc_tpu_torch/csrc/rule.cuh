// What the superstep kernels share: the speculative rule for one row on a
// team of threads (add_word, fold_plane and walk_row: K1 in superstep.cu,
// K5 in compact.cu, K8 in hub.cu, K13 in serve.cu, K20 in shard.cu, K23 in
// ring.cu; a group of lanes a row: team_lanes, group_passes) and the
// transition it ends in (finish_rule); the epoch flags of the count
// exchanges (store_flag, load_flag: K3 and K14); the loop-control fold of
// one superstep (finish_step: K2 and K6); the stage predicate (stage_live:
// K5-K8); and the hub region's live table (K6-K8).
//
// The rule is the port of dgc_tpu/ops/speculative.py:40 neighbor_stats and
// :67 apply_update_mc over dgc_tpu/ops/bitmask.py:28 plane_masks, :37
// forbidden_planes and :75 first_fit, for one row of a combined table
// (neighbor id | beats bit 30) gathered from the state buffer `src`, or of
// a table of plain ids whose priority is read from the degrees (K20).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dgc {

// The control block's first eight slots (CTRL_* in kernels/superstep.py):
// the attempt's loop carry and this superstep's counters. The compact
// engine's block appends its ring and block-counter slots after them.
constexpr int kStatus = 0;
constexpr int kStep = 1;
constexpr int kPrevActive = 2;
constexpr int kStall = 3;
constexpr int kCur = 4;
constexpr int kFail = 5;
constexpr int kActive = 6;
constexpr int kMc = 7;

constexpr int kRunning = 0;
constexpr int kSuccess = 1;
constexpr int kFailure = 2;
constexpr int kStalled = 3;

constexpr int kBeatsBit = 30;
constexpr int kNbrMask = (1 << kBeatsBit) - 1;
constexpr int kDivergeBig = 1 << 30;

// Bit b of plane p is set iff color 32p+b < k. A shift by 32 is undefined
// for a 32-bit word, so a full plane is special-cased (bitmask.py:31-34).
__device__ __forceinline__ uint32_t plane_mask(int k, int p) {
  const long long nbits = static_cast<long long>(k) - 32LL * p;
  if (nbits >= 32) return 0xFFFFFFFFu;
  if (nbits <= 0) return 0u;
  return (1u << static_cast<uint32_t>(nbits)) - 1u;
}

struct RowResult {
  int next;     // the row's new packed word
  bool fail;    // needs a color and its confirmed set covers [0, k)
  bool active;  // uncolored or fresh after the step
  int mc;       // divergence candidate: -1, the candidate, or kDivergeBig
};

// The state transition of a row whose packed word is `me`, from its
// neighbor stats (apply_update_mc).
__device__ __forceinline__ RowResult finish_rule(int me, bool clash,
                                                 bool found, int cand,
                                                 bool old_free) {
  const int mycol = me >> 1;
  const bool myfresh = me >= 0 && (me & 1) != 0;
  const bool demote = myfresh && clash;
  const bool needs = me < 0 || demote;
  RowResult r;
  if (needs && found) {
    r.next = cand * 2 + 1;  // speculative (fresh)
  } else if (demote) {
    r.next = -1;            // could not re-pick this round
  } else if (myfresh) {
    r.next = mycol * 2;     // confirm fresh -> old
  } else {
    r.next = me;
  }
  r.fail = needs && !old_free;
  r.active = r.next < 0 || (r.next & 1) != 0;
  r.mc = needs ? (found ? cand : kDivergeBig) : -1;
  return r;
}

// ---- the team walk of K1, K5, K8, K13, K20 and K23 ----------------------
//
// K1, K5, K13, K20 and K23 (a group of lanes a row, K1 a block from its
// widest tables) and K8 (a warp or a block a row) read a row with a team of
// threads and keep the row's
// planes two ways: the first two planes of a pass (where the first fit
// picks mostly fall) in registers, OR-reduced over the team, and the rest
// of the pass in shared words that the team ORs into with atomicOr. A
// per-entry branch ladder over a register array of every plane costs ~3
// instructions a plane an entry; this costs a handful. (Four planes in two
// 64-bit registers were slower on the card: the shifts and the team's
// shuffles cost more than the shared atomics they saved.)

constexpr int kRegPlanes = 2;  // planes of a pass held in registers

// A group of lanes a row: the least power of two, at most 32, whose lanes
// hold a row of `width` at kLaneEntries entries each
// (kernels.superstep.team_lanes mirrors it; 4 to 64 were timed for K5,
// PERF.md). A warp's groups share kTeamWords shared plane words: `lanes`
// of fa and `lanes` of fo a group.
constexpr int kLaneEntries = 32;
constexpr int kTeamWords = 64;

__host__ __device__ __forceinline__ int team_lanes(int width) {
  int lanes = 1;
  while (lanes < 32 && lanes * kLaneEntries < width) lanes <<= 1;
  return lanes;
}

// Planes base and base + 1 of a pass, in registers.
struct PlaneRegs {
  uint32_t fa0 = 0u;
  uint32_t fa1 = 0u;
  uint32_t fo0 = 0u;
  uint32_t fo1 = 0u;

  // plane p (< kRegPlanes) of the pass: every colored neighbor's bits
  // (fa), the confirmed ones' (fo)
  __device__ __forceinline__ uint32_t fa(int p) const {
    return p == 0 ? fa0 : fa1;
  }
  __device__ __forceinline__ uint32_t fo(int p) const {
    return p == 0 ? fo0 : fo1;
  }
  // OR over the lanes o, o/2, ..., 1 apart (a group of 2o lanes)
  __device__ __forceinline__ void or_xor(int o) {
    for (; o > 0; o >>= 1) {
      fa0 |= __shfl_xor_sync(0xFFFFFFFFu, fa0, o);
      fa1 |= __shfl_xor_sync(0xFFFFFFFFu, fa1, o);
      fo0 |= __shfl_xor_sync(0xFFFFFFFFu, fo0, o);
      fo1 |= __shfl_xor_sync(0xFFFFFFFFu, fo1, o);
    }
  }
  // OR over the whole warp
  __device__ __forceinline__ void or_warp() {
    fa0 = __reduce_or_sync(0xFFFFFFFFu, fa0);
    fa1 = __reduce_or_sync(0xFFFFFFFFu, fa1);
    fo0 = __reduce_or_sync(0xFFFFFFFFu, fo0);
    fo1 = __reduce_or_sync(0xFFFFFFFFu, fo1);
  }
};

// Whether the neighbor of entry `e` beats the row: bit 30 of a combined
// table's entry (BeatsBit). A table of plain ids (K20) passes its own
// functor, which reads the priority from the degrees. Asked only of a fresh
// neighbor of the row's own color, the one place the clash test needs it.
struct BeatsBit {
  __device__ __forceinline__ bool operator()(int e) const {
    return (e >> kBeatsBit) != 0;
  }
};

// One gathered neighbor word `word` of entry `e` into the pass's `gp`
// planes from `base`: its color's bit into the registers or into the
// shared words s_fa/s_fo (plane base + kRegPlanes + i at index i), and
// into fo when confirmed; a fresh neighbor of my color that beats me
// (`beats`) is a clash (read in the pass from plane 0 only). A color past
// the pass adds nothing.
template <class Beats = BeatsBit>
__device__ __forceinline__ void add_word(int e, int word, int base, int gp,
                                         int mycol, PlaneRegs& pl,
                                         uint32_t* s_fa, uint32_t* s_fo,
                                         bool& clash, Beats beats = Beats{}) {
  if (word < 0) return;  // uncolored neighbor or pad sentinel
  const int c = word >> 1;
  const bool fresh = (word & 1) != 0;
  if (base == 0 && fresh && c == mycol && beats(e)) clash = true;
  const int w = (c >> 5) - base;
  if (w < 0 || w >= gp) return;
  const uint32_t bit = 1u << (c & 31);
  if (w == 0) {
    pl.fa0 |= bit;
    if (!fresh) pl.fo0 |= bit;
  } else if (w == 1) {
    pl.fa1 |= bit;
    if (!fresh) pl.fo1 |= bit;
  } else {
    atomicOr(s_fa + (w - kRegPlanes), bit);
    if (!fresh) atomicOr(s_fo + (w - kRegPlanes), bit);
  }
}

// Plane pg (< the window) of a row into its first fit: `fa` holds every
// colored neighbor's bit of the plane, `fo` the confirmed ones'. Sets the
// first free color under k (`found`, `cand`) and whether a color under k is
// free of confirmed neighbors (`old_free`).
__device__ __forceinline__ void fold_plane(uint32_t fa, uint32_t fo, int pg,
                                           int k, bool& found, int& cand,
                                           bool& old_free) {
  const uint32_t m = plane_mask(k, pg);
  const uint32_t free_all = ~fa & m;
  if (!found && free_all != 0u) {
    found = true;
    cand = 32 * pg + __ffs(free_all) - 1;
  }
  if ((~fo & m) != 0u) old_free = true;
}

// How walk_row gathers a neighbor's word from the state `src`. kGatherPad:
// every id but the pad sentinel `pad`, from device memory (K1, K5, K8,
// K20, K23: their buffers hold −1 at slot pad). kGatherLim: every id below
// `pad`, an id at or past it reading as uncolored (the serve carry's lanes
// have no pad slot), from device memory; kGatherShared likewise from a
// state staged in shared memory (K13).
constexpr int kGatherPad = 0;
constexpr int kGatherLim = 1;
constexpr int kGatherShared = 2;

// The entries [0, len) of `row` that fall to thread t of a team of n: the
// quads (four consecutive entries) t, t + n, t + 2n, ..., two quads, so
// eight independent gathers, in flight at a time; a quad is one 16-byte
// load where the row is 16-byte aligned. An entry whose neighbor id is the
// pad sentinel `pad` is not gathered: its word is the state's slot `pad`,
// which holds −1 in every buffer K5 and K8 run on (kernels/compact.py
// extend_packed, kernels/shard.py new_shard_state), and reads so here
// (kGather: which ids are gathered, and from where).
// visit(e, word) for each entry of the thread's quads (the pad sentinel
// and −1 past len). The row and `src` must not change during the launch.
template <int kGather = kGatherPad, class Visit>
__device__ __forceinline__ void walk_row(const int* __restrict__ src,
                                         const int* __restrict__ row, int len,
                                         int t, int n, int pad, Visit visit) {
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0u;
  const int nq = (len + 3) >> 2;
  for (int q0 = t; q0 < nq; q0 += 2 * n) {
    int e[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + h * n;
      const int j = 4 * q;
      if (vec && j + 4 <= len) {
        const int4 v4 = __ldg(reinterpret_cast<const int4*>(row) + q);
        e[4 * h] = v4.x;
        e[4 * h + 1] = v4.y;
        e[4 * h + 2] = v4.z;
        e[4 * h + 3] = v4.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          e[4 * h + u] = q < nq && j + u < len ? __ldg(row + j + u) : pad;
        }
      }
    }
    int w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int nbr = e[u] & kNbrMask;
      if constexpr (kGather == kGatherPad) {
        w[u] = nbr != pad ? __ldg(src + nbr) : -1;
      } else if constexpr (kGather == kGatherLim) {
        w[u] = nbr < pad ? __ldg(src + nbr) : -1;
      } else {
        w[u] = nbr < pad ? src[nbr] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) visit(e[u], w[u]);
  }
}

// The passes of a group of `lanes` lanes over its row's entries [0, len)
// (K1, K13, K20, K23): a pass holds kRegPlanes + lanes planes from `base`, in
// PlaneRegs and the group's shared words s_fa/s_fo, and hands each to
// plane(pg, fa, fo) on the first lane of a group that walks (`walk`,
// uniform over the group). The first pass also takes the highest plane
// of any neighbor color over the warp; no pass reads the rows above it,
// whose planes are zero for every row of the warp. Every lane of the warp
// calls it with the same `lanes` and `planes`. Returns the planes handed
// over, and leaves the group's clash in `clash` on each of its lanes.
// kGather as walk_row (K13 in serve.cu gathers by kGatherLim or
// kGatherShared); `beats` as add_word (K20 reads the degrees).
template <int kGather = kGatherPad, class Plane, class Beats = BeatsBit>
__device__ __forceinline__ int group_passes(const int* __restrict__ src,
                                            const int* __restrict__ row,
                                            int len, int gl, int lanes,
                                            int pad, bool walk, int planes,
                                            int mycol, uint32_t* s_fa,
                                            uint32_t* s_fo, bool& clash,
                                            Plane plane,
                                            Beats beats = Beats{}) {
  const int per_pass = kRegPlanes + lanes;
  int top = -1;  // the highest plane of a neighbor's color
  int done = planes;
  for (int base = 0; base < planes; base += per_pass) {
    const int gp = min(per_pass, planes - base);
    s_fa[gl] = 0u;
    s_fo[gl] = 0u;
    __syncwarp();
    PlaneRegs pl;
    if (walk) {
      walk_row<kGather>(src, row, len, gl, lanes, pad, [&](int e, int word) {
        add_word(e, word, base, gp, mycol, pl, s_fa, s_fo, clash, beats);
        if (base == 0 && word >= 0) top = max(top, word >> 6);
      });
    }
    pl.or_xor(lanes >> 1);  // within the group
    __syncwarp();  // the group's shared words are complete
    if (walk && gl == 0) {
      for (int p = 0; p < gp; ++p) {
        const bool reg = p < kRegPlanes;
        plane(base + p, reg ? pl.fa(p) : s_fa[p - kRegPlanes],
              reg ? pl.fo(p) : s_fo[p - kRegPlanes]);
      }
    }
    __syncwarp();  // read before the next pass clears them
    if (base == 0) top = __reduce_max_sync(0xFFFFFFFFu, top);
    if (top < base + gp) {  // uniform over the warp
      done = base + gp;
      break;
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    clash |= __shfl_xor_sync(0xFFFFFFFFu, clash ? 1 : 0, o) != 0;
  }
  return done;
}

// A 64-bit flag (epoch << 32 | count) a block publishes and the grid's
// other blocks poll (K3's and K14's count exchanges): a volatile store and
// load, so a poll reads what another block stored, not a cached copy.
__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Fold this superstep's counters into the loop carry, on one thread, for
// an attempt still RUNNING. FAILURE > SUCCESS > STALLED > RUNNING
// (dgc_tpu/engine/bucketed.py:193 status_step); a step is STALLED after
// `stall_window` steps without fewer active rows, or when step+1 reaches
// `max_steps` (the ELL rule; the compact engine tests max_steps before a
// step instead and passes INT_MAX). Flips `cur` unless the step failed, so
// a failed step leaves the pre-step state current, and clears the counters.
__device__ __forceinline__ void finish_step(int* ctrl, int max_steps,
                                            int stall_window) {
  const int step = ctrl[kStep];
  const int active = ctrl[kActive];
  const bool any_fail = ctrl[kFail] > 0;
  const int stall = active < ctrl[kPrevActive] ? 0 : ctrl[kStall] + 1;
  int status = kRunning;
  if (any_fail) {
    status = kFailure;
  } else if (active == 0) {
    status = kSuccess;
  } else if (stall >= stall_window || step + 1 >= max_steps) {
    status = kStalled;
  }
  if (!any_fail) ctrl[kCur] ^= 1;
  ctrl[kStatus] = status;
  ctrl[kStep] = step + 1;
  ctrl[kPrevActive] = active;
  ctrl[kStall] = stall;
  ctrl[kFail] = 0;
  ctrl[kActive] = 0;
  ctrl[kMc] = -1;
}

// Does the stage run another superstep? The attempt RUNNING, its carried
// active count above the stage threshold and its step below max_steps
// (the while conds of dgc_tpu/engine/compact.py:1484-1486, 1543-1545). K5-K8
// test it and return at once when it fails; it reads slots only K6 writes.
__device__ __forceinline__ bool stage_live(const int* ctrl, int thresh,
                                           int max_steps) {
  return ctrl[kStatus] == kRunning && ctrl[kPrevActive] > thresh &&
         ctrl[kStep] < max_steps;
}

// The live table, int32[kLiveRows, nb] (LIVE_* in kernels/compact.py):
// per bucket of the hub region, then the flat region's total, the live
// counts (`ba`, dgc_tpu/engine/compact.py:908) and their staged next
// values, the prune tiers (compact.py:543) and their staged next values,
// and the branch K7 chose for this superstep. K7 and K8 write the staged
// rows; K6 commits them unless the step failed.
constexpr int kLiveBa = 0;
constexpr int kLiveBaNext = 1;
constexpr int kLiveTier = 2;
constexpr int kLiveTierNext = 3;
constexpr int kLiveBranch = 4;
constexpr int kLiveRows = 5;

}  // namespace dgc
