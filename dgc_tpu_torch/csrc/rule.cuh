// What the superstep kernels share: the speculative rule for one row, on
// one thread (row_rule: K1 in superstep.cu, K5 in compact.cu, K13 in
// serve.cu, K20 in shard.cu) or on a whole warp with seeded planes (warp_row_rule: K8 in
// hub.cu); the loop-control fold of one superstep (finish_step: K2 and
// K6); the stage predicate (stage_live: K5-K8); and the hub region's live
// table (K6-K8).
//
// The rule is the port of dgc_tpu/ops/speculative.py:40 neighbor_stats and
// :67 apply_update_mc over dgc_tpu/ops/bitmask.py:28 plane_masks, :37
// forbidden_planes and :75 first_fit, for one row of a combined table
// (neighbor id | beats bit 30) gathered from the state buffer `src`.

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

// First-fit over one group of PB planes starting at plane `base`: `fa`
// holds every colored neighbor's bit, `fo` the confirmed ones'. Sets the
// first free color under k (`found`, `cand`) and whether a color under k is
// free of confirmed neighbors (`old_free`).
template <int PB>
__device__ __forceinline__ void fold_planes(const uint32_t (&fa)[PB],
                                            const uint32_t (&fo)[PB],
                                            int base, int planes, int k,
                                            bool& found, int& cand,
                                            bool& old_free) {
#pragma unroll
  for (int p = 0; p < PB; ++p) {
    const int pg = base + p;
    const uint32_t m = pg < planes ? plane_mask(k, pg) : 0u;
    const uint32_t free_all = ~fa[p] & m;
    if (!found && free_all != 0u) {
      found = true;
      cand = 32 * pg + __ffs(free_all) - 1;
    }
    if ((~fo[p] & m) != 0u) old_free = true;
  }
}

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

// The priority of a row whose table holds plain neighbor ids (kPrio): the
// degrees `deg` (-1 at the pad sentinel's slot) and the row's own degree
// and id. A neighbor beats the row when its degree is larger, or equal
// with a smaller id (dgc_tpu/ops/speculative.py beats_rule).
struct Prio {
  const int* deg = nullptr;
  int my_deg = 0;
  int my_id = 0;
};

// One neighbor entry `e` into the planes of group `base`: its color's bit
// into `fa` (and into `fo` when confirmed); a fresh neighbor of my color
// that beats me is a clash (read in group 0 only). With kLim, a neighbor id
// at or past `lim` is the pad sentinel of a state buffer that has no pad
// slot (the serve carry's lanes) and reads as uncolored. With kPrio, `e`
// is a plain id and whether it beats me is read from `prio` instead of
// bit 30, and only where the clash test needs it.
template <int PB, bool kLim = false, bool kPrio = false>
__device__ __forceinline__ void add_neighbor(const int* __restrict__ src,
                                             int e, int base, int mycol,
                                             uint32_t (&fa)[PB],
                                             uint32_t (&fo)[PB],
                                             bool& clash, int lim = 0,
                                             const Prio& prio = Prio{}) {
  if constexpr (kLim) {
    if ((e & kNbrMask) >= lim) return;
  }
  const int word = src[e & kNbrMask];
  if (word < 0) return;  // uncolored neighbor or pad sentinel
  const int c = word >> 1;
  const bool fresh = (word & 1) != 0;
  if (base == 0 && fresh && c == mycol) {
    bool beats;
    if constexpr (kPrio) {
      const int nd = prio.deg[e];
      beats = nd > prio.my_deg || (nd == prio.my_deg && e < prio.my_id);
    } else {
      beats = (e >> kBeatsBit) != 0;
    }
    if (beats) clash = true;
  }
  const int w = (c >> 5) - base;
  const uint32_t bit = 1u << (c & 31);
#pragma unroll
  for (int p = 0; p < PB; ++p) {
    if (p == w) {
      fa[p] |= bit;
      if (!fresh) fo[p] |= bit;
    }
  }
}

// The rule for a row whose packed word is `me`, over the `width` entries
// at `row`, with a window of `planes` planes, on one thread. PB planes are
// held in registers at a time; a wider window is scanned in groups of PB,
// re-reading the row for each group. kLim/lim and kPrio/prio as
// add_neighbor: with kPrio the neighbors' words come from `src`, the
// gathered state, whatever buffer the row's own word `me` came from.
template <int PB, bool kLim = false, bool kPrio = false>
__device__ __forceinline__ RowResult row_rule(const int* __restrict__ src,
                                              const int* __restrict__ row,
                                              int width, int planes, int k,
                                              int me, int lim = 0,
                                              const Prio& prio = Prio{}) {
  const int mycol = me >> 1;  // arithmetic: -1 stays -1
  bool clash = false;
  bool found = false;     // a color under k is free of every neighbor
  int cand = k;           // first-fit over all colored neighbors
  bool old_free = false;  // a color under k is free of confirmed ones
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
    for (int j = 0; j < width; ++j) {
      add_neighbor<PB, kLim, kPrio>(src, row[j], base, mycol, fa, fo, clash,
                                    lim, prio);
    }
    fold_planes<PB>(fa, fo, base, planes, k, found, cand, old_free);
  }
  return finish_rule(me, clash, found, cand, old_free);
}

// The same rule on a whole warp, for the hub region's wide rows: lane l
// reads entries l, l+32, ...; the planes are OR-reduced over the warp and
// the clash any-reduced, so every lane returns the same result. `seed`
// (or null) holds `planes` planes OR'd into both forbidden sets after the
// reduction: the pruned branches' captured confirmed colors
// (dgc_tpu/engine/compact.py:595-596). `fo_out` (or null) receives, from
// lane 0, the row's confirmed-neighbor planes before the seed: the rebase
// capture's `conf` (compact.py:663). All 32 lanes must call it together.
template <int PB>
__device__ __forceinline__ RowResult warp_row_rule(
    const int* __restrict__ src, const int* __restrict__ row, int width,
    int planes, int k, int me, const uint32_t* __restrict__ seed,
    uint32_t* __restrict__ fo_out) {
  const int lane = threadIdx.x & 31;
  const int mycol = me >> 1;
  bool clash = false;
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
      fa[p] = 0u;
      fo[p] = 0u;
    }
#pragma unroll 4
    for (int j = lane; j < width; j += 32) {
      add_neighbor<PB>(src, row[j], base, mycol, fa, fo, clash);
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      fa[p] = __reduce_or_sync(0xFFFFFFFFu, fa[p]);
      fo[p] = __reduce_or_sync(0xFFFFFFFFu, fo[p]);
      const int pg = base + p;
      if (pg < planes) {
        if (fo_out != nullptr && lane == 0) fo_out[pg] = fo[p];
        if (seed != nullptr) {
          fa[p] |= seed[pg];
          fo[p] |= seed[pg];
        }
      }
    }
    fold_planes<PB>(fa, fo, base, planes, k, found, cand, old_free);
  }
  clash = __any_sync(0xFFFFFFFFu, clash);
  return finish_rule(me, clash, found, cand, old_free);
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
