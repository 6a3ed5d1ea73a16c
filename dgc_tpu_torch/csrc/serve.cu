// The batched serve tier's superstep for Hopper (sm_90a), with a plain C
// interface for ctypes (dgc_tpu_torch/kernels/serve.py).
//
// Replaces the jitted XLA programs of dgc_tpu/serve/batched.py (B12), one
// batched superstep of B lanes (graphs of one shape class) at a time:
//   K13 lane_superstep — B12a, :282 _superstep_body's stage branches with
//                        :231 _full_lane_superstep, :245
//                        _staged_lane_superstep and :223
//                        _lane_superstep_math: the speculative rule
//                        (rule.cuh row_rule) over every row of a lane
//                        (rung 0) or over its slot list's first pads[s]
//                        slots (rung s), into the back buffer `nxt`, and
//                        each lane's fail and active counts.
//   K14 lane_compact   — B12b, :268 _rebuild_idx over
//                        dgc_tpu/engine/compact.py:288 _compact_idx, as
//                        run at batched.py:333-346: the stage-entry
//                        recompaction of each live lane whose slot list
//                        was built at a shallower rung.
//   K15 lane_finish    — B12c, batched.py:363-466: the transition and the
//                        freeze (stall, status, the revert of a failed
//                        step, the STALLED clamp at max_steps, the result
//                        slots, the confirm budget from the colors used,
//                        the re-init, rung/nc/idx_rung), and the routing
//                        of the next superstep. Its kTiming instance reads
//                        the card's clock once per batched superstep
//                        (:414-423; traj.cuh globaltimer_us).
//   K16 lane_reset     — B12d, :202 _fresh_lanes and :487-528 (the slice
//                        entry: the re-init of flagged lanes; with the
//                        speculation plane's optional spec/cancel vectors,
//                        the spec tag seated on a flagged lane and a
//                        cancelled spec-tagged lane killed, :498-511; the
//                        timing seed), and the slice's control block.
// The while-loops of :539 batched_sweep_kernel and :556
// batched_slice_kernel (B12e) are host loops over these launches
// (serve/batched.py): one K16, then rounds of K14 (staged ladders only),
// K13 and K15, launched back to back.
//
// The lane mesh (B12g, :821-901 the `_sharded` twins: the lane axis split
// over n shards, each holding its contiguous block of lanes with a
// control block of its own). The reference's cross-lane values are full
// reductions that the SPMD partitioner turns into all-reductions: the
// executed rung (min over live lanes) and the live predicate. Here:
//   K15/K16 partial instances (kPartial) — the last block's fold writes
//                        the shard's partial into its own control block:
//                        the min executed rung over its live lanes
//                        (identity nstages - 1: a shard of dead lanes adds
//                        nothing), whether any of its lanes is live (the
//                        budget not applied), and the step count. The
//                        ticket stays per launch.
//   K26 lane_mesh_fold — one small launch after every shard's K15 (and
//                        after every shard's K16): the min of the partial
//                        rungs, live = any(shard live) && steps < budget,
//                        the step count and a zeroed ticket, written into
//                        every shard's control block through a table of
//                        their pointers. Every shard's next K14/K13 reads
//                        those words first, exactly as the unsharded slice
//                        does, so the host still enqueues a whole slice
//                        without a sync. On folded words K26 is a fixed
//                        point (min of equal rungs, any of zeros), so a
//                        round past the live word changes nothing.
// Shards on other cards are read and written through peer access
// (dgc_enable_peer_access); the host orders the launches across streams
// with events (kernels/serve.py MeshLanes).
//
// State. The carry is the reference's 20 slots (dgc_tpu_torch/layout.py),
// one lane-leading tensor each; the packed state of lane b is row b of
// slot 2, int32[B, V] with no pad slot: a neighbor id >= V reads as
// uncolored (row_rule's kLim). Beside it: the back buffer `nxt`
// int32[B, V], equal to `packed` in every lane between supersteps (made
// as its copy; K16 re-inits a flagged lane's row as it re-inits the
// lane's state; K15 restores it), so the BSP snapshot holds when K13 writes
// only the slot rows of a staged rung; the per-lane counters `scratch`
// int32[3, B] (fail, active, max color); and the control block `ctrl`
// (CTRL_* in kernels/serve.py): the executed rung, the live word (a lane
// still running and steps left in the slice), the step count, the budget,
// K15's block ticket, and the ladder (stage count, thresholds, pads; pad
// 0 = the full table). The executed rung is the min over live lanes of
// max(rung, desired rung), as the reference: exact for every lane because
// a wider pad covers a deeper lane's frontier. Every kernel reads the live
// word first and returns at once when it is 0, so the host enqueues a whole
// slice without a sync; dead lanes (phase >= 2) are frozen by doing nothing.
//
// Bounds (one batched superstep; PERF.md has the measured times). K13 must
// read each evaluated row's W table entries, the lane's state once and
// write the evaluated rows: full table B x V x (W + 2) words. K14 reads a
// lane's V words and writes its A0 slots. K15 writes or copies the
// evaluated rows (the fin lanes' V words three times), and B scalars. K16
// reads a flagged lane's V degrees and writes its rows; an unflagged
// lane costs its scalars only.
// These first kernels are one thread per row (K13, K15) or one block per
// lane (K14), written to be right and simple, not yet coalesced.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "rule.cuh"
#include "traj.cuh"

namespace {

// the carry's slots (dgc_tpu_torch/layout.py CARRY_*)
constexpr int kCarryLen = 20;
constexpr int kCPhase = 0;
constexpr int kCK = 1;
constexpr int kCPacked = 2;
constexpr int kCStep = 3;
constexpr int kCPrevActive = 4;
constexpr int kCStall = 5;
constexpr int kCP1 = 6;
constexpr int kCS1 = 7;
constexpr int kCSt1 = 8;
constexpr int kCUsed = 9;
constexpr int kCP2 = 10;
constexpr int kCS2 = 11;
constexpr int kCSt2 = 12;
constexpr int kCTUs = 13;
constexpr int kCTPrev = 14;
constexpr int kCRung = 15;
constexpr int kCNc = 16;
constexpr int kCIdxRung = 17;
constexpr int kCIdx = 18;
constexpr int kCSpec = 19;

// the control block (CTRL_* in kernels/serve.py)
constexpr int kRexec = 0;
constexpr int kLive = 1;
constexpr int kSteps = 2;
constexpr int kBudget = 3;
constexpr int kTicket = 4;
constexpr int kNStages = 5;
constexpr int kThresh0 = 6;
constexpr int kMaxStages = 8;
constexpr int kPad0 = kThresh0 + kMaxStages;

constexpr int kMaxShards = 64;  // K26's pointer table

// the per-lane counters (SCR_* in kernels/serve.py)
constexpr int kScrFail = 0;
constexpr int kScrActive = 1;
constexpr int kScrMaxc = 2;

constexpr int kThreads = 256;
constexpr int kFinishItems = 8;  // K15: rows (or slots) per thread
constexpr int kFinishChunk = kThreads * kFinishItems;
constexpr int kCompactThreads = 1024;
constexpr int kCompactItems = 8;  // K14: rows per thread and tile

// What every launch gets, by value (the wrapper's _LaneArgs mirrors it).
struct LaneArgs {
  int* slot[kCarryLen];   // the carry, lane-leading
  const int* comb;        // int32[B, V, W]: neighbor id | beats << 30
  const int* degrees;     // int32[B, V]
  const int* k0;          // int32[B]
  const int* max_steps;   // int32[B]
  const int* reset;       // int32[B]
  int* nxt;               // int32[B, V]
  int* scratch;           // int32[3, B]
  int* ctrl;              // int32[kPad0 + kMaxStages]
  const int* spec;        // int32[B] or null: the tag a flagged lane gets
  const int* cancel;      // int32[B] or null: kill a spec-tagged lane
  int b;
  int v;
  int w;
  int a0;
  int planes;
  int stall_window;
  int budget;
};

// K26's arguments, by value: each shard's control block.
struct FoldArgs {
  int* ctrl[kMaxShards];
  int n;
};

// The deepest stage whose entry threshold covers the lane's previous
// active count (batched.py:316-319).
__device__ __forceinline__ int desired_rung(const int* ctrl, int prev_active) {
  int d = 0;
  const int n = ctrl[kNStages];
  for (int s = 1; s < n; ++s) {
    if (prev_active <= ctrl[kThresh0 + s - 1]) d = s;
  }
  return d;
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// One live lane's superstep outcome from its scalars and its counters.
struct LaneStep {
  bool any_fail;
  bool fin;
  bool first;
  bool store1;
  bool store2;
  int stall;
  int status;
  int step;
};

__device__ __forceinline__ LaneStep lane_step(const LaneArgs& a, int b,
                                              int fail, int active) {
  LaneStep t;
  t.any_fail = fail > 0;
  t.stall = active < a.slot[kCPrevActive][b] ? 0 : a.slot[kCStall][b] + 1;
  // FAILURE > SUCCESS > STALLED > RUNNING (bucketed.py:193 status_step)
  t.status = t.any_fail ? dgc::kFailure
             : active == 0 ? dgc::kSuccess
             : t.stall >= a.stall_window ? dgc::kStalled
             : dgc::kRunning;
  t.step = a.slot[kCStep][b] + 1;
  t.fin = t.status != dgc::kRunning || t.step >= a.max_steps[b];
  t.first = a.slot[kCPhase][b] == 0;
  t.store1 = t.fin && t.first;
  t.store2 = t.fin && !t.first;
  return t;
}

// Fold a lane's next routing into the block's shared min and any.
__device__ __forceinline__ void route(const int* ctrl, int rung,
                                      int prev_active, int* s_min,
                                      int* s_any) {
  atomicMin(s_min, max(rung, desired_rung(ctrl, prev_active)));
  *s_any = 1;
}

// ---- K16: slice entry ---------------------------------------------------

template <bool kTiming, bool kPartial>
__global__ void __launch_bounds__(kThreads) lane_reset_kernel(LaneArgs a) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool fresh = a.reset[b] != 0;
  const size_t lane = static_cast<size_t>(b) * a.v;
  if (r < a.v) {
    const size_t o = lane + r;
    if (fresh) {
      const int pk0 = a.degrees[o] == 0 ? 0 : 1;  // initial_packed
      a.slot[kCPacked][o] = pk0;
      a.slot[kCP1][o] = 0;
      a.slot[kCP2][o] = 0;
      a.nxt[o] = pk0;
    }
  }
  if (fresh && r < a.a0) a.slot[kCIdx][static_cast<size_t>(b) * a.a0 + r] = a.v;
  if (blockIdx.x != 0 || blockIdx.y != 0) return;

  // block (0, 0): every lane's scalars, the counters, the control block
  __shared__ int s_ts;
  __shared__ int s_min;
  __shared__ int s_any;
  if (threadIdx.x == 0) {
    s_ts = kTiming ? dgc::globaltimer_us() : 0;  // one reading for all
    s_min = a.ctrl[kNStages] - 1;
    s_any = 0;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < a.b; l += blockDim.x) {
    if (a.reset[l] != 0) {
      a.slot[kCPhase][l] = 0;
      a.slot[kCK][l] = a.k0[l];
      a.slot[kCStep][l] = 1;
      a.slot[kCPrevActive][l] = a.v + 1;
      a.slot[kCStall][l] = 0;
      a.slot[kCS1][l] = 0;
      a.slot[kCSt1][l] = 0;
      a.slot[kCUsed][l] = 0;
      a.slot[kCS2][l] = 0;
      a.slot[kCSt2][l] = dgc::kFailure;
      a.slot[kCTUs][l] = 0;
      a.slot[kCTPrev][l] = 0;
      a.slot[kCRung][l] = 0;
      a.slot[kCNc][l] = 0;
      a.slot[kCIdxRung][l] = 0;
      a.slot[kCSpec][l] = 0;
    }
    if (a.spec != nullptr || a.cancel != nullptr) {
      // the speculation plane, after the re-init and before the timing
      // seed and the routing fold: a flagged lane is seated with its tag
      // and is never killed (reset beats cancel); a cancelled spec-tagged
      // lane is done before any superstep runs
      const bool fresh = a.reset[l] != 0;
      const int tag = fresh ? (a.spec != nullptr ? a.spec[l] : 0)
                            : a.slot[kCSpec][l];
      a.slot[kCSpec][l] = tag;
      if (!fresh && tag != 0 && a.cancel != nullptr && a.cancel[l] != 0) {
        a.slot[kCPhase][l] = 2;
      }
    }
    const int phase = a.slot[kCPhase][l];
    // a lane without a sample is attributed from the slice boundary
    if (kTiming && phase < 2 && a.slot[kCTPrev][l] == 0) a.slot[kCTPrev][l] = s_ts;
    a.scratch[kScrFail * a.b + l] = 0;
    a.scratch[kScrActive * a.b + l] = 0;
    a.scratch[kScrMaxc * a.b + l] = -1;
    if (phase < 2) {
      route(a.ctrl, a.slot[kCRung][l], a.slot[kCPrevActive][l], &s_min, &s_any);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.ctrl[kRexec] = s_min;
    // a shard's partial: any lane live (K26 applies the budget)
    a.ctrl[kLive] = s_any != 0 && (kPartial || a.budget > 0);
    a.ctrl[kSteps] = 0;
    a.ctrl[kBudget] = a.budget;
    a.ctrl[kTicket] = 0;
  }
}

// ---- K14: stage-entry recompaction --------------------------------------
//
// One block per lane; the lane's rows in tiles of kCompactThreads x
// kCompactItems, each scanned block-wide, in order, the running count in
// shared memory. Active rows (uncolored or fresh) past the pad are
// dropped; the rest of the A0-wide list is the dummy V.

__global__ void __launch_bounds__(kCompactThreads) lane_compact_kernel(LaneArgs a) {
  const int b = blockIdx.x;
  if (a.ctrl[kLive] == 0) return;
  const int s = a.ctrl[kRexec];
  const int pad = a.ctrl[kPad0 + s];
  if (pad == 0) return;  // the full table: no slot list
  if (a.slot[kCPhase][b] >= 2 || a.slot[kCIdxRung][b] >= s) return;
  const int* __restrict__ pk = a.slot[kCPacked] + static_cast<size_t>(b) * a.v;
  int* __restrict__ idx = a.slot[kCIdx] + static_cast<size_t>(b) * a.a0;

  __shared__ int s_warp[kCompactThreads / 32];
  __shared__ int s_base;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t0 = 0; t0 < a.v; t0 += kCompactThreads * kCompactItems) {
    const int base = t0 + threadIdx.x * kCompactItems;
    unsigned bits = 0u;
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kCompactItems; ++i) {
      const int pos = base + i;
      if (pos < a.v) {
        const int w = pk[pos];
        if (w < 0 || (w & 1) != 0) {
          bits |= 1u << i;
          ++cnt;
        }
      }
    }
    int x = cnt;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
        if (lane >= o) t += y;
      }
      s_warp[lane] = t;
    }
    __syncthreads();
    int off = s_base + x - cnt + (warp > 0 ? s_warp[warp - 1] : 0);
    const int total = s_warp[kCompactThreads / 32 - 1];
#pragma unroll
    for (int i = 0; i < kCompactItems; ++i) {
      if ((bits >> i) & 1u) {
        if (off < pad) idx[off] = base + i;
        ++off;
      }
    }
    __syncthreads();  // every thread has read s_base and s_warp
    if (threadIdx.x == 0) s_base += total;
    __syncthreads();
  }
  for (int j = min(s_base, pad) + threadIdx.x; j < a.a0; j += kCompactThreads) {
    idx[j] = a.v;
  }
  if (threadIdx.x == 0) a.slot[kCIdxRung][b] = s;
}

// ---- K13: one batched superstep -----------------------------------------

template <int PB>
__global__ void __launch_bounds__(kThreads) lane_superstep_kernel(LaneArgs a) {
  if (a.ctrl[kLive] == 0) return;
  const int b = blockIdx.y;
  if (a.slot[kCPhase][b] >= 2) return;  // frozen
  const int pad = a.ctrl[kPad0 + a.ctrl[kRexec]];
  const int n = pad == 0 ? a.v : pad;
  if (static_cast<int>(blockIdx.x) * kThreads >= n) return;  // past the rung
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const size_t lane = static_cast<size_t>(b) * a.v;
  int row = -1;
  if (t < n) {
    row = pad == 0 ? t : a.slot[kCIdx][static_cast<size_t>(b) * a.a0 + t];
    if (row >= a.v) row = -1;  // a dummy slot: inert, its write dropped
  }
  bool fail = false;
  bool active = false;
  if (row >= 0) {
    const int* __restrict__ src = a.slot[kCPacked] + lane;
    const int* __restrict__ entries = a.comb + (lane + row) * a.w;
    const dgc::RowResult res = dgc::row_rule<PB, true>(
        src, entries, a.w, a.planes, a.slot[kCK][b], src[row], a.v);
    a.nxt[lane + row] = res.next;
    fail = res.fail;
    active = res.active;
  }
  const int nfail = __syncthreads_count(fail);
  const int nactive = __syncthreads_count(active);
  if (threadIdx.x == 0) {
    if (nfail) atomicAdd(a.scratch + kScrFail * a.b + b, nfail);
    if (nactive) atomicAdd(a.scratch + kScrActive * a.b + b, nactive);
  }
}

// ---- K15: transition, freeze, routing -----------------------------------

// The last block of K15: every live lane's scalars, the counters cleared,
// the next superstep's routing and the live word.
template <bool kTiming, bool kPartial>
__device__ void finish_lanes(const LaneArgs& a) {
  __shared__ int s_ts;
  __shared__ int s_min;
  __shared__ int s_any;
  if (threadIdx.x == 0) {
    s_ts = kTiming ? dgc::globaltimer_us() : 0;  // one reading per superstep
    s_min = a.ctrl[kNStages] - 1;
    s_any = 0;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < a.b; l += blockDim.x) {
    const int fail = load_volatile(a.scratch + kScrFail * a.b + l);
    const int active = load_volatile(a.scratch + kScrActive * a.b + l);
    const int maxc = load_volatile(a.scratch + kScrMaxc * a.b + l);
    a.scratch[kScrFail * a.b + l] = 0;
    a.scratch[kScrActive * a.b + l] = 0;
    a.scratch[kScrMaxc * a.b + l] = -1;
    const int phase = a.slot[kCPhase][l];
    if (phase >= 2) continue;  // frozen
    const LaneStep t = lane_step(a, l, fail, active);
    const int rung_now = max(a.slot[kCRung][l],
                             desired_rung(a.ctrl, a.slot[kCPrevActive][l]));
    const int used = t.store1 ? maxc + 1 : a.slot[kCUsed][l];
    const int status =
        t.status == dgc::kRunning && t.fin ? dgc::kStalled : t.status;
    const int k2 = used - 1;
    // an attempt-only (spec-tagged) lane never runs the confirm (:409-412)
    const bool run2 = t.fin && t.first && status == dgc::kSuccess && k2 >= 1 &&
                      a.slot[kCSpec][l] == 0;
    if constexpr (kTiming) {
      const int prev = a.slot[kCTPrev][l];
      if (prev > 0) {
        const unsigned delta =
            static_cast<unsigned>(s_ts - prev) & static_cast<unsigned>(dgc::kUsMask);
        a.slot[kCTUs][l] =
            static_cast<int>(static_cast<unsigned>(a.slot[kCTUs][l]) + delta);
      }
      a.slot[kCTPrev][l] = s_ts;
    }
    const int phase_new = t.fin ? (run2 ? 1 : 2) : phase;
    const int prev_new = t.fin ? a.v + 1 : active;
    const int rung_new = t.fin ? 0 : rung_now;
    a.slot[kCPhase][l] = phase_new;
    if (run2) a.slot[kCK][l] = k2;
    a.slot[kCStep][l] = t.fin ? 1 : t.step;
    a.slot[kCPrevActive][l] = prev_new;
    a.slot[kCStall][l] = t.fin ? 0 : t.stall;
    if (t.store1) {
      a.slot[kCS1][l] = t.step;
      a.slot[kCSt1][l] = status;
    }
    a.slot[kCUsed][l] = used;
    if (t.store2) {
      a.slot[kCS2][l] = t.step;
      a.slot[kCSt2][l] = status;
    }
    a.slot[kCRung][l] = rung_new;
    a.slot[kCNc][l] = active;
    if (t.fin) a.slot[kCIdxRung][l] = 0;
    if (phase_new < 2) route(a.ctrl, rung_new, prev_new, &s_min, &s_any);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int steps = a.ctrl[kSteps] + 1;
    a.ctrl[kSteps] = steps;
    a.ctrl[kRexec] = s_min;
    // a shard's partial: any lane live (K26 applies the budget)
    a.ctrl[kLive] = s_any != 0 && (kPartial || steps < a.ctrl[kBudget]);
    a.ctrl[kTicket] = 0;
  }
}

// Blocks (chunk, lane): a live lane's rows in the chunk, or its slots in a
// staged rung. A lane that finished its attempt: the result slot from the
// step's state (the pre-step one if the step failed), its max color, the
// re-init of both buffers. Else the step is adopted (packed <- nxt) or
// reverted (nxt <- packed). Then a ticket; the last block folds.
template <bool kTiming, bool kPartial>
__global__ void __launch_bounds__(kThreads) lane_finish_kernel(LaneArgs a) {
  if (a.ctrl[kLive] == 0) return;
  const int b = blockIdx.y;
  __shared__ int s_max[kThreads / 32];
  __shared__ bool s_last;
  if (a.slot[kCPhase][b] < 2) {
    const LaneStep t = lane_step(a, b, a.scratch[kScrFail * a.b + b],
                                 a.scratch[kScrActive * a.b + b]);
    const int pad = a.ctrl[kPad0 + a.ctrl[kRexec]];
    const size_t lane = static_cast<size_t>(b) * a.v;
    int* __restrict__ packed = a.slot[kCPacked] + lane;
    int* __restrict__ nxt = a.nxt + lane;
    const int c0 = blockIdx.x * kFinishChunk;
    if (t.fin) {
      int* __restrict__ out = a.slot[t.store1 ? kCP1 : kCP2] + lane;
      const int* __restrict__ deg = a.degrees + lane;
      int cmax = -1;
#pragma unroll
      for (int i = 0; i < kFinishItems; ++i) {
        const int r = c0 + i * kThreads + threadIdx.x;
        if (r < a.v) {
          const int w = t.any_fail ? packed[r] : nxt[r];
          out[r] = w;
          cmax = max(cmax, w >= 0 ? w >> 1 : -1);
          const int pk0 = deg[r] == 0 ? 0 : 1;
          packed[r] = pk0;
          nxt[r] = pk0;
        }
      }
      if (t.store1) {  // the colors used, for the confirm's budget
        cmax = __reduce_max_sync(0xFFFFFFFFu, cmax);
        if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = cmax;
        __syncthreads();
        if (threadIdx.x == 0) {
          int m = s_max[0];
#pragma unroll
          for (int i = 1; i < kThreads / 32; ++i) m = max(m, s_max[i]);
          if (m >= 0) atomicMax(a.scratch + kScrMaxc * a.b + b, m);
        }
      }
    } else if (pad == 0) {
#pragma unroll
      for (int i = 0; i < kFinishItems; ++i) {
        const int r = c0 + i * kThreads + threadIdx.x;
        if (r < a.v) {
          if (t.any_fail) {
            nxt[r] = packed[r];
          } else {
            packed[r] = nxt[r];
          }
        }
      }
    } else {
      const int* __restrict__ idx = a.slot[kCIdx] + static_cast<size_t>(b) * a.a0;
#pragma unroll
      for (int i = 0; i < kFinishItems; ++i) {
        const int j = c0 + i * kThreads + threadIdx.x;
        if (j < pad) {
          const int r = idx[j];
          if (r < a.v) {
            if (t.any_fail) {
              nxt[r] = packed[r];
            } else {
              packed[r] = nxt[r];
            }
          }
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int total = static_cast<int>(gridDim.x * gridDim.y);
    s_last = atomicAdd(a.ctrl + kTicket, 1) == total - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  finish_lanes<kTiming, kPartial>(a);
}

// ---- K26: the lane mesh's fold ------------------------------------------
//
// One warp: lane i < n reads shard i's partial, the warp reduces, then
// every lane writes the folded words into its shards' control blocks.

__global__ void __launch_bounds__(32) lane_mesh_fold_kernel(FoldArgs a) {
  int rung = INT_MAX;
  int any = 0;
  for (int i = threadIdx.x; i < a.n; i += 32) {
    rung = min(rung, load_volatile(a.ctrl[i] + kRexec));
    any |= load_volatile(a.ctrl[i] + kLive) != 0;
  }
  rung = __reduce_min_sync(0xFFFFFFFFu, rung);
  any = __reduce_or_sync(0xFFFFFFFFu, any);
  const int steps = load_volatile(a.ctrl[0] + kSteps);
  const int live = any != 0 && steps < load_volatile(a.ctrl[0] + kBudget);
  __syncwarp();
  for (int i = threadIdx.x; i < a.n; i += 32) {
    a.ctrl[i][kRexec] = rung;
    a.ctrl[i][kLive] = live;
    a.ctrl[i][kSteps] = steps;
    a.ctrl[i][kTicket] = 0;
  }
}

int span_of(const LaneArgs* a) { return a->v > a->a0 ? a->v : a->a0; }

bool args_ok(const LaneArgs* a) {
  return a->b >= 1 && a->b <= 65535 && a->v >= 1 && a->w >= 1 && a->a0 >= 1 &&
         a->planes >= 1 && a->planes <= 32;
}

template <int PB>
void launch_superstep(const LaneArgs* a, cudaStream_t st) {
  const dim3 grid((span_of(a) + kThreads - 1) / kThreads, a->b);
  lane_superstep_kernel<PB><<<grid, kThreads, 0, st>>>(*a);
}


}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 = launched); `a` is read on the
// host before the call returns.

// K16 and K15 take the instance from `timing` (kTiming) and `partial`
// (kPartial: a shard of the lane mesh, K26 folds next).
int dgc_lane_reset(const void* args, int timing, int partial, void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((span_of(a) + kThreads - 1) / kThreads, a->b);
  if (timing && partial) {
    lane_reset_kernel<true, true><<<grid, kThreads, 0, st>>>(*a);
  } else if (timing) {
    lane_reset_kernel<true, false><<<grid, kThreads, 0, st>>>(*a);
  } else if (partial) {
    lane_reset_kernel<false, true><<<grid, kThreads, 0, st>>>(*a);
  } else {
    lane_reset_kernel<false, false><<<grid, kThreads, 0, st>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

int dgc_lane_compact(const void* args, void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  lane_compact_kernel<<<a->b, kCompactThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int dgc_lane_superstep(const void* args, void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (a->planes <= 1) {
    launch_superstep<1>(a, st);
  } else if (a->planes <= 2) {
    launch_superstep<2>(a, st);
  } else if (a->planes <= 4) {
    launch_superstep<4>(a, st);
  } else if (a->planes <= 8) {
    launch_superstep<8>(a, st);
  } else if (a->planes <= 16) {
    launch_superstep<16>(a, st);
  } else {
    launch_superstep<32>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

int dgc_lane_finish(const void* args, int timing, int partial, void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((span_of(a) + kFinishChunk - 1) / kFinishChunk, a->b);
  if (timing && partial) {
    lane_finish_kernel<true, true><<<grid, kThreads, 0, st>>>(*a);
  } else if (timing) {
    lane_finish_kernel<true, false><<<grid, kThreads, 0, st>>>(*a);
  } else if (partial) {
    lane_finish_kernel<false, true><<<grid, kThreads, 0, st>>>(*a);
  } else {
    lane_finish_kernel<false, false><<<grid, kThreads, 0, st>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K26 over the `n` control blocks `ctrl` (a host array of n device
// pointers, copied into the launch's arguments).
int dgc_lane_mesh_fold(void* const* ctrl, int n, void* stream) {
  if (n < 1 || n > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs a{};
  for (int i = 0; i < n; ++i) a.ctrl[i] = static_cast<int*>(ctrl[i]);
  a.n = n;
  lane_mesh_fold_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Let `device` read and write `peer`'s memory (a lane mesh over several
// cards); 0 also when it already could.
int dgc_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: access is what was asked for
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : r);
}

int dgc_lane_args_size() { return static_cast<int>(sizeof(LaneArgs)); }
int dgc_max_shards() { return kMaxShards; }

}  // extern "C"
