// The batched serve tier's superstep for Hopper (sm_90a), with a plain C
// interface for ctypes (dgc_tpu_torch/kernels/serve.py).
//
// Replaces the jitted XLA programs of dgc_tpu/serve/batched.py (B12), one
// batched superstep of B lanes (graphs of one shape class) at a time:
//   K13 lane_superstep — B12a, :282 _superstep_body's stage branches with
//                        :231 _full_lane_superstep, :245
//                        _staged_lane_superstep and :223
//                        _lane_superstep_math: the speculative rule
//                        (rule.cuh's team walk) over every unconfirmed
//                        row of a lane (rung 0) or over the unconfirmed
//                        rows of its slot list's first pads[s] slots
//                        (rung s), into the back buffer `nxt`, and each
//                        lane's fail and active counts.
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
//   K26 lane_mesh_fold — the tail of those partial instances (mesh_tail):
//                        the last shard to finish folds: the min of the
//                        partial rungs, live = any(shard live) && steps <
//                        budget, the step count and a zeroed ticket,
//                        written into every shard's control block through
//                        a table of their pointers (FoldArgs, a launch
//                        argument of the partial instances alone). On one
//                        card the shards share a stream, so the last
//                        shard's launch folds, and only it gets the table:
//                        the others' partial is written before it starts.
//                        Across cards (FoldArgs.spread) every shard's
//                        block takes a ticket in shard 0's control block
//                        after a system fence, and the one that draws
//                        n - 1 folds and zeroes the ticket; system fences
//                        and atomics cost microseconds a launch, so the
//                        one-card mesh takes none.
//                        Every shard's next K14/K13 reads those words first,
//                        exactly as the unsharded slice does, so the host
//                        still enqueues a whole slice without a sync. A
//                        round past the live word runs no K15 tail, so
//                        it folds nothing; the folded words are a fixed
//                        point of the fold (min of equal rungs, any of
//                        zeros) all the same. K26 was a launch of its own
//                        after every round, one warp moving 104 bytes: its
//                        time was the launch's, which only a tail can save.
// Shards on other cards are read and written through peer access
// (dgc_enable_peer_access); the host orders the rounds across streams with
// events (kernels/serve.py MeshLanes), so the last shard to finish, on
// whichever card, folds before any shard's next launch.
//
// State. The carry is the reference's 20 slots (dgc_tpu_torch/layout.py),
// one lane-leading tensor each; the packed state of lane b is row b of
// slot 2, int32[B, V] with no pad slot: a neighbor id >= V reads as
// uncolored (rule.cuh kGatherLim). Beside it: the back buffer `nxt`
// int32[B, V], equal to `packed` in every lane between supersteps (made
// as its copy; K16 re-inits a flagged lane's row as it re-inits the
// lane's state; K15 restores it; the pool makes it again after a resize),
// so the BSP snapshot holds when K13 writes only the slot rows of a staged
// rung, or only the unconfirmed rows; the per-lane counters `scratch`
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
// read the real entries of each evaluated row that is not confirmed, each
// evaluated row's word and length, the lane's state once, and write the
// rows it changes. K14 reads a lane's V words and writes its A0 slots.
// K15 writes or copies the evaluated rows (the fin lanes' V words three
// times), and B scalars. K16 reads a flagged lane's V degrees and writes
// its rows; an unflagged lane costs its scalars only.
//
// K13 and K15 (the work the rung has). Each runs a bounded grid of
// co-resident blocks over the executed rung's work: each live lane's rows
// (the full table) or slots (a staged rung), and in K15 the V rows of a
// lane that ended its attempt. Every block reads every lane's scalars (one
// thread a lane, issued with the control block's words) and finds its
// lanes by a block-wide scan, so the grid does not depend on which lanes
// are live, and no host sync sizes it.
//   K13 splits the live lanes over the blocks (lane i of L takes blocks
// [iG/L, (i+1)G/L), which interleave its rows, so a lane's real rows and
// its padding spread evenly; with fewer blocks than lanes a block takes
// whole lanes). It walks only a row's real entries, up to its degree
// (csr_to_ell puts them first and fills the rest with the sentinel V),
// with rule.cuh's team walk (team_lanes, walk_row, group_passes: a group
// of 1-32 lanes a row by the class width, as K1, K5 and K23), fetching a
// warp's next rows while it walks the current ones, and skips a confirmed
// row: its rule returns its own word and counts nothing, and `nxt`
// already holds it. On a class of at most kStagedMaxV rows a block first
// copies the lane's packed state into shared memory with one bulk copy of
// the TMA (cp.async.bulk on an mbarrier) and gathers the neighbors' words
// there, where its share of the lane is long enough to pay for the copy
// (stage_rows_for; a gather from device memory costs a 32-byte sector);
// other blocks and wider classes gather from device memory. The fail and
// active counts go out as one atomic a warp and lane.
//   K15 gives each block a contiguous range of the chunks; a thread's
// words of a chunk are loaded together (four a load where the rows are
// 16-byte aligned) before any is stored. The blocks that had a range take
// a ticket; the last one runs every lane's scalar transition from the
// scalars it read at its start, with the ladder's thresholds in shared
// memory. K16 is one thread a row, written to be right and simple.
//
// K14 is one wave of co-resident blocks over the rebuilding lanes, several
// blocks a lane, 16-byte loads, one exchange of the blocks' counts in
// which every block reads every flag at once, and a dummy fill shared by
// the lane's blocks; its flags carry an epoch, so its scratch is made once
// with the lanes and never cleared (the K14 section below; K3's design in
// compact.cu). A block a lane walking its rows tile after tile is held by
// latency, not bandwidth, and on a one-lane batch (every batch of the
// serve replay) it would keep one SM of 132 busy.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "rule.cuh"
#include "tma.cuh"
#include "traj.cuh"

namespace {

using dgc::kTeamWords;

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
constexpr int kMeshTicket = kPad0 + kMaxStages;  // shard 0's: shards done

constexpr int kMaxShards = 64;  // the fold's pointer table

// the per-lane counters (SCR_* in kernels/serve.py)
constexpr int kScrFail = 0;
constexpr int kScrActive = 1;
constexpr int kScrMaxc = 2;

constexpr int kThreads = 256;
// K14: a block's threads; the 16-byte chunks a thread takes a tile, side by
// side (the grid is sized to give a block one tile)
constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactBlocksPerSm = 4;
constexpr int kCompactItems = 4;
constexpr int kCompactTile = kCompactThreads * kCompactItems;
// K13: a block's warps; the classes whose lane state a block stages
constexpr int kStepThreads = 512;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStagedMaxV = 32768;  // 128 KB of shared memory
// K15: a chunk of a lane's rows (or slots), 16 words a thread
constexpr int kFinishThreads = 256;
constexpr int kFinishItems = 16;
constexpr int kFinishChunk = kFinishThreads * kFinishItems;
constexpr unsigned kFull = 0xFFFFFFFFu;

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
  int* ctrl;              // int32[kMeshTicket + 1]
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

// The fold's arguments (the partial instances', by value): each shard's
// control block, a count of the folds made (on shard 0's card), the shard
// count (0: a shard's partial alone, no fold), whether the shards sit on
// several cards (then every shard takes the ticket; else this launch is
// the last shard's on a stream the shards share, and folds).
struct FoldArgs {
  int* ctrl[kMaxShards];
  int* folds;
  int n;
  int spread;
};

// The other instances' place for it: nothing, so their launches stay as
// they were.
struct NoFold {};

template <bool kPartial>
using FoldOf = typename std::conditional<kPartial, FoldArgs, NoFold>::type;

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

// The scalars lane_step reads, loaded together.
struct LaneScalars {
  int phase;
  int fail;
  int active;
  int prev_active;
  int stall;
  int step;
  int max_steps;
};

__device__ __forceinline__ LaneScalars lane_scalars(const LaneArgs& a, int b) {
  LaneScalars x;
  x.phase = a.slot[kCPhase][b];
  x.fail = a.scratch[kScrFail * a.b + b];
  x.active = a.scratch[kScrActive * a.b + b];
  x.prev_active = a.slot[kCPrevActive][b];
  x.stall = a.slot[kCStall][b];
  x.step = a.slot[kCStep][b];
  x.max_steps = a.max_steps[b];
  return x;
}

__device__ __forceinline__ LaneStep lane_step(const LaneScalars& x,
                                              int stall_window) {
  LaneStep t;
  t.any_fail = x.fail > 0;
  t.stall = x.active < x.prev_active ? 0 : x.stall + 1;
  // FAILURE > SUCCESS > STALLED > RUNNING (bucketed.py:193 status_step)
  t.status = t.any_fail ? dgc::kFailure
             : x.active == 0 ? dgc::kSuccess
             : t.stall >= stall_window ? dgc::kStalled
             : dgc::kRunning;
  t.step = x.step + 1;
  t.fin = t.status != dgc::kRunning || t.step >= x.max_steps;
  t.first = x.phase == 0;
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

// ---- K26: the lane mesh's fold, in the partial K15/K16's tail -------------
//
// A shard's partial as its tail writes it (thread 0's): the rung, whether
// any lane is live, the steps and the budget.
struct Partial {
  int rung;
  int live;
  int steps;
  int budget;
};

// On one card, the other shards' partials, read by warp 0 of every block
// with the control block at the launch's start (their launches have ended;
// the last block folds): lane i reads shards i and i + 32 unless they are
// its own, and shard 0's steps and budget unless shard 0 is its own (own0),
// into registers that nothing reads until the fold. Across cards nothing:
// the fold reads after the ticket.
struct FoldPre {
  int rung[2];
  int live[2];
  int steps0;
  int budget0;
  int own0;
};

__device__ __forceinline__ FoldPre fold_pre(const FoldArgs& f,
                                            const int* own) {
  FoldPre p{{INT_MAX, INT_MAX}, {0, 0}, 0, 0, 0};
  if (f.n == 0 || f.spread || threadIdx.x >= 32) return p;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = threadIdx.x + 32 * k;
    const bool take = i < f.n && f.ctrl[i] != own;
    if (take) {
      p.rung[k] = load_volatile(f.ctrl[i] + kRexec);
      p.live[k] = load_volatile(f.ctrl[i] + kLive);
    }
  }
  p.own0 = f.ctrl[0] == own;
  if (!p.own0) {
    p.steps0 = load_volatile(f.ctrl[0] + kSteps);
    p.budget0 = load_volatile(f.ctrl[0] + kBudget);
  }
  return p;
}

__device__ __forceinline__ FoldPre fold_pre(const NoFold&, const int*) {
  return FoldPre{};
}

// Called by every thread of the block that has just written its shard's
// partial (`own`, thread 0's); warp 0 alone goes on, with no block barrier.
// Across cards thread 0 publishes the partial and takes the mesh ticket, and
// only the block that draws n - 1 goes on, then reads every shard's
// partial; on one card this block goes on with `pre`. The warp folds: the
// rungs' min, the live words' OR, shard 0's steps and budget; then every
// lane writes the folded words into its shards' control blocks.
__device__ __forceinline__ void mesh_tail(const FoldArgs& f,
                                          const FoldPre& pre,
                                          const Partial& own) {
  if (f.n == 0 || threadIdx.x >= 32) return;  // uniform: a partial alone
  int fold = 1;
  if (f.spread && threadIdx.x == 0) {
    __threadfence_system();  // the partial, before the ticket
    fold = atomicAdd_system(f.ctrl[0] + kMeshTicket, 1) == f.n - 1;
  }
  if (__shfl_sync(0xFFFFFFFFu, fold, 0) == 0) return;
  // thread 0's partial
  const Partial s_own{__shfl_sync(0xFFFFFFFFu, own.rung, 0),
                      __shfl_sync(0xFFFFFFFFu, own.live, 0),
                      __shfl_sync(0xFFFFFFFFu, own.steps, 0),
                      __shfl_sync(0xFFFFFFFFu, own.budget, 0)};
  int rung = INT_MAX;
  int any = 0;
  int steps0;
  int budget0;
  if (f.spread) {
    __threadfence_system();  // every partial, after the ticket
    for (int i = threadIdx.x; i < f.n; i += 32) {
      rung = min(rung, load_volatile(f.ctrl[i] + kRexec));
      any |= load_volatile(f.ctrl[i] + kLive) != 0;
    }
    steps0 = load_volatile(f.ctrl[0] + kSteps);
    budget0 = load_volatile(f.ctrl[0] + kBudget);
  } else {
    rung = min(min(pre.rung[0], pre.rung[1]), s_own.rung);
    any = (pre.live[0] | pre.live[1]) != 0 || s_own.live != 0;
    steps0 = pre.own0 ? s_own.steps : pre.steps0;
    budget0 = pre.own0 ? s_own.budget : pre.budget0;
  }
  rung = __reduce_min_sync(0xFFFFFFFFu, rung);
  any = __reduce_or_sync(0xFFFFFFFFu, any);
  const int live = any != 0 && steps0 < budget0;
  for (int i = threadIdx.x; i < f.n; i += 32) {
    f.ctrl[i][kRexec] = rung;
    f.ctrl[i][kLive] = live;
    f.ctrl[i][kSteps] = steps0;
    f.ctrl[i][kTicket] = 0;
  }
  if (threadIdx.x == 0) {
    if (f.spread) f.ctrl[0][kMeshTicket] = 0;
    atomicAdd_system(f.folds, 1);
  }
}

__device__ __forceinline__ void mesh_tail(const NoFold&, const FoldPre&,
                                          const Partial&) {}

// ---- K16: slice entry ---------------------------------------------------

template <bool kTiming, bool kPartial>
__global__ void __launch_bounds__(kThreads)
lane_reset_kernel(LaneArgs a, FoldOf<kPartial> f) {
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
  const FoldPre pre = fold_pre(f, a.ctrl);
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
    // a shard's partial: any lane live (the fold applies the budget)
    a.ctrl[kLive] = s_any != 0 && (kPartial || a.budget > 0);
    a.ctrl[kSteps] = 0;
    a.ctrl[kBudget] = a.budget;
    a.ctrl[kTicket] = 0;
  }
  mesh_tail(f, pre, Partial{s_min, s_any, 0, a.budget});
}

// ---- K13 and K15: lanes and their work ----------------------------------

// The control block's routing words, loaded together: the live word, the
// executed rung and its pad (every stage's pad read, the rung's selected).
struct Route {
  int live;
  int rexec;
  int pad;
};

__device__ __forceinline__ Route read_route(const int* ctrl) {
  int pads[kMaxStages];
#pragma unroll
  for (int s = 0; s < kMaxStages; ++s) pads[s] = ctrl[kPad0 + s];
  const int rexec = ctrl[kRexec];
  Route r;
  r.live = ctrl[kLive];
  r.rexec = rexec;
  r.pad = pads[0];
#pragma unroll
  for (int s = 1; s < kMaxStages; ++s) {
    if (rexec == s) r.pad = pads[s];
  }
  return r;
}

// The block's exclusive scan of x, in lane order, and the block's total
// (blockDim.x a multiple of 32). Every thread calls it.
__device__ __forceinline__ long long block_scan(long long x, long long* s_warp,
                                                long long& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  long long before = 0;
  total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const long long c = s_warp[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();  // read before the next scan writes them
  return before + inc - x;
}

// The work units of every lane summed: work(l) is {units, flags} of lane
// l, units 0 for a lane with none. Every thread calls it.
template <class Work>
__device__ __forceinline__ long long work_total(int b, long long* s_warp,
                                                Work work) {
  long long total = 0;
  for (int t0 = 0; t0 < b; t0 += blockDim.x) {
    const int l = t0 + threadIdx.x;
    const int c = l < b ? work(l).x : 0;
    long long tile;
    block_scan(c, s_warp, tile);
    total += tile;
  }
  return total;
}

// The shared words of each_lane, one a thread of the block.
struct LaneList {
  long long* warp;  // [blockDim / 32]
  int* units;       // [blockDim]
  long long* off;   // [blockDim]
  int* flags;       // [blockDim]
  int* first;       // the tile's first and last lanes of the range
  int* last;
};

// Lane l's units [off, off + units) in the order of lanes: each lane
// whose units meet [lo, hi), in lane order, as each(l, j0, j1, flags)
// with [j0, j1) the lane's units in the range. Every thread calls it; the
// lanes of a range are consecutive among those with work, so a tile's are
// found by its first and last.
template <class Work, class Each>
__device__ __forceinline__ void each_lane(int b, long long lo, long long hi,
                                          const LaneList& s, Work work,
                                          Each each) {
  long long base = 0;
  for (int t0 = 0; t0 < b && base < hi; t0 += blockDim.x) {
    const int t = threadIdx.x;
    const int l = t0 + t;
    const int2 wk = l < b ? work(l) : make_int2(0, 0);
    if (t == 0) {
      *s.first = blockDim.x;
      *s.last = -1;
    }
    long long tile;
    const long long off = base + block_scan(wk.x, s.warp, tile);
    const bool meets = wk.x > 0 && off < hi && off + wk.x > lo;
    s.units[t] = meets ? wk.x : 0;
    s.off[t] = off;
    s.flags[t] = wk.y;
    if (meets) {
      atomicMin(s.first, t);
      atomicMax(s.last, t);
    }
    __syncthreads();
    const int first = *s.first;
    const int last = *s.last;
    for (int i = first; i <= last; ++i) {  // uniform over the block
      const int c = s.units[i];
      if (c == 0) continue;
      const long long o = s.off[i];
      each(t0 + i, static_cast<int>((lo > o ? lo : o) - o),
           static_cast<int>((hi < o + c ? hi : o + c) - o), s.flags[i]);
    }
    __syncthreads();  // read before the next tile writes them
    base += tile;
  }
}

// ---- K13: one batched superstep -----------------------------------------

// Lane b's rows (its rows, or its slots of a staged rung: a slot past V
// is inert) in batches of a warp's rows: this block takes batches q0, q0 +
// dq, ... of the n items (a lane's blocks interleave theirs, so each holds
// as many real rows as another). A row goes to a group of team_lanes(w)
// lanes of a warp (one lane a row up to 32 entries), which walks its real
// entries, gathering the neighbors' words from `src` (the lane's state in
// device memory, or staged in shared memory) as kGather says. A confirmed
// row is skipped. A warp fetches its next rows' slots, words and degrees
// while it walks the current ones. One atomic a warp for each of fail and
// active.
template <int kGather>
__device__ __forceinline__ void lane_rows(const LaneArgs& a, int b,
                                          const int* src, int n, int q0,
                                          int dq, int pad, uint32_t* s_rows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = dgc::team_lanes(a.w);
  const int per_warp = 32 / lanes;    // rows a warp takes at a time
  const int sub = lane / lanes;       // the warp's row of this lane
  const int gl = lane & (lanes - 1);  // the lane in its row's group
  uint32_t* s_fa = s_rows + warp * kTeamWords + sub * 2 * lanes;
  const size_t base = static_cast<size_t>(b) * a.v;
  const int* __restrict__ idx = a.slot[kCIdx] + static_cast<size_t>(b) * a.a0;
  const int k = a.slot[kCK][b];
  // the row of item j (-1: past the items, or a dummy slot), its word and
  // its degree
  auto fetch = [&](int j, int& row, int& me, int& deg) {
    row = -1;
    if (j < n) {
      row = pad == 0 ? j : idx[j];
      if (row >= a.v) row = -1;
    }
    me = row >= 0 ? src[row] : 0;
    deg = row >= 0 ? a.degrees[base + row] : 0;
  };
  int nfail = 0;
  int nactive = 0;
  int row, me, deg;
  int q = q0 + warp;
  fetch(q * per_warp + sub, row, me, deg);
  for (; q * per_warp < n; q += dq) {
    int next_row, next_me, next_deg;
    fetch((q + dq) * per_warp + sub, next_row, next_me, next_deg);
    const bool walk = row >= 0 && !dgc::is_confirmed(me);  // uniform a group
    const int len = walk ? min(deg, a.w) : 0;
    const int* __restrict__ entries =
        a.comb + (base + (walk ? row : 0)) * static_cast<size_t>(a.w);
    bool clash = false;
    bool found = false;     // a color under k is free of every neighbor
    int cand = k;           // first-fit over all colored neighbors
    bool old_free = false;  // a color under k is free of confirmed ones
    const int done = dgc::group_passes<kGather>(
        src, entries, len, gl, lanes, a.v, walk, a.planes, me >> 1, s_fa,
        s_fa + lanes, clash, [&](int pg, uint32_t fa, uint32_t fo) {
          dgc::fold_plane(fa, fo, pg, k, found, cand, old_free);
        });
    bool fail = false;
    bool active = false;
    if (walk && gl == 0) {
      if (done < a.planes) dgc::fold_plane(0u, 0u, done, k, found, cand, old_free);
      const dgc::RowResult res = dgc::finish_rule(me, clash, found, cand, old_free);
      a.nxt[base + row] = res.next;
      fail = res.fail;
      active = res.active;
    }
    nfail += __popc(__ballot_sync(kFull, fail));
    nactive += __popc(__ballot_sync(kFull, active));
    row = next_row;
    me = next_me;
    deg = next_deg;
  }
  if (lane == 0) {
    if (nfail) atomicAdd(a.scratch + kScrFail * a.b + b, nfail);
    if (nactive) atomicAdd(a.scratch + kScrActive * a.b + b, nactive);
  }
}

// The live lanes of ranks [r0, r0 + n) into s_list (n <= blockDim), and
// the count of live lanes (live(l): lane l is live). Every thread calls
// it; s_list is complete on return.
template <class Live>
__device__ __forceinline__ int live_lanes(int b, int r0, int n, int* s_list,
                                          long long* s_warp, Live live) {
  int base = 0;
  for (int t0 = 0; t0 < b; t0 += blockDim.x) {
    const int l = t0 + threadIdx.x;
    const bool on = l < b && live(l);
    long long tile;
    const int rank = base + static_cast<int>(block_scan(on ? 1 : 0, s_warp, tile));
    if (on && rank >= r0 && rank < r0 + n) s_list[rank - r0] = l;
    base += static_cast<int>(tile);
  }
  __syncthreads();
  return base;
}

// A block's share of the live lanes (K13) or the rebuilding ones (K14):
// the ranks [r0, r1), and its part of the `parts` blocks of lane r0. With
// G blocks for L lanes (G >= L) lane i takes blocks [iG/L, (i+1)G/L); with
// fewer blocks than lanes, block g takes the lanes [gL/G, (g+1)L/G) whole
// (part 0 of 1). In 32-bit arithmetic, which a 64-bit division would slow
// by about a microsecond a launch: grid * nlive < 2^32, both at most
// 65,535 (args_ok, and a grid of co-resident blocks).
struct BlockShare {
  int r0, r1, part, parts;
};

__host__ __device__ inline BlockShare block_share(unsigned g, unsigned grid,
                                                  unsigned nlive) {
  BlockShare s;
  if (grid >= nlive) {
    s.r0 = static_cast<int>(((g + 1) * nlive - 1) / grid);
    s.r1 = s.r0 + 1;
    const unsigned g0 = s.r0 * grid / nlive;
    const unsigned g1 = (s.r0 + 1) * grid / nlive;
    s.part = static_cast<int>(g - g0);
    s.parts = static_cast<int>(g1 - g0);
  } else {
    s.r0 = static_cast<int>(g * nlive / grid);
    s.r1 = static_cast<int>((g + 1) * nlive / grid);
    s.part = 0;
    s.parts = 1;
  }
  return s;
}

// Whether a block stages a lane's state (a class of at most kStagedMaxV
// rows): when its share of the lane's n items is stage_rows rows or more.
__host__ __device__ inline bool stages_lane(int n, int dq, int stage_rows) {
  return static_cast<long long>(n) * kStepWarps >=
         static_cast<long long>(stage_rows) * dq;
}

// The live lanes split over the grid by rank (block_share). With kStaged
// (a class of at most kStagedMaxV rows) a block first copies a lane's
// state into shared memory where stages_lane says so. Where the lanes fit
// one tile of the block, each thread reads its lane's phase with the
// control block, before either is needed.
template <bool kStaged>
__global__ void __launch_bounds__(kStepThreads, 1)
lane_superstep_kernel(LaneArgs a, int stage_rows) {
  extern __shared__ __align__(128) unsigned char s_dyn[];  // the lane's state
  __shared__ uint32_t s_rows[kStepWarps * kTeamWords];
  __shared__ long long s_warp[kStepWarps];
  __shared__ int s_list[kStepThreads];
  __shared__ __align__(8) uint64_t s_bar;
  const bool one_tile = a.b <= kStepThreads;
  const int my_phase =
      one_tile && static_cast<int>(threadIdx.x) < a.b
          ? a.slot[kCPhase][threadIdx.x] : 2;
  const Route routing = read_route(a.ctrl);
  if (routing.live == 0) return;
  const int pad = routing.pad;
  const int n = pad == 0 ? a.v : pad;
  auto live = [&](int l) {
    return (one_tile ? my_phase : a.slot[kCPhase][l]) < 2;
  };
  // one tile: every live lane's rank listed at once
  const int nlive = live_lanes(a.b, 0, one_tile ? kStepThreads : 0, s_list,
                               s_warp, live);
  if (nlive == 0) return;
  // a lane's blocks interleave its batches of rows
  const BlockShare sh = block_share(blockIdx.x, gridDim.x, nlive);
  const int r0 = sh.r0, r1 = sh.r1;
  const int q0 = sh.part * kStepWarps, dq = sh.parts * kStepWarps;
  const bool stage = kStaged && stages_lane(n, dq, stage_rows);
  if (stage) {  // uniform over the block
    if (threadIdx.x == 0) {
      dgc::mbar_init(&s_bar);
      dgc::fence_async_shared();  // the barrier, before the first bulk copy
    }
    __syncthreads();  // the barrier set up before any thread polls it
  }
  uint32_t parity = 0;
  for (int c0 = r0; c0 < r1; c0 += kStepThreads) {
    const int cn = min(kStepThreads, r1 - c0);
    if (!one_tile) live_lanes(a.b, c0, cn, s_list, s_warp, live);
    for (int r = c0; r < c0 + cn; ++r) {  // uniform over the block
      const int b = s_list[one_tile ? r : r - c0];
      const int* __restrict__ packed =
          a.slot[kCPacked] + static_cast<size_t>(b) * a.v;
      if (stage) {
        if (threadIdx.x == 0) {
          dgc::fence_async_shared();  // after the last lane's reads
          const uint32_t bytes = static_cast<uint32_t>(a.v) * 4u;
          dgc::mbar_expect(&s_bar, bytes);
          dgc::bulk_load(s_dyn, packed, bytes, &s_bar);
        }
        while (!dgc::mbar_test(&s_bar, parity)) {
        }
        parity ^= 1u;
        lane_rows<dgc::kGatherShared>(a, b, reinterpret_cast<const int*>(s_dyn),
                                      n, q0, dq, pad, s_rows);
        __syncthreads();  // every warp is done with the staged state
      } else {
        lane_rows<dgc::kGatherLim>(a, b, packed, n, q0, dq, pad, s_rows);
      }
    }
    __syncthreads();  // s_list read before the next chunk lists
  }
}

// ---- K14: stage-entry recompaction --------------------------------------
//
// One wave of co-resident blocks (a cooperative launch: the runtime refuses
// a grid that could not all be resident at once) over the lanes that
// rebuild: each live lane whose slot list was built at a shallower rung
// than the executed one s (phase < 2, idx_rung < s). Every block reads the
// control block first and returns at once when the live word is 0 or rung
// s has no slot list (pad 0); then it finds the rebuilding lanes by a
// block-wide scan over every lane's phase and idx_rung (one thread a lane),
// so the grid does not depend on which lanes rebuild and no host sync
// sizes it, and returns when there are none.
//   The lanes split over the grid as K13's do: with G blocks for L lanes
// (G >= L) lane i takes blocks [iG/L, (i+1)G/L), each a contiguous part of
// the lane's 16-byte chunks of `packed`; with fewer blocks than lanes,
// block g takes lanes [gL/G, (g+1)L/G) whole. A block reads its part in
// tiles, kCompactItems neighbouring chunks a thread (their loads in flight
// together), and counts the active rows (uncolored or fresh) with one
// block-wide scan a tile; the first tile's bits and scan stay in registers
// for the writes, a later tile is read again.
//   The exchange. Every block publishes one 64-bit flag, epoch << 32 |
// count, in scratch[1 + block], and reads every block's flag at once, one a
// thread, until each carries this launch's epoch (a look-back over the
// whole grid in one round trip; co-residency makes the wait safe). Its
// lane's earlier blocks' counts give its first slot, all its lane's blocks'
// counts the lane's count. It then lists a tile's slots in shared memory
// and stores them in order, neighbouring threads on neighbouring slots (the
// slots at or past pad are dropped), and writes its share of the lane's
// dummy fill [min(count, pad), A0), four slots a store where aligned. A
// block that has its lanes whole writes them before the exchange.
//   The trap. Every block reads every lane's idx_rung to find its lanes, so
// idx_rung[b] = s is written only after the exchange, when every block has
// published, and so has read them: by the lane's first block. The epoch:
// scratch[0] holds the last rebuilding launch's; a launch that rebuilds
// takes the next one (never 0, a fresh scratch's), and block 0 stores it
// after the exchange, once every block has read the old one. So the
// scratch, made once with the lanes (kernels/serve.py new_lanes), is never
// cleared: no flag an earlier launch left reads as this launch's.

// A part of lane b's rows in 16-byte chunks: chunk c holds rows 4c - head
// to 4c - head + 3 (those in [0, V)); the part is chunks [c0, c1), in
// tiles of kCompactTile. Its bounds in 32 bits (launch_compact checks that
// the products fit), as block_share's.
struct LanePart {
  const int* pk;  // the lane's packed words
  int* idx;       // the lane's slot list
  int head;
  int c0;
  int c1;
  int tiles;
};

__device__ __forceinline__ LanePart lane_part(const LaneArgs& a, int b,
                                              unsigned part, unsigned parts) {
  LanePart p;
  p.pk = a.slot[kCPacked] + static_cast<size_t>(b) * a.v;
  p.idx = a.slot[kCIdx] + static_cast<size_t>(b) * a.a0;
  p.head = static_cast<int>((reinterpret_cast<uintptr_t>(p.pk) >> 2) & 3);
  const unsigned nc = (static_cast<unsigned>(a.v) + p.head + 3) >> 2;
  p.c0 = static_cast<int>(nc * part / parts);
  p.c1 = static_cast<int>(nc * (part + 1) / parts);
  p.tiles = (p.c1 - p.c0 + kCompactTile - 1) / kCompactTile;
  return p;
}

// This thread's first chunk of tile t.
__device__ __forceinline__ int tile_chunk(const LanePart& p, int t) {
  return p.c0 + t * kCompactTile + threadIdx.x * kCompactItems;
}

// This thread's chunks of tile t, their active bits (bit 4u + j: row j of
// its chunk u is uncolored or fresh); a row outside [0, V) or a chunk past
// the part is not active. The loads are issued together.
__device__ __forceinline__ unsigned tile_bits(const LanePart& p, int v,
                                              int t) {
  const int cb = tile_chunk(p, t);
  const int4* pk4 = reinterpret_cast<const int4*>(p.pk - p.head);
  int4 q[kCompactItems];
#pragma unroll
  for (int u = 0; u < kCompactItems; ++u) {
    const int c = cb + u;
    const int p0 = 4 * c - p.head;
    q[u] = make_int4(0, 0, 0, 0);  // 0: a confirmed color 0, not active
    if (c >= p.c1) continue;
    if (p0 >= 0 && p0 + 4 <= v) {
      q[u] = __ldg(pk4 + c);
    } else {
      int w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = p0 + j >= 0 && p0 + j < v ? __ldg(p.pk + p0 + j) : 0;
      }
      q[u] = make_int4(w[0], w[1], w[2], w[3]);
    }
  }
  const auto act = [](int w) { return w < 0 || (w & 1) != 0 ? 1u : 0u; };
  unsigned bits = 0u;
#pragma unroll
  for (int u = 0; u < kCompactItems; ++u) {
    bits |= (act(q[u].x) | act(q[u].y) << 1 | act(q[u].z) << 2 |
             act(q[u].w) << 3) << (4 * u);
  }
  return bits;
}

// A part's count: one scan a tile; the first tile's bits, scan and total
// kept (every thread calls it).
struct PartCount {
  unsigned bits0;
  int excl0;
  int total0;
  int count;
};

__device__ __forceinline__ PartCount count_part(const LanePart& p, int v,
                                                long long* s_warp) {
  PartCount c{0u, 0, 0, 0};
  for (int t = 0; t < p.tiles; ++t) {
    const unsigned bits = tile_bits(p, v, t);
    long long total;
    const int excl = static_cast<int>(block_scan(__popc(bits), s_warp, total));
    if (t == 0) {
      c.bits0 = bits;
      c.excl0 = excl;
      c.total0 = static_cast<int>(total);
    }
    c.count += static_cast<int>(total);
  }
  return c;
}

// The part's slots from `first` on, in order (those at or past pad
// dropped): a tile's listed in s_out at their places, then stored side by
// side; then its share (part of parts) of the lane's dummy fill
// [min(count, pad), A0) with V. Every thread calls it.
__device__ __forceinline__ void write_part(const LaneArgs& a,
                                          const LanePart& p,
                                          const PartCount& c, int first,
                                          int count, int pad, int part,
                                          int parts, long long* s_warp,
                                          int* s_out) {
  const int tid = threadIdx.x;
  int run = first;
  for (int t = 0; t < p.tiles && run < pad; ++t) {  // uniform
    unsigned bits = c.bits0;
    int excl = c.excl0;
    int total = c.total0;
    if (t > 0) {
      bits = tile_bits(p, a.v, t);
      long long sum;
      excl = static_cast<int>(block_scan(__popc(bits), s_warp, sum));
      total = static_cast<int>(sum);
    }
    const int p0 = 4 * tile_chunk(p, t) - p.head;
    int k = excl;
    while (bits != 0u) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1u;
      s_out[k++] = p0 + j;
    }
    __syncthreads();
    const int n = min(total, pad - run);
    for (int i = tid; i < n; i += kCompactThreads) p.idx[run + i] = s_out[i];
    __syncthreads();  // s_out read before the next tile lists
    run += total;
  }
  const int f = min(count, pad);
  const unsigned span = static_cast<unsigned>(a.a0 - f);
  const unsigned up = static_cast<unsigned>(part);
  const unsigned ups = static_cast<unsigned>(parts);
  const int f0 = f + static_cast<int>(span * up / ups);
  const int f1 = f + static_cast<int>(span * (up + 1) / ups);
  // slot i is 16-byte aligned iff (ih + i) % 4 == 0
  const int ih =
      static_cast<int>((reinterpret_cast<uintptr_t>(p.idx) >> 2) & 3);
  const int q0 = min(f0 + ((4 - (ih + f0) % 4) % 4), f1);
  const int q1 = max(f1 - (ih + f1) % 4, q0);
  for (int i = f0 + tid; i < q0; i += kCompactThreads) p.idx[i] = a.v;
  const int4 dummy = make_int4(a.v, a.v, a.v, a.v);
  for (int i = q0 + 4 * tid; i < q1; i += 4 * kCompactThreads) {
    *reinterpret_cast<int4*>(p.idx + i) = dummy;
  }
  for (int i = q1 + tid; i < f1; i += kCompactThreads) p.idx[i] = a.v;
}

__global__ void __launch_bounds__(kCompactThreads, kCompactBlocksPerSm)
lane_compact_kernel(LaneArgs a, unsigned long long* scratch) {
  __shared__ int s_out[4 * kCompactTile];  // a tile's slots
  __shared__ long long s_warp[kCompactWarps];
  __shared__ int s_list[kCompactThreads];
  __shared__ unsigned s_epoch;
  const Route routing = read_route(a.ctrl);
  if (routing.live == 0 || routing.pad == 0) return;  // uniform
  const int s = routing.rexec;
  const int pad = routing.pad;
  const bool one_tile = a.b <= kCompactThreads;
  auto rebuilds = [&](int l) {
    return a.slot[kCPhase][l] < 2 && a.slot[kCIdxRung][l] < s;
  };
  // one tile of lanes: every rebuilding lane's rank listed at once
  const int nl = live_lanes(a.b, 0, one_tile ? kCompactThreads : 0, s_list,
                            s_warp, rebuilds);
  if (nl == 0) return;  // uniform: no lane rebuilds, the epoch stays
  const int tid = threadIdx.x;
  if (tid == 0) {
    const unsigned e = static_cast<unsigned>(dgc::load_flag(scratch)) + 1u;
    s_epoch = e == 0u ? 1u : e;
  }
  const long long grid = gridDim.x;
  const long long g = blockIdx.x;
  const BlockShare sh = block_share(blockIdx.x, gridDim.x, nl);
  const int r0 = sh.r0, r1 = sh.r1, part = sh.part, parts = sh.parts;
  const long long g0 = g - part;  // the lane's first block
  if (!one_tile) live_lanes(a.b, r0, r1 - r0, s_list, s_warp, rebuilds);
  const int list0 = one_tile ? 0 : r0;
  // a block with its lanes whole writes them now; a part of a lane counts
  PartCount mine{0u, 0, 0, 0};
  for (int r = r0; r < r1; ++r) {  // uniform
    const LanePart p = lane_part(a, s_list[r - list0], part, parts);
    mine = count_part(p, a.v, s_warp);
    if (parts == 1) {
      write_part(a, p, mine, 0, mine.count, pad, 0, 1, s_warp, s_out);
    }
  }

  // the exchange: every block's flag, all at once
  __syncthreads();  // s_epoch set; every thread has read the lanes
  const unsigned epoch = s_epoch;
  unsigned long long* flags = scratch + 1;
  if (tid == 0) {
    dgc::store_flag(flags + g,
                    static_cast<unsigned long long>(epoch) << 32 |
                        static_cast<unsigned>(parts > 1 ? mine.count : 0));
  }
  // the counts of the lane's earlier blocks (high word) and of all its
  // blocks (low word): each under 2^30, so the sums do not mix
  long long both = 0;
  const long long g1 = g0 + parts;
  for (long long j = tid; j < grid; j += kCompactThreads) {
    unsigned long long f;
    do {
      f = dgc::load_flag(flags + j);
    } while (static_cast<unsigned>(f >> 32) != epoch);
    const long long c = static_cast<long long>(f & 0xFFFFFFFFULL);
    if (j >= g0 && j < g1) both += (j < g ? c << 32 : 0) + c;
  }
  block_scan(both, s_warp, both);
  // every block has read the old epoch and every lane's idx_rung
  if (g == 0 && tid == 0) dgc::store_flag(scratch, epoch);
  if (parts > 1) {
    const LanePart p = lane_part(a, s_list[r0 - list0], part, parts);
    write_part(a, p, mine, static_cast<int>(both >> 32),
               static_cast<int>(both & 0xFFFFFFFFLL), pad, part, parts,
               s_warp, s_out);
  }
  if (part == 0 && tid < r1 - r0) {
    a.slot[kCIdxRung][s_list[r0 - list0 + tid]] = s;
  }
}

// ---- K15: transition, freeze, routing -----------------------------------

// The ladder's deepest stage whose entry threshold covers a lane's
// previous active count (batched.py:316-319), over thresholds in shared
// memory.
__device__ __forceinline__ int desired_rung_of(const int* s_thresh, int n,
                                               int prev_active) {
  int d = 0;
  for (int s = 1; s < n; ++s) {
    if (prev_active <= s_thresh[s - 1]) d = s;
  }
  return d;
}

// Every scalar of a lane K15 reads: lane_step's, and the tail's.
struct LaneFull {
  LaneScalars x;
  int rung;
  int used;
  int spec;
  int t_prev;
  int t_us;
};

template <bool kTiming>
__device__ __forceinline__ LaneFull lane_full(const LaneArgs& a, int l) {
  LaneFull f;
  f.x = lane_scalars(a, l);
  f.rung = a.slot[kCRung][l];
  f.used = a.slot[kCUsed][l];
  f.spec = a.slot[kCSpec][l];
  f.t_prev = kTiming ? a.slot[kCTPrev][l] : 0;
  f.t_us = kTiming ? a.slot[kCTUs][l] : 0;
  return f;
}

// The last block of K15: every live lane's scalars, the counters cleared,
// the next superstep's routing and the live word. `mine` holds lane
// threadIdx.x's scalars, loaded with the control block, where the lanes
// fit one tile (`one_tile`); the others are loaded here, all together.
// The counters are not reloaded: K13 wrote them before the launch, and the
// max color only where a lane stores its first result.
template <bool kTiming, bool kPartial>
__device__ Partial finish_lanes(const LaneArgs& a, bool one_tile,
                                const LaneFull& mine, const int* s_ctrl) {
  __shared__ int s_ts;
  __shared__ int s_min;
  __shared__ int s_any;
  const int* s_thresh = s_ctrl + kThresh0;
  const int nstages = s_ctrl[kNStages];
  if (threadIdx.x == 0) {
    s_ts = kTiming ? dgc::globaltimer_us() : 0;  // one reading per superstep
    s_min = nstages - 1;
    s_any = 0;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < a.b; l += blockDim.x) {
    const LaneFull f = one_tile ? mine : lane_full<kTiming>(a, l);
    const LaneScalars& x = f.x;
    a.scratch[kScrFail * a.b + l] = 0;
    a.scratch[kScrActive * a.b + l] = 0;
    if (x.phase >= 2) {  // frozen
      a.scratch[kScrMaxc * a.b + l] = -1;
      continue;
    }
    const LaneStep t = lane_step(x, a.stall_window);
    const int maxc = t.store1 ? load_volatile(a.scratch + kScrMaxc * a.b + l) : -1;
    a.scratch[kScrMaxc * a.b + l] = -1;
    const int rung_now =
        max(f.rung, desired_rung_of(s_thresh, nstages, x.prev_active));
    const int used = t.store1 ? maxc + 1 : f.used;
    const int status =
        t.status == dgc::kRunning && t.fin ? dgc::kStalled : t.status;
    const int k2 = used - 1;
    // an attempt-only (spec-tagged) lane never runs the confirm (:409-412)
    const bool run2 = t.fin && t.first && status == dgc::kSuccess && k2 >= 1 &&
                      f.spec == 0;
    if constexpr (kTiming) {
      if (f.t_prev > 0) {
        const unsigned delta = static_cast<unsigned>(s_ts - f.t_prev) &
                               static_cast<unsigned>(dgc::kUsMask);
        a.slot[kCTUs][l] = static_cast<int>(static_cast<unsigned>(f.t_us) + delta);
      }
      a.slot[kCTPrev][l] = s_ts;
    }
    const int phase_new = t.fin ? (run2 ? 1 : 2) : x.phase;
    const int prev_new = t.fin ? a.v + 1 : x.active;
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
    a.slot[kCNc][l] = x.active;
    if (t.fin) a.slot[kCIdxRung][l] = 0;
    if (phase_new < 2) {
      atomicMin(&s_min, max(rung_new, desired_rung_of(s_thresh, nstages, prev_new)));
      s_any = 1;
    }
  }
  __syncthreads();
  const int steps = s_ctrl[kSteps] + 1;
  if (threadIdx.x == 0) {
    a.ctrl[kSteps] = steps;
    a.ctrl[kRexec] = s_min;
    // a shard's partial: any lane live (the fold applies the budget)
    a.ctrl[kLive] = s_any != 0 && (kPartial || steps < s_ctrl[kBudget]);
    a.ctrl[kTicket] = 0;
  }
  return Partial{s_min, s_any, steps, s_ctrl[kBudget]};
}

// K15's flags of a lane
constexpr int kFin = 1;
constexpr int kAnyFail = 2;
constexpr int kStore1 = 4;

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ void st4(int* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}
__device__ __forceinline__ int pk0_of(int degree) { return degree == 0 ? 0 : 1; }
__device__ __forceinline__ int color_of(int w) { return w >= 0 ? w >> 1 : -1; }

// Chunk q of lane b's work. A lane that finished its attempt (kFin): the
// result slot from the step's state (the pre-step one if the step
// failed), its max color, the re-init of both buffers, over its V rows.
// Else the step adopted (packed <- nxt) or reverted (nxt <- packed) over
// its rows (the full table) or its slots. A thread's kFinishItems words:
// every load first, then the stores (four words a load where `vec`: the
// lanes' rows are 16-byte aligned).
__device__ __forceinline__ void finish_chunk(const LaneArgs& a, int b, int q,
                                             int flags, int pad, bool vec) {
  const size_t base = static_cast<size_t>(b) * a.v;
  int* __restrict__ packed = a.slot[kCPacked] + base;
  int* __restrict__ nxt = a.nxt + base;
  const bool fail = (flags & kAnyFail) != 0;
  const int* __restrict__ src = fail ? packed : nxt;
  const int j0 = q * kFinishChunk;
  const int tid = threadIdx.x;
  constexpr int kQuads = kFinishItems / 4;
  if ((flags & kFin) != 0) {
    const int r1 = min(a.v, j0 + kFinishChunk);
    int* __restrict__ out = a.slot[(flags & kStore1) != 0 ? kCP1 : kCP2] + base;
    const int* __restrict__ deg = a.degrees + base;
    int cmax = -1;
    if (vec) {
      int4 w[kQuads];
      int4 d[kQuads];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int r = j0 + 4 * (tid + u * kFinishThreads);
        if (r < r1) {
          w[u] = ld4(src + r);
          d[u] = ld4(deg + r);
        }
      }
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int r = j0 + 4 * (tid + u * kFinishThreads);
        if (r < r1) {
          st4(out + r, w[u]);
          cmax = max(cmax, max(max(color_of(w[u].x), color_of(w[u].y)),
                               max(color_of(w[u].z), color_of(w[u].w))));
          const int4 p = make_int4(pk0_of(d[u].x), pk0_of(d[u].y),
                                   pk0_of(d[u].z), pk0_of(d[u].w));
          st4(packed + r, p);
          st4(nxt + r, p);
        }
      }
    } else {
      int w[kFinishItems];
      int d[kFinishItems];
#pragma unroll
      for (int u = 0; u < kFinishItems; ++u) {
        const int r = j0 + tid + u * kFinishThreads;
        if (r < r1) {
          w[u] = src[r];
          d[u] = deg[r];
        }
      }
#pragma unroll
      for (int u = 0; u < kFinishItems; ++u) {
        const int r = j0 + tid + u * kFinishThreads;
        if (r < r1) {
          out[r] = w[u];
          cmax = max(cmax, color_of(w[u]));
          packed[r] = pk0_of(d[u]);
          nxt[r] = pk0_of(d[u]);
        }
      }
    }
    if ((flags & kStore1) != 0) {  // the colors used, for the confirm's budget
      cmax = __reduce_max_sync(kFull, cmax);
      if ((tid & 31) == 0 && cmax >= 0) {
        atomicMax(a.scratch + kScrMaxc * a.b + b, cmax);
      }
    }
    return;
  }
  int* __restrict__ dst = fail ? nxt : packed;
  if (pad == 0 && vec) {
    const int r1 = min(a.v, j0 + kFinishChunk);
    int4 w[kQuads];
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int r = j0 + 4 * (tid + u * kFinishThreads);
      if (r < r1) w[u] = ld4(src + r);
    }
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const int r = j0 + 4 * (tid + u * kFinishThreads);
      if (r < r1) st4(dst + r, w[u]);
    }
    return;
  }
  // the full table one word a load, or a staged rung's slots: their rows
  // first, then the words
  const int* __restrict__ idx = a.slot[kCIdx] + static_cast<size_t>(b) * a.a0;
  const int j1 = min(pad == 0 ? a.v : pad, j0 + kFinishChunk);
  int r[kFinishItems];
#pragma unroll
  for (int u = 0; u < kFinishItems; ++u) {
    const int j = j0 + tid + u * kFinishThreads;
    r[u] = j >= j1 ? a.v : pad == 0 ? j : idx[j];
  }
  int w[kFinishItems];
#pragma unroll
  for (int u = 0; u < kFinishItems; ++u) w[u] = r[u] < a.v ? src[r[u]] : 0;
#pragma unroll
  for (int u = 0; u < kFinishItems; ++u) {
    if (r[u] < a.v) dst[r[u]] = w[u];
  }
}

// A block's range of the live lanes' chunks: a lane that finished its
// attempt has V rows, another its rows (the full table) or its slots.
// Where the lanes fit one tile, each thread reads its lane's scalars with
// the control block, before either is needed, and the last block's tail
// uses them. The blocks that had a range take the ticket (after a fence
// where they wrote a max color, the only word of theirs the tail reads);
// the last one folds (one block alone when no lane had work).
template <bool kTiming, bool kPartial>
__global__ void __launch_bounds__(kFinishThreads)
lane_finish_kernel(LaneArgs a, int vec, FoldOf<kPartial> f) {
  __shared__ long long s_warp[kFinishThreads / 32];
  __shared__ int s_units[kFinishThreads];
  __shared__ long long s_off[kFinishThreads];
  __shared__ int s_flags[kFinishThreads];
  __shared__ int s_first;
  __shared__ int s_last;
  __shared__ bool s_is_last;
  __shared__ int s_ctrl[kPad0];  // the control block's words the tail reads
  const bool one_tile = a.b <= kFinishThreads;
  LaneFull mine{};
  mine.x.phase = 2;
  if (one_tile && static_cast<int>(threadIdx.x) < a.b) {
    mine = lane_full<kTiming>(a, threadIdx.x);
  }
  const int ctrl_word = threadIdx.x < kPad0 ? a.ctrl[threadIdx.x] : 0;
  // the fold's other partials (the last block folds), read with the
  // control block
  const FoldPre pre = fold_pre(f, a.ctrl);
  const Route routing = read_route(a.ctrl);
  if (routing.live == 0) return;
  if (threadIdx.x < kPad0) s_ctrl[threadIdx.x] = ctrl_word;
  const int pad = routing.pad;
  const int chunks_v = (a.v + kFinishChunk - 1) / kFinishChunk;
  const int chunks_p = (pad + kFinishChunk - 1) / kFinishChunk;
  auto work = [&](int l) {
    const LaneScalars x = one_tile ? mine.x : lane_scalars(a, l);
    if (x.phase >= 2) return make_int2(0, 0);
    const LaneStep t = lane_step(x, a.stall_window);
    return make_int2(t.fin || pad == 0 ? chunks_v : chunks_p,
                     (t.fin ? kFin : 0) | (t.any_fail ? kAnyFail : 0) |
                         (t.store1 ? kStore1 : 0));
  };
  const long long total = work_total(a.b, s_warp, work);
  const long long grid = total < gridDim.x ? total : gridDim.x;
  const long long per = grid > 0 ? (total + grid - 1) / grid : 0;
  const int used = per > 0 ? static_cast<int>((total + per - 1) / per) : 1;
  if (static_cast<int>(blockIdx.x) >= used) return;  // uniform
  bool maxed = false;  // uniform: this block wrote a max color
  if (per > 0) {
    const long long lo = static_cast<long long>(blockIdx.x) * per;
    const long long hi = lo + per < total ? lo + per : total;
    const LaneList list{s_warp, s_units, s_off, s_flags, &s_first, &s_last};
    each_lane(a.b, lo, hi, list, work, [&](int b, int q0, int q1, int flags) {
      for (int q = q0; q < q1; ++q) finish_chunk(a, b, q, flags, pad, vec != 0);
      maxed = maxed || (flags & kStore1) != 0;
    });
  }
  if (maxed) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_is_last = atomicAdd(a.ctrl + kTicket, 1) == used - 1;
  __syncthreads();
  if (!s_is_last) return;
  __threadfence();
  const Partial own = finish_lanes<kTiming, kPartial>(a, one_tile, mine, s_ctrl);
  mesh_tail(f, pre, own);
}

int span_of(const LaneArgs* a) { return a->v > a->a0 ? a->v : a->a0; }

bool args_ok(const LaneArgs* a) {
  return a->b >= 1 && a->b <= 65535 && a->v >= 1 && a->w >= 1 && a->a0 >= 1 &&
         a->planes >= 1 && a->planes <= 32;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

// The most co-resident blocks of `fn` at `threads` and `smem` bytes of
// dynamic shared memory on the current device (0 on an error), cached per
// device, instance and size. A kernel with more than 48 KB of dynamic
// shared memory is allowed `max_smem` on each device once.
int co_resident(const void* fn, int threads, size_t smem, size_t max_smem) {
  struct Entry {
    const void* fn;
    size_t smem;
    int dev;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int cached = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> hold(mu);
  bool attr_set = max_smem <= 48 * 1024;
  for (int i = 0; i < cached; ++i) {
    const Entry& e = cache[i];
    if (e.fn == fn && e.dev == dev) {
      if (e.smem == smem) return e.blocks;
      attr_set = true;  // set when the first size was
    }
  }
  if (!attr_set &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(max_smem)) != cudaSuccess) {
    return 0;
  }
  int occ = 0;
  int sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const int blocks = occ * sms;
  if (cached < 64) cache[cached++] = Entry{fn, smem, dev, blocks};
  return blocks;
}

// K13's rows a block's share of a lane needs before the block stages the
// lane's state: a share of r rows of about w / 2 real entries each gathers
// ~16 w r bytes of 32-byte sectors from device memory; staging copies the
// lane's 4 V bytes once. Stage when the gathers would move more.
int stage_rows_for(const LaneArgs* a) {
  const int r = a->v / (4 * a->w);
  return r > 1 ? r : 1;
}

// K13's launch: its instance (the lane state staged or not), dynamic
// shared memory and grid; false on an error.
struct StepLaunch {
  bool staged;
  size_t smem;
  int grid;
};

bool superstep_launch(const LaneArgs* a, StepLaunch* s) {
  s->staged = a->v <= kStagedMaxV && a->v % 4 == 0 &&
              aligned16(a->slot[kCPacked]);
  const void* fn = s->staged
                       ? reinterpret_cast<const void*>(lane_superstep_kernel<true>)
                       : reinterpret_cast<const void*>(lane_superstep_kernel<false>);
  s->smem = s->staged ? static_cast<size_t>(a->v) * 4 : 0;
  const int most = co_resident(fn, kStepThreads, s->smem,
                               static_cast<size_t>(kStagedMaxV) * 4);
  if (most < 1) return false;
  const long long need = (static_cast<long long>(a->b) * span_of(a) +
                          kStepThreads - 1) / kStepThreads;
  s->grid = static_cast<int>(need < most ? need : most);
  return true;
}

int launch_superstep(const LaneArgs* a, cudaStream_t st) {
  StepLaunch s;
  if (!superstep_launch(a, &s)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int rows = stage_rows_for(a);
  if (s.staged) {
    lane_superstep_kernel<true><<<s.grid, kStepThreads, s.smem, st>>>(*a, rows);
  } else {
    lane_superstep_kernel<false><<<s.grid, kStepThreads, 0, st>>>(*a, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int compact_grid_max() {
  return co_resident(reinterpret_cast<const void*>(lane_compact_kernel),
                     kCompactThreads, 0, 0);
}

// K14's grid: a tile of chunks a block were every lane to rebuild, at
// least enough blocks that none lists more than a tile of lanes, at most
// every block resident at once (the cooperative launch checks) and a flag
// a block in the scratch.
int launch_compact(const LaneArgs* a, unsigned long long* scratch, int slots,
                   cudaStream_t st) {
  int most = compact_grid_max();
  if (most > slots) most = slots;
  const long long chunks = static_cast<long long>(a->b) * ((a->v + 6) / 4);
  const long long floor = (a->b + kCompactThreads - 1) / kCompactThreads;
  long long grid = (chunks + kCompactTile - 1) / kCompactTile;
  if (grid < floor) grid = floor;
  if (grid > most) grid = most;
  if (most < 1 || grid < floor) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // lane_part's and write_part's 32-bit products
  if ((a->v / 4 + 2LL) * grid > 0xFFFFFFFFLL ||
      static_cast<long long>(a->a0) * grid > 0xFFFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaneArgs args = *a;
  void* params[] = {&args, &scratch};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lane_compact_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(kCompactThreads), params, 0,
      st);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kTiming, bool kPartial>
int launch_finish(const LaneArgs* a, const FoldOf<kPartial>& f,
                  cudaStream_t st) {
  const void* fn =
      reinterpret_cast<const void*>(lane_finish_kernel<kTiming, kPartial>);
  const int most = co_resident(fn, kFinishThreads, 0, 0);
  if (most < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long need =
      static_cast<long long>(a->b) *
      ((span_of(a) + kFinishChunk - 1) / kFinishChunk);
  const int grid = static_cast<int>(need < most ? need : most);
  const int vec = a->v % 4 == 0 && aligned16(a->slot[kCPacked]) &&
                  aligned16(a->nxt) && aligned16(a->slot[kCP1]) &&
                  aligned16(a->slot[kCP2]) && aligned16(a->degrees);
  lane_finish_kernel<kTiming, kPartial><<<grid, kFinishThreads, 0, st>>>(
      *a, vec, f);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTiming, bool kPartial>
int launch_reset(const LaneArgs* a, const FoldOf<kPartial>& f,
                 cudaStream_t st) {
  const dim3 grid((span_of(a) + kThreads - 1) / kThreads, a->b);
  lane_reset_kernel<kTiming, kPartial><<<grid, kThreads, 0, st>>>(*a, f);
  return static_cast<int>(cudaGetLastError());
}

bool fold_ok(const FoldArgs* f) {
  return f->n >= 0 && f->n <= kMaxShards && (f->n == 0 || f->folds != nullptr);
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 = launched); `a` is read on the
// host before the call returns.

// K16 and K15 take the instance from `timing` (kTiming) and `fold`
// (kPartial where it is not null: a shard of the lane mesh, its partial
// and the fold's tail, with the fold's arguments, read on the host before
// the call returns; n = 0 for a shard's partial alone).
int dgc_lane_reset(const void* args, int timing, const void* fold,
                   void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  const auto* f = static_cast<const FoldArgs*>(fold);
  if (!args_ok(a) || (f != nullptr && !fold_ok(f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (timing && f) return launch_reset<true, true>(a, *f, st);
  if (timing) return launch_reset<true, false>(a, NoFold{}, st);
  if (f) return launch_reset<false, true>(a, *f, st);
  return launch_reset<false, false>(a, NoFold{}, st);
}

// The most blocks K14 launches on the current device (0 on an error): its
// scratch holds one flag a block after the epoch.
int dgc_lane_compact_grid_max() { return compact_grid_max(); }

// scratch: uint64[1 + slots], zeroed once when made (the epoch and the
// flags), used by one stream at a time.
int dgc_lane_compact(const void* args, void* scratch, int slots,
                     void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  if (!args_ok(a) || scratch == nullptr || slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_compact(a, static_cast<unsigned long long*>(scratch), slots,
                        static_cast<cudaStream_t>(stream));
}

int dgc_lane_superstep(const void* args, void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_superstep(a, static_cast<cudaStream_t>(stream));
}

// K13's launch on `a` where `nlive` lanes are live and the executed rung
// has `pad` slots (0: the full table), as the blocks would split it:
// out[0] its grid, out[1] the blocks that stage a lane's state into shared
// memory, out[2] those that gather from device memory (the others).
int dgc_lane_superstep_plan(const void* args, int nlive, int pad, int* out) {
  const auto* a = static_cast<const LaneArgs*>(args);
  if (!args_ok(a) || nlive < 0 || nlive > a->b || pad < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StepLaunch s;
  if (!superstep_launch(a, &s)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int n = pad == 0 ? a->v : pad;
  const int rows = stage_rows_for(a);
  out[0] = s.grid;
  out[1] = 0;
  out[2] = 0;
  for (int g = 0; g < s.grid && nlive > 0; ++g) {
    const BlockShare sh = block_share(g, s.grid, nlive);
    if (sh.r0 == sh.r1) continue;  // no lane of its own
    ++out[s.staged && stages_lane(n, sh.parts * kStepWarps, rows) ? 1 : 2];
  }
  return 0;
}

int dgc_lane_finish(const void* args, int timing, const void* fold,
                    void* stream) {
  const auto* a = static_cast<const LaneArgs*>(args);
  const auto* f = static_cast<const FoldArgs*>(fold);
  if (!args_ok(a) || (f != nullptr && !fold_ok(f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (timing && f) return launch_finish<true, true>(a, *f, st);
  if (timing) return launch_finish<true, false>(a, NoFold{}, st);
  if (f) return launch_finish<false, true>(a, *f, st);
  return launch_finish<false, false>(a, NoFold{}, st);
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
int dgc_fold_args_size() { return static_cast<int>(sizeof(FoldArgs)); }
int dgc_max_shards() { return kMaxShards; }

}  // extern "C"
