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
// as the frontier shrinks. K3 reads and writes V words and writes the slot
// list (9 MB at the first stage, ~2.7 us). K4 reads the slots' rows (at
// most pad x 32 words) and writes them once. K6 is one control-block
// update, plus a copy of V words into the ring when it pushes. K4 and K6
// are one thread per item (K4) or per word (K6), written to be right and
// simple, not yet shaped for coalesced table reads.
//
// K5 was one thread per row, and latency held it, not bandwidth: each
// thread walked its row alone, one dependent gather after another, its
// neighbors' loads width * 4 bytes apart. So a row takes a group of lanes
// sized by its segment's width, reading it in 16-byte quads with eight
// gathers in flight a lane, and a confirmed row (which transitions to
// itself, counting nothing) reads no entry (the K5 section below).
//
// K3 is bound by its bytes, and what kept it from them was latency, not
// bandwidth: a single-pass scan over ~500 tiles waits on its predecessors'
// flags one at a time, and the dummy fill (most of the slot list at the
// first stage) fell to the last tile alone. So K3 is one wave of
// co-resident blocks, 16-byte loads and stores, one exchange of the
// blocks' counts in which every block reads every flag at once, and a
// dummy fill shared by the whole grid; its flags carry an epoch, so the
// engine's scratch is made once and never cleared between launches.

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

__device__ __forceinline__ void load_desc(int* s_desc, const int* desc,
                                          int nseg) {
  for (int i = threadIdx.x; i < nseg * kDescCols; i += blockDim.x) {
    s_desc[i] = desc[i];
  }
  __syncthreads();
}

// ---- K3: ordered stream compaction ------------------------------------
//
// One wave of co-resident blocks (a cooperative launch: the runtime
// refuses a grid that could not all be resident at once), each owning a
// contiguous range of the 16-byte chunks of `cur`'s rows [row0, V).
//
// Phase 1. A block reads its chunks with 16-byte loads and keeps each
// chunk's four active bits in shared memory. Its count goes out as one
// 64-bit flag (epoch << 32 | count) in `scratch[1 + block]`; only then
// does it write its last chunks over the other buffer (16-byte stores when
// the buffers' offset allows, else 8- or 4-byte ones), so no copy store
// queues ahead of the flag. Every block then reads all the grid's flags at
// once, one a thread (a look-back over the whole grid in one round trip:
// co-residency makes the wait safe): its predecessors' counts sum to its
// offset, all of them to the active count. Phase 2 writes the block's
// slots in order from its bits, and every block fills its share of
// [count, pad) with the dummy n.
//
// The epoch. `scratch[0]` holds the last launch's epoch; a launch uses the
// next one (never 0, the value of a fresh scratch), so a flag a previous
// launch left never reads as ready and the scratch needs no clearing.
// Block 0 stores the new epoch once it has seen every block's flag, that
// is once every block has read the old one.

constexpr int kSlotThreads = 512;
constexpr int kSlotWarps = kSlotThreads / 32;
constexpr int kSlotBlocksPerSm = 2;
constexpr int kSlotUnroll = 2;  // rounds of 16-byte loads in flight a thread
constexpr int kSlotMaxSmem = 96 * 1024;  // the chunks' bits of one block

// The exclusive prefix of x over the block and (in `total`) its sum; all
// threads call it.
__device__ __forceinline__ int slot_scan(int x, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kSlotWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kSlotWarps) s_warp[lane] = t;
  }
  __syncthreads();
  const int excl = inc - x + (warp > 0 ? s_warp[warp - 1] : 0);
  total = s_warp[kSlotWarps - 1];
  __syncthreads();  // s_warp is free for the next call
  return excl;
}

// Chunk c's four words over the other buffer at position p0 = 4c - head
// (kStore: the widest store the alignment of dst + p0 allows).
template <int kStore>
__device__ __forceinline__ void copy_chunk(int* dst, int p0, const int4& q) {
  if (kStore == 4) {
    *reinterpret_cast<int4*>(dst + p0) = q;
  } else if (kStore == 2) {
    int2* d2 = reinterpret_cast<int2*>(dst + p0);
    d2[0] = make_int2(q.x, q.y);
    d2[1] = make_int2(q.z, q.w);
  } else {
    dst[p0] = q.x;
    dst[p0 + 1] = q.y;
    dst[p0 + 2] = q.z;
    dst[p0 + 3] = q.w;
  }
}

// kStore: the widest store the other buffer's alignment allows at a
// chunk (4, 2 or 1 words: the buffers lie stride words apart).
template <int kStore>
__global__ void __launch_bounds__(kSlotThreads, kSlotBlocksPerSm)
compact_slots_kernel(const int* ctrl, int* state, size_t stride, int row0,
                     int n, int pad, int* __restrict__ idx,
                     unsigned long long* scratch) {
  extern __shared__ unsigned char s_bits[];  // a chunk's 4 bits a byte
  __shared__ int s_warp[kSlotWarps];
  __shared__ unsigned s_epoch;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int grid = gridDim.x;
  if (tid == 0) {
    const unsigned e = static_cast<unsigned>(load_flag(scratch)) + 1u;
    s_epoch = e == 0u ? 1u : e;
  }

  const int cur = ctrl[kCur];
  const int* src = state + cur * stride + row0;
  int* dst = state + (1 - cur) * stride + row0;
  // chunk c holds positions 4c - head .. 4c - head + 3 (16-byte aligned)
  const int head = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int4* __restrict__ src4 = reinterpret_cast<const int4*>(src - head);
  const int nc = (head + n + 3) >> 2;
  const int c0 = static_cast<int>(static_cast<long long>(nc) * b / grid);
  const int c1 = static_cast<int>(static_cast<long long>(nc) * (b + 1) / grid);
  const int rounds = (c1 - c0 + kSlotThreads - 1) / kSlotThreads;

  // phase 1: count the actives; the last batch's copy waits for the flag
  int cnt = 0;
  int4 q[kSlotUnroll];
  bool full[kSlotUnroll];
  int last = 0;  // the last batch's first round
  for (int r = 0; r < rounds; r += kSlotUnroll) {
    last = r;
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      const int c = c0 + (r + u) * kSlotThreads + tid;
      const int p0 = 4 * c - head;
      full[u] = r + u < rounds && c < c1 && p0 >= 0 && p0 + 4 <= n;
      if (full[u]) q[u] = src4[c];
    }
    const bool copy_now = r + kSlotUnroll < rounds;
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      if (r + u >= rounds) break;
      const int c = c0 + (r + u) * kSlotThreads + tid;
      const int p0 = 4 * c - head;
      int w[4] = {0, 0, 0, 0};  // 0: not active (a confirmed color 0)
      if (full[u]) {
        w[0] = q[u].x;
        w[1] = q[u].y;
        w[2] = q[u].z;
        w[3] = q[u].w;
        if (copy_now) copy_chunk<kStore>(dst, p0, q[u]);
      } else if (c < c1) {  // the first or the last chunk: word by word
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + j;
          if (p >= 0 && p < n) {
            w[j] = src[p];
            dst[p] = w[j];
          }
        }
      }
      unsigned bits = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (w[j] < 0 || (w[j] & 1) != 0) bits |= 1u << j;
      }
      s_bits[(r + u) * kSlotThreads + tid] = static_cast<unsigned char>(bits);
      cnt += __popc(bits);
    }
  }
  int count;
  slot_scan(cnt, s_warp, count);
  const unsigned epoch = s_epoch;
  unsigned long long* flags = scratch + 1;
  if (tid == 0) {
    store_flag(flags + b, (static_cast<unsigned long long>(epoch) << 32) |
                              static_cast<unsigned>(count));
  }
#pragma unroll
  for (int u = 0; u < kSlotUnroll; ++u) {
    if (last + u < rounds && full[u]) {
      copy_chunk<kStore>(dst, 4 * (c0 + (last + u) * kSlotThreads + tid) - head,
                         q[u]);
    }
  }

  // every block's count, all at once: this block's offset and the total
  int before = 0;
  int all = 0;
  for (int j = tid; j < grid; j += kSlotThreads) {
    unsigned long long f;
    do {
      f = load_flag(flags + j);
    } while (static_cast<unsigned>(f >> 32) != epoch);
    const int a = static_cast<int>(f & 0xFFFFFFFFULL);
    all += a;
    if (j < b) before += a;
  }
  int total;
  slot_scan(before, s_warp, before);
  slot_scan(all, s_warp, total);
  // every block has read the old epoch (it published under the new one)
  if (b == 0 && tid == 0) store_flag(scratch, epoch);

  // phase 2: the slots in order; actives past pad are dropped
  int run = before;
  for (int r = 0; r < rounds && run < pad; ++r) {
    const unsigned bits = s_bits[r * kSlotThreads + tid];
    int sum;
    int off = run + slot_scan(__popc(bits), s_warp, sum);
    const int p0 = 4 * (c0 + r * kSlotThreads + tid) - head;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((bits >> j) & 1u) {
        if (off < pad) idx[off] = p0 + j;
        ++off;
      }
    }
    run += sum;
  }

  // this block's share of the dummy fill [total, pad)
  if (total < pad) {
    const long long span = pad - total;
    const int f0 = total + static_cast<int>(span * b / grid);
    const int f1 = total + static_cast<int>(span * (b + 1) / grid);
    const int a0 = min((f0 + 3) & ~3, f1);  // idx is 16-byte aligned
    const int a1 = max(f1 & ~3, a0);
    for (int i = f0 + tid; i < a0; i += kSlotThreads) idx[i] = n;
    const int4 dummy = make_int4(n, n, n, n);
    for (int i = a0 / 4 + tid; i < a1 / 4; i += kSlotThreads) {
      reinterpret_cast<int4*>(idx)[i] = dummy;
    }
    for (int i = a1 + tid; i < f1; i += kSlotThreads) idx[i] = n;
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
//
// A group of `lanes` lanes a row, the smallest power of two (at most 32)
// whose lanes hold the row at kLaneEntries entries each (rule.cuh
// team_lanes; kernels/compact.py k5_lanes mirrors it). Each segment's rows
// take whole warps of 32 / lanes rows (seg_warps: its rows' warps rounded
// up, so no warp spans two segments and every group sits at a multiple of
// its size within its warp); the host passes the plan's warp total. A
// group reads its row in quads (walk_row: 16-byte loads where the row is
// aligned, eight gathers in flight a lane), so a warp reads 32 / lanes rows
// side by side; the group ORs the two register planes of each pass over
// its lanes with shuffles and the rest through its shared words (`lanes`
// words each of fa and fo a row: 64 a warp), so a pass holds 2 + lanes
// planes and a wider window makes more passes over the row. A confirmed
// row transitions to itself and counts nothing (finish_rule), so its
// entries are not read; the recording variant counts the unconfirmed real
// neighbors in the same pass.

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int seg_warps(const int* d) {
  return (d[1] * team_lanes(d[2]) + 31) >> 5;
}

template <bool kRecord>
__global__ void __launch_bounds__(kThreads)
segmented_superstep_kernel(int* ctrl, int* state, size_t stride,
                           const int* __restrict__ seg,
                           const int* __restrict__ desc, int nseg,
                           const int* __restrict__ gidx, int row_base,
                           int dummy, int k, int thresh, int max_steps,
                           int* umax, int ucol) {
  // the predicate reads slots this kernel never writes: uniform exit
  if (!stage_live(ctrl, thresh, max_steps)) return;
  __shared__ int s_desc[kMaxSegs * kDescCols];
  __shared__ int s_warp0[kMaxSegs + 1];  // each segment's first warp
  __shared__ uint32_t s_rows[kWarps * kTeamWords];
  load_desc(s_desc, desc, nseg);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {  // the segments' warps, prefix-summed, two a lane
    const int a = lane < nseg ? seg_warps(s_desc + lane * kDescCols) : 0;
    const int b =
        lane + 32 < nseg ? seg_warps(s_desc + (lane + 32) * kDescCols) : 0;
    int x = a;
    int y = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xa = __shfl_up_sync(0xFFFFFFFFu, x, o);
      const int yb = __shfl_up_sync(0xFFFFFFFFu, y, o);
      if (lane >= o) {
        x += xa;
        y += yb;
      }
    }
    const int first_half = __shfl_sync(0xFFFFFFFFu, x, 31);
    if (lane == 0) s_warp0[0] = 0;
    if (lane < nseg) s_warp0[lane + 1] = x;
    if (lane + 32 < nseg) s_warp0[lane + 33] = first_half + y;
  }
  __syncthreads();
  const int cur = ctrl[kCur];
  const int* __restrict__ src = state + cur * stride;
  int* __restrict__ dst = state + (1 - cur) * stride;
  const int pad = dummy - 1;  // the pad sentinel V

  const int gw = blockIdx.x * kWarps + warp;
  bool fail = false;
  bool active = false;
  int mc = -1;
  int unconf = 0;  // kRecord: the row's unconfirmed real neighbors
  if (gw < s_warp0[nseg]) {  // uniform over the warp
    int s = 0;
    while (s + 1 < nseg && s_warp0[s + 1] <= gw) ++s;
    const int* d = s_desc + s * kDescCols;
    const int width = d[2];
    const int planes = d[3];
    const int lanes = team_lanes(width);
    const int sub = lane / lanes;       // the warp's row of this lane
    const int gl = lane & (lanes - 1);  // the lane in its row's group
    const int rs = (gw - s_warp0[s]) * (32 / lanes) + sub;
    const bool valid = rs < d[1];
    const int r = d[0] + rs;
    const int g = valid ? (gidx != nullptr ? gidx[r] : row_base + r) : 0;
    // an unused slot is the dummy row: it changes nothing, counts nothing
    const bool eval = valid && (gidx == nullptr || g != dummy);
    const int me = eval ? src[g] : 0;
    const bool walk = eval && !is_confirmed(me);  // uniform over the group
    const int* __restrict__ row =
        seg + d[4] + static_cast<size_t>(valid ? rs : 0) * width;
    uint32_t* s_fa = s_rows + warp * kTeamWords + sub * 2 * lanes;
    uint32_t* s_fo = s_fa + lanes;
    const int per_pass = kRegPlanes + lanes;
    const int mycol = me >> 1;  // arithmetic: -1 stays -1
    bool clash = false;
    bool found = false;     // a color under k is free of every neighbor
    int cand = k;           // first-fit over all colored neighbors
    bool old_free = false;  // a color under k is free of confirmed ones
    int cnt = 0;
    for (int base = 0; base < planes; base += per_pass) {
      const int gp = min(per_pass, planes - base);
      s_fa[gl] = 0u;
      s_fo[gl] = 0u;
      __syncwarp();
      PlaneRegs pl;
      if (walk) {
        walk_row(src, row, width, gl, lanes, pad, [&](int e, int word) {
          add_word(e, word, base, gp, mycol, pl, s_fa, s_fo, clash);
          if constexpr (kRecord) {
            if (base == 0 && (e & kNbrMask) < pad && !is_confirmed(word)) {
              ++cnt;
            }
          }
        });
      }
      pl.or_xor(lanes >> 1);  // within the group
      __syncwarp();  // the group's shared words are complete
      if (walk && gl == 0) {
        for (int p = 0; p < gp; ++p) {
          const bool reg = p < kRegPlanes;
          const uint32_t fa = reg ? pl.fa(p) : s_fa[p - kRegPlanes];
          const uint32_t fo = reg ? pl.fo(p) : s_fo[p - kRegPlanes];
          fold_plane(fa, fo, base + p, k, found, cand, old_free);
        }
      }
      __syncwarp();  // read before the next pass clears them
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      clash |= __shfl_xor_sync(0xFFFFFFFFu, clash ? 1 : 0, o) != 0;
      if constexpr (kRecord) cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, o);
    }
    if (eval && gl == 0) {
      int next = me;
      if (walk) {
        const dgc::RowResult res =
            finish_rule(me, clash, found, cand, old_free);
        next = res.next;
        const long long window = 32LL * planes;
        const bool fail_valid = window >= width + 1LL || k <= window;
        fail = res.fail && fail_valid;
        active = res.active;
        mc = res.mc;
        // rows inactive before the step count 0
        if constexpr (kRecord) unconf = cnt;
      }
      dst[g] = next;
    }
  }

  const int nfail = __syncthreads_count(fail);
  const int nactive = __syncthreads_count(active);
  const int wmax = __reduce_max_sync(0xFFFFFFFFu, mc);
  __shared__ int warp_max[kWarps];
  __shared__ int warp_unconf[kWarps];
  if (lane == 0) warp_max[warp] = wmax;
  if constexpr (kRecord) {
    const int wun = __reduce_max_sync(0xFFFFFFFFu, unconf);
    if (lane == 0) warp_unconf[warp] = wun;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bmax = warp_max[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) bmax = max(bmax, warp_max[i]);
    if (nfail) atomicAdd(ctrl + kFail, nfail);
    if (nactive) atomicAdd(ctrl + kActive, nactive);
    if (bmax >= 0) atomicMax(ctrl + kMc, bmax);
    if constexpr (kRecord) {
      int bun = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) bun = max(bun, warp_unconf[i]);
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

unsigned finish_blocks(int stride, int record) {
  if (record == 0) return 1;
  const int per_block = kThreads * 4;
  unsigned blocks = static_cast<unsigned>((stride + per_block - 1) / per_block);
  return blocks > 528 ? 528 : blocks;  // 4 per SM; the copy strides the rest
}

int slot_grid_max() {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return -1;
  }
  return kSlotBlocksPerSm * sms;
}

// K3's grid: at most kSlotBlocksPerSm blocks an SM, fewer when the range
// is short (at least a round of chunks a block) or the chunks' bits do not
// let that many fit; all of them resident (the cooperative launch checks).
template <int kStore>
int launch_slots(const void* ctrl_p, void* state_p, int stride_i, int row0,
                 int n, int pad, void* idx_p, void* scratch_p, int slots,
                 cudaStream_t st) {
  const int grid_max = slot_grid_max();
  if (grid_max < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const void* fn = reinterpret_cast<const void*>(compact_slots_kernel<kStore>);
  const long long nc = (static_cast<long long>(n) + 6) / 4;  // any head
  long long grid = (nc + kSlotThreads - 1) / kSlotThreads;
  if (grid > grid_max) grid = grid_max;
  if (grid > slots) grid = slots;
  if (grid < 1) grid = 1;
  size_t smem = 0;
  for (int tries = 0;; ++tries) {
    const long long rounds =
        ((nc + grid - 1) / grid + kSlotThreads - 1) / kSlotThreads;
    smem = static_cast<size_t>(rounds) * kSlotThreads;
    if (smem > static_cast<size_t>(kSlotMaxSmem) || tries == 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlotMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int occ = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, fn, kSlotThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long fit =
        static_cast<long long>(occ) * (grid_max / kSlotBlocksPerSm);
    if (fit >= grid) break;
    if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
    grid = fit;
  }
  const int* ctrl = static_cast<const int*>(ctrl_p);
  int* state = static_cast<int*>(state_p);
  size_t stride = static_cast<size_t>(stride_i);
  int* idx = static_cast<int*>(idx_p);
  unsigned long long* scratch = static_cast<unsigned long long*>(scratch_p);
  void* args[] = {&ctrl, &state, &stride, &row0, &n, &pad, &idx, &scratch};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(static_cast<unsigned>(grid)), dim3(kSlotThreads), args, smem,
      st);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry point returns the launch's cudaError_t (0 = launched).

// The most blocks K3 launches on the current device: its scratch holds
// one flag a block after the epoch.
int dgc_compact_slots_grid_max() { return slot_grid_max(); }

// state: int32[2, stride]; idx: int32[pad], 16-byte aligned; scratch:
// uint64[1 + slots], zeroed once when made (the epoch and the flags).
int dgc_compact_slots(const void* ctrl, void* state, int stride, int row0,
                      int n, int pad, void* idx, void* scratch, int slots,
                      void* stream) {
  if (n <= 0 || pad <= 0 || slots < 1 ||
      (reinterpret_cast<uintptr_t>(idx) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (stride % 4) {
    case 0:
      return launch_slots<4>(ctrl, state, stride, row0, n, pad, idx, scratch,
                             slots, static_cast<cudaStream_t>(stream));
    case 2:
      return launch_slots<2>(ctrl, state, stride, row0, n, pad, idx, scratch,
                             slots, static_cast<cudaStream_t>(stream));
    default:
      return launch_slots<1>(ctrl, state, stride, row0, n, pad, idx, scratch,
                             slots, static_cast<cudaStream_t>(stream));
  }
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

// seg: the plan's flat table; desc: int32[nseg, 5]; warps: the plan's
// warps (the sum over its segments of ceil(rows * lanes / 32),
// kernels/compact.py k5_warps); gidx: int32[rows]
// state indices, or null for rows row_base + r; dummy: the dummy slot
// (V+1); umax: int32[>= ucol + 1], the unconf vector of the recording
// variant (kRecord), or null for the plain K5.
int dgc_segmented_superstep(void* ctrl, void* state, int stride,
                            const void* seg, const void* desc, int nseg,
                            int warps, const void* gidx,
                            int row_base, int dummy, int k, int thresh,
                            int max_steps, void* umax, int ucol,
                            void* stream) {
  if (warps <= 0 || nseg <= 0 || nseg > kMaxSegs || ucol < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  auto* c = static_cast<int*>(ctrl);
  auto* s = static_cast<int*>(state);
  const auto* sg = static_cast<const int*>(seg);
  const auto* d = static_cast<const int*>(desc);
  const auto* gi = static_cast<const int*>(gidx);
  auto st = static_cast<cudaStream_t>(stream);
  const auto words = static_cast<size_t>(stride);
  if (umax == nullptr) {
    segmented_superstep_kernel<false><<<blocks, kThreads, 0, st>>>(
        c, s, words, sg, d, nseg, gi, row_base, dummy, k, thresh, max_steps,
        nullptr, 0);
  } else {
    segmented_superstep_kernel<true><<<blocks, kThreads, 0, st>>>(
        c, s, words, sg, d, nseg, gi, row_base, dummy, k, thresh, max_steps,
        static_cast<int*>(umax), ucol);
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
