// The dense-adjacency superstep for Hopper (sm_90a), with a plain C
// interface for ctypes (dgc_tpu_torch/kernels/dense.py).
//
// Replaces B10, the jitted XLA program of the JAX package's dense engine,
// dgc_tpu/engine/dense_engine.py:44 _attempt_kernel_dense, in two kernels:
//   K11 dense_forbid  — the forbidden sets counts = adj @ onehot(colors)
//                       (:68-70) and the first free column below k of
//                       every uncolored row (:71-74), as a bitmask of the
//                       neighbors' colors;
//   K12 dense_resolve — the priority conflict mask (:76-79), the new colors
//                       (:81) and the status fold (:82-92).
//
// State. Two int32[Vp] color buffers (-1 uncolored; Vp = V padded to a
// multiple of 256, the pad rows -1 for good), the bf16[Vp, Vp] 0/1 adjacency
// (pad rows and columns zero), the int32[Vp] degrees (pads 0), the int32[Vp]
// candidates K11 writes and K12 reads, and a control block int32[6] (the
// slots below). K11 reads buffer `cur`; K12 writes the other one and its
// last block flips `cur` unless the step failed, so a failed step leaves
// the pre-step colors current (:93). Both return at once when the status
// is no longer RUNNING, so the host enqueues a chunk of supersteps and
// syncs once per chunk.
//
// K11. The first fit needs only the set of colors among a row's
// neighbors, so K11 reads each uncolored row's adjacency exactly once,
// whatever k is, and does no product. A persistent grid of one block an
// SM shares the uncolored rows evenly: each block copies the colors into
// shared memory as int16, ranks the uncolored rows in order and takes the
// ranks blockIdx.x, + grid, ... (an SM streams its rows at a fraction of
// the card's rate, so the most rows one SM holds sets a light step's
// time); the colored and pad rows get -1. The block's rows alternate
// between two pipelines of eight warps, each with its own ring of 2-4 row
// buffers fed by the TMA's bulk copies on per-stage mbarriers and its own
// named barrier, so two rows stream at once while the colors are read
// once an SM. A pipeline scans a row in 16-byte words, a batch a thread
// in flight, and looks up each nonzero column's color in shared memory
// (a hub row has thousands): a color below k sets its bit in a bitmask of
// min(k, Vp) bits (at most 2 KB; colors below 64 in registers first, one
// OR a warp), and the pipeline's first warp takes the first clear bit
// with a ballot over 32 words at a time and __ffs. An uncolored row with
// no free color below k gets 0 (the argmax of all-false) and adds to the
// fail count. Three masks in turn need one barrier a row: a row's mask is
// cleared two rows after its search.
//
// K12. A row is latency: one warp a row (the design before) walked an
// unbeaten row's 32 KB in 64 dependent steps of 512 bytes, each waiting on
// its load and then on the neighbors' degrees and candidates in device
// memory, so on a step with few uncolored rows one row's chain set the
// launch's time. K12 now takes K11's shape: a persistent grid of one block
// of 32 warps an SM copies the candidates into shared memory as int16
// (cand < vp <= 32,768), ranks the uncolored rows (cand >= 0, below v) as
// K11 does (rank_rows) and takes the rows b, b + grid, ..., a row to a
// team of warps sized so that the block's teams have a row each (1 warp a
// team from 32 rows a block, 4, 8, 16, the whole block below 2). A team
// reads its row in batches of four 16-byte words a thread, all in flight
// together (a whole block takes a 32 KB row in one round trip), looks each
// nonzero column x's candidate up in shared memory, reads deg x from
// device memory only where it equals the row's candidate, and takes the
// batch's verdict (x beats u: deg x > deg u, or equal degrees and x < u; no
// beats matrix) with one vote (a warp's, a named barrier's or the block's);
// a row beaten in a batch reads no further, which on a step where most
// rows are uncolored and beaten early (the first steps) saves most of the
// bytes: a ring of whole rows in flight (bulk copies, as K11) was tried and
// read every row whole, slower than the warps on those steps (PERF.md). The
// block copies its share of the other rows below v (colored:
// they keep their word) four a thread before its rows. The last block to
// finish (a ticket in the control block, as K6 and K9) folds the fail
// count, the uncolored count after the step and the step into the status:
// FAILURE, then SUCCESS, then STALLED once step + 1 >= max_steps. A failed
// step writes no color.
//
// Bound. Each kernel reads the adjacency rows of the uncolored vertices
// (at most V^2 * 2 bytes, 512 MiB at V = 16,384) and a few V-vectors: the
// card's 3.35 TB/s makes that ~0.16 ms a superstep at most. Each moves those
// bytes once; the other work (a lookup per nonzero, K11's search of the
// mask) is small beside them. PERF.md has the measured times against the
// bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "rule.cuh"
#include "tma.cuh"

namespace {

using dgc::bulk_load;
using dgc::fence_async_shared;
using dgc::kFailure;
using dgc::kRunning;
using dgc::kStalled;
using dgc::kSuccess;
using dgc::mbar_expect;
using dgc::mbar_init;
using dgc::mbar_test;

// The control block (DCTRL_* in kernels/dense.py).
constexpr int kDStatus = 0;
constexpr int kDStep = 1;
constexpr int kDCur = 2;
constexpr int kDFail = 3;    // uncolored rows with no free column (K11)
constexpr int kDUncol = 4;   // rows uncolored after the step (K12)
constexpr int kDTicket = 5;  // K12's blocks done, 0 between launches

constexpr int kVertexTile = 256;      // Vp's multiple (VERTEX_TILE)
constexpr int kForbidThreads = 512;   // K11: two pipelines of eight warps
constexpr int kPipes = 2;
constexpr int kPipeThreads = kForbidThreads / kPipes;
constexpr int kForbidMaxStages = 4;   // K11: a pipeline's rows in flight
constexpr int kForbidSmem = 220 * 1024;  // K11: one block an SM
constexpr int kScanBatch = 8;         // K11: 16-byte words a thread in flight
constexpr int kResolveThreads = 1024;  // K12: one block an SM, 32 warps
constexpr int kResolveWarps = kResolveThreads / 32;
constexpr int kResolveBatch = 4;  // K12: 16-byte words a thread in flight
constexpr int kResolveMaxVp = 32768;  // K12: candidates below vp as int16
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---- K11: forbidden sets and first fit --------------------------------------

// bit h of the result: the h-th bf16 of x is nonzero
__device__ __forceinline__ uint32_t nonzero_halves(uint32_t x) {
  return ((x & 0xFFFFu) != 0u ? 1u : 0u) | ((x >> 16) != 0u ? 2u : 0u);
}

// bit h of the result: the h-th int16 of x is negative (an uncolored row)
__device__ __forceinline__ uint32_t negative_halves(uint32_t x) {
  return ((x >> 15) & 1u) | ((x >> 30) & 2u);
}

// a color (K11) or a candidate (K12) as the int16 kept in shared memory, in
// the low half
__device__ __forceinline__ uint32_t color16(int c) {
  return static_cast<uint16_t>(c < 0 ? -1 : (c > 32767 ? 32767 : c));
}

// a barrier of pipeline p's threads alone (named barrier 1 + p)
__device__ __forceinline__ void pipe_sync(int p) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + p), "r"(kPipeThreads) : "memory");
}

// The rows below v that `bits` picks, ranked in order across the grid: the
// rows of rank blockIdx.x, + gridDim.x, ... go to s_list in rank order (no
// block holds two rows more than another). bits(j) has bit e set where row
// 8j + e is picked, for j < words; each thread ranks a run of words [run0,
// run1) and the block scans the counts (s_warp: a word a warp). Returns the
// picked rows' count; the caller syncs before reading s_list. K11 and K12.
template <int kThreads, class Bits>
__device__ __forceinline__ int rank_rows(int words, int v, Bits bits,
                                         int* s_warp, int* s_list) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grid = gridDim.x;
  const int b = blockIdx.x;
  const int run0 = static_cast<int>(static_cast<long long>(words) * tid /
                                    kThreads);
  const int run1 = static_cast<int>(static_cast<long long>(words) *
                                    (tid + 1) / kThreads);
  auto picked = [&](int j) {
    uint32_t m = bits(j);
    if (8 * j + 8 > v) m &= 8 * j < v ? (1u << (v - 8 * j)) - 1u : 0u;
    return m;
  };
  int cnt = 0;
  for (int j = run0; j < run1; ++j) cnt += __popc(picked(j));
  int inc = cnt;  // the block's inclusive scan of cnt
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int base = 0;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    base += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  int q = base + inc - cnt;  // the rank of this thread's first row
  for (int j = run0; j < run1; ++j) {
    uint32_t m = picked(j);
    while (m != 0u) {
      const int e = __ffs(m) - 1;
      m &= m - 1u;
      if (q % grid == b) s_list[q / grid] = 8 * j + e;
      ++q;
    }
  }
  return total;
}

__global__ void __launch_bounds__(kForbidThreads)
dense_forbid_kernel(int* ctrl, const int* state, int vp,
                    const uint16_t* __restrict__ adj, int* __restrict__ cand,
                    int v, int mbits, int stages, int list_cap) {
  // the status is the same for every thread of the grid: a uniform exit
  if (ctrl[kDStatus] != kRunning) return;
  // vp is a multiple of 256: each row of the buffers is 16-byte aligned
  const int4* __restrict__ colors4 = reinterpret_cast<const int4*>(
      state + static_cast<size_t>(ctrl[kDCur]) * vp);
  const int words = vp >> 3;  // 16-byte words of an adjacency row

  // dynamic: each pipeline's `stages` adjacency rows, the colors as int16
  // (a row's bytes), each pipeline's three masks of mwords, the row list
  extern __shared__ __align__(128) unsigned char s_dyn[];
  __shared__ __align__(8) uint64_t s_bar[kPipes][kForbidMaxStages];
  __shared__ int s_warp[kForbidThreads / 32];
  const uint32_t row_bytes = static_cast<uint32_t>(vp) * 2u;
  const int mwords = (mbits + 31) >> 5;
  const size_t ring_bytes = static_cast<size_t>(kPipes) * stages * row_bytes;
  uint4* s_col = reinterpret_cast<uint4*>(s_dyn + ring_bytes);
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(s_dyn + ring_bytes +
                                                  row_bytes);
  int* s_list = reinterpret_cast<int*>(s_masks + kPipes * 3 * mwords);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grid = gridDim.x;
  const int b = blockIdx.x;
  if (tid == 0) {
    for (int p = 0; p < kPipes; ++p) {
      for (int s = 0; s < stages; ++s) mbar_init(&s_bar[p][s]);
    }
    fence_async_shared();  // the barriers, before the first bulk copy
  }
  for (int i = tid; i < kPipes * 3 * mwords; i += kForbidThreads) {
    s_masks[i] = 0u;
  }
  // the colors, eight a 16-byte word as int16 (-1, or the color up to
  // 32,767: only those below mbits <= 16,384 are read), once for both
  // pipelines: a row's neighbors are looked up in shared memory, and the
  // uncolored rows are ranked
  for (int j = tid; j < words; j += kForbidThreads) {
    const int4 x = colors4[2 * j];
    const int4 y = colors4[2 * j + 1];
    s_col[j] = make_uint4(color16(x.x) | (color16(x.y) << 16),
                          color16(x.z) | (color16(x.w) << 16),
                          color16(y.x) | (color16(y.y) << 16),
                          color16(y.z) | (color16(y.w) << 16));
  }
  __syncthreads();
  // the uncolored rows below v, ranked: this block's are listed
  auto uncolored = [&](int j) {
    const uint4 c = s_col[j];
    return negative_halves(c.x) | (negative_halves(c.y) << 2) |
           (negative_halves(c.z) << 4) | (negative_halves(c.w) << 6);
  };
  const int total = rank_rows<kForbidThreads>(words, v, uncolored, s_warp,
                                              s_list);
  // -1 for this block's share of the colored and pad rows
  const int16_t* s_c16 = reinterpret_cast<const int16_t*>(s_col);
  for (int r = b + tid * grid; r < vp; r += kForbidThreads * grid) {
    if (r >= v || s_c16[r] >= 0) cand[r] = -1;
  }
  __syncthreads();
  const int block_rows = total > b ? (total - b + grid - 1) / grid : 0;
  if (block_rows > list_cap) __trap();  // the launcher sized the list

  // two pipelines of kPipeThreads, each over every other listed row, each
  // with its own ring, barriers and masks, synchronised by a named barrier
  const int pipe = tid / kPipeThreads;
  const int ptid = tid % kPipeThreads;
  const int rows = (block_rows - pipe + kPipes - 1) / kPipes;
  if (rows <= 0) return;
  unsigned char* ring = s_dyn + static_cast<size_t>(pipe) * stages * row_bytes;
  uint64_t* bars = s_bar[pipe];
  uint32_t* masks = s_masks + pipe * 3 * mwords;
  auto issue = [&](int li) {  // the pipeline's row li: list entry pipe + 2 li
    const int s = li % stages;
    mbar_expect(&bars[s], row_bytes);
    bulk_load(ring + static_cast<size_t>(s) * row_bytes,
              adj + static_cast<size_t>(s_list[pipe + kPipes * li]) * vp,
              row_bytes, &bars[s]);
  };
  if (ptid == 0) {
    for (int li = 0; li < stages && li < rows; ++li) issue(li);
  }

  int nfail = 0;  // the pipeline's thread 0's
  for (int li = 0; li < rows; ++li) {
    const int s = li % stages;
    uint32_t* mask = masks + (li % 3) * mwords;
    while (!mbar_test(&bars[s], static_cast<uint32_t>(li / stages) & 1u)) {
    }
    // the colors of the row's neighbors below mbits, as bits. Colors
    // below 64 gather in registers and reach the mask once a warp (a hub
    // row's thousands of neighbors hold few colors: one shared word each
    // would serialize them); the others go to the mask at once.
    const uint4* __restrict__ row =
        reinterpret_cast<const uint4*>(ring + static_cast<size_t>(s) * row_bytes);
    uint32_t low0 = 0u;  // colors 0-31 of this thread's neighbors
    uint32_t low1 = 0u;  // colors 32-63
    // a batch of words a thread: their loads, then their colors' loads,
    // each in flight together; then the set columns alone
    for (int j0 = ptid; j0 < words; j0 += kPipeThreads * kScanBatch) {
      uint32_t nz[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int j = j0 + u * kPipeThreads;
        const uint4 w = j < words ? row[j] : make_uint4(0u, 0u, 0u, 0u);
        nz[u] = nonzero_halves(w.x) | (nonzero_halves(w.y) << 2) |
                (nonzero_halves(w.z) << 4) | (nonzero_halves(w.w) << 6);
      }
      uint4 cw[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        if (nz[u] != 0u) cw[u] = s_col[j0 + u * kPipeThreads];
      }
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        uint32_t m = nz[u];
        if (m == 0u) continue;
        const uint64_t c03 = cw[u].x | (static_cast<uint64_t>(cw[u].y) << 32);
        const uint64_t c47 = cw[u].z | (static_cast<uint64_t>(cw[u].w) << 32);
        while (m != 0u) {
          const int e = __ffs(m) - 1;
          m &= m - 1u;
          const int c = static_cast<int16_t>(static_cast<uint16_t>(
              e < 4 ? c03 >> (16 * e) : c47 >> (16 * (e - 4))));
          if (c < 0 || c >= mbits) continue;
          const uint32_t bit = 1u << (c & 31);
          if (c < 32) {
            low0 |= bit;
          } else if (c < 64) {
            low1 |= bit;
          } else {
            atomicOr(mask + (c >> 5), bit);
          }
        }
      }
    }
    low0 = __reduce_or_sync(kFull, low0);
    low1 = __reduce_or_sync(kFull, low1);
    if (lane == 0) {
      if (low0 != 0u) atomicOr(mask, low0);
      if (low1 != 0u) atomicOr(mask + 1, low1);  // set only if mbits > 32
    }
    // the mask is whole, stage s read, the mask of row li - 1 searched
    pipe_sync(pipe);
    if (ptid == 0 && li + stages < rows) {
      fence_async_shared();
      issue(li + stages);
    }
    if (ptid < 32) {  // the pipeline's first warp: the first clear bit
      int found = -1;
      for (int w0 = 0; w0 < mwords; w0 += 32) {
        const int w = w0 + lane;
        uint32_t free = 0u;
        if (w < mwords) {
          free = ~mask[w];
          if (w == mwords - 1 && (mbits & 31) != 0) {
            free &= (1u << (mbits & 31)) - 1u;
          }
        }
        const unsigned hit = __ballot_sync(kFull, free != 0u);
        if (hit != 0u) {
          const int l = __ffs(hit) - 1;
          found = (w0 + l) * 32 + __ffs(__shfl_sync(kFull, free, l)) - 1;
          break;
        }
      }
      if (ptid == 0) {
        cand[s_list[pipe + kPipes * li]] = found >= 0 ? found : 0;
        nfail += found < 0;
      }
    }
    // the mask of row li + 2, which row li - 1 used: searched before the
    // barrier above, set only after the next one
    uint32_t* next = masks + ((li + 2) % 3) * mwords;
    for (int w = ptid; w < mwords; w += kPipeThreads) next[w] = 0u;
  }
  if (ptid == 0 && nfail) atomicAdd(ctrl + kDFail, nfail);
}

// ---- K12: conflicts, new colors, status --------------------------------------

// bits e of the result: the e-th int16 of the word is not negative (a row
// with a candidate: uncolored)
__device__ __forceinline__ uint32_t candidate_halves(uint4 c) {
  return ~(negative_halves(c.x) | (negative_halves(c.y) << 2) |
           (negative_halves(c.z) << 4) | (negative_halves(c.w) << 6)) & 0xFFu;
}

// The OR of `pred` over a team of `threads` threads (whole warps) of the
// block, through named barrier `id` (1-8; 0 is __syncthreads')
__device__ __forceinline__ bool team_or(int id, int threads, bool pred) {
  uint32_t r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\t"
      "selp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(pred)), "r"(id), "r"(threads)
      : "memory");
  return r != 0u;
}

// K12's teams: a row to each team of `warps` warps (1, 4, 8, 16 or 32), so
// that a block's teams have a row each where the block has rows enough
__device__ __forceinline__ int team_warps(int rows) {
  return rows >= 32 ? 1 : rows >= 8 ? 4 : rows >= 4 ? 8 : rows >= 2 ? 16 : 32;
}

__global__ void __launch_bounds__(kResolveThreads, 1)
dense_resolve_kernel(int* ctrl, int* state, int vp,
                     const uint16_t* __restrict__ adj,
                     const int* __restrict__ cand,
                     const int* __restrict__ deg, int v, int max_steps,
                     int list_cap) {
  if (ctrl[kDStatus] != kRunning) return;
  const int cur = ctrl[kDCur];
  // a failed step keeps the pre-step colors: nothing to resolve
  const bool failed = ctrl[kDFail] != 0;

  // dynamic: the candidates as int16 (vp * 2 bytes), the row list
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_warp[kResolveWarps];
  __shared__ int s_uncol;
  __shared__ bool s_last;
  const int words = vp >> 3;  // 16-byte words of an adjacency row
  uint4* s_cand = reinterpret_cast<uint4*>(s_dyn);
  const int16_t* s_c16 = reinterpret_cast<const int16_t*>(s_cand);
  int* s_list = reinterpret_cast<int*>(s_dyn + static_cast<size_t>(vp) * 2);

  const int tid = threadIdx.x;
  const int grid = gridDim.x;
  const int b = blockIdx.x;
  int uncol = 0;  // rows this thread leaves uncolored
  if (tid == 0) s_uncol = 0;
  if (!failed) {
    const int* __restrict__ src = state + static_cast<size_t>(cur) * vp;
    int* __restrict__ dst = state + static_cast<size_t>(1 - cur) * vp;
    // the candidates, eight a 16-byte word as int16 (cand < vp <= 32,768):
    // a row's neighbors are looked up in shared memory, the rows ranked
    const int4* __restrict__ cand4 = reinterpret_cast<const int4*>(cand);
    for (int j = tid; j < words; j += kResolveThreads) {
      const int4 x = cand4[2 * j];
      const int4 y = cand4[2 * j + 1];
      s_cand[j] = make_uint4(color16(x.x) | (color16(x.y) << 16),
                             color16(x.z) | (color16(x.w) << 16),
                             color16(y.x) | (color16(y.y) << 16),
                             color16(y.z) | (color16(y.w) << 16));
    }
    __syncthreads();
    const int total = rank_rows<kResolveThreads>(
        words, v, [&](int j) { return candidate_halves(s_cand[j]); }, s_warp,
        s_list);

    // this block's share of the other rows below v keep their word, four
    // a thread (vp is a multiple of 256: src and dst are 16-byte aligned)
    for (int i = b * kResolveThreads + tid; 4 * i < v;
         i += grid * kResolveThreads) {
      const int4 w = *reinterpret_cast<const int4*>(src + 4 * i);
      const uint2 c = reinterpret_cast<const uint2*>(s_cand)[i];
      uint32_t keep = (negative_halves(c.x) | (negative_halves(c.y) << 2));
      if (4 * i + 4 > v) keep &= (1u << (v - 4 * i)) - 1u;
      const int x[4] = {w.x, w.y, w.z, w.w};
      if (keep == 0xFu) {
        *reinterpret_cast<int4*>(dst + 4 * i) = w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((keep >> e) & 1u) dst[4 * i + e] = x[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) uncol += ((keep >> e) & 1u) && x[e] < 0;
    }
    __syncthreads();  // s_list
    const int rows = total > b ? (total - b + grid - 1) / grid : 0;
    if (rows > list_cap) __trap();  // the launcher sized the list

    // the listed rows, a row to a team: team g of `teams` takes rows g,
    // g + teams, ... of the list. Row u keeps its candidate unless a
    // neighbor x with the same one beats it (deg x > deg u, or equal and
    // x < u). The team reads the row in batches of kResolveBatch 16-byte
    // words a thread, all in flight together, looks each nonzero column's
    // candidate up in shared memory, reads deg x only for a match, and
    // stops at the batch where some thread found a beater.
    const int tw = team_warps(rows);
    const int team_threads = tw * 32;
    const int teams = kResolveWarps / tw;
    const int team = tid / team_threads;
    const int ttid = tid % team_threads;
    const int batch_words = team_threads * kResolveBatch;
    for (int li = team; li < rows; li += teams) {
      const int u = s_list[li];
      const int cu = s_c16[u];
      const int du = deg[u];
      const uint4* __restrict__ row =
          reinterpret_cast<const uint4*>(adj + static_cast<size_t>(u) * vp);
      bool beaten = false;
      for (int base = 0; base < words; base += batch_words) {
        uint4 w[kResolveBatch];
#pragma unroll
        for (int k = 0; k < kResolveBatch; ++k) {
          const int j = base + ttid + k * team_threads;
          w[k] = j < words ? __ldcs(row + j) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < kResolveBatch; ++k) {
          uint32_t m = nonzero_halves(w[k].x) | (nonzero_halves(w[k].y) << 2) |
                       (nonzero_halves(w[k].z) << 4) |
                       (nonzero_halves(w[k].w) << 6);
          if (m == 0u) continue;
          const int j = base + ttid + k * team_threads;
          const uint4 c = s_cand[j];
          const uint64_t c03 = c.x | (static_cast<uint64_t>(c.y) << 32);
          const uint64_t c47 = c.z | (static_cast<uint64_t>(c.w) << 32);
          while (m != 0u) {
            const int e = __ffs(m) - 1;
            m &= m - 1u;
            const int cx = static_cast<int16_t>(static_cast<uint16_t>(
                e < 4 ? c03 >> (16 * e) : c47 >> (16 * (e - 4))));
            if (cx != cu || beaten) continue;
            const int x = 8 * j + e;
            const int dx = deg[x];
            beaten = dx > du || (dx == du && x < u);
          }
        }
        // uniform across the team: the batch's verdict
        beaten = tw == 1    ? __any_sync(kFull, beaten) != 0
                 : tw == kResolveWarps ? __syncthreads_or(beaten) != 0
                                      : team_or(1 + team, team_threads, beaten);
        if (beaten) break;
      }
      if (ttid == 0) {
        dst[u] = beaten ? -1 : cu;
        uncol += beaten;
      }
    }
  }

  if (uncol) atomicAdd(&s_uncol, uncol);
  __syncthreads();
  if (tid == 0) {
    if (s_uncol) atomicAdd(ctrl + kDUncol, s_uncol);
    __threadfence();
    s_last = atomicAdd(ctrl + kDTicket, 1) == grid - 1;
  }
  __syncthreads();
  if (!s_last || tid != 0) return;

  __threadfence();
  const int uncol_all = atomicAdd(ctrl + kDUncol, 0);
  const int step = ctrl[kDStep];
  int status = kRunning;
  if (failed) {
    status = kFailure;
  } else if (uncol_all == 0) {
    status = kSuccess;
  } else if (step + 1LL >= max_steps) {
    status = kStalled;
  }
  ctrl[kDStatus] = status;
  ctrl[kDStep] = step + 1;
  if (!failed) ctrl[kDCur] = 1 - cur;
  ctrl[kDFail] = 0;
  ctrl[kDUncol] = 0;
  ctrl[kDTicket] = 0;
}

// A persistent kernel over ranked rows (K11, K12): its row list holds
// list_cap ints, the most rows a block takes over the smallest grid (one
// block an SM, at most vp); the grid is as many blocks as fit at once with
// `smem` bytes of dynamic shared memory each, at most vp.
struct Persistent {
  int sms;
  int list_cap;
  int grid;
};

cudaError_t persistent_list(int vp, Persistent* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&out->sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  const int grid_min = out->sms < vp ? out->sms : vp;
  out->list_cap = (vp + grid_min - 1) / grid_min;
  return cudaSuccess;
}

cudaError_t persistent_grid(const void* fn, int threads, size_t smem, int vp,
                            Persistent* out) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidValue;
  out->grid = occ * out->sms < vp ? occ * out->sms : vp;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// state: int32[2, vp]; adj: bf16[vp, vp]; cand: int32[vp]; vp a multiple
// of 256, v <= vp, k >= 1. Returns the launch's cudaError_t (0 = launched).
int dgc_dense_forbid(void* ctrl, const void* state, const void* adj,
                     void* cand, int vp, int v, int k, void* stream) {
  if (vp <= 0 || vp % kVertexTile != 0 || v < 0 || v > vp || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Persistent g;
  cudaError_t e = persistent_list(vp, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the first free color of a row is below its neighbors' count, below vp
  const int mbits = k < vp ? k : vp;
  const size_t row_bytes = static_cast<size_t>(vp) * 2;
  const size_t extras = row_bytes +  // the colors as int16
                        kPipes * 3 * static_cast<size_t>((mbits + 31) / 32) * 4 +
                        static_cast<size_t>(g.list_cap) * 4;
  long long stages = (static_cast<long long>(kForbidSmem) -
                      static_cast<long long>(extras)) /
                     (kPipes * static_cast<long long>(row_bytes));
  if (stages > kForbidMaxStages) stages = kForbidMaxStages;
  if (stages < 2) stages = 2;
  const size_t smem = static_cast<size_t>(kPipes * stages) * row_bytes + extras;
  e = persistent_grid(reinterpret_cast<const void*>(dense_forbid_kernel),
                      kForbidThreads, smem, vp, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_forbid_kernel<<<g.grid, kForbidThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<const int*>(state), vp,
      static_cast<const uint16_t*>(adj), static_cast<int*>(cand), v, mbits,
      static_cast<int>(stages), g.list_cap);
  return static_cast<int>(cudaGetLastError());
}

// deg: int32[vp]; cand K11's (every entry below vp); vp at most 32,768;
// state and cand 16-byte aligned.
int dgc_dense_resolve(void* ctrl, void* state, const void* adj,
                      const void* cand, const void* deg, int vp, int v,
                      int max_steps, void* stream) {
  if (vp <= 0 || vp % kVertexTile != 0 || vp > kResolveMaxVp || v < 0 ||
      v > vp || (reinterpret_cast<uintptr_t>(state) & 15u) != 0u ||
      (reinterpret_cast<uintptr_t>(cand) & 15u) != 0u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Persistent g;
  cudaError_t e = persistent_list(vp, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the candidates as int16, the row list
  const size_t smem = static_cast<size_t>(vp) * 2 +
                      static_cast<size_t>(g.list_cap) * 4;
  e = persistent_grid(reinterpret_cast<const void*>(dense_resolve_kernel),
                      kResolveThreads, smem, vp, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_resolve_kernel<<<g.grid, kResolveThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<int*>(state), vp,
      static_cast<const uint16_t*>(adj), static_cast<const int*>(cand),
      static_cast<const int*>(deg), v, max_steps, g.list_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
