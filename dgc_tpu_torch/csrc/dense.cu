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
// K12. One warp per row: an uncolored row u scans its adjacency row in
// 16-byte words for a neighbor v with the same candidate (cand[v] >= 0, so
// v is uncolored) that beats u (deg v > deg u, or equal degrees and
// v < u), and stops at the first. The beats matrix of the JAX kernel (:55)
// is computed from the degrees on the fly. The last block to finish (a
// ticket in the control block, as K6 and K9) folds the fail count, the
// uncolored count after the step and the step into the status: FAILURE,
// then SUCCESS, then STALLED once step + 1 >= max_steps.
//
// Bound. Each kernel reads the adjacency rows of the uncolored vertices
// (at most V^2 * 2 bytes, 512 MiB at V = 16,384) and a few V-vectors: the
// card's 3.35 TB/s makes that ~0.16 ms a superstep at most. K11 moves those
// bytes once; its other work (a bit per nonzero, a search of the mask) is
// small beside them. PERF.md has the measured times against the bound.

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
constexpr int kResolveThreads = 256;  // eight warps, one row each
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

// a color as the int16 K11 keeps in shared memory, in the low half
__device__ __forceinline__ uint32_t color16(int c) {
  return static_cast<uint16_t>(c < 0 ? -1 : (c > 32767 ? 32767 : c));
}

// a barrier of pipeline p's threads alone (named barrier 1 + p)
__device__ __forceinline__ void pipe_sync(int p) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + p), "r"(kPipeThreads) : "memory");
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
  const int warp = tid >> 5;
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
  // the uncolored rows below v in order, each thread over a run of words
  // [run0, run1): the rows of rank b, b + grid, ... are this block's (no
  // block holds two rows more than another)
  const int run0 = static_cast<int>(static_cast<long long>(words) * tid /
                                    kForbidThreads);
  const int run1 = static_cast<int>(static_cast<long long>(words) *
                                    (tid + 1) / kForbidThreads);
  auto uncolored = [&](int j) {
    const uint4 c = s_col[j];
    uint32_t bits = negative_halves(c.x) | (negative_halves(c.y) << 2) |
                    (negative_halves(c.z) << 4) | (negative_halves(c.w) << 6);
    if (8 * j + 8 > v) bits &= 8 * j < v ? (1u << (v - 8 * j)) - 1u : 0u;
    return bits;
  };
  int cnt = 0;
  for (int j = run0; j < run1; ++j) cnt += __popc(uncolored(j));
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
  for (int w = 0; w < kForbidThreads / 32; ++w) {
    base += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  int q = base + inc - cnt;  // the rank of this thread's first row
  for (int j = run0; j < run1; ++j) {
    uint32_t bits = uncolored(j);
    while (bits != 0u) {
      const int e = __ffs(bits) - 1;
      bits &= bits - 1u;
      if (q % grid == b) s_list[q / grid] = 8 * j + e;
      ++q;
    }
  }
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

__global__ void __launch_bounds__(kResolveThreads)
dense_resolve_kernel(int* ctrl, int* state, int vp,
                     const uint16_t* __restrict__ adj,
                     const int* __restrict__ cand,
                     const int* __restrict__ deg, int v, int max_steps) {
  if (ctrl[kDStatus] != kRunning) return;
  const int cur = ctrl[kDCur];
  // a failed step keeps the pre-step colors: nothing to resolve
  const bool failed = ctrl[kDFail] != 0;
  const int* __restrict__ src = state + static_cast<size_t>(cur) * vp;
  int* __restrict__ dst = state + static_cast<size_t>(1 - cur) * vp;

  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * (kResolveThreads / 32) + (threadIdx.x >> 5);
  bool uncol_after = false;
  if (u < v && !failed) {
    const int cu = cand[u];
    int next = src[u];
    if (cu >= 0) {  // uncolored: it keeps its candidate unless beaten
      const int du = deg[u];
      const uint4* __restrict__ row =
          reinterpret_cast<const uint4*>(adj + static_cast<size_t>(u) * vp);
      const int words = vp / 8;
      bool beaten = false;
      for (int base = 0; base < words; base += 32) {
        const int j = base + lane;
        if (j < words) {
          const uint4 w = row[j];
          const uint32_t q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if ((q[i >> 1] >> (16 * (i & 1))) & 0xFFFFu) {
              const int x = j * 8 + i;
              const int dx = deg[x];
              if (cand[x] == cu && (dx > du || (dx == du && x < u))) {
                beaten = true;
              }
            }
          }
        }
        if (__any_sync(kFull, beaten)) {
          beaten = true;
          break;
        }
      }
      next = beaten ? -1 : cu;
    }
    if (lane == 0) dst[u] = next;
    uncol_after = next < 0;
  }

  const int n = __syncthreads_count(lane == 0 && uncol_after);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    if (n) atomicAdd(ctrl + kDUncol, n);
    __threadfence();
    s_last = atomicAdd(ctrl + kDTicket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;

  __threadfence();
  const int uncol = atomicAdd(ctrl + kDUncol, 0);
  const int step = ctrl[kDStep];
  int status = kRunning;
  if (failed) {
    status = kFailure;
  } else if (uncol == 0) {
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

}  // namespace

extern "C" {

// state: int32[2, vp]; adj: bf16[vp, vp]; cand: int32[vp]; vp a multiple
// of 256, v <= vp, k >= 1. Returns the launch's cudaError_t (0 = launched).
int dgc_dense_forbid(void* ctrl, const void* state, const void* adj,
                     void* cand, int vp, int v, int k, void* stream) {
  if (vp <= 0 || vp % kVertexTile != 0 || v < 0 || v > vp || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // the first free color of a row is below its neighbors' count, below vp
  const int mbits = k < vp ? k : vp;
  const size_t row_bytes = static_cast<size_t>(vp) * 2;
  const int grid_min = sms < vp ? sms : vp;  // the grid has this many or more
  const int list_cap = (vp + grid_min - 1) / grid_min;
  const size_t extras = row_bytes +  // the colors as int16
                        kPipes * 3 * static_cast<size_t>((mbits + 31) / 32) * 4 +
                        static_cast<size_t>(list_cap) * 4;
  long long stages = (static_cast<long long>(kForbidSmem) -
                      static_cast<long long>(extras)) /
                     (kPipes * static_cast<long long>(row_bytes));
  if (stages > kForbidMaxStages) stages = kForbidMaxStages;
  if (stages < 2) stages = 2;
  const size_t smem = static_cast<size_t>(kPipes * stages) * row_bytes + extras;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(dense_forbid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, dense_forbid_kernel,
                                                    kForbidThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = occ * sms < vp ? occ * sms : vp;
  dense_forbid_kernel<<<grid, kForbidThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<const int*>(state), vp,
      static_cast<const uint16_t*>(adj), static_cast<int*>(cand), v, mbits,
      static_cast<int>(stages), list_cap);
  return static_cast<int>(cudaGetLastError());
}

int dgc_dense_resolve(void* ctrl, void* state, const void* adj,
                      const void* cand, const void* deg, int vp, int v,
                      int max_steps, void* stream) {
  if (vp <= 0 || vp % kVertexTile != 0 || v < 0 || v > vp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int warps = kResolveThreads / 32;
  const int blocks = v > 0 ? (v + warps - 1) / warps : 1;
  dense_resolve_kernel<<<blocks, kResolveThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<int*>(state), vp,
      static_cast<const uint16_t*>(adj), static_cast<const int*>(cand),
      static_cast<const int*>(deg), v, max_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
