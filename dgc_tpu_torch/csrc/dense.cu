// The dense-adjacency superstep for Hopper (sm_90a), with a plain C
// interface for ctypes (dgc_tpu_torch/kernels/dense.py).
//
// Replaces B10, the jitted XLA program of the JAX package's dense engine,
// dgc_tpu/engine/dense_engine.py:44 _attempt_kernel_dense, in two kernels:
//   K11 dense_forbid  — the forbidden sets counts = adj @ onehot(colors)
//                       (:68-70) on the tensor cores, and the first free
//                       column below k of every uncolored row (:71-74);
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
// K11. A block owns 64 rows (four warps of 16). It walks the color columns
// in tiles of 128; for each it sums adj[rows, :] @ onehot[:, tile] over the
// vertices in chunks of 256 with mma.sync m16n8k16 (bf16 in, f32
// accumulate: every product is 0 or 1 and every count at most 16,383, so
// the counts are exact). The adjacency chunk (64 x 256, 32 KB) goes
// through shared memory in 16-byte loads, eight a thread in flight; the
// one-hot B fragments are made in registers
// from the chunk's 256 colors in shared memory, so no one-hot is written to
// device memory, and a fragment whose columns no vertex of the chunk holds
// is not multiplied. A chunk that holds no color of the tile is skipped
// whole, adjacency load included. After each tile a row takes the first
// column below k whose count is 0; the block goes on to the next tile only
// while one of its uncolored rows has found none (the first fit of every
// row is then exact: no earlier column was free). An uncolored row with no
// free column below k gets candidate 0 (the argmax of all-false) and adds
// to the fail count; a colored or pad row gets -1.
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
// card's 3.35 TB/s makes that ~0.16 ms a superstep at most. The product's
// operations (2 * V * sum of the uncolored rows' first-fit widths) sit far
// below the bf16 tensor-core rate, so the bytes bound both. This first
// version is simple and exact: no TMA, no cp.async pipelining, one chunk
// of 64 x 256 at a time (PERF.md has its measured time against the bound).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "rule.cuh"

namespace {

using dgc::kFailure;
using dgc::kRunning;
using dgc::kStalled;
using dgc::kSuccess;

// The control block (DCTRL_* in kernels/dense.py).
constexpr int kDStatus = 0;
constexpr int kDStep = 1;
constexpr int kDCur = 2;
constexpr int kDFail = 3;    // uncolored rows with no free column (K11)
constexpr int kDUncol = 4;   // rows uncolored after the step (K12)
constexpr int kDTicket = 5;  // K12's blocks done, 0 between launches

constexpr int kRows = 64;             // K11 rows a block
constexpr int kChunk = 256;           // K11 vertices a product step
constexpr int kChunkWords = kChunk / 8;  // 16-byte words a row of a chunk
constexpr int kTile = 128;            // K11 color columns a tile
constexpr int kFrags = kTile / 8;     // n8 fragments a tile
constexpr int kPitch = kChunk + 8;    // bf16 a shared row: spreads the banks
constexpr int kForbidThreads = 128;   // four warps of 16 rows
constexpr int kLoads = kRows * kChunkWords / kForbidThreads;  // 16 a thread
constexpr int kBatch = 8;             // of them in flight at once
constexpr int kResolveThreads = 256;  // eight warps, one row each
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kOneLo = 0x3F80u;       // bf16 1.0 in the low half
constexpr uint32_t kOneHi = 0x3F800000u;   // bf16 1.0 in the high half

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The n8 fragment whose column holds `c` for a lane of group g: bit nf of
// the result is set when c == c0 + 8 nf + g.
__device__ __forceinline__ uint32_t frag_bit(int c, int c0, int g) {
  const int r = c - c0 - g;
  return (r >= 0 && r < kTile && (r & 7) == 0) ? (1u << (r >> 3)) : 0u;
}

// ---- K11: forbidden sets and first fit --------------------------------------

__global__ void __launch_bounds__(kForbidThreads)
dense_forbid_kernel(int* ctrl, const int* state, int vp,
                    const uint16_t* __restrict__ adj, int* __restrict__ cand,
                    int v, int k) {
  // the status is the same for every thread of the grid: a uniform exit
  if (ctrl[kDStatus] != kRunning) return;
  const int* __restrict__ colors = state + static_cast<size_t>(ctrl[kDCur]) * vp;

  __shared__ __align__(16) uint16_t s_adj[kRows * kPitch];
  __shared__ int s_col[kChunk];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment's row group
  const int t = lane & 3;   // the thread in the group
  const int row0 = blockIdx.x * kRows;
  const int r_lo = row0 + warp * 16 + g;  // this lane's two rows
  const int r_hi = r_lo + 8;
  const bool un_lo = r_lo < v && colors[r_lo] < 0;
  const bool un_hi = r_hi < v && colors[r_hi] < 0;
  int c_lo = -1;  // first free column, -1 while none is found
  int c_hi = -1;

  bool need = __syncthreads_or(un_lo || un_hi);
  for (int c0 = 0; need && c0 < k; c0 += kTile) {
    float acc[kFrags][4];
#pragma unroll
    for (int nf = 0; nf < kFrags; ++nf) {
      acc[nf][0] = acc[nf][1] = acc[nf][2] = acc[nf][3] = 0.f;
    }
    for (int k0 = 0; k0 < vp; k0 += kChunk) {
      bool in_tile = false;
      for (int i = threadIdx.x; i < kChunk; i += kForbidThreads) {
        const int c = colors[k0 + i];
        s_col[i] = c;
        in_tile |= c >= c0 && c < c0 + kTile;
      }
      // no vertex of the chunk holds a color of the tile: nothing to add
      if (!__syncthreads_or(in_tile)) continue;
      // the adjacency chunk, in rounds of kBatch 16-byte loads a thread,
      // all issued before the first store
#pragma unroll
      for (int round = 0; round < kLoads; round += kBatch) {
        uint4 buf[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int i = (round + q) * kForbidThreads + threadIdx.x;
          buf[q] = *reinterpret_cast<const uint4*>(
              adj + static_cast<size_t>(row0 + i / kChunkWords) * vp + k0 +
              (i % kChunkWords) * 8);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int i = (round + q) * kForbidThreads + threadIdx.x;
          *reinterpret_cast<uint4*>(s_adj + (i / kChunkWords) * kPitch +
                                    (i % kChunkWords) * 8) = buf[q];
        }
      }
      __syncthreads();
#pragma unroll 1
      for (int ks = 0; ks < kChunk; ks += 16) {
        const int ca = s_col[ks + 2 * t];
        const int cb = s_col[ks + 2 * t + 1];
        const int cc = s_col[ks + 2 * t + 8];
        const int cd = s_col[ks + 2 * t + 9];
        const uint32_t hit = __reduce_or_sync(
            kFull, frag_bit(ca, c0, g) | frag_bit(cb, c0, g) |
                       frag_bit(cc, c0, g) | frag_bit(cd, c0, g));
        if (hit == 0) continue;  // warp-uniform
        const uint16_t* lo = s_adj + (warp * 16 + g) * kPitch + ks + 2 * t;
        const uint16_t* hi = lo + 8 * kPitch;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(lo);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(hi);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(lo + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(hi + 8);
#pragma unroll
        for (int nf = 0; nf < kFrags; ++nf) {
          if (!((hit >> nf) & 1u)) continue;  // warp-uniform
          const int col = c0 + nf * 8 + g;
          const uint32_t b0 = (ca == col ? kOneLo : 0u) | (cb == col ? kOneHi : 0u);
          const uint32_t b1 = (cc == col ? kOneLo : 0u) | (cd == col ? kOneHi : 0u);
          mma_bf16(acc[nf], a0, a1, a2, a3, b0, b1);
        }
      }
      __syncthreads();
    }
    // the first column of the tile below k that no neighbor holds
    int f_lo = INT_MAX;
    int f_hi = INT_MAX;
#pragma unroll
    for (int nf = 0; nf < kFrags; ++nf) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c0 + nf * 8 + 2 * t + j;
        if (col < k) {
          if (acc[nf][j] < 0.5f) f_lo = min(f_lo, col);
          if (acc[nf][2 + j] < 0.5f) f_hi = min(f_hi, col);
        }
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      f_lo = min(f_lo, __shfl_xor_sync(kFull, f_lo, off));
      f_hi = min(f_hi, __shfl_xor_sync(kFull, f_hi, off));
    }
    if (c_lo < 0 && f_lo != INT_MAX) c_lo = f_lo;
    if (c_hi < 0 && f_hi != INT_MAX) c_hi = f_hi;
    need = __syncthreads_or((un_lo && c_lo < 0) || (un_hi && c_hi < 0));
  }

  int nfail = 0;
  if (t == 0) {
    cand[r_lo] = un_lo ? (c_lo >= 0 ? c_lo : 0) : -1;
    cand[r_hi] = un_hi ? (c_hi >= 0 ? c_hi : 0) : -1;
    nfail = (un_lo && c_lo < 0) + (un_hi && c_hi < 0);
  }
  nfail = __reduce_add_sync(kFull, nfail);
  if (lane == 0 && nfail) atomicAdd(ctrl + kDFail, nfail);
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
  if (vp <= 0 || vp % kChunk != 0 || v < 0 || v > vp || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dense_forbid_kernel<<<vp / kRows, kForbidThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctrl), static_cast<const int*>(state), vp,
      static_cast<const uint16_t*>(adj), static_cast<int*>(cand), v, k);
  return static_cast<int>(cudaGetLastError());
}

int dgc_dense_resolve(void* ctrl, void* state, const void* adj,
                      const void* cand, const void* deg, int vp, int v,
                      int max_steps, void* stream) {
  if (vp <= 0 || vp % kChunk != 0 || v < 0 || v > vp) {
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
