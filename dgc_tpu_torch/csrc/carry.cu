// The serve tier's device-resident carry for Hopper (sm_90a), with a plain
// C interface for ctypes (dgc_tpu_torch/kernels/carry.py).
//
// Replaces the jitted XLA programs of dgc_tpu/serve/batched.py (B12f) that
// keep a pool's carry and input stacks on the device (`--device-carry`):
//   K17 lane_seat      — :625-646 seat_lane_kernel (_seat_lane_body): each
//                        seated lane's table row and degrees, uploaded once
//                        into a staging buffer, scattered into its lane of
//                        the stacks; its k0 and max_steps set, its reset
//                        flag raised. One launch seats a whole wave (the
//                        host keeps the last seat of a lane, so the result
//                        is the per-seat scatter applied in seat order).
//   K18 carry_permute  — :648-666 permute_carry_kernel: the pool-resize
//                        carry move, out[slot][dst[i]] = old[slot][src[i]]
//                        for all 20 slots, every other row of the fresh
//                        carry filled with the idle lane's values here (no
//                        idle carry uploaded). `out` never aliases `old`.
//   K19 inputs_resize  — :668-690 resize_inputs_kernel: row i of the new
//                        stacks is old lane src[i], or the class dummy
//                        (its table row, zero degrees, k0 = 1, its
//                        max_steps) where src[i] is past the old width; the
//                        reset flags all 0.
// The donated slice (:606 batched_slice_kernel_donated) needs no kernel:
// K13-K16 update the carry in place.
//
// Their lane-mesh instances (B12g: :892 permute_carry_kernel_sharded and
// :901 resize_inputs_kernel_sharded, where a kept lane may cross shards):
//   K18 carry_permute_mesh — K18 into one new shard's fresh carry, its rows
//                        gathered from any old shard: a device table of the
//                        n old shards' slot pointers, and a row map of
//                        (old shard, lane) for each new row (shard -1:
//                        idle). One launch a new shard.
//   K19 inputs_resize_mesh — K19 into one new shard's stacks, from a table
//                        of the old shards' comb, degrees, k0 and max_steps
//                        pointers and a (old shard, lane) map (shard -1:
//                        the dummy). One launch a new shard.
// A shard on another card is read through peer access.
// K17 needs no instance of its own: a seat wave is split by owning shard
// and K17 runs once on each shard that has seats.
//
// The host turns the index lists into one int32 map per launch (K17: the
// seats' lanes; K18: the old lane of each new row, -1 for idle; K19: src),
// so every kernel is a gather over its output rows.
//
// Bounds (PERF.md has the measured times): each kernel is a pure int32
// copy, its bytes are the rows read (the staging rows, the kept lanes, the
// dummy row once) plus the rows written. These first kernels are one
// coalesced 4-byte word per thread and item, written to be right and
// simple.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCarryLen = 20;
constexpr int kCPacked = 2;
constexpr int kCP1 = 6;
constexpr int kCP2 = 10;
constexpr int kCIdx = 18;
constexpr int kThreads = 256;
constexpr int kItems = 8;  // words per thread of a row chunk
constexpr int kChunk = kThreads * kItems;

struct SeatArgs {
  int* comb;                 // int32[B, row]: the stacks, row = V * W
  int* degrees;              // int32[B, V]
  int* k0;                   // int32[B]
  int* max_steps;            // int32[B]
  int* reset;                // int32[B]
  const int* stage_comb;     // int32[n, row]: the seats' rows, uploaded
  const int* stage_degrees;  // int32[n, V]
  const int* seats;          // int32[3, n]: lane, k0, max_steps
  long long row;
  int v;
  int b;
  int n;
};

struct PermuteArgs {
  const int* old[kCarryLen];  // the carry, lane-leading, B_old lanes
  int* out[kCarryLen];        // a fresh carry of B_new lanes
  const int* rows;            // int32[B_new]: the old lane of a row, or -1
  int idle[kCarryLen];        // the idle lane's value of each slot
  int b_old;
  int b_new;
  int v;
  int a0;
};

struct ResizeArgs {
  const int* comb;        // int32[B_old, row]
  const int* degrees;     // int32[B_old, V]
  const int* k0;          // int32[B_old]
  const int* max_steps;   // int32[B_old]
  int* out_comb;          // int32[B_new, row]
  int* out_degrees;       // int32[B_new, V]
  int* out_k0;            // int32[B_new]
  int* out_max_steps;     // int32[B_new]
  int* out_reset;         // int32[B_new]
  const int* src;         // int32[B_new]: an old lane, or >= B_old: dummy
  const int* dummy_comb;  // int32[row]
  long long row;
  int dummy_k0;
  int dummy_max_steps;
  int b_old;
  int b_new;
  int v;
};

// ---- K17: seat a wave of lanes --------------------------------------------

__global__ void __launch_bounds__(kThreads) lane_seat_kernel(SeatArgs a) {
  const int i = blockIdx.y;
  const int lane = a.seats[i];
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const int* __restrict__ src = a.stage_comb + static_cast<size_t>(i) * a.row;
  int* __restrict__ dst = a.comb + static_cast<size_t>(lane) * a.row;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long c = c0 + it * kThreads + threadIdx.x;
    if (c < a.row) dst[c] = src[c];
    if (c < a.v) {
      a.degrees[static_cast<size_t>(lane) * a.v + c] =
          a.stage_degrees[static_cast<size_t>(i) * a.v + c];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.k0[lane] = a.seats[a.n + i];
    a.max_steps[lane] = a.seats[2 * a.n + i];
    a.reset[lane] = 1;
  }
}

// ---- K18: move the kept lanes' carry rows into a fresh carry --------------

__global__ void __launch_bounds__(kThreads) carry_permute_kernel(PermuteArgs a) {
  const int r = blockIdx.y;
  const int k = a.rows[r];
  const int width = a.v > a.a0 ? a.v : a.a0;
  const int c0 = blockIdx.x * kChunk;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int c = c0 + it * kThreads + threadIdx.x;
    if (c >= width) break;
    if (c < a.v) {
      const size_t o = static_cast<size_t>(r) * a.v + c;
      const size_t s = static_cast<size_t>(k) * a.v + c;
      a.out[kCPacked][o] = k >= 0 ? a.old[kCPacked][s] : a.idle[kCPacked];
      a.out[kCP1][o] = k >= 0 ? a.old[kCP1][s] : a.idle[kCP1];
      a.out[kCP2][o] = k >= 0 ? a.old[kCP2][s] : a.idle[kCP2];
    }
    if (c < a.a0) {
      a.out[kCIdx][static_cast<size_t>(r) * a.a0 + c] =
          k >= 0 ? a.old[kCIdx][static_cast<size_t>(k) * a.a0 + c]
                 : a.idle[kCIdx];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < kCarryLen) {
    const int j = threadIdx.x;
    if (j != kCPacked && j != kCP1 && j != kCP2 && j != kCIdx) {
      a.out[j][r] = k >= 0 ? a.old[j][k] : a.idle[j];
    }
  }
}

// ---- K19: resize the input stacks ------------------------------------------

__global__ void __launch_bounds__(kThreads) inputs_resize_kernel(ResizeArgs a) {
  const int r = blockIdx.y;
  const int k = a.src[r];
  const bool dummy = k < 0 || k >= a.b_old;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const int* __restrict__ src =
      dummy ? a.dummy_comb : a.comb + static_cast<size_t>(k) * a.row;
  int* __restrict__ dst = a.out_comb + static_cast<size_t>(r) * a.row;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long c = c0 + it * kThreads + threadIdx.x;
    if (c < a.row) dst[c] = src[c];
    if (c < a.v) {
      a.out_degrees[static_cast<size_t>(r) * a.v + c] =
          dummy ? 0 : a.degrees[static_cast<size_t>(k) * a.v + c];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.out_k0[r] = dummy ? a.dummy_k0 : a.k0[k];
    a.out_max_steps[r] = dummy ? a.dummy_max_steps : a.max_steps[k];
    a.out_reset[r] = 0;
  }
}

// The mesh instances' arguments: the old shards as device tables of
// pointers (int64), the row map int32[2, B_new] (old shard, then lane).
struct PermuteMeshArgs {
  const long long* old;   // [n_old, kCarryLen]: each old shard's slots
  int* out[kCarryLen];    // a fresh carry of B_new lanes (one new shard)
  const int* rows;        // int32[2, B_new]: old shard (-1: idle), lane
  int idle[kCarryLen];
  int n_old;
  int b_new;
  int v;
  int a0;
};

struct ResizeMeshArgs {
  const long long* old;   // [n_old, 4]: comb, degrees, k0, max_steps
  int* out_comb;          // int32[B_new, row]
  int* out_degrees;       // int32[B_new, V]
  int* out_k0;            // int32[B_new]
  int* out_max_steps;     // int32[B_new]
  int* out_reset;         // int32[B_new]
  const int* src;         // int32[2, B_new]: old shard (-1: dummy), lane
  const int* dummy_comb;  // int32[row]
  long long row;
  int dummy_k0;
  int dummy_max_steps;
  int n_old;
  int b_new;
  int v;
};

__device__ __forceinline__ const int* slot_of(const long long* table, int shard,
                                              int width, int j) {
  return reinterpret_cast<const int*>(table[static_cast<size_t>(shard) * width + j]);
}

// ---- K18 mesh instance ------------------------------------------------------

__global__ void __launch_bounds__(kThreads) carry_permute_mesh_kernel(
    PermuteMeshArgs a) {
  const int r = blockIdx.y;
  const int shard = a.rows[r];
  const int k = a.rows[a.b_new + r];  // the lane within its old shard
  const bool kept = shard >= 0;
  const int width = a.v > a.a0 ? a.v : a.a0;
  const int c0 = blockIdx.x * kChunk;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int c = c0 + it * kThreads + threadIdx.x;
    if (c >= width) break;
    if (c < a.v) {
      const size_t o = static_cast<size_t>(r) * a.v + c;
      const size_t s = static_cast<size_t>(k) * a.v + c;
      a.out[kCPacked][o] =
          kept ? slot_of(a.old, shard, kCarryLen, kCPacked)[s] : a.idle[kCPacked];
      a.out[kCP1][o] = kept ? slot_of(a.old, shard, kCarryLen, kCP1)[s] : a.idle[kCP1];
      a.out[kCP2][o] = kept ? slot_of(a.old, shard, kCarryLen, kCP2)[s] : a.idle[kCP2];
    }
    if (c < a.a0) {
      a.out[kCIdx][static_cast<size_t>(r) * a.a0 + c] =
          kept ? slot_of(a.old, shard, kCarryLen,
                         kCIdx)[static_cast<size_t>(k) * a.a0 + c]
               : a.idle[kCIdx];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < kCarryLen) {
    const int j = threadIdx.x;
    if (j != kCPacked && j != kCP1 && j != kCP2 && j != kCIdx) {
      a.out[j][r] = kept ? slot_of(a.old, shard, kCarryLen, j)[k] : a.idle[j];
    }
  }
}

// ---- K19 mesh instance ------------------------------------------------------

__global__ void __launch_bounds__(kThreads) inputs_resize_mesh_kernel(
    ResizeMeshArgs a) {
  const int r = blockIdx.y;
  const int shard = a.src[r];
  const int k = a.src[a.b_new + r];
  const bool dummy = shard < 0;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const int* __restrict__ src =
      dummy ? a.dummy_comb
            : slot_of(a.old, shard, 4, 0) + static_cast<size_t>(k) * a.row;
  const int* __restrict__ deg =
      dummy ? nullptr : slot_of(a.old, shard, 4, 1) + static_cast<size_t>(k) * a.v;
  int* __restrict__ dst = a.out_comb + static_cast<size_t>(r) * a.row;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long c = c0 + it * kThreads + threadIdx.x;
    if (c < a.row) dst[c] = src[c];
    if (c < a.v) {
      a.out_degrees[static_cast<size_t>(r) * a.v + c] = dummy ? 0 : deg[c];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.out_k0[r] = dummy ? a.dummy_k0 : slot_of(a.old, shard, 4, 2)[k];
    a.out_max_steps[r] =
        dummy ? a.dummy_max_steps : slot_of(a.old, shard, 4, 3)[k];
    a.out_reset[r] = 0;
  }
}

unsigned chunks(long long n) {
  return static_cast<unsigned>((n + kChunk - 1) / kChunk);
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 = launched; an empty launch,
// no seat or no row, launches nothing); `args` is read on the host before
// the call returns.

int dgc_lane_seat(const void* args, void* stream) {
  const auto* a = static_cast<const SeatArgs*>(args);
  if (a->n < 0 || a->n > 65535 || a->row < 1 || a->v < 1 || a->b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n == 0) return 0;
  const long long span = a->row > a->v ? a->row : a->v;
  const dim3 grid(chunks(span), a->n);
  lane_seat_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int dgc_carry_permute(const void* args, void* stream) {
  const auto* a = static_cast<const PermuteArgs*>(args);
  if (a->b_new < 1 || a->b_new > 65535 || a->b_old < 0 || a->v < 1 ||
      a->a0 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(chunks(a->v > a->a0 ? a->v : a->a0), a->b_new);
  carry_permute_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int dgc_inputs_resize(const void* args, void* stream) {
  const auto* a = static_cast<const ResizeArgs*>(args);
  if (a->b_new < 1 || a->b_new > 65535 || a->b_old < 0 || a->row < 1 ||
      a->v < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long span = a->row > a->v ? a->row : a->v;
  const dim3 grid(chunks(span), a->b_new);
  inputs_resize_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int dgc_carry_permute_mesh(const void* args, void* stream) {
  const auto* a = static_cast<const PermuteMeshArgs*>(args);
  if (a->b_new < 1 || a->b_new > 65535 || a->n_old < 1 || a->v < 1 ||
      a->a0 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(chunks(a->v > a->a0 ? a->v : a->a0), a->b_new);
  carry_permute_mesh_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int dgc_inputs_resize_mesh(const void* args, void* stream) {
  const auto* a = static_cast<const ResizeMeshArgs*>(args);
  if (a->b_new < 1 || a->b_new > 65535 || a->n_old < 1 || a->row < 1 ||
      a->v < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long span = a->row > a->v ? a->row : a->v;
  const dim3 grid(chunks(span), a->b_new);
  inputs_resize_mesh_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int dgc_permute_mesh_args_size() {
  return static_cast<int>(sizeof(PermuteMeshArgs));
}
int dgc_resize_mesh_args_size() {
  return static_cast<int>(sizeof(ResizeMeshArgs));
}
int dgc_seat_args_size() { return static_cast<int>(sizeof(SeatArgs)); }
int dgc_permute_args_size() { return static_cast<int>(sizeof(PermuteArgs)); }
int dgc_resize_args_size() { return static_cast<int>(sizeof(ResizeArgs)); }

}  // extern "C"
