// What the recording kernels share (B11, in-kernel superstep telemetry):
// the trajectory row's columns and the card's clock.
//
// Ports dgc_tpu/obs/kernel.py:95 make_trajstep (the row write) and
// dgc_tpu/obs/devclock.py:55 kernel_clock_us (the timestamp). The row of
// superstep s is row s of an int32[cap, cols] buffer (layout.py COL_*);
// a step at or past cap is dropped. The JAX package samples the host clock
// through a callback; a Hopper kernel reads its own, %globaltimer (ns),
// here in microseconds masked to 31 bits, so a timestamp never reads as the
// -1 fill of an unwritten row. Only differences between rows mean
// anything: the two clocks have different origins.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "rule.cuh"

namespace dgc {

constexpr int kColActive = 0;
constexpr int kColFail = 1;
constexpr int kColMc = 2;
constexpr int kColGatherCalls = 3;
constexpr int kColMaxUnconf = 4;
constexpr int kColTsUs = 5;
constexpr int kTrajCols = 6;  // the fixed columns before the bucket tail
constexpr int kUsMask = 0x7FFFFFFF;

// The card's clock in masked microseconds.
__device__ __forceinline__ int globaltimer_us() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return static_cast<int>((ns / 1000ULL) & static_cast<unsigned long long>(kUsMask));
}

// Is a packed word confirmed (colored, not fresh)? A neighbor that is not
// counts toward the unconfirmed-neighbor columns.
__device__ __forceinline__ bool is_confirmed(int word) {
  return word >= 0 && (word & 1) == 0;
}

}  // namespace dgc
