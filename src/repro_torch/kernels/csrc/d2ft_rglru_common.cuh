// Geometry and helpers shared by the D2FT-gated RG-LRU kernels
// (d2ft_rglru_fwd.cu, d2ft_rglru_bwd.cu).
//
// Layouts are the model's (no transposed or gathered copies): la, b, h, dy,
// dla, db [B, S, W], W the contiguous axis. The G gate groups cut W into G
// bands of Wg = W / G channels; slice s = b*G + g is band g of sample b.
//
// One block per (channel group z, slice y): grid (ceil(Wg / (kCols * V)),
// n_slices). A block owns kCols * V channels of one slice
// (V = 4 with 16-byte loads when W, Wg and every pointer allow it, else 1)
// over the whole sequence, which it walks in tiles of kTileRows rows.
// Thread (seg, col) = (tid / kCols, tid % kCols) holds kRows consecutive
// rows of a tile for its V channels in registers, so a warp's load is
// 32 / kCols rows of kCols * V * 4 bytes (128 bytes at V = 4). Every
// operand row is read from device memory once.
//
// A tile is a first-order affine recurrence per channel, x -> a x + c.
// Each thread folds its kRows rows into one map (A, C), from a zero start;
// the warp combines its segments' maps in order with a Kogge-Stone scan of
// shuffles; each warp's total goes through shared memory, and every thread
// folds the totals of the warps before it (after it, in the backward) onto
// the state entering the tile; then it walks its rows again from its own
// entering state and writes the outputs. Every combination is in a fixed
// order, so results are bitwise the same on every call; no atomics on
// values.
//
// Operands reach the registers through shared memory, staged with cp.async
// one tile ahead (kStages buffers): each thread copies its own rows and
// later reads only those, so no barrier guards the staging, and the next
// tile's loads are in flight while this one is combined and written. Rows
// outside the sequence and channels past the band stage as zeros: la = 0
// is the identity map's decay.
//
// Slices: block y holds slice y and runs it by slice_gate.cuh's rule (its
// gate is not 0 and, under a dispatch bound, fewer than n_disp live slices
// come before it), so the launcher builds no table. A block that does not
// run writes exact zeros and computes nothing; the caller pre-fills
// nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "slice_gate.cuh"   // which slices run
#include "tf32x3.cuh"   // cp.async helpers

namespace rglru {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;    // blocks an SM: at most 128 registers
constexpr int kWarps = kThreads / 32;
// rows a thread holds per tile, and channel columns a block. 4 x 8 holds
// every operand in registers without spills at 128 registers (before the
// staging, 8 rows spilled 32 / 112 bytes forward / backward, 16 rows
// 476 / 644) and was the fastest pair timed at recurrentgemma-2b's shapes
// on an H100
constexpr int kRows = 4;
constexpr int kCols = 8;
constexpr int kSegs = kThreads / kCols;          // segments a tile
constexpr int kTileRows = kSegs * kRows;
constexpr int kStages = 2;                       // tiles staged a block
static_assert(32 % kCols == 0 && kCols <= 32 && kRows >= 1, "geometry");

// Floats one operand of one tile takes in a stage: kRows per thread.
template <int V>
constexpr int kSlotFloats = kRows * kThreads * V;

// Copy this thread's rows r0 .. r0 + kRows - 1 of an operand (row r at
// src + r * W) into its slots of dst; rows outside [0, n) and a channel
// past the band (!cv) as zeros. any: an address the copy may name when it
// reads nothing.
template <int V>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      const float* any, int r0, int n,
                                      int W, bool cv) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r0 + i;
    const bool in = cv && row >= 0 && row < n;
    const float* p = in ? src + (size_t)row * W : any;
    float* d = dst + (i * kThreads + threadIdx.x) * V;
    if constexpr (V == 4)
      tf32x3::cp_async16(d, p, in ? 16 : 0);
    else
      tf32x3::cp_async4(d, p, in ? 4 : 0);
  }
}

// This thread's kRows rows of an operand from its slots of src.
template <int V>
__device__ __forceinline__ void unstage(float (&x)[kRows][V],
                                        const float* src) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float* p = src + (i * kThreads + threadIdx.x) * V;
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      x[i][0] = t.x; x[i][1] = t.y; x[i][2] = t.z; x[i][3] = t.w;
    } else {
      x[i][0] = p[0];
    }
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    p[0] = x[0];
}

template <int V>
__device__ __forceinline__ void shfl_up(float (&y)[V], const float (&x)[V],
                                        int off) {
#pragma unroll
  for (int c = 0; c < V; ++c) y[c] = __shfl_up_sync(0xffffffffu, x[c], off);
}

template <int V>
__device__ __forceinline__ void shfl_down(float (&y)[V],
                                          const float (&x)[V], int off) {
#pragma unroll
  for (int c = 0; c < V; ++c)
    y[c] = __shfl_down_sync(0xffffffffu, x[c], off);
}

// Launch geometry: one block per (channel group, slice).
inline dim3 grid_of(int n_slices, int Wg, int V) {
  return dim3((Wg + kCols * V - 1) / (kCols * V), n_slices);
}
// 16-byte loads need every row offset and base pointer 16-byte aligned.
inline bool vec4_ok(int W, int G, const void* const* ptrs, int n) {
  if (W % 4 != 0 || (W / G) % 4 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return false;
  return true;
}

}  // namespace rglru
