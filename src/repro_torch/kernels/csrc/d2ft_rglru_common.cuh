// Geometry shared by the D2FT-gated RG-LRU kernels (d2ft_rglru_fwd.cu,
// d2ft_rglru_bwd.cu).
//
// Layouts are the model's (no transposed or gathered copies): la, b, h, dy,
// dla, db [B, S, W], W the contiguous axis. The G gate groups cut W into G
// bands of Wg = W / G channels; slice s = b*G + g is band g of sample b.
// Every kernel runs on a grid (dispatched slice d, chunk c, channel block z)
// with one thread per channel of the band: neighbouring threads read
// neighbouring floats of a row, so a warp's load of one time step is one
// 128-byte line. Per-chunk summaries live in scratch [n_disp, nc, Wg],
// indexed by the dispatch index d.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rglru {

constexpr int kMaxThreads = 256;

struct Slot {
  int s;       // slice id
  int ch;      // channel within the band
  long base;   // offset of (sample, first row of chunk c, band channel ch)
  long sum;    // offset of (d, c, ch) in the summaries
  bool valid;  // ch < Wg
};

// Where this thread works. Slice ids come from the compaction table when
// there is one (no gathered copies).
__device__ __forceinline__ Slot slot(const int32_t* __restrict__ slice_idx,
                                     int S, int W, int G, int Q) {
  const int Wg = W / G;
  const int d = blockIdx.x, c = blockIdx.y;
  Slot t;
  t.ch = blockIdx.z * blockDim.x + threadIdx.x;
  t.valid = t.ch < Wg;
  t.s = slice_idx != nullptr ? slice_idx[d] : d;
  const int b = t.s / G, g = t.s % G;
  t.base = ((long)b * S + (long)c * Q) * W + (long)g * Wg + t.ch;
  t.sum = ((long)d * gridDim.y + c) * Wg + t.ch;
  return t;
}

// Summary offset of chunk j of this thread's (d, ch).
__device__ __forceinline__ long sum_at(const Slot& t, int j, int Wg) {
  return t.sum + (long)(j - (int)blockIdx.y) * Wg;
}

// Launch geometry: one thread per channel of a band, at most 256 a block.
inline dim3 block_of(int Wg) {
  const int w = ((Wg + 31) / 32) * 32;
  return dim3(w < kMaxThreads ? w : kMaxThreads);
}

inline dim3 grid_of(int n_disp, int nc, int Wg) {
  const int t = block_of(Wg).x;
  return dim3(n_disp, nc, (Wg + t - 1) / t);
}

}  // namespace rglru
