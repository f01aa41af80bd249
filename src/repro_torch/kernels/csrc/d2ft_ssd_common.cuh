// Helpers shared by the D2FT-gated SSD kernels (d2ft_ssd_fwd.cu,
// d2ft_ssd_bwd.cu): the row tile, a register-tiled float32 product over
// shared memory, tile loads, and the in-chunk cumulative decay.
//
// Layouts are the model's (no transposed or gathered copies): x, y, dx, dy
// [B, S, H, P]; da, ddA [B, S, H]; Bm, Cm [B, S, N]. Slice s = b*H + h.
// A chunk is Q <= 256 consecutive rows, cut into 64-row tiles; the last
// tile may be ragged, and its missing rows are zero-filled in shared memory
// so that they add nothing to any product.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

constexpr int kT = 64;            // row tile within a chunk
constexpr int kThreads = 256;     // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kMaxQ = 256;        // largest chunk
constexpr int kLdT = kT + 1;      // leading dim of a 64 x 64 tile (+1: banks)

// acc[i][j] += sum_k A(r, k) * B(k, c), r = ty*RT + i, c = tx + 16*j.
// A(r, k) is a[r*lda + k], or a[k*lda + r] when TA; B(k, c) is
// b[k*ldb + c], or b[c*ldb + k] when TB. Leading dims are odd where an
// operand is read across rows, so a half warp hits 16 banks.
template <int RT, int CT, int K, bool TA, bool TB>
__device__ __forceinline__ void mma(float (&acc)[RT][CT],
                                    const float* __restrict__ a, int lda,
                                    const float* __restrict__ b, int ldb,
                                    int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RT], bv[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      av[i] = TA ? a[k * lda + ty * RT + i] : a[(ty * RT + i) * lda + k];
#pragma unroll
    for (int j = 0; j < CT; ++j)
      bv[j] = TB ? b[(tx + 16 * j) * ldb + k] : b[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int RT, int CT>
__device__ __forceinline__ void zero(float (&acc)[RT][CT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
}

// 64 rows of W floats (W % 4 == 0) from src, rows `stride` floats apart,
// into dst [64][ld]; rows >= nrows are zero-filled.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long stride, int nrows, int tid) {
  constexpr int V = W / 4;
  for (int i = tid; i < kT * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows)
      v = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
    float* o = dst + r * ld + c;
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

// Sum over the 16 lanes that share a ty (one half warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// cum[i] = da[0] + ... + da[i] over the chunk's rows (da rows `stride`
// floats apart), for i < n (n a multiple of 64 covering Q); rows past Q add
// 0. Summed in float32, in order, by one thread: the plain version's
// torch.cumsum along a non-innermost dimension sums the same way, so both
// compute the same cum and the same decays exp(cum_q - cum_k). At
// Q = 256, |cum| reaches ~200, where one float32 rounding of cum moves a
// decay by ~1.5e-5 relative; another summation order would put that
// difference between the kernels and their plain version.
__device__ __forceinline__ void chunk_cumsum(float* cum,
                                             const float* __restrict__ da,
                                             long stride, int Q, int n,
                                             int tid) {
  for (int i = tid; i < n; i += kThreads) cum[i] = i < Q ? da[i * stride] : 0.f;
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) {
      acc += cum[i];
      cum[i] = acc;
    }
  }
  __syncthreads();
}

}  // namespace ssd
