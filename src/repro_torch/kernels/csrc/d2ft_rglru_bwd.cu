// D2FT-gated RG-LRU scan, gate-aware backward, for Hopper (sm_90a),
// float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_rglru.py::_bwd_kernel
// (launcher _backward). For h_t = a_t * h_{t-1} + b_t with a = exp(la),
// the cotangent of h_t carried backwards is
//   g_t = dy_t + a_{t+1} * g_{t+1}     (g past the end = 0)
// and per (sample, channel band) slice with g_b != 0 and per channel
//   db_t  = g_t,
//   dla_t = g_t * a_t * h_{t-1}        (h the forward's output, h_{-1} = 0).
// This is the sequential form of the TPU kernel's chunk sums
//   db_k = sum_{q>=k} exp(lc_q - lc_k) dh_q,
//   dla  = reverse_cumsum(dh * h - b * db):
// the reverse cumulative sum telescopes to g_t * (h_t - b_t), and
// h_t - b_t = a_t * h_{t-1} is taken directly (the difference cancels when
// a is small), so b is not read. g_b <= g_f, so h is the true forward
// output on every slice that runs here. A slice with g_b == 0 runs nothing
// and writes exact-zero dla and db.
//
// What bounds it on this card: bytes. Per element it reads la, h and dy and
// writes dla and db (20 bytes) for ~5 operations.
//
// Design: the forward's (d2ft_rglru_fwd.cu, d2ft_rglru_common.cuh) run
// backwards in time. The carry a row passes to the row before it is
// k_t = a_t * g_t = a_t * (dy_t + k_{t+1}), an affine map of k_{t+1}; a
// block walks its slice's tiles from the last, each thread folds its rows
// from the last to the first into one map from a zero carry, the segments
// are combined from the right (shuffles down in the warp, the warps'
// totals through shared memory), and each thread walks its rows again from
// its entering carry: g = dy + k, db = g, k = a g, dla = k h_{t-1}. Each
// thread stages h one row back (rows r0 - 1 .. r0 + kRows - 2 for its rows
// r0 ..), so every row of h is read once, and no thread waits on
// another's; la, dy and h take 96 KB of staging (two tiles) a block. The compaction, the zeros, the executed-step counter
// and the padding are the forward's.

#include "d2ft_rglru_common.cuh"

namespace {

using namespace rglru;

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rglru_bwd_kernel(const float* __restrict__ la, const float* __restrict__ h,
                 const float* __restrict__ dy,
                 const float* __restrict__ gate, float* __restrict__ dla,
                 float* __restrict__ db,
                 unsigned long long* __restrict__ steps, int n_slices,
                 int n_disp, int S, int W, int G, int nc) {
  __shared__ float agg_a[2][kWarps][kCols * V], agg_c[2][kWarps][kCols * V];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % kCols, seg = tid / kCols;
  const int s = blockIdx.y;
  const bool run = gating::slice_runs<kThreads>(gate, n_slices, n_disp, s);
  const int Wg = W / G;
  const int ch = (blockIdx.x * kCols + col) * V;
  const bool cv = ch < Wg;
  const size_t base = (size_t)(s / G) * S * W + (size_t)(s % G) * Wg + ch;

  if (!run) {                                  // exact zeros, no compute
    const float z[V] = {};
    if (cv)
      for (int row = seg; row < S; row += kSegs) {
        store<V>(dla + base + (size_t)row * W, z);
        store<V>(db + base + (size_t)row * W, z);
      }
    return;
  }

  // tile t's la, dy and h one row back, staged in buffer t % kStages
  extern __shared__ float4 stage_buf[];
  float* const stg = reinterpret_cast<float*>(stage_buf);
  constexpr int kSlot = kSlotFloats<V>;
  const int nt = (S + kTileRows - 1) / kTileRows;
  auto fetch = [&](int t) {
    float* d = stg + (t % kStages) * 3 * kSlot;
    const int r0 = t * kTileRows + seg * kRows;
    stage<V>(d, la + base, la, r0, S, W, cv);
    stage<V>(d + kSlot, dy + base, dy, r0, S, W, cv);
    stage<V>(d + 2 * kSlot, h + base, h, r0 - 1, S, W, cv);
  };
  fetch(nt - 1);
  tf32x3::commit();

  float carry[V];                  // the carry entering a tile's last row
#pragma unroll
  for (int c = 0; c < V; ++c) carry[c] = 0.f;
  for (int t = nt - 1, par = 0; t >= 0; --t, par ^= 1) {
    if (t > 0) fetch(t - 1);
    tf32x3::commit();                          // empty past the first tile
    tf32x3::wait<1>();                         // tile t has landed
    const int r0 = t * kTileRows + seg * kRows;
    const float* src = stg + (t % kStages) * 3 * kSlot;
    float a[kRows][V], d[kRows][V], hp[kRows][V];
    unstage<V>(a, src);
    unstage<V>(d, src + kSlot);
    unstage<V>(hp, src + 2 * kSlot);
    // this segment's map from a zero carry at its end: k -> A k + C
    float A[V], C[V];
#pragma unroll
    for (int c = 0; c < V; ++c) A[c] = 1.f, C[c] = 0.f;
#pragma unroll
    for (int i = kRows - 1; i >= 0; --i)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        a[i][c] = expf(a[i][c]);
        A[c] *= a[i][c];
        C[c] = a[i][c] * (d[i][c] + C[c]);
      }
    // inclusive over the warp's segments from the right: later (An, Cn),
    // then this one
#pragma unroll
    for (int off = kCols; off < 32; off <<= 1) {
      float An[V], Cn[V];
      shfl_down<V>(An, A, off);
      shfl_down<V>(Cn, C, off);
      if (lane + off < 32) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          C[c] = fmaf(A[c], Cn[c], C[c]);
          A[c] *= An[c];
        }
      }
    }
    // the segments after this one in the warp (exclusive)
    float Ae[V], Ce[V];
    shfl_down<V>(Ae, A, kCols);
    shfl_down<V>(Ce, C, kCols);
    if (lane < kCols) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        agg_a[par][warp][col * V + c] = A[c];
        agg_c[par][warp][col * V + c] = C[c];
      }
    }
    __syncthreads();
    // the carry entering this segment's last row: the tile's entering
    // carry through the warps after this one, then the segments after it
    // in the warp; and the carry the tile passes on through every warp
    float k[V], next[V];
#pragma unroll
    for (int c = 0; c < V; ++c) k[c] = next[c] = carry[c];
#pragma unroll
    for (int w = kWarps - 1; w >= 0; --w)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float wa = agg_a[par][w][col * V + c];
        const float wc = agg_c[par][w][col * V + c];
        next[c] = fmaf(wa, next[c], wc);
        if (w > warp) k[c] = fmaf(wa, k[c], wc);
      }
    if (lane < 32 - kCols) {
#pragma unroll
      for (int c = 0; c < V; ++c) k[c] = fmaf(Ae[c], k[c], Ce[c]);
    }
#pragma unroll
    for (int i = kRows - 1; i >= 0; --i) {
      float g[V], dl[V];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        g[c] = d[i][c] + k[c];
        k[c] = a[i][c] * g[c];
        dl[c] = k[c] * hp[i][c];
      }
      if (cv && r0 + i < S) {
        store<V>(db + base + (size_t)(r0 + i) * W, g);
        store<V>(dla + base + (size_t)(r0 + i) * W, dl);
      }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) carry[c] = next[c];
  }
  if (steps != nullptr && blockIdx.x == 0 && tid == 0)
    atomicAdd(steps, (unsigned long long)nc);
}

template <int V>
cudaError_t launch(const void* la, const void* h, const void* dy,
                   const void* gate, void* dla, void* db, void* steps,
                   int n_slices, int n_disp, int S, int W, int G, int nc,
                   cudaStream_t stream) {
  constexpr int smem = kStages * 3 * kSlotFloats<V> * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  rglru_bwd_kernel<V><<<grid_of(n_slices, W / G, V), kThreads, smem,
                        stream>>>(
      static_cast<const float*>(la), static_cast<const float*>(h),
      static_cast<const float*>(dy), static_cast<const float*>(gate),
      static_cast<float*>(dla), static_cast<float*>(db),
      static_cast<unsigned long long*>(steps), n_slices, n_disp, S, W, G,
      nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. Arguments as
// d2ft_rglru_fwd_f32's, with h the forward's output and dy its cotangent.
int d2ft_rglru_bwd_f32(const void* la, const void* h, const void* dy,
                       const void* gate, void* dla, void* db, void* steps,
                       int n_slices, int n_disp, int S, int W, int G, int Q,
                       void* stream) {
  if (n_slices <= 0 || n_slices > 65535 || n_disp <= 0 ||
      n_disp > n_slices || S <= 0 || Q <= 0 || S % Q || G <= 0 || W % G ||
      n_slices % G)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {la, h, dy, dla, db};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec4_ok(W, G, ptrs, 5)
             ? launch<4>(la, h, dy, gate, dla, db, steps, n_slices, n_disp,
                         S, W, G, S / Q, st)
             : launch<1>(la, h, dy, gate, dla, db, steps, n_slices, n_disp,
                         S, W, G, S / Q, st);
}

const char* d2ft_rglru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
