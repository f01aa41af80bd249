// D2FT-gated RG-LRU scan, forward, for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_rglru.py::_fwd_kernel
// (launcher _forward). Per (sample, channel band) slice with g_f != 0 and
// per channel, the recurrence
//   h_t = exp(la_t) * h_{t-1} + b_t,   h_{-1} = 0,
// and h [B, S, W] out. A slice with g_f == 0 runs nothing and writes exact
// zeros.
//
// What bounds it on this card: bytes. Per element it reads la and b and
// writes h (12 bytes) for ~3 operations (exp, multiply, add), far below
// the ~20 operations a byte at which float32 arithmetic would bind.
//
// Design (geometry and the combine in d2ft_rglru_common.cuh): the TPU grid
// (slice, chunk) walks a slice's chunks in order and carries the state in
// VMEM, each chunk in the quadratic log-space form with a [Q, Q, Wg] decay
// matrix. Here each channel is an independent first-order recurrence, so
// no decay matrix is built: one kernel, one pass, each operand read once.
// A block owns 32 channels (8 columns of 16-byte vectors) of one slice
// and walks the sequence in tiles of 128 rows; each thread stages its 4
// rows of la and b with cp.async one tile ahead (16 copies of 16 bytes in
// flight a thread), reads them into registers, turns la into a = exp(la)
// in place, folds its rows into (A, C) = (prod a, the state from
// a zero start), and the segments are combined in order (shuffles in the
// warp, the 8 warps' totals through shared memory, double-buffered by
// tile parity so one barrier a tile suffices). Then it walks its rows from
// its entering state and writes h once. The tile's end state, folded by
// every thread from the same totals, carries into the next tile. At
// recurrentgemma-2b's shapes (B 4, S 512, W 2560, G 10) that is 320
// blocks of 8 warps, two an SM, each with 64 KB of staging (two tiles)
// in shared memory.
// The executed-step counter (replaces the JAX on_backward_block hook):
// the block of channel group 0 of each run slice adds S / Q, its (slice,
// chunk) steps, with one atomic, when the caller passes the int64 cell.
// Odd S is the caller's zero padding (la = 0, b = 0); rows past S in the
// last tile are the identity map and are not written.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_rglru.py) checks
// devices, dtypes, shapes and contiguity, allocates h (unfilled) and
// passes PyTorch's current stream. The kernel allocates nothing. The entry
// returns cudaGetLastError().

#include "d2ft_rglru_common.cuh"

namespace {

using namespace rglru;

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rglru_fwd_kernel(const float* __restrict__ la, const float* __restrict__ b,
                 const float* __restrict__ gate, float* __restrict__ h_out,
                 unsigned long long* __restrict__ steps, int n_slices,
                 int n_disp, int S, int W, int G, int nc) {
  // the warps' total maps (A, C), [tile parity][warp][column]
  __shared__ float agg_a[2][kWarps][kCols * V], agg_c[2][kWarps][kCols * V];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % kCols, seg = tid / kCols;
  const int s = blockIdx.y;
  const bool run = gating::slice_runs<kThreads>(gate, n_slices, n_disp, s);
  const int Wg = W / G;
  const int ch = (blockIdx.x * kCols + col) * V;  // channel in the band
  const bool cv = ch < Wg;
  const size_t base = (size_t)(s / G) * S * W + (size_t)(s % G) * Wg + ch;

  if (!run) {                                  // exact zeros, no compute
    const float z[V] = {};
    if (cv)
      for (int row = seg; row < S; row += kSegs)
        store<V>(h_out + base + (size_t)row * W, z);
    return;
  }

  // tile t's la and b, staged in buffer t % kStages
  extern __shared__ float4 stage_buf[];
  float* const stg = reinterpret_cast<float*>(stage_buf);
  constexpr int kSlot = kSlotFloats<V>;
  const int nt = (S + kTileRows - 1) / kTileRows;
  auto fetch = [&](int t) {
    float* d = stg + (t % kStages) * 2 * kSlot;
    const int r0 = t * kTileRows + seg * kRows;
    stage<V>(d, la + base, la, r0, S, W, cv);
    stage<V>(d + kSlot, b + base, b, r0, S, W, cv);
  };
  fetch(0);
  tf32x3::commit();

  float carry[V];                              // the state entering a tile
#pragma unroll
  for (int c = 0; c < V; ++c) carry[c] = 0.f;
  for (int t = 0, par = 0; t < nt; ++t, par ^= 1) {
    if (t + 1 < nt) fetch(t + 1);
    tf32x3::commit();                          // empty past the last tile
    tf32x3::wait<1>();                         // tile t has landed
    const int r0 = t * kTileRows + seg * kRows;
    float a[kRows][V], x[kRows][V];
    unstage<V>(a, stg + (t % kStages) * 2 * kSlot);
    unstage<V>(x, stg + (t % kStages) * 2 * kSlot + kSlot);
    // this segment's map from a zero start: h -> A h + C
    float A[V], C[V];
#pragma unroll
    for (int c = 0; c < V; ++c) A[c] = 1.f, C[c] = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        a[i][c] = expf(a[i][c]);
        A[c] *= a[i][c];
        C[c] = fmaf(a[i][c], C[c], x[i][c]);
      }
    // inclusive over the warp's segments in order: earlier (Ap, Cp), then
    // this one
#pragma unroll
    for (int off = kCols; off < 32; off <<= 1) {
      float Ap[V], Cp[V];
      shfl_up<V>(Ap, A, off);
      shfl_up<V>(Cp, C, off);
      if (lane >= off) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          C[c] = fmaf(A[c], Cp[c], C[c]);
          A[c] *= Ap[c];
        }
      }
    }
    // the segments before this one in the warp (exclusive)
    float Ae[V], Ce[V];
    shfl_up<V>(Ae, A, kCols);
    shfl_up<V>(Ce, C, kCols);
    if (lane >= 32 - kCols) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        agg_a[par][warp][col * V + c] = A[c];
        agg_c[par][warp][col * V + c] = C[c];
      }
    }
    __syncthreads();
    // the state entering this segment: the tile's entering state through
    // the warps before this one, then the segments before it in the warp;
    // and the tile's end state through every warp
    float hs[V], next[V];
#pragma unroll
    for (int c = 0; c < V; ++c) hs[c] = next[c] = carry[c];
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float wa = agg_a[par][w][col * V + c];
        const float wc = agg_c[par][w][col * V + c];
        next[c] = fmaf(wa, next[c], wc);
        if (w < warp) hs[c] = fmaf(wa, hs[c], wc);
      }
    if (lane >= kCols) {
#pragma unroll
      for (int c = 0; c < V; ++c) hs[c] = fmaf(Ae[c], hs[c], Ce[c]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int c = 0; c < V; ++c) hs[c] = fmaf(a[i][c], hs[c], x[i][c]);
      if (cv && r0 + i < S)
        store<V>(h_out + base + (size_t)(r0 + i) * W, hs);
    }
#pragma unroll
    for (int c = 0; c < V; ++c) carry[c] = next[c];
  }
  if (steps != nullptr && blockIdx.x == 0 && tid == 0)
    atomicAdd(steps, (unsigned long long)nc);
}

template <int V>
cudaError_t launch(const void* la, const void* b, const void* gate,
                   void* h, void* steps, int n_slices, int n_disp, int S,
                   int W, int G, int nc, cudaStream_t stream) {
  constexpr int smem = kStages * 2 * kSlotFloats<V> * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_fwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  rglru_fwd_kernel<V><<<grid_of(n_slices, W / G, V), kThreads, smem,
                        stream>>>(
      static_cast<const float*>(la), static_cast<const float*>(b),
      static_cast<const float*>(gate), static_cast<float*>(h),
      static_cast<unsigned long long*>(steps), n_slices, n_disp, S, W, G,
      nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. gate holds the
// n_slices = B * G slice gates; n_disp (1..n_slices) the dispatch count:
// slices past the first n_disp of the live-first order write zeros.
// steps may be null (no step count). S must be a multiple of Q, W of G.
int d2ft_rglru_fwd_f32(const void* la, const void* b, const void* gate,
                       void* h, void* steps, int n_slices, int n_disp,
                       int S, int W, int G, int Q, void* stream) {
  if (n_slices <= 0 || n_slices > 65535 || n_disp <= 0 ||
      n_disp > n_slices || S <= 0 || Q <= 0 || S % Q || G <= 0 || W % G ||
      n_slices % G)
    return cudaErrorInvalidValue;
  const void* ptrs[] = {la, b, h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec4_ok(W, G, ptrs, 3)
             ? launch<4>(la, b, gate, h, steps, n_slices, n_disp, S, W, G,
                         S / Q, st)
             : launch<1>(la, b, gate, h, steps, n_slices, n_disp, S, W, G,
                         S / Q, st);
}

const char* d2ft_rglru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
