// Tile machinery shared by the D2FT-gated MoE expert FFN kernels
// (d2ft_moe_fwd.cu, d2ft_moe_bwd.cu): float32 SIMT GEMM tiles, the device
// work list of live (expert, capacity-block) tiles, the activations.
//
// Layouts are the model's: the capacity buffer x, y, dy, dx [E, C, D] and
// the expert weights w_up / w_gate [E, D, F], w_down [E, F, D], all
// row-major, so each GEMM reads its operands in place, some transposed.
//
// A GEMM tile is 128 output rows by 64 or 128 columns, 256 threads as
// 16 x 16. Thread (ty, tx) owns rows {ty*4 .. ty*4+3} and {64 + ty*4 ..}
// (kTM = 8) and columns {tx*4 .. tx*4+3} (TN = 4), plus {64 + tx*4 ..}
// when TN = 8: two float4 fragments a step from shared memory per
// operand, no bank conflicts between a warp's fragments. The K dimension
// goes through shared memory in slabs of kBK = 16, stored k-major
// ([kBK][width + 4]: the +4 keeps float4 alignment and spreads the
// transposing stores over the banks). Every load is bounds-checked, so
// any D, F and capacity block size work; no wgmma, TMA or cp.async yet.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBM = 128;        // output rows of a tile
constexpr int kBK = 16;         // K slab
constexpr int kTM = 8;          // rows per thread
constexpr int kPA = kBM + 4;    // pitch of an A slab (floats)
constexpr int kListThreads = 1024;

template <int TN>
__host__ __device__ constexpr int width() { return 16 * TN; }  // 64 or 128

template <int TN>
__host__ __device__ constexpr int pitch() { return width<TN>() + 4; }

__device__ __forceinline__ int row_of(int ty, int i) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

// s[kk][i] = p[(i0 + i) * ld + k0 + kk] for a source whose rows are the
// tile's i and whose k is contiguous (x rows as A; w as a transposed B).
// Out-of-range entries are zeros. W is the slab width (i extent).
template <int W>
__device__ __forceinline__ void load_ik(float* s, const float* __restrict__ p,
                                        long ld, int i0, int ni, int k0,
                                        int nk) {
  constexpr int P = W + 4;
#pragma unroll
  for (int r = 0; r < W * kBK / kThreads; ++r) {
    const int idx = r * kThreads + threadIdx.x;
    const int i = idx / kBK, kk = idx % kBK;
    const int gi = i0 + i, gk = k0 + kk;
    s[kk * P + i] = (gi < ni && gk < nk) ? p[(long)gi * ld + gk] : 0.f;
  }
}

// s[kk][i] = p[(k0 + kk) * ld + i0 + i] for a source whose rows are k and
// whose i is contiguous (w as B; x or a·h rows as a transposed A).
template <int W>
__device__ __forceinline__ void load_ki(float* s, const float* __restrict__ p,
                                        long ld, int i0, int ni, int k0,
                                        int nk) {
  constexpr int P = W + 4;
#pragma unroll
  for (int r = 0; r < W * kBK / kThreads; ++r) {
    const int idx = r * kThreads + threadIdx.x;
    const int kk = idx / W, i = idx % W;
    const int gi = i0 + i, gk = k0 + kk;
    s[kk * P + i] = (gi < ni && gk < nk) ? p[(long)gk * ld + gi] : 0.f;
  }
}

// This thread's 8 A values of slab row kk.
__device__ __forceinline__ void a_frag(float (&av)[kTM], const float* a,
                                       int kk, int ty) {
  const float4 lo = *reinterpret_cast<const float4*>(a + kk * kPA + ty * 4);
  const float4 hi =
      *reinterpret_cast<const float4*>(a + kk * kPA + 64 + ty * 4);
  av[0] = lo.x; av[1] = lo.y; av[2] = lo.z; av[3] = lo.w;
  av[4] = hi.x; av[5] = hi.y; av[6] = hi.z; av[7] = hi.w;
}

// acc += av (x) this thread's TN B values of slab row kk.
template <int TN>
__device__ __forceinline__ void fma_frag(float (&acc)[kTM][TN],
                                         const float (&av)[kTM],
                                         const float* b, int kk, int tx) {
  float bv[TN];
  const float4 lo =
      *reinterpret_cast<const float4*>(b + kk * pitch<TN>() + tx * 4);
  bv[0] = lo.x; bv[1] = lo.y; bv[2] = lo.z; bv[3] = lo.w;
  if constexpr (TN == 8) {
    const float4 hi =
        *reinterpret_cast<const float4*>(b + kk * pitch<TN>() + 64 + tx * 4);
    bv[4] = hi.x; bv[5] = hi.y; bv[6] = hi.z; bv[7] = hi.w;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <int TN>
__device__ __forceinline__ void zero(float (&acc)[kTM][TN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// The tile a block of a (work slot, row block, column block) grid works
// on: work[z] = e * n_use + cb is a live tile when z < work[n_tiles].
struct Tile {
  int e, cb;    // expert, capacity block
  int r0;       // first slot of this block's rows within the expert
  int nr;       // valid rows (<= kBM)
  bool live;
};

__device__ __forceinline__ Tile tile_of(const int32_t* __restrict__ work,
                                        int n_tiles, int n_use, int bc) {
  Tile t;
  const int z = blockIdx.z;
  const int id = work[z];
  t.live = z < work[n_tiles];
  t.e = id / n_use;
  t.cb = id % n_use;
  t.r0 = t.cb * bc + blockIdx.y * kBM;
  t.nr = min(kBM, bc - (int)blockIdx.y * kBM);
  return t;
}

// One block of kListThreads: the stable partition of the tiles
// t = e * n_use + c (c < n_use) by mask[e * mask_ld + c] != 0, live tiles
// first, into work[0 .. E*n_use); work[E*n_use] = the live count. Each
// thread takes a contiguous run of tiles; a block scan of the live counts
// places them. No host synchronisation: the GEMM kernels read the list.
static __global__ void __launch_bounds__(kListThreads) build_work_list(
    const float* __restrict__ mask, int E, int mask_ld, int n_use,
    int32_t* __restrict__ work) {
  __shared__ int scan[kListThreads];
  const int n = E * n_use;
  const int per = (n + kListThreads - 1) / kListThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int live = 0;
  for (int t = lo; t < hi; ++t)
    live += mask[(t / n_use) * mask_ld + t % n_use] != 0.f;
  scan[threadIdx.x] = live;
  __syncthreads();
  for (int off = 1; off < kListThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? scan[threadIdx.x - off] : 0;
    __syncthreads();
    scan[threadIdx.x] += v;
    __syncthreads();
  }
  const int total = scan[kListThreads - 1];
  int lp = scan[threadIdx.x] - live;     // live tiles before lo
  int dp = total + (lo - lp);            // dead tiles go after every live
  for (int t = lo; t < hi; ++t) {
    if (mask[(t / n_use) * mask_ld + t % n_use] != 0.f)
      work[lp++] = t;
    else
      work[dp++] = t;
  }
  if (threadIdx.x == 0) work[n] = total;
}

// Activation codes (kernels/d2ft_moe.py ACTS): 0 silu, 1 gelu (tanh
// form, jax.nn.gelu's default), 2 relu; f and its derivative.
__device__ __forceinline__ float act_f(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));
  if (act == 1) {
    const float c = 0.7978845608028654f;          // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return fmaxf(g, 0.f);
}

__device__ __forceinline__ float act_df(float g, int act) {
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-g));
    return s * (1.f + g * (1.f - s));
  }
  if (act == 1) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (g + 0.044715f * g * g * g));
    return 0.5f * (1.f + t) +
           0.5f * g * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * g * g);
  }
  return g > 0.f ? 1.f : 0.f;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace moe
