// Tile machinery shared by the D2FT-gated MoE expert FFN kernels
// (d2ft_moe_fwd.cu, d2ft_moe_bwd.cu): 3xTF32 tensor-core GEMM tiles fed by
// a cp.async ring, the device work list of live (expert, capacity-block)
// tiles, the activations.
//
// Layouts are the model's: the capacity buffer x, y, dy, dx [E, C, D] and
// the expert weights w_up / w_gate [E, D, F], w_down [E, F, D], all
// row-major, so each GEMM reads its operands in place, some transposed.
//
// A GEMM tile is kBM = 128 output rows by BN = 64 or 128 columns, 8 warps
// as 2 (M) x 4 (N): each warp owns 64 rows (kMt = 4 m-tiles of 16) by
// BN / 4 columns (n-tiles of 8) of every accumulator of the tile, on
// mma.sync m16n8k8 in 3xTF32 (tf32x3.cuh: float32 accuracy; each k-step's
// three products go to a fresh tensor-core accumulator that is added in
// IEEE float32). K goes through shared memory in slabs of kBK = 32, in a
// ring of cp.async stages in dynamic shared memory, slab s + STAGES - 1 in
// flight while slab s is multiplied. Operands are staged as they lie in
// memory, in the swizzled tiles of tf32x3.cuh:
//   A [m][k] (x, dy, mid, dh|dg rows)      ldmatrix        load_a1<false>
//   A [k][m] (x^T, (a h)^T for the dW)     float by float  load_a1<true>
//   B [k][n] (W_up, W_gate, W_down; dh,    float by float  load_bs<false>
//            dg, dy for the dW)
//   B [n][k] (W_down in dmid, W_up and     ldmatrix        load_bs<true>
//            W_gate in dx)
// The ragged edges (D, F, capacity blocks of any size) are zero-filled by
// the copies themselves; an operand whose rows or base are not 16-byte
// aligned is copied a float at a time (the entry decides per operand).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace moe {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kThreads = 256;   // 8 warps: 2 (M) x 4 (N)
constexpr int kBM = 128;        // output rows of a tile
constexpr int kBK = 32;         // K slab
constexpr int kMt = 4;          // m-tiles of 16 rows a warp
constexpr int kListThreads = 1024;
constexpr int kSmemMax = 232448;   // shared memory a block may take
// Two blocks an SM (16 warps) for the kernels with 64 accumulator floats
// a thread: at most 128 registers, and 3 stages of 32 KB each
constexpr int kBlocksPerSm = 2;
constexpr int kStages = 3;

// this warp's first row (of kBM) and first column (of BN)
__device__ __forceinline__ int warp_m0() { return (threadIdx.x >> 7) * 64; }
template <int BN>
__device__ __forceinline__ int warp_n0() {
  return ((threadIdx.x >> 5) & 3) * (BN / 4);
}

// The NT n-tiles of the warp's B fragments at k-step k8, from a [k][n]
// tile (NK false: row k, column n) or a [n][k] tile (NK true)
template <bool NK, int NT>
__device__ __forceinline__ void load_bs(FragB (&fb)[NT], const float* s,
                                        int pitch, int n0, int k8) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if constexpr (NK)
      tf32x3::load_b_nk(fb[j], s, pitch, n0 + 8 * j, k8);
    else
      tf32x3::load_b_kn(fb[j], s, pitch, k8, n0 + 8 * j);
  }
}

// The A fragment of rows m0 .. m0 + 15 at k-step k8, from a [m][k] tile
// (KM false) or a [k][m] tile (KM true)
template <bool KM>
__device__ __forceinline__ void load_a1(FragA& fa, const float* s,
                                        int pitch, int m0, int k8) {
  if constexpr (KM)
    tf32x3::load_a_km(fa, s, pitch, k8, m0);
  else
    tf32x3::load_a(fa, s, pitch, m0, k8);
}

// acc[j] += fa fb[j] for one m-tile and the warp's NT n-tiles. A k-step
// loads the B fragments first and then one m-tile's A fragment at a time,
// so 4 NT + 8 registers of fragments are live beside the accumulators.
template <int NT>
__device__ __forceinline__ void mma_m(float (&acc)[NT][4], const FragA& fa,
                                      const FragB (&fb)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) tf32x3::mma3(acc[j], fa, fb[j]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[kMt][NT][4]) {
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Element e of accumulator fragment (i, j) lies at tile row
// m0 + 16 i + g + 8 (e >> 1), column n0 + 8 j + 2 t + (e & 1). Calls
// f(row, col, i, j, h) for h = 0, 1 (the fragment's rows g and g + 8; its
// columns col and col + 1 are elements 2 h and 2 h + 1).
template <int NT, class Fn>
__device__ __forceinline__ void for_each_pair(int m0, int n0, Fn&& f) {
  const int g = tf32x3::lane_id() >> 2, t = tf32x3::lane_id() & 3;
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(m0 + 16 * i + g + 8 * h, n0 + 8 * j + 2 * t, i, j, h);
}

// out[col], out[col + 1] = v0, v1 for the columns below n; one 8-byte
// store where both are in range and out + col is 8-byte aligned
__device__ __forceinline__ void store_pair(float* out, int col, int n,
                                           float v0, float v1) {
  if (col + 1 < n && ((reinterpret_cast<uintptr_t>(out + col) & 7) == 0)) {
    *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
  } else {
    if (col < n) out[col] = v0;
    if (col + 1 < n) out[col + 1] = v1;
  }
}

// The cp.async ring: load(s, stage) issues slab s's copies into a stage
// of STAGE floats, compute(stage) multiplies a landed slab. n slabs; slab
// s + STAGES - 1 is in flight while slab s is multiplied. Ends with every
// copy landed and (after the last compute) no barrier: the caller's
// epilogue reads registers only.
template <int STAGES, int STAGE, class Load, class Compute>
__device__ __forceinline__ void ring(float* smem, int n, Load&& load,
                                     Compute&& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, smem + s * STAGE);
    tf32x3::commit();
  }
  for (int s = 0; s < n; ++s) {
    tf32x3::wait<STAGES - 2>();
    __syncthreads();              // slab s landed; slab s - 1 all read
    const int nx = s + STAGES - 1;
    if (nx < n) load(nx, smem + (nx % STAGES) * STAGE);
    tf32x3::commit();
    compute(static_cast<const float*>(smem + (s % STAGES) * STAGE));
  }
  tf32x3::wait<0>();
}

// 16-byte copies for an operand whose base is 16-byte aligned and whose
// row stride and every offset taken from it are multiples of 4 floats
inline bool vec_ok(const void* p, long ld, long offset = 0) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0 &&
         offset % 4 == 0;
}

// The tile a block of a (column block, row block, work slot) grid works
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
// The live tiles stay in ascending order, so an expert's live blocks are
// one ascending run of the list.
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

// The first index in work[0, n) whose tile id is >= id (work's live
// prefix is ascending)
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ work,
                                           int n, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (work[mid] < id)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
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

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Set a kernel's dynamic shared memory limit (above 48 KB needs it)
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace moe
