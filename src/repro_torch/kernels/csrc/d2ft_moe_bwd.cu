// D2FT-gated MoE expert FFN, gate-aware backward, for Hopper (sm_90a),
// float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_moe.py::_bwd_kernel
// (launcher _backward, through the custom VJP's _vjp_bwd). On the grid of
// the first nb capacity blocks of every expert (the g_b bound: the dispatch
// packs backward-live slots into a prefix), for each tile whose block mask
// bm[e, cb] is set, with h = x W_up, g = x W_gate, a = act(g):
//   dmid = dy W_down^T,  dh = dmid * a,  dg = dmid * h * act'(g),
//   dx   = dh W_up^T + dg W_gate^T,
//   dW_up[e] += x^T dh,  dW_gate[e] += x^T dg,  dW_down[e] += (a h)^T dy.
// A tile with bm == 0 gives exact-zero dx and adds nothing; an expert with
// no live tile gets exact-zero dW. dx past nb is the caller's (zeros).
//
// What bounds it on this card: operations. A live tile needs 8 matmuls of
// 2 bc D F FLOPs (the recompute of h and g, dmid, two for dx, three dW;
// 4.3 GFLOP a tile at olmoe-1b-7b's 128 x 2048 x 1024) against reading x
// and dy and writing dx (3 MB a tile) and each expert's weights and
// gradients once (50 MB): hundreds of FLOPs per byte, above the ~20 where
// float32 FMA (67 TFLOP/s) and not HBM (3.35 TB/s) is the limit.
//
// Design. The TPU kernel walks an expert's capacity blocks in order on one
// core and keeps the expert's three [D, F] dW accumulators resident in
// VMEM across them ("arbitrary" axis). Blocks of a Hopper grid run in no
// order and 3 x 8 MB of accumulators fit no block, so one launcher call
// runs five kernels:
//   1. build_work_list: the live (expert, block) tiles of bm's first nb
//      columns at the front of a work list, on the device;
//   2. moe_bwd_mid_kernel, a block per (live tile, 128 rows, 64 columns of
//      F): h, g (A = x) and dmid (A = dy, B = W_down read transposed) as
//      three accumulators over one walk of D, then dh and dg into a
//      [E, nb bc, 2F] scratch and a h into a [E, nb bc, F] one;
//   3. moe_bwd_dx_kernel, a block per (work-list slot, 128 rows, 128
//      columns of D): dx = [dh | dg] [W_up | W_gate]^T as one GEMM of depth
//      2F (both weights read transposed, in place); dead tiles write their
//      zeros. It adds one to the executed-tile counter per live tile;
//   4. moe_bwd_dw_upgate_kernel, a block per (expert, 128 rows of D, 64
//      columns of F): dW_up and dW_gate as two accumulators sharing x^T;
//   5. moe_bwd_dw_down_kernel, a block per (expert, 128 rows of F, 128
//      columns of D): dW_down = (a h)^T dy.
// Kernels 4-5 give each output tile to one block, which walks its expert's
// live capacity blocks in ascending order (the K dimension of the sum):
// a fixed summation order and no float atomics, as in the port's other
// backward kernels. All three dW are always computed, as the TPU kernel
// does; skipping those of frozen weights is later work. Each GEMM is the
// register-blocked SIMT tile of d2ft_moe_common.cuh.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_moe.py) checks
// devices, dtypes, shapes and contiguity, allocates dx (zeroed past nb bc
// slots), the dW outputs, both scratches and the int32 work list (E nb + 1
// entries), and passes PyTorch's current stream. The entry returns
// cudaGetLastError().

#include "d2ft_moe_common.cuh"

namespace {

using namespace moe;

constexpr int kTN4 = 4, kTN8 = 8;
constexpr int kW4 = width<kTN4>(), kW8 = width<kTN8>();

__global__ void __launch_bounds__(kThreads) moe_bwd_mid_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ wu, const float* __restrict__ wg,
    const float* __restrict__ wd, const int32_t* __restrict__ work,
    float* __restrict__ dhg, float* __restrict__ ah, int C, int Cb, int nb,
    int bc, int D, int F, int act) {
  const Tile t = tile_of(work, gridDim.z, nb, bc);
  if (!t.live) return;
  __shared__ __align__(16) float Ax[kBK * kPA];
  __shared__ __align__(16) float Ady[kBK * kPA];
  __shared__ __align__(16) float Bu[kBK * pitch<kTN4>()];
  __shared__ __align__(16) float Bg[kBK * pitch<kTN4>()];
  __shared__ __align__(16) float Bd[kBK * pitch<kTN4>()];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kW4;
  const long row = (long)t.e * C + t.r0;
  const float* xe = x + row * D;
  const float* dye = dy + row * D;
  const float* wue = wu + (long)t.e * D * F;
  const float* wge = wg + (long)t.e * D * F;
  const float* wde = wd + (long)t.e * F * D;
  float h[kTM][kTN4], g[kTM][kTN4], dm[kTM][kTN4];
  zero(h);
  zero(g);
  zero(dm);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();
    load_ik<kBM>(Ax, xe, D, 0, t.nr, k0, D);
    load_ik<kBM>(Ady, dye, D, 0, t.nr, k0, D);
    load_ki<kW4>(Bu, wue, F, n0, F, k0, D);
    load_ki<kW4>(Bg, wge, F, n0, F, k0, D);
    load_ik<kW4>(Bd, wde, D, n0, F, k0, D);     // B[d][f] = W_down[f][d]
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM];
      a_frag(av, Ax, kk, ty);
      fma_frag(h, av, Bu, kk, tx);
      fma_frag(g, av, Bg, kk, tx);
      a_frag(av, Ady, kk, ty);
      fma_frag(dm, av, Bd, kk, tx);
    }
  }
  const long srow = (long)t.e * Cb + t.r0;
  float* dhe = dhg + srow * 2 * F;
  float* ahe = ah + srow * F;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row_of(ty, i);
    if (r >= t.nr) continue;
#pragma unroll
    for (int j = 0; j < kTN4; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c >= F) continue;
      const float a = act_f(g[i][j], act);
      dhe[(long)r * 2 * F + c] = dm[i][j] * a;
      dhe[(long)r * 2 * F + F + c] = dm[i][j] * h[i][j] * act_df(g[i][j], act);
      ahe[(long)r * F + c] = a * h[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) moe_bwd_dx_kernel(
    const float* __restrict__ dhg, const float* __restrict__ wu,
    const float* __restrict__ wg, const int32_t* __restrict__ work,
    float* __restrict__ dx, unsigned long long* __restrict__ tiles, int C,
    int Cb, int nb, int bc, int D, int F) {
  const Tile t = tile_of(work, gridDim.z, nb, bc);
  const int n0 = blockIdx.x * kW8;
  float* dxe = dx + ((long)t.e * C + t.r0) * D;
  if (!t.live) {
    for (int idx = threadIdx.x; idx < t.nr * kW8; idx += kThreads) {
      const int r = idx / kW8, c = n0 + idx % kW8;
      if (c < D) dxe[(long)r * D + c] = 0.f;
    }
    return;
  }
  __shared__ __align__(16) float As[kBK * kPA];
  __shared__ __align__(16) float Bs[kBK * pitch<kTN8>()];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* de = dhg + ((long)t.e * Cb + t.r0) * 2 * F;
  float acc[kTM][kTN8];
  zero(acc);
  // depth 2F: dh against W_up^T, then dg against W_gate^T
  for (int half = 0; half < 2; ++half) {
    const float* ae = de + half * F;
    const float* we = (half == 0 ? wu : wg) + (long)t.e * D * F;
    for (int k0 = 0; k0 < F; k0 += kBK) {
      __syncthreads();
      load_ik<kBM>(As, ae, 2 * F, 0, t.nr, k0, F);
      load_ik<kW8>(Bs, we, F, n0, D, k0, F);     // B[f][d] = W[d][f]
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTM];
        a_frag(av, As, kk, ty);
        fma_frag(acc, av, Bs, kk, tx);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row_of(ty, i);
    if (r >= t.nr) continue;
#pragma unroll
    for (int j = 0; j < kTN8; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c < D) dxe[(long)r * D + c] = acc[i][j];
    }
  }
  if (tiles != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    atomicAdd(tiles, 1ull);
}

__global__ void __launch_bounds__(kThreads) moe_bwd_dw_upgate_kernel(
    const float* __restrict__ x, const float* __restrict__ dhg,
    const float* __restrict__ bm, float* __restrict__ dwu,
    float* __restrict__ dwg, int C, int Cb, int n_cb, int nb, int bc, int D,
    int F) {
  __shared__ __align__(16) float As[kBK * kPA];
  __shared__ __align__(16) float Bu[kBK * pitch<kTN4>()];
  __shared__ __align__(16) float Bg[kBK * pitch<kTN4>()];
  const int e = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kW4;
  float gu[kTM][kTN4], gg[kTM][kTN4];
  zero(gu);
  zero(gg);
  for (int cb = 0; cb < nb; ++cb) {
    if (bm[(long)e * n_cb + cb] == 0.f) continue;      // uniform per block
    const float* xe = x + ((long)e * C + (long)cb * bc) * D;
    const float* de = dhg + ((long)e * Cb + (long)cb * bc) * 2 * F;
    for (int k0 = 0; k0 < bc; k0 += kBK) {
      __syncthreads();
      load_ki<kBM>(As, xe, D, m0, D, k0, bc);        // A[d][r] = x[r][d]
      load_ki<kW4>(Bu, de, 2 * F, n0, F, k0, bc);    // dh[r][f]
      load_ki<kW4>(Bg, de + F, 2 * F, n0, F, k0, bc);  // dg[r][f]
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTM];
        a_frag(av, As, kk, ty);
        fma_frag(gu, av, Bu, kk, tx);
        fma_frag(gg, av, Bg, kk, tx);
      }
    }
  }
  float* ue = dwu + (long)e * D * F;
  float* ge = dwg + (long)e * D * F;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + row_of(ty, i);
    if (m >= D) continue;
#pragma unroll
    for (int j = 0; j < kTN4; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c >= F) continue;
      ue[(long)m * F + c] = gu[i][j];
      ge[(long)m * F + c] = gg[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) moe_bwd_dw_down_kernel(
    const float* __restrict__ ah, const float* __restrict__ dy,
    const float* __restrict__ bm, float* __restrict__ dwd, int C, int Cb,
    int n_cb, int nb, int bc, int D, int F) {
  __shared__ __align__(16) float As[kBK * kPA];
  __shared__ __align__(16) float Bs[kBK * pitch<kTN8>()];
  const int e = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kW8;
  float acc[kTM][kTN8];
  zero(acc);
  for (int cb = 0; cb < nb; ++cb) {
    if (bm[(long)e * n_cb + cb] == 0.f) continue;      // uniform per block
    const float* ae = ah + ((long)e * Cb + (long)cb * bc) * F;
    const float* dye = dy + ((long)e * C + (long)cb * bc) * D;
    for (int k0 = 0; k0 < bc; k0 += kBK) {
      __syncthreads();
      load_ki<kBM>(As, ae, F, m0, F, k0, bc);        // A[f][r] = (a h)[r][f]
      load_ki<kW8>(Bs, dye, D, n0, D, k0, bc);       // dy[r][d]
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTM];
        a_frag(av, As, kk, ty);
        fma_frag(acc, av, Bs, kk, tx);
      }
    }
  }
  float* de = dwd + (long)e * F * D;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + row_of(ty, i);
    if (m >= F) continue;
#pragma unroll
    for (int j = 0; j < kTN8; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c < D) de[(long)m * D + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. tiles may be null (no
// executed-tile count). x, dy, dx: [E, C, D] with C = n_cb bc; bm [E, n_cb]
// (its first nb columns are read); dhg [E, nb bc, 2F], ah [E, nb bc, F];
// act 0 silu, 1 gelu, 2 relu.
int d2ft_moe_bwd_f32(const void* x, const void* wu, const void* wg,
                     const void* wd, const void* bm, const void* dy, void* dx,
                     void* dwu, void* dwg, void* dwd, void* dhg, void* ah,
                     void* work, void* tiles, int E, int C, int n_cb, int nb,
                     int bc, int D, int F, int act, void* stream) {
  if (E <= 0 || bc <= 0 || n_cb <= 0 || C != n_cb * bc || nb <= 0 ||
      nb > n_cb || D <= 0 || F <= 0 || act < 0 || act > 2)
    return cudaErrorInvalidValue;
  const int n_tiles = E * nb, Cb = nb * bc;
  if (n_tiles > 65535 || E > 65535 || ceil_div(bc, kBM) > 65535 ||
      ceil_div(D, kBM) > 65535 || ceil_div(F, kBM) > 65535)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  int32_t* wl = static_cast<int32_t*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build_work_list<<<1, kListThreads, 0, st>>>(f(bm), E, n_cb, nb, wl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_bwd_mid_kernel<<<dim3(ceil_div(F, kW4), ceil_div(bc, kBM), n_tiles),
                       kThreads, 0, st>>>(f(x), f(dy), f(wu), f(wg), f(wd),
                                          wl, o(dhg), o(ah), C, Cb, nb, bc,
                                          D, F, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_bwd_dx_kernel<<<dim3(ceil_div(D, kW8), ceil_div(bc, kBM), n_tiles),
                      kThreads, 0, st>>>(
      f(dhg), f(wu), f(wg), wl, o(dx),
      static_cast<unsigned long long*>(tiles), C, Cb, nb, bc, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_bwd_dw_upgate_kernel<<<dim3(ceil_div(F, kW4), ceil_div(D, kBM), E),
                             kThreads, 0, st>>>(
      f(x), f(dhg), f(bm), o(dwu), o(dwg), C, Cb, n_cb, nb, bc, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_bwd_dw_down_kernel<<<dim3(ceil_div(D, kW8), ceil_div(F, kBM), E),
                           kThreads, 0, st>>>(
      f(ah), f(dy), f(bm), o(dwd), C, Cb, n_cb, nb, bc, D, F);
  return cudaGetLastError();
}

const char* d2ft_moe_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
