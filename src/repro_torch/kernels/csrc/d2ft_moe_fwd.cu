// D2FT-gated MoE expert FFN, forward, for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_moe.py::_fwd_kernel
// (launcher _forward). Over the [E, C, D] capacity buffer x, for every
// (expert e, capacity block of bc slots) tile whose block mask fm[e, cb]
// is set:
//   y = (act(x W_gate[e]) * (x W_up[e])) W_down[e],
// and exact zeros for every other tile.
//
// What bounds it on this card: operations. A live tile needs 3 matmuls of
// 2 bc D F FLOPs (at olmoe-1b-7b: 128 x 2048 x 1024, 1.6 GFLOP a tile)
// against reading x and writing y (2 MB) and each expert's 25 MB of
// weights once: hundreds of FLOPs per byte, far above the ~20 at which
// float32 FMA (67 TFLOP/s without tensor cores; TF32 is off) and not HBM
// (3.35 TB/s) is the limit.
//
// Design. The TPU kernel holds a whole tile's [bc, F] intermediate and all
// three [D, F] weights of its expert in VMEM (megabytes) and runs three
// MXU products per grid step. A Hopper block has at most 227 KB of shared
// memory: a tile's [128, 1024] float32 intermediate alone is 512 KB. So
// one launcher call runs three kernels:
//   1. build_work_list (one block): the live (expert, block) tiles from fm,
//      stably partitioned to the front of a work list with their count,
//      on the device, so nothing waits on the host;
//   2. moe_mid_kernel, a block per (live tile, 128 rows, 64 columns of F):
//      h = x W_up and g = x W_gate as two accumulators over one walk of x
//      (D in slabs of 16), then mid = act(g) * h into a [E, C, F] scratch;
//   3. moe_down_kernel, a block per (work-list slot, 128 rows, 128 columns
//      of D): y = mid W_down[e] for live tiles; the dead tiles at the end
//      of the list write their zeros (no separate fill). It adds one to the
//      executed-tile counter per live tile when the caller passes the cell.
// Blocks whose work-list slot is past the live count return at once, so
// the grid is the TPU's (E, C / bc) and a dead tile costs a block launch.
// Each GEMM is a register-blocked SIMT tile (d2ft_moe_common.cuh): no
// wgmma, TMA or cp.async pipelining yet; speed is later work.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_moe.py) checks
// devices, dtypes, shapes and contiguity, allocates y, the mid scratch and
// the int32 work list (E * C / bc + 1 entries), and passes PyTorch's
// current stream. The entry returns cudaGetLastError().

#include "d2ft_moe_common.cuh"

namespace {

using namespace moe;

constexpr int kTNm = 4;                       // mid kernel: 64 columns
constexpr int kTNd = 8;                       // down kernel: 128 columns
constexpr int kWm = width<kTNm>(), kWd = width<kTNd>();

__global__ void __launch_bounds__(kThreads) moe_mid_kernel(
    const float* __restrict__ x, const float* __restrict__ wu,
    const float* __restrict__ wg, const int32_t* __restrict__ work,
    float* __restrict__ mid, int C, int n_cb, int bc, int D, int F,
    int act) {
  const Tile t = tile_of(work, gridDim.z, n_cb, bc);
  if (!t.live) return;
  __shared__ __align__(16) float As[kBK * kPA];
  __shared__ __align__(16) float Bu[kBK * pitch<kTNm>()];
  __shared__ __align__(16) float Bg[kBK * pitch<kTNm>()];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kWm;
  const float* xe = x + ((long)t.e * C + t.r0) * D;
  const float* wue = wu + (long)t.e * D * F;
  const float* wge = wg + (long)t.e * D * F;
  float h[kTM][kTNm], g[kTM][kTNm];
  zero(h);
  zero(g);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    __syncthreads();
    load_ik<kBM>(As, xe, D, 0, t.nr, k0, D);
    load_ki<kWm>(Bu, wue, F, n0, F, k0, D);
    load_ki<kWm>(Bg, wge, F, n0, F, k0, D);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM];
      a_frag(av, As, kk, ty);
      fma_frag(h, av, Bu, kk, tx);
      fma_frag(g, av, Bg, kk, tx);
    }
  }
  float* me = mid + ((long)t.e * C + t.r0) * F;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row_of(ty, i);
    if (r >= t.nr) continue;
#pragma unroll
    for (int j = 0; j < kTNm; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c < F) me[(long)r * F + c] = act_f(g[i][j], act) * h[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) moe_down_kernel(
    const float* __restrict__ mid, const float* __restrict__ wd,
    const int32_t* __restrict__ work, float* __restrict__ y,
    unsigned long long* __restrict__ tiles, int C, int n_cb, int bc, int D,
    int F) {
  const Tile t = tile_of(work, gridDim.z, n_cb, bc);
  const int n0 = blockIdx.x * kWd;
  float* ye = y + ((long)t.e * C + t.r0) * D;
  if (!t.live) {
    for (int idx = threadIdx.x; idx < t.nr * kWd;
         idx += kThreads) {
      const int r = idx / kWd, c = n0 + idx % kWd;
      if (c < D) ye[(long)r * D + c] = 0.f;
    }
    return;
  }
  __shared__ __align__(16) float As[kBK * kPA];
  __shared__ __align__(16) float Bs[kBK * pitch<kTNd>()];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* me = mid + ((long)t.e * C + t.r0) * F;
  const float* wde = wd + (long)t.e * F * D;
  float acc[kTM][kTNd];
  zero(acc);
  for (int k0 = 0; k0 < F; k0 += kBK) {
    __syncthreads();
    load_ik<kBM>(As, me, F, 0, t.nr, k0, F);
    load_ki<kWd>(Bs, wde, D, n0, D, k0, F);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM];
      a_frag(av, As, kk, ty);
      fma_frag(acc, av, Bs, kk, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row_of(ty, i);
    if (r >= t.nr) continue;
#pragma unroll
    for (int j = 0; j < kTNd; ++j) {
      const int c = n0 + col_of(tx, j);
      if (c < D) ye[(long)r * D + c] = acc[i][j];
    }
  }
  if (tiles != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    atomicAdd(tiles, 1ull);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. tiles may be null (no
// executed-tile count). C must be a multiple of bc; act 0 silu, 1 gelu,
// 2 relu.
int d2ft_moe_fwd_f32(const void* x, const void* wu, const void* wg,
                     const void* wd, const void* fm, void* y, void* mid,
                     void* work, void* tiles, int E, int C, int bc, int D,
                     int F, int act, void* stream) {
  if (E <= 0 || C <= 0 || bc <= 0 || C % bc || D <= 0 || F <= 0 ||
      act < 0 || act > 2)
    return cudaErrorInvalidValue;
  const int n_cb = C / bc, n_tiles = E * n_cb;
  if (n_tiles > 65535 || ceil_div(bc, kBM) > 65535)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  int32_t* wl = static_cast<int32_t*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  build_work_list<<<1, kListThreads, 0, st>>>(f(fm), E, n_cb, n_cb, wl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_mid_kernel<<<dim3(ceil_div(F, kWm), ceil_div(bc, kBM),
                        n_tiles),
                   kThreads, 0, st>>>(f(x), f(wu), f(wg), wl,
                                      static_cast<float*>(mid), C, n_cb, bc,
                                      D, F, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<<<dim3(ceil_div(D, kWd), ceil_div(bc, kBM),
                         n_tiles),
                    kThreads, 0, st>>>(
      static_cast<const float*>(mid), f(wd), wl, static_cast<float*>(y),
      static_cast<unsigned long long*>(tiles), C, n_cb, bc, D, F);
  return cudaGetLastError();
}

const char* d2ft_moe_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
