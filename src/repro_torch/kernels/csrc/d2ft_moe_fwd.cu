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
// weights once: hundreds of FLOPs per byte, far above where HBM (3.35
// TB/s) would be the limit. The products run on the tensor cores as
// 3xTF32 (tf32x3.cuh: float32 accuracy, three TF32 products a step, up to
// 165 TFLOP/s of such work against 67 TFLOP/s of float32 FMA), and the
// kernels are held to that bound.
//
// Design. The TPU kernel holds a whole tile's [bc, F] intermediate and all
// three [D, F] weights of its expert in VMEM (megabytes) and runs three
// MXU products per grid step. A Hopper block has at most 227 KB of shared
// memory: a tile's [128, 1024] float32 intermediate alone is 512 KB. So
// one launcher call runs three kernels:
//   1. build_work_list (one block): the live (expert, block) tiles from fm,
//      stably partitioned to the front of a work list with their count,
//      on the device, so nothing waits on the host;
//   2. moe_mid_kernel, a block per (64 columns of F, 128 rows, live tile):
//      h = x W_up and g = x W_gate as two accumulators over one walk of x
//      (each x fragment feeds both products), D in slabs of 32 through a
//      ring of 3 cp.async stages (x [128][32] and both weight slabs
//      [32][64]: 96 KB), then mid = act(g) * h into a [E, C, F] scratch;
//   3. moe_down_kernel, a block per (128 columns of D, 128 rows, work-list
//      slot): y = mid W_down[e] for live tiles, F in slabs of 32 through 3
//      stages (mid [128][32], W_down [32][128]: 96 KB); the dead tiles at
//      the end of the list write their zeros (no separate fill). It adds
//      one to the executed-tile counter per live tile when the caller
//      passes the cell.
// Blocks whose work-list slot is past the live count return at once, so
// the grid is the TPU's (E, C / bc) and a dead tile costs a block launch.
// Every product is a warp's 64-row share of the tile on mma.sync m16n8k8
// in 3xTF32 (d2ft_moe_common.cuh): 8 warps as 2 x 4, 64 accumulator
// floats a thread in both kernels (h and g at 64 x 16 a warp; y at 64 x
// 32), at most 128 registers, so that two blocks (16 warps) share an SM.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_moe.py) checks
// devices, dtypes, shapes and contiguity, allocates y, the mid scratch and
// the int32 work list (E * C / bc + 1 entries), and passes PyTorch's
// current stream. The entry returns the first launch error.

#include "d2ft_moe_common.cuh"

namespace {

using namespace moe;

// the mid kernel: 128 rows x 64 columns of F, h and g
struct Mid {
  static constexpr int kBN = 64, kNt = kBN / 32;
  static constexpr int kA = kBM * kBK;          // x slab [128][32]
  static constexpr int kB = kBK * kBN;          // a weight slab [32][64]
  static constexpr int kStage = kA + 2 * kB;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// the down kernel: 128 rows x 128 columns of D
struct Down {
  static constexpr int kBN = 128, kNt = kBN / 32;
  static constexpr int kA = kBM * kBK;          // mid slab [128][32]
  static constexpr int kB = kBK * kBN;          // W_down slab [32][128]
  static constexpr int kStage = kA + kB;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// vec bits: 1 x, 2 W_up and W_gate, 4 mid, 8 W_down
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) moe_mid_kernel(
    const float* __restrict__ x, const float* __restrict__ wu,
    const float* __restrict__ wg, const int32_t* __restrict__ work,
    float* __restrict__ mid, int C, int n_cb, int bc, int D, int F,
    int act, int vec) {
  const Tile t = tile_of(work, gridDim.z, n_cb, bc);
  if (!t.live) return;
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * Mid::kBN;
  const int wm = warp_m0(), wn = warp_n0<Mid::kBN>();
  const float* xe = x + ((size_t)t.e * C + t.r0) * D;
  const float* wue = wu + (size_t)t.e * D * F + n0;
  const float* wge = wg + (size_t)t.e * D * F + n0;
  float h[kMt][Mid::kNt][4], g[kMt][Mid::kNt][4];
  zero(h);
  zero(g);
  ring<kStages, Mid::kStage>(
      smem, ceil_div(D, kBK),
      [&](int s, float* st) {
        const int k0 = s * kBK;
        tf32x3::stage<kBM, kBK, kBK, kThreads>(st, xe + k0, D, t.nr, D - k0,
                                               vec & 1);
        tf32x3::stage<kBK, Mid::kBN, Mid::kBN, kThreads>(
            st + Mid::kA, wue + (size_t)k0 * F, F, D - k0, F - n0, vec & 2);
        tf32x3::stage<kBK, Mid::kBN, Mid::kBN, kThreads>(
            st + Mid::kA + Mid::kB, wge + (size_t)k0 * F, F, D - k0, F - n0,
            vec & 2);
      },
      [&](const float* st) {
#pragma unroll 1
        for (int k8 = 0; k8 < kBK; k8 += 8) {
          FragB bu[Mid::kNt], bg[Mid::kNt];
          load_bs<false>(bu, st + Mid::kA, Mid::kBN, wn, k8);
          load_bs<false>(bg, st + Mid::kA + Mid::kB, Mid::kBN, wn, k8);
#pragma unroll
          for (int i = 0; i < kMt; ++i) {
            FragA fa;
            load_a1<false>(fa, st, kBK, wm + 16 * i, k8);
            mma_m(h[i], fa, bu);
            mma_m(g[i], fa, bg);
          }
        }
      });
  float* me = mid + ((size_t)t.e * C + t.r0) * F + n0;
  for_each_pair<Mid::kNt>(wm, wn, [&](int r, int c, int i, int j, int hh) {
    if (r >= t.nr) return;
    store_pair(me + (size_t)r * F, c, F - n0,
               act_f(g[i][j][2 * hh], act) * h[i][j][2 * hh],
               act_f(g[i][j][2 * hh + 1], act) * h[i][j][2 * hh + 1]);
  });
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) moe_down_kernel(
    const float* __restrict__ mid, const float* __restrict__ wd,
    const int32_t* __restrict__ work, float* __restrict__ y,
    unsigned long long* __restrict__ tiles, int C, int n_cb, int bc, int D,
    int F, int vec) {
  const Tile t = tile_of(work, gridDim.z, n_cb, bc);
  const int n0 = blockIdx.x * Down::kBN;
  float* ye = y + ((size_t)t.e * C + t.r0) * D + n0;
  if (!t.live) {
    for (int idx = threadIdx.x; idx < t.nr * Down::kBN; idx += kThreads) {
      const int r = idx / Down::kBN, c = idx % Down::kBN;
      if (c < D - n0) ye[(size_t)r * D + c] = 0.f;
    }
    return;
  }
  extern __shared__ __align__(16) float smem[];
  const int wm = warp_m0(), wn = warp_n0<Down::kBN>();
  const float* me = mid + ((size_t)t.e * C + t.r0) * F;
  const float* wde = wd + (size_t)t.e * F * D + n0;
  float acc[kMt][Down::kNt][4];
  zero(acc);
  ring<kStages, Down::kStage>(
      smem, ceil_div(F, kBK),
      [&](int s, float* st) {
        const int k0 = s * kBK;
        tf32x3::stage<kBM, kBK, kBK, kThreads>(st, me + k0, F, t.nr, F - k0,
                                               vec & 4);
        tf32x3::stage<kBK, Down::kBN, Down::kBN, kThreads>(
            st + Down::kA, wde + (size_t)k0 * D, D, F - k0, D - n0, vec & 8);
      },
      [&](const float* st) {
#pragma unroll 1
        for (int k8 = 0; k8 < kBK; k8 += 8) {
          FragB fb[Down::kNt];
          load_bs<false>(fb, st + Down::kA, Down::kBN, wn, k8);
#pragma unroll
          for (int i = 0; i < kMt; ++i) {
            FragA fa;
            load_a1<false>(fa, st, kBK, wm + 16 * i, k8);
            mma_m(acc[i], fa, fb);
          }
        }
      });
  for_each_pair<Down::kNt>(wm, wn, [&](int r, int c, int i, int j, int hh) {
    if (r >= t.nr) return;
    store_pair(ye + (size_t)r * D, c, D - n0, acc[i][j][2 * hh],
               acc[i][j][2 * hh + 1]);
  });
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
  const int vec = vec_ok(x, D) | (vec_ok(wu, F) && vec_ok(wg, F)) << 1 |
                  vec_ok(mid, F) << 2 | vec_ok(wd, D) << 3;
  cudaError_t err = allow_smem(moe_mid_kernel, Mid::kSmem);
  if (err == cudaSuccess) err = allow_smem(moe_down_kernel, Down::kSmem);
  if (err != cudaSuccess) return err;
  build_work_list<<<1, kListThreads, 0, st>>>(f(fm), E, n_cb, n_cb, wl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_mid_kernel<<<dim3(ceil_div(F, Mid::kBN), ceil_div(bc, kBM), n_tiles),
                   kThreads, Mid::kSmem, st>>>(
      f(x), f(wu), f(wg), wl, static_cast<float*>(mid), C, n_cb, bc, D, F,
      act, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<<<dim3(ceil_div(D, Down::kBN), ceil_div(bc, kBM),
                         n_tiles),
                    kThreads, Down::kSmem, st>>>(
      static_cast<const float*>(mid), f(wd), wl, static_cast<float*>(y),
      static_cast<unsigned long long*>(tiles), C, n_cb, bc, D, F, vec);
  return cudaGetLastError();
}

const char* d2ft_moe_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
