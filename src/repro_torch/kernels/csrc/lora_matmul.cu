// Fused LoRA matmul for Hopper (sm_90a), float32: y = x W + scale (x A) B.
//
// Replaces the Pallas TPU kernel repro/kernels/lora_matmul.py::_kernel
// (launcher lora_matmul). x: [M, K], W: [K, N], A: [K, r], B: [r, N], all
// row-major; y: [M, N]. Forward only, as the TPU kernel is. The point of
// the fusion (paper §II-D, D2FT-LoRA): the [M, r] intermediate u = x A
// never goes to device memory.
//
// What bounds it on this card: operations. At the D2FT-LoRA run's wq
// (M 4096, K 1152, N 1024, r 8) the function needs 2MKN + 2MKr + 2MrN =
// 9.8 GFLOP against 4(MK + KN + Kr + rN + MN) = 40 MB, ~245 FLOP per byte.
// Held to float32 FMA (67 TFLOP/s) that is 0.146 ms; the products here run
// on the tensor cores as 3xTF32 (tf32x3.cuh: float32 accuracy, three TF32
// products a step, 165 TFLOP/s of such work), whose bound is 0.059 ms.
//
// Design:
//  * The Pallas kernel loads a full-K stripe of x [bm, K] and W [K, bn]
//    into VMEM (megabytes). A Hopper block has at most 227 KB of shared
//    memory, so one block per BM x 128 output tile walks K in slabs of 64
//    through a cp.async ring of 3 stages (2 where 3 do not fit): slab k + 2
//    is in flight while slab k is multiplied, and the ragged edge of M, N
//    and K is zero-filled by the copies themselves (sources that are not
//    16-byte aligned, or whose rows are not a multiple of 4 floats, are
//    copied a float at a time).
//  * 8 warps as 2 (M) x 4 (N), each owning a (BM / 2) x 32 output tile on
//    mma.sync m16n8k8 in 3xTF32, a slab's products summed on the tensor
//    core and then added in IEEE float32 (tf32x3::mma3 says why). Each x
//    fragment it loads from a slab feeds both the base product (with the
//    W slab) and u += x_slab A_slab (with the A slab [64, r_max]), so x is
//    read once for both; the u tile [BM, r_max] is shared among the 4
//    warps of a row band (by rows, or by columns where r_max is 256) and
//    its n-tiles past r are skipped. Then scale * u goes to shared memory,
//    B is walked in [64, 128] slabs through the same ring, and scale * u
//    B[:, tile] is added into the base accumulator: one set of
//    accumulators, one store.
//  * r_max is a compile-time width: 16 and 64 at BM 128, 256 (the paper's
//    rank-matched R up to 240 fit) at BM 64, where u takes 64 registers a
//    thread. Shared memory: 3, 2 and 2 stages of x, W and A slabs,
//    221,184 / 163,840 / 229,376 bytes; u and the B slab reuse it after
//    the K walk. 253-255 registers a thread (-Xptxas -v), no spills.
//  * Grid steps run in parallel in no order; nothing carries between
//    blocks. Blocks along N are adjacent, so the x rows they share are in
//    L2. Every block of a row computes the same u: 2MKr extra FLOPs per
//    N tile (r / N of the base product at r 8 and N 1024), which the TPU
//    kernel pays too.
//  * The TPU wrapper asserts M % block_m == 0: a tiling rule, not part of
//    the function. Here ragged M, N and K are masked in the kernel.
//
// Launch contract: the caller (repro_torch/kernels/lora_matmul.py) checks
// device, dtypes, shapes and contiguity, allocates y and passes PyTorch's
// current stream. The kernel allocates nothing. The entry returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kBN = 128;                  // output tile columns
constexpr int kBK = 64;                   // K slab
constexpr int kThreads = 256;             // 8 warps: 2 (M) x 4 (N)

template <int BM, int RMAX>
struct Geo {
  static constexpr int kRp = RMAX < 32 ? 32 : RMAX;   // A slab / u pitch
  static constexpr int kX = BM * kBK;                 // x slab floats
  static constexpr int kW = kBK * kBN;                // W (or B) slab
  static constexpr int kA = kBK * kRp;                // A slab
  static constexpr int kStage = kX + kW + kA;
  // three stages where they fit a block's shared memory, else two
  static constexpr int kStages =
      3 * sizeof(float) * kStage <= 232448 ? 3 : 2;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static constexpr int kMt = BM / 2 / 16;             // m-tiles per warp
  // the u tile [BM, RMAX] split among the 4 warps of a row band
  static constexpr int kUrow = RMAX >= 256 ? 1 : kMt;  // row parts
  static constexpr int kUcol = 4 / kUrow;               // column parts
  static constexpr int kUmt = kMt / kUrow;              // u m-tiles a warp
  static constexpr int kUnt = RMAX / 8 / kUcol;         // u n-tiles a warp
  static_assert(kUrow * kUcol == 4 && kUmt * kUrow == kMt, "u split");
  static_assert(kSmem <= 232448, "shared memory over a block's limit");
  static_assert(BM * kRp + kW <= kStages * kStage, "epilogue reuse");
};

template <int BM, int RMAX>
__global__ void __launch_bounds__(kThreads)
lora_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ y, int M, int K, int N, int r,
                   float scale, int vec_mask) {
  using G = Geo<BM, RMAX>;
  constexpr int kMt = G::kMt, kRp = G::kRp;
  extern __shared__ float smem[];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int row_w = wm * (BM / 2);                     // warp's rows
  const int col_w = wn * 32;                           // warp's columns
  // the warp's part of u: m-tiles [um0, um0 + kUmt) of its kMt, columns
  // [uc0, uc0 + 8 kUnt)
  const int um0 = (wn % G::kUrow) * G::kUmt;
  const int uc0 = (wn / G::kUrow) * G::kUnt * 8;
  const bool vx = vec_mask & 1, vw = vec_mask & 2, va = vec_mask & 4,
             vb = vec_mask & 8;

  float acc[kMt][4][4], u[G::kUmt][G::kUnt][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < G::kUmt; ++i)
#pragma unroll
    for (int j = 0; j < G::kUnt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[i][j][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  auto load_slab = [&](int kt) {
    float* st = smem + (kt % G::kStages) * G::kStage;
    const int k0 = kt * kBK;
    tf32x3::stage<BM, kBK, kBK, kThreads>(st, x + (size_t)m0 * K + k0, K,
                                          M - m0, K - k0, vx);
    tf32x3::stage<kBK, kBN, kBN, kThreads>(
        st + G::kX, w + (size_t)k0 * N + n0, N, K - k0, N - n0, vw);
    tf32x3::stage<kBK, RMAX, kRp, kThreads>(
        st + G::kX + G::kW, a + (size_t)k0 * r, r, K - k0, r, va);
  };
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < nk) load_slab(s);
    tf32x3::commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    tf32x3::wait<G::kStages - 2>();
    __syncthreads();              // slab kt landed; slab kt - 1 all read
    if (kt + G::kStages - 1 < nk) load_slab(kt + G::kStages - 1);
    tf32x3::commit();
    const float* xs = smem + (kt % G::kStages) * G::kStage;
    const float* ws = xs + G::kX;
    const float* as = ws + G::kW;
    // the slab's 32 products a term on the tensor core, then into acc in
    // IEEE float32 (tf32x3::mma3 says why)
    float part[kMt][4][4];
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll 1
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      FragA fa[kMt];
#pragma unroll
      for (int i = 0; i < kMt; ++i)
        tf32x3::load_a(fa[i], xs, kBK, row_w + 16 * i, k8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        tf32x3::load_b_kn(fb, ws, kBN, k8, col_w + 8 * j);
#pragma unroll
        for (int i = 0; i < kMt; ++i)
          tf32x3::mma3_into(part[i][j], fa[i], fb);
      }
#pragma unroll
      for (int j = 0; j < G::kUnt; ++j) {
        if (uc0 + 8 * j >= r) break;       // padding columns of u
        FragB fb;
        tf32x3::load_b_kn(fb, as, kRp, k8, uc0 + 8 * j);
        // fa[um0 + ui], with indices the compiler sees (fa stays in
        // registers); the branch is uniform across the warp
#pragma unroll
        for (int ui = 0; ui < G::kUmt; ++ui)
#pragma unroll
          for (int i = 0; i < kMt; ++i)
            if (i == um0 + ui) tf32x3::mma3(u[ui][j], fa[i], fb);
      }
    }
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  tf32x3::wait<0>();
  __syncthreads();                // every slab read: the ring is free

  // scale * u to shared memory [BM][kRp] (columns past r are zeros)
  float* us = smem;
  float* bs = smem + BM * kRp;
#pragma unroll
  for (int i = 0; i < G::kUmt; ++i)
#pragma unroll
    for (int j = 0; j < G::kUnt; ++j) {
      const int row = row_w + 16 * (um0 + i) + g;
      const int col = uc0 + 8 * j + 2 * t;
      us[tf32x3::at(kRp, row, col)] = scale * u[i][j][0];
      us[tf32x3::at(kRp, row, col + 1)] = scale * u[i][j][1];
      us[tf32x3::at(kRp, row + 8, col)] = scale * u[i][j][2];
      us[tf32x3::at(kRp, row + 8, col + 1)] = scale * u[i][j][3];
    }
  // acc += (scale u) B[:, tile], B walked in [64, 128] slabs
  for (int t0 = 0; t0 < r; t0 += kBK) {
    __syncthreads();              // u written; the last B slab read
    tf32x3::stage<kBK, kBN, kBN, kThreads>(bs, b + (size_t)t0 * N + n0, N,
                                           r - t0, N - n0, vb);
    tf32x3::commit();
    tf32x3::wait<0>();
    __syncthreads();
    const int tn = min(kBK, r - t0);
    for (int k8 = 0; k8 < tn; k8 += 8) {
      FragA fa[kMt];
#pragma unroll
      for (int i = 0; i < kMt; ++i)
        tf32x3::load_a(fa[i], us, kRp, row_w + 16 * i, t0 + k8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        tf32x3::load_b_kn(fb, bs, kBN, k8, col_w + 8 * j);
#pragma unroll
        for (int i = 0; i < kMt; ++i) tf32x3::mma3(acc[i][j], fa[i], fb);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + col_w + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + row_w + 16 * i + g + 8 * h;
        if (row >= M) continue;
        float* yr = y + (size_t)row * N;
        if (col < N) yr[col] = acc[i][j][2 * h];
        if (col + 1 < N) yr[col + 1] = acc[i][j][2 * h + 1];
      }
    }
}

template <int BM, int RMAX>
cudaError_t launch(const void* x, const void* w, const void* a,
                   const void* b, void* y, int M, int K, int N, int r,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Geo<BM, RMAX>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_kernel<BM, RMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies where a source is 16-byte aligned and its rows are a
  // multiple of 4 floats
  auto vec = [](const void* p, int ld) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0;
  };
  const int vec_mask = vec(x, K) | vec(w, N) << 1 | vec(a, r) << 2 |
                       vec(b, N) << 3;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  lora_matmul_kernel<BM, RMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(y), M, K, N, r, scale, vec_mask);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. 1 <= r <= 256.
int lora_matmul_f32(const void* x, const void* w, const void* a,
                    const void* b, void* y, int M, int K, int N, int r,
                    float scale, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || r <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 16) return launch<128, 16>(x, w, a, b, y, M, K, N, r, scale, s);
  if (r <= 64) return launch<128, 64>(x, w, a, b, y, M, K, N, r, scale, s);
  if (r <= 256) return launch<64, 256>(x, w, a, b, y, M, K, N, r, scale, s);
  return cudaErrorInvalidValue;
}

const char* lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
