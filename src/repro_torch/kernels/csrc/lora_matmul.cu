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
// 9.8 GFLOP against 4(MK + KN + Kr + rN + MN) = 40 MB, ~245 FLOP per byte,
// far above the ~20 at which float32 FMA (67 TFLOP/s, no tensor cores with
// TF32 off) and not HBM (3.35 TB/s) is the limit.
//
// What the design does about the TPU design that does not carry over:
//  * The Pallas kernel loads a full-K stripe of x [bm, K] and W [K, bn]
//    into VMEM (megabytes) and runs three MXU products on it. A Hopper
//    block has at most 227 KB of shared memory, so one block per 64 x 64
//    output tile walks K in slabs of 32: each x slab [64, 32] feeds both
//    the base product (with the W slab [32, 64]) and u += x_slab A_slab
//    (with the A slab [32, r]), so x is read once for both. u [64, r]
//    stays in registers during the K walk, then in shared memory for the
//    epilogue y = acc + scale * u B[:, tile], with B walked in the same
//    [32, 64] slabs as W.
//  * Grid steps run in parallel in no order; nothing carries between
//    blocks. Blocks along N are adjacent, so the x rows they share are in
//    L2. Every block of a row computes the same u: 2MKr extra FLOPs per
//    N tile (r / N of the base product at r 8 and N 1024), which the TPU
//    kernel pays too.
//  * The TPU wrapper asserts M % block_m == 0: a tiling rule, not part of
//    the function. Here ragged M, N and K are masked in the kernel (zero
//    fill in shared memory, masked stores).
//  * 256 threads as 16 x 16, each owning 4 rows x 4 strided columns of the
//    tile (and 4 rows x r_max/16 columns of u), float32 FMA from shared
//    memory. r is taken up to 256 (the paper's rank-matched R 1/60/200/240)
//    in three compile-time widths r_max = 16, 64, 256. No wgmma, TMA or
//    cp.async pipelining yet: speed is later work.
//
// Launch contract: the caller (repro_torch/kernels/lora_matmul.py) checks
// device, dtypes, shapes and contiguity, allocates y and passes PyTorch's
// current stream. The kernel allocates nothing. The entry returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                   // output tile rows
constexpr int kBN = 64;                   // output tile columns
constexpr int kBK = 32;                   // K slab
constexpr int kThreads = 256;             // 16 x 16
constexpr int kXd = kBK + 1;              // x slab row pitch (bank spread)

template <int RMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBM * kXd + kBK * kBN + kBK * RMAX + kBM * (RMAX + 1));
}

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
lora_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ y, int M, int K, int N, int r,
                   float scale) {
  constexpr int kUc = RMAX / 16;          // u columns per thread
  constexpr int kUd = RMAX + 1;
  extern __shared__ float smem[];
  float* x_s = smem;                      // [kBM][kXd]
  float* w_s = x_s + kBM * kXd;           // [kBK][kBN], W then B slabs
  float* a_s = w_s + kBK * kBN;           // [kBK][RMAX]
  float* u_s = a_s + kBK * RMAX;          // [kBM][kUd]

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4], u[4][kUc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < kUc; ++c) u[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();                      // last slab's reads are done
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int row = i / kBK, kk = i % kBK;
      const int m = m0 + row, kq = k0 + kk;
      x_s[row * kXd + kk] = (m < M && kq < K) ? x[(size_t)m * K + kq] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, col = i % kBN;
      const int kq = k0 + kk, n = n0 + col;
      w_s[i] = (kq < K && n < N) ? w[(size_t)kq * N + n] : 0.f;
    }
    for (int i = tid; i < kBK * RMAX; i += kThreads) {
      const int kk = i / RMAX, t = i % RMAX;
      const int kq = k0 + kk;
      a_s[i] = (kq < K && t < r) ? a[(size_t)kq * r + t] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float xa[4], wb[4], ab[kUc];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = x_s[(ty * 4 + i) * kXd + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wb[j] = w_s[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int c = 0; c < kUc; ++c) ab[c] = a_s[kk * RMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
#pragma unroll
        for (int c = 0; c < kUc; ++c) u[i][c] = fmaf(xa[i], ab[c], u[i][c]);
      }
    }
  }

  // u to shared memory (columns past r are zeros: A's slabs were), then
  // delta = u B[:, tile] over r in slabs of kBK rows of B
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kUc; ++c)
      u_s[(ty * 4 + i) * kUd + tx + 16 * c] = u[i][c];
  float d[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
  for (int t0 = 0; t0 < r; t0 += kBK) {
    __syncthreads();                      // u_s written; last B slab read
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int tt = i / kBN, col = i % kBN;
      const int t = t0 + tt, n = n0 + col;
      w_s[i] = (t < r && n < N) ? b[(size_t)t * N + n] : 0.f;
    }
    __syncthreads();
    const int tn = min(kBK, r - t0);
    for (int tt = 0; tt < tn; ++tt) {
      float ua[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ua[i] = u_s[(ty * 4 + i) * kUd + t0 + tt];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = w_s[tt * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[i][j] = fmaf(ua[i], bb[j], d[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(size_t)m * N + n] = acc[i][j] + scale * d[i][j];
    }
  }
}

template <int RMAX>
cudaError_t launch(const void* x, const void* w, const void* a,
                   const void* b, void* y, int M, int K, int N, int r,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<RMAX>();
  static_assert(smem <= 232448,
                "the tile's shared memory exceeds what one block may take");
  cudaError_t err = cudaFuncSetAttribute(
      lora_matmul_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  lora_matmul_kernel<RMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(y), M, K, N, r, scale);
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
  if (r <= 16) return launch<16>(x, w, a, b, y, M, K, N, r, scale, s);
  if (r <= 64) return launch<64>(x, w, a, b, y, M, K, N, r, scale, s);
  if (r <= 256) return launch<256>(x, w, a, b, y, M, K, N, r, scale, s);
  return cudaErrorInvalidValue;
}

const char* lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
