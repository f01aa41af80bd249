// D2FT-gated flash-attention forward for Hopper (sm_90a), float32, on the
// tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_attention.py::
// _fwd_kernel (launcher _forward). q, k, v: [N = B*H, S, hd] (kv heads
// expanded), gate g_f: [N]. Per (sample, head) slice: o = g_f * softmax(
// (q k^T) * scale, masked) v and lse = m + log(l), in float32 accuracy; a
// slice with g_f == 0 runs nothing and writes o = 0, lse = LSE_MASKED
// (+2^30), as do rows that saw no live key. Masks: causal, sliding window,
// and the ragged edge kpos < S, each with NEG_INF = -2^30 in the scores.
//
// What bounds it on this card: operations. A live (q tile, k tile) pair is
// 2 x 2*64*Bc*hd FLOPs against 2*Bc*hd*4 bytes of k and v; the bytes the
// function must move are far fewer than its FLOPs over either compute
// rate. The products run on the tensor cores as 3xTF32 (tf32x3.cuh:
// float32 accuracy, three TF32 products a step, 165 TFLOP/s of such work
// against 67 TFLOP/s of float32 FMA), and the kernel is held to that bound.
//
// What the design does about the TPU design that does not carry over:
//  * The Pallas grid (slice, q tile, k tile) carries acc, m and l in VMEM
//    scratch along its sequential k axis. Hopper blocks run in no order, so
//    one block per (dispatched slice, 64-row q tile) walks the live k tiles
//    itself, FlashAttention-2 style: 4 row groups of 16 query rows (the m16
//    of mma.sync m16n8k8), one warp each up to hd 128, with the scores, the
//    online-softmax state (m, l) and the output accumulator in registers. The
//    tile skip (tile_live) and the element mask (elem_live) are the Pallas
//    kernel's _block_live and _tile_mask.
//  * Products. s = q k^T: A (q) and B (k, stored [n][k]) by ldmatrix from
//    swizzled tiles. P.V: P goes from the score accumulator to the A fragment
//    in registers (tf32x3::acc_as_a), with no shared-memory round trip; that
//    takes the product's k in a permuted order, so each V tile is staged with
//    its rows in the same order (tf32x3::stage_kpairs) and read as B [k][n]
//    (load_b_kn) without bank conflicts. Every k-step's three TF32 products
//    go to a fresh tensor-core accumulator that is added to the sum in IEEE
//    float32 (tf32x3::mma3): the tensor core's own float32 sum truncates. The
//    scale is applied to the scores after the product, as the backward
//    recomputes them, so the backward's p = exp(s * scale - lse) reads this
//    lse in the same arithmetic.
//  * Staging. q is staged once; k and v tiles stream through a two-stage
//    cp.async ring: the next live tile's k and v load while this one's
//    products run. Tiles (kernel_block(hd, "fwd")): 64 query rows against
//    Bc = 64 key rows up to hd 64 and 32 above, in 40 KB (hd <= 32), 80 KB
//    (hd 64), 72 KB (hd 80 and 96, rows padded to a pitch of 96 floats) and
//    96 KB (hd 128) of shared memory, two blocks an SM;
//    at hd 256 q takes 64 KB, a k + v stage 64 KB and the score hand-over
//    16 KB, 212,992 of the 232,448 bytes a block may take, one block of 8
//    warps an SM (a 64-row key tile, or a third stage, would not fit).
//  * Registers: the output accumulator is 16 x hd a row group, hd / 2
//    floats a thread, and the scores Bc / 2: up to hd 128 one warp holds
//    both (250 registers at hd 128). At hd 256 one warp would hold 128
//    accumulator floats, and took 255 registers with spills and 4 warps an
//    SM; so two warps share each row group (8 warps): each takes the score
//    product over half of hd, the two halves are handed over through 16 KB
//    of shared memory and added (a + b in one warp, b + a in the other:
//    the same scores bit for bit, so both take the same softmax), and each
//    accumulates P.V for half of the output columns. No product is done
//    twice. Warps whose 16 rows lie wholly past S (the ragged last q tile)
//    stage and synchronise but skip the products.
//  * Compaction: instead of gathering live slices to the front and
//    scattering results back (4-5 full copies per call), a block reads its
//    slice id from the int32 table live_permutation builds (all slices,
//    live ones first); blocks past the dispatch count write the exact
//    zeros and LSE_MASKED of the slices they hold and run nothing, so the
//    caller allocates o and lse without pre-filling them.
//  * Odd S (ViT's 197 is prime): no padded copies; the last tiles are
//    ragged, their rows zero-filled by the copies and masked by kpos < S.
//  * Executed-tile counter (replaces the JAX on_backward_block hook): when
//    the caller passes a device int64 cell, each block adds the number of
//    tiles it executed with one atomic.
//  * q, k and v must be 16-byte aligned (the launcher copies a tensor that
//    is not); every row is hd floats, a multiple of 4.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_attention.py)
// checks devices, dtypes, shapes and contiguity, allocates the outputs and
// passes PyTorch's current stream. The kernel allocates nothing. The entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int kRows = 64;                     // query rows a block
constexpr float kNegInf = -1073741824.0f;     // -2^30
constexpr float kLseMasked = 1073741824.0f;   // +2^30

template <int HD>
struct Geo {
  static constexpr int kBc = HD > 64 ? 32 : 64;       // key rows a tile
  // row pitch, floats: a multiple of 32 for the swizzle (hd 80 takes 96)
  static constexpr int kHp = (HD + 31) / 32 * 32;
  static constexpr int kNt = kBc / 8;                 // score n-tiles
  static constexpr int kSplit = HD > 128 ? 2 : 1;     // warps a row group
  static constexpr int kWarps = kRows / 16 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSd = HD / kSplit;             // score dims a warp
  static constexpr int kOw = HD / 8 / kSplit;         // output n-tiles
  static constexpr int kStage = 2 * kBc * kHp;        // k + v, floats
  // the partial scores a split warp hands its partner
  static constexpr int kXch = kSplit > 1 ? kWarps * 32 * 4 * kNt : 0;
  static constexpr size_t kSmem =
      sizeof(float) * (kRows * kHp + 2 * kStage + kXch);
  static_assert(kSmem <= 232448,
                "a tile's shared memory exceeds what one block may take");
};

__device__ __forceinline__ bool tile_live(int q0, int bq, int k0, int bk,
                                          int causal, int window, int S) {
  bool live = q0 < S && k0 < S;
  if (causal) live = live && k0 <= q0 + bq - 1;
  if (window > 0) live = live && k0 + bk - 1 > q0 - window;
  return live;
}

__device__ __forceinline__ bool elem_live(int qpos, int kpos, int causal,
                                          int window, int S) {
  bool m = kpos < S;
  if (causal) m = m && kpos <= qpos;
  if (window > 0) m = m && kpos > qpos - window;
  return m;
}

// max and sum over the 4 lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(Geo<HD>::kThreads)
d2ft_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ gate,
                     const int32_t* __restrict__ slice_idx,
                     float* __restrict__ o, float* __restrict__ lse,
                     unsigned long long* __restrict__ tiles, int n_disp,
                     int S, int causal, int window, float scale) {
  using G = Geo<HD>;
  constexpr int kBc = G::kBc, kHp = G::kHp, kNt = G::kNt, kOw = G::kOw;
  constexpr int kThreads = G::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kRows][kHp]
  float* kv_s = q_s + kRows * kHp;        // [2 stages][k, v][kBc][kHp]
  float* xch_s = kv_s + 2 * G::kStage;    // [kWarps][4 kNt][32]

  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int rows = min(kRows, S - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)n * S * HD;
  float* ob = o + base + (size_t)q0 * HD;
  float* lb = lse + (size_t)n * S + q0;
  const float gf = gate[n];

  // a p_s slice, or one the table leaves out: zeros, no compute
  if (gf == 0.f || (int)blockIdx.x >= n_disp) {
    for (int i = tid; i < rows * HD; i += kThreads) ob[i] = 0.f;
    for (int i = tid; i < rows; i += kThreads) lb[i] = kLseMasked;
    return;
  }

  const int n_k = (S + kBc - 1) / kBc;
  auto next_live = [&](int kt) {
    while (kt < n_k && !tile_live(q0, kRows, kt * kBc, kBc, causal, window,
                                  S))
      ++kt;
    return kt;
  };
  auto stage_kv = [&](int kt, int buf) {
    const size_t off = base + (size_t)kt * kBc * HD;
    const int krows = min(kBc, S - kt * kBc);
    float* ks = kv_s + buf * G::kStage;
    tf32x3::stage<kBc, HD, kHp, kThreads>(ks, k + off, HD, krows, HD, true);
    tf32x3::stage_kpairs<kBc, HD, kHp, kThreads>(ks + kBc * kHp, v + off, HD,
                                                 krows);
  };

  tf32x3::stage<kRows, HD, kHp, kThreads>(q_s, q + base + (size_t)q0 * HD,
                                          HD, rows, HD, true);
  tf32x3::commit();
  int kt = next_live(0);
  if (kt < n_k) stage_kv(kt, 0);
  tf32x3::commit();

  // this warp's 16 rows of the tile; with kSplit 2, warps w and w + 4
  // share them: half 0 / 1 takes score dims and output columns [0, hd / 2)
  // / [hd / 2, hd)
  const int rg = warp % (kRows / 16), half = warp / (kRows / 16);
  const int r0 = 16 * rg, c0 = half * (HD / G::kSplit);
  const bool active = r0 < rows;
  float acc[kOw][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kOw; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int executed = 0, buf = 0;
  while (kt < n_k) {
    ++executed;
    const int k0 = kt * kBc;
    const int nxt = next_live(kt + 1);
    if (nxt < n_k) stage_kv(nxt, buf ^ 1);
    tf32x3::commit();
    tf32x3::wait<1>();
    __syncthreads();                      // q and this tile's k, v landed
    const float* k_s = kv_s + buf * G::kStage;
    const float* v_s = k_s + kBc * kHp;
    if (active) {
      // s = q k^T, 16 x kBc a warp
      float s[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
      for (int d8 = c0 / 8; d8 < (c0 + G::kSd) / 8; ++d8) {
        FragA fa;
        tf32x3::load_a(fa, q_s, kHp, r0, 8 * d8);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          FragB fb;
          tf32x3::load_b_nk(fb, k_s, kHp, 8 * j, 8 * d8);
          tf32x3::mma3(s[j], fa, fb);
        }
      }
      if constexpr (G::kSplit > 1) {
        // own half plus the partner's, in IEEE float32: the same sum,
        // bit for bit, in both warps of the pair
        float* own = xch_s + warp * (4 * kNt * 32);
        const float* other = xch_s + (warp ^ (kRows / 16)) * (4 * kNt * 32);
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) own[(4 * j + e) * 32 + lane] = s[j][e];
        asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rg));
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] += other[(4 * j + e) * 32 + lane];
      }
      // scale, mask, online softmax: h = 0 row g, h = 1 row g + 8
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + r0 + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = elem_live(qpos, kpos, causal, window, S)
                        ? s[j][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        corr[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int j = 0; j < kOw; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      // acc += P v: P from the score registers, 8 keys a k-step. The
      // k-steps are a rolled loop (code size, registers); each takes s[0]
      // and shifts the rest down, so every register index is a constant
#pragma unroll 1
      for (int j = 0; j < kNt; ++j) {
        FragA pa;
        tf32x3::acc_as_a(pa, s[0]);
#pragma unroll
        for (int c = 0; c < kOw; ++c) {
          FragB fb;
          tf32x3::load_b_kn(fb, v_s, kHp, 8 * j, c0 + 8 * c);
          tf32x3::mma3(acc[c], pa, fb);
        }
#pragma unroll
        for (int i = 0; i + 1 < kNt; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = s[i + 1][e];
      }
    }
    __syncthreads();                      // this stage read by every warp
    buf ^= 1;
    kt = nxt;
  }
  tf32x3::wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    const int r = r0 + g + 8 * h;
    if (r < rows) {
      const bool seen = lt > 0.f;
      const float mul = seen ? gf / lt : 0.f;
#pragma unroll
      for (int c = 0; c < kOw; ++c)
        *reinterpret_cast<float2*>(ob + (size_t)r * HD + c0 + 8 * c +
                                   2 * t) =
            make_float2(acc[c][2 * h] * mul, acc[c][2 * h + 1] * mul);
      if (t == 0 && half == 0) lb[r] = seen ? m[h] + logf(lt) : kLseMasked;
    }
  }
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* gate, const void* slice_idx, void* o,
                   void* lse, void* tiles, int n_disp, int n_slices, int S,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = Geo<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      d2ft_attn_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_slices, (S + kRows - 1) / kRows);
  d2ft_attn_fwd_kernel<HD><<<grid, Geo<HD>::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(gate),
      static_cast<const int32_t*>(slice_idx), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<unsigned long long*>(tiles),
      n_disp, S, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. slice_idx (a
// permutation of all n_slices slices, live ones first) and tiles may be
// null (every slice dispatched in order; no tile count). Blocks of the
// slices at slice_idx[n_disp:] write their zeros and LSE_MASKED, so o and
// lse need no pre-fill. The tiles (64 query rows against 64 key rows up
// to hd 64, 32 above) must be the caller's kernel_block(hd, "fwd").
int d2ft_attn_fwd_f32(const void* q, const void* k, const void* v,
                      const void* gate, const void* slice_idx, void* o,
                      void* lse, void* tiles, int n_disp, int n_slices,
                      int S, int hd, int causal, int window, float scale,
                      void* stream) {
  if (n_disp <= 0 || S <= 0 || n_slices < n_disp ||
      (slice_idx == nullptr && n_slices != n_disp))
    return cudaErrorInvalidValue;
  auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if ((bits(q) | bits(k) | bits(v)) & 15) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define D2FT_FWD_CASE(HD)                                                    \
  case HD:                                                                   \
    return launch<HD>(q, k, v, gate, slice_idx, o, lse, tiles, n_disp,      \
                      n_slices, S, causal, window, scale, s);
    D2FT_FWD_CASE(16)
    D2FT_FWD_CASE(32)
    D2FT_FWD_CASE(64)
    D2FT_FWD_CASE(80)
    D2FT_FWD_CASE(96)
    D2FT_FWD_CASE(128)
    D2FT_FWD_CASE(256)
#undef D2FT_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

const char* d2ft_attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
