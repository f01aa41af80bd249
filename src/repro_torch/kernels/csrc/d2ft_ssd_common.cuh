// Geometry, product helpers and the two kernels both directions run, shared
// by the D2FT-gated SSD kernels (d2ft_ssd_fwd.cu, d2ft_ssd_bwd.cu).
//
// Layouts are the model's (no transposed or gathered copies): x, y, dx, dy
// [B, S, H, P]; da, ddA [B, S, H]; Bm, Cm, dB, dC [B, S, N], B and C shared
// by the H heads. Slice s = b*H + h. A chunk is Q <= 256 consecutive rows,
// cut into nT = ceil(Q / 64) tiles of 64 rows; rows past Q stage as zeros
// and take a decay of 0, so they add nothing to any product.
//
// Products run on the tensor cores in 3xTF32 (tf32x3.cuh: float32 accuracy,
// each k-step's three products into a fresh accumulator added in IEEE
// float32), all but two, which stay on float32 FMA in the plain version's
// order (fma_rows): C.B^T (ssd_cb_kernel says why) and the backward's
// dy x^T (d2ft_ssd_bwd.cu). A block has 8 warps. A product's output of M
// rows and NC columns is cut into m16 x n8 tiles; warp w holds m-tile
// w % (M / 16) and NT consecutive n8 tiles (Lay), so every output element
// has one owner.
//
// Operands are staged into shared memory with cp.async, one item ahead of
// the item being computed, in swizzled tiles whose rows are a multiple of
// 32 floats: A is read with ldmatrix (tf32x3::load_a) or, transposed in
// place, float by float (load_a_km); B likewise (load_b_nk, load_b_kn).
//
// Which slices run is slice_gate.cuh's rule; blocks of slices that do not
// run write their zeros. The launchers build no table and fill nothing.
//
// Workspaces (the launchers allocate them unfilled; a kernel reads only
// what an earlier kernel of the same call wrote):
//   cum [B*H, S]        each running slice's in-chunk cumulative log-decay
//   cb  [B, nc, QP, QP] C.B^T of every chunk, QP = 64 nT: the causal 64 x 64
//                       tiles, of samples with a running slice
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "slice_gate.cuh"
#include "tf32x3.cuh"

namespace ssd {

constexpr int kT = 64;            // rows of a tile
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 256;        // largest chunk
// heads a backward block loops over; kernels/d2ft_ssd.py's HEAD_GROUP
constexpr int kHeadGroup = 8;
constexpr int kPassBatch = 8;     // chunks a pass over chunks loads at once
static_assert(kThreads == kMaxQ, "one thread per chunk row");

// floats a staged row takes: a multiple of the swizzle's 32
__host__ __device__ constexpr int pitch_of(int w) {
  return (w + 31) / 32 * 32;
}

// Warp layout of an M x NC product (M 16 or 64): warp w on m-tile w % MT
// and n8 tiles [NT (w / MT), NT (w / MT + 1)); where there are fewer n8
// tiles than warps to a row (16 x 16), warps past ACTIVE hold nothing.
template <int M, int NC>
struct Lay {
  static constexpr int MT = M / 16;
  static constexpr int WN = kWarps / MT;
  static constexpr int NT8 = NC / 8;
  static constexpr int NT = NT8 >= WN ? NT8 / WN : 1;
  static constexpr int ACTIVE = NT8 >= WN ? kWarps : MT * NT8;
  static_assert(M % 16 == 0 && kWarps % MT == 0 && NC % 8 == 0 &&
                (NT8 < WN || NT8 % WN == 0), "layout");
  __device__ static int warp() { return threadIdx.x >> 5; }
  __device__ static bool active() { return warp() < ACTIVE; }
  __device__ static int row0() { return 16 * (warp() % MT); }
  __device__ static int col0() { return 8 * NT * (warp() / MT); }
  __device__ static int wn() { return warp() / MT; }
};

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc += A B over K (a multiple of 8): fa(a, k0) loads the warp's A at
// k0, fb(b, k0, j) the B of its j-th n8 tile. The k-steps run in order.
template <int K, int NT, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], FA&& fa, FB&& fb) {
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 8) {
    tf32x3::FragA a;
    fa(a, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tf32x3::FragB b;
      fb(b, k0, j);
      tf32x3::mma3(acc[j], a, b);
    }
  }
}

// tf32x3::load_a with rows row0 + g scaled by s0 and row0 + g + 8 by s8
__device__ __forceinline__ void load_a_rows(tf32x3::FragA& f, const float* s,
                                            int pitch, int row0, int col0,
                                            float s0, float s8) {
  const int l = threadIdx.x & 31, j = l >> 3;
  uint32_t raw[4];
  tf32x3::ldsm_x4(raw, s + tf32x3::at(pitch, row0 + (l & 7) + 8 * (j & 1),
                                      col0 + 4 * (j >> 1)));
  const float sc[4] = {s0, s8, s0, s8};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    tf32x3::split(__uint_as_float(raw[e]) * sc[e], f.big[e], f.small[e]);
}

// tf32x3::load_a_km with k0 + t scaled by s0 and k0 + t + 4 by s4
__device__ __forceinline__ void load_a_km_cols(tf32x3::FragA& f,
                                               const float* s, int pitch,
                                               int k0, int m0, float s0,
                                               float s4) {
  const int g = lane_g(), t = lane_t();
  using tf32x3::at;
  tf32x3::split(s[at(pitch, k0 + t, m0 + g)] * s0, f.big[0], f.small[0]);
  tf32x3::split(s[at(pitch, k0 + t, m0 + g + 8)] * s0, f.big[1], f.small[1]);
  tf32x3::split(s[at(pitch, k0 + t + 4, m0 + g)] * s4, f.big[2], f.small[2]);
  tf32x3::split(s[at(pitch, k0 + t + 4, m0 + g + 8)] * s4, f.big[3],
                f.small[3]);
}

// Row (r, c) of the warp's e-th accumulator value of n8 tile j.
template <class L>
__device__ __forceinline__ int acc_row(int e) {
  return L::row0() + lane_g() + (e >> 1) * 8;
}
template <class L>
__device__ __forceinline__ int acc_col(int j, int e) {
  return L::col0() + 8 * j + 2 * lane_t() + (e & 1);
}

// out[r * ld + c] = acc for rows r < rows (of the 64 or 16 the layout holds)
template <class L, int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4],
                                          float* out, long ld, int rows) {
  if (!L::active()) return;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = acc_row<L>(e);
      if (r < rows) out[r * ld + acc_col<L>(j, e)] = acc[j][e];
    }
}

// Each warp's per-row partial sums (rows g and g + 8 of its m-tile, summed
// over its columns) into red[wn][row], after a sum over the four lanes of
// the row; a later row_total (after a barrier) adds the WN warps in order.
template <class L>
__device__ __forceinline__ void rows_to_red(float r0, float r8, float* red) {
  r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
  r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
  r8 += __shfl_xor_sync(0xffffffffu, r8, 1);
  r8 += __shfl_xor_sync(0xffffffffu, r8, 2);
  if (lane_t() == 0 && L::active()) {
    red[L::wn() * kT + L::row0() + lane_g()] = r0;
    red[L::wn() * kT + L::row0() + lane_g() + 8] = r8;
  }
}

template <class L>
__device__ __forceinline__ float row_total(const float* red, int r) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < L::WN; ++w) s += red[w * kT + r];
  return s;
}

// acc[i][j] = sum_k a[4 ty + i][k] b[tx + 16 j][k] over k < K in order,
// one float32 FMA a term, thread (ty, tx) = (tid / 16, tid % 16): the
// order in which the plain version's float32 GEMMs sum. a and b are
// swizzled [64][pitch] tiles, read 4 floats at a time (a swizzled 16-byte
// chunk stays whole; 8 consecutive rows' chunks lie on distinct banks).
template <int K>
__device__ __forceinline__ void fma_rows(float (&acc)[4][4], const float* a,
                                         const float* b, int pitch) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* ra[4];
  const float* rb[4];
  int sa[4], sb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ra[i] = a + (4 * ty + i) * pitch;
    sa[i] = tf32x3::swz(4 * ty + i);
    rb[i] = b + (tx + 16 * i) * pitch;
    sb[i] = tf32x3::swz(tx + 16 * i);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(ra[i] + (k ^ sa[i]));
      bv[i] = *reinterpret_cast<const float4*>(rb[i] + (k ^ sb[i]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// fma_rows' per-row partial sums (rows 4 ty + i) summed over the 16
// threads of the row, into red[row]
__device__ __forceinline__ void rows16_to_red(float (&rs)[4], float* red) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], o);
  }
  if ((threadIdx.x & 15) == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[4 * (threadIdx.x >> 4) + i] = rs[i];
}

// ROWS x COLS of a row-major source (row stride ld floats) into a swizzled
// tile; rows at or past rows_valid are zeros. vec: 16-byte copies.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long ld, int rows_valid,
                                           bool vec) {
  tf32x3::stage<ROWS, COLS, pitch_of(COLS), kThreads>(
      dst, src, static_cast<int>(ld), rows_valid, COLS, vec);
}

// One chunk's Q cumulative decays from the cum workspace into dst[0, 256),
// zeros past Q.
__device__ __forceinline__ void stage_cum(float* dst, const float* src,
                                          int Q) {
  const int i = threadIdx.x;
  tf32x3::cp_async4(dst + i, i < Q ? src + i : src, i < Q ? 4 : 0);
}

// L[q][k] = exp(cum_q - cum_k) on k <= q < Q, else 0: the plain version's
// exp(where(causal, diff, -inf)) on the same cum.
__device__ __forceinline__ float decay(const float* cum, int q, int k, int Q) {
  return (k <= q && q < Q) ? expf(cum[q] - cum[k]) : 0.f;
}

// cum[i] = da[0] + ... + da[i] over the chunk's rows (da rows `stride`
// floats apart), for i < 256; rows past Q add 0. Summed in float32, in
// order, by one thread: the plain version's torch.cumsum along a
// non-innermost dimension sums the same way, so both compute the same cum
// and the same decays exp(cum_q - cum_k). At Q = 256, |cum| reaches ~200,
// where one float32 rounding of cum moves a decay by ~1.5e-5 relative;
// another summation order would put that difference between the kernels
// and their plain version.
__device__ __forceinline__ void chunk_cumsum(float* cum,
                                             const float* __restrict__ da,
                                             long stride, int Q) {
  const int i = threadIdx.x;
  cum[i] = i < Q ? da[i * stride] : 0.f;
  __syncthreads();
  if (i == 0) {
    float acc = 0.f;
    for (int r = 0; r < kMaxQ; ++r) {
      acc += cum[r];
      cum[r] = acc;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- C.B^T
// One of the two products kept on float32 FMA (the other is the
// backward's dy x^T). The plain version's C.B^T is a float32 GEMM that
// sums each entry's N products in order with FMA, and its entries' own
// rounding (~1e-6 relative at N 128) reaches y, dx and ddA through the
// (C.B^T o L) products: at the JAX tests' N(0, 1) operands C.B^T in
// 3xTF32 moved y by up to 1.5e-5 against the plain version on the card,
// past the 1e-5 the kernels are held to (an exact C.B^T would too: the
// plain version's own entries are that far from exact). Summed the plain
// version's way, in n order with FMA, the entries are its own. It costs
// little: once per (sample, chunk), ~8 MFLOP at Q 256.
template <int N>
constexpr size_t cb_smem() {
  return sizeof(float) * 3 * kT * pitch_of(N);
}

// C.B^T of chunk c of sample b, once for all its heads: block (z, c, b)
// holds q tile qt = nT - 1 - z (the longest rows first) and writes the
// causal tiles kt <= qt of cb (fma_rows). C's rows stay staged; B's k
// tiles stream through two buffers. Samples with no running slice are
// skipped: no kernel reads their tiles.
template <int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_cb_kernel(
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ gate, float* __restrict__ cb, int n,
    int n_disp, int S, int H, int Q, bool vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr int pN = pitch_of(N);
  float* cs = sm;                        // [64][pN] C rows of the q tile
  float* ring = cs + kT * pN;            // 2 x [64][pN] B rows of a k tile
  const int nT = (Q + kT - 1) / kT, QP = nT * kT;
  const int qt = nT - 1 - blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (!gating::any_runs<kThreads>(gate, n, n_disp, b * H, H)) return;
  const long t0 = (long)b * S + (long)c * Q;
  stage_tile<kT, N>(cs, Cm + (t0 + qt * kT) * N, N, min(kT, Q - qt * kT),
                    vec);
  stage_tile<kT, N>(ring, Bm + t0 * N, N, min(kT, Q), vec);
  tf32x3::commit();
  float* out = cb + ((long)(b * nc + c) * QP + qt * kT) * QP;
  for (int kt = 0; kt <= qt; ++kt) {
    if (kt < qt)
      stage_tile<kT, N>(ring + ((kt + 1) & 1) * kT * pN,
                        Bm + (t0 + (kt + 1) * kT) * N, N,
                        min(kT, Q - (kt + 1) * kT), vec);
    tf32x3::commit();
    tf32x3::wait<1>();
    __syncthreads();
    float acc[4][4];
    fma_rows<N>(acc, cs, ring + (kt & 1) * kT * pN, pN);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(long)(4 * ty + i) * QP + kt * kT + tx + 16 * j] = acc[i][j];
    __syncthreads();
  }
}

// ------------------------------------------------- a chunk's state product
template <int P, int N>
constexpr size_t chunk_state_smem() {
  return sizeof(float) *
         (2 * kT * (pitch_of(P) + pitch_of(N)) + 2 * kMaxQ);
}

// One running slice's chunk (block (s, c)): the in-chunk cumulative decay,
// written to the cum workspace, and the [P, N] product
//   out[p][n] = sum_k w_k U[k][p] V[k][n]
// forward (kBwd false): U = x, V = B, w_k = exp(tot - cum_k), the state the
// chunk adds, into prevs[s, c] (ssd_state_pass_kernel turns it into the
// state entering c); backward: U = dy, V = C, w_k = exp(cum_k), the chunk's
// sum_q e^{cum_q} dy_q^T C_q, into ds[s, c]. The forward counts one
// executed (slice, chunk) step. U is read transposed in place
// (load_a_km), 64-row slabs of U and V through two buffers.
template <int P, int N, bool kBwd>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_state_kernel(
    const float* __restrict__ U, const float* __restrict__ da,
    const float* __restrict__ V, const float* __restrict__ gate,
    float* __restrict__ out, float* __restrict__ cumw,
    unsigned long long* __restrict__ steps, int n, int n_disp, int S,
    int H, int Q, bool vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr int pP = pitch_of(P), pN = pitch_of(N);
  constexpr int kSlab = kT * (pP + pN);
  using L = Lay<P, N>;
  float* ring = sm;                      // 2 x ([64][pP] U, [64][pN] V)
  float* cum = ring + 2 * kSlab;         // [256]
  float* w = cum + kMaxQ;                // [256]
  const int s = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  if (!gating::slice_runs<kThreads>(gate, n, n_disp, s)) return;
  const int b = s / H, h = s % H, nT = (Q + kT - 1) / kT;
  const long t0 = (long)b * S + (long)c * Q;
  auto stage_item = [&](int kt) {
    float* dst = ring + (kt & 1) * kSlab;
    const int rows = min(kT, Q - kt * kT);
    stage_tile<kT, P>(dst, U + ((t0 + kt * kT) * H + h) * P, (long)H * P,
                      rows, vec);
    stage_tile<kT, N>(dst + kT * pP, V + (t0 + kt * kT) * N, N, rows, vec);
  };
  stage_item(0);
  tf32x3::commit();
  chunk_cumsum(cum, da + t0 * H + h, H, Q);
  {
    const int i = threadIdx.x;
    const float tot = cum[Q - 1];
    if (i < Q) cumw[(long)s * S + (long)c * Q + i] = cum[i];
    w[i] = i < Q ? expf(kBwd ? cum[i] : tot - cum[i]) : 0.f;
  }
  float acc[L::NT][4];
  zero(acc);
  for (int kt = 0; kt < nT; ++kt) {
    if (kt + 1 < nT) stage_item(kt + 1);
    tf32x3::commit();
    tf32x3::wait<1>();
    __syncthreads();
    const float* us = ring + (kt & 1) * kSlab;
    const float* vs = us + kT * pP;
    const float* wk = w + kt * kT;
    if (L::active())
      gemm<kT>(acc,
               [&](tf32x3::FragA& a, int k0) {
                 load_a_km_cols(a, us, pP, k0, L::row0(),
                                wk[k0 + lane_t()], wk[k0 + lane_t() + 4]);
               },
               [&](tf32x3::FragB& f, int k0, int j) {
                 tf32x3::load_b_kn(f, vs, pN, k0, L::col0() + 8 * j);
               });
    __syncthreads();
  }
  store_acc<L>(acc, out + ((long)s * nc + c) * P * N, N, P);
  if (!kBwd && steps != nullptr && threadIdx.x == 0) atomicAdd(steps, 1ull);
}

// 16-byte cp.async needs every staged row and base 16-byte aligned.
inline bool vec_ok(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return false;
  return true;
}

}  // namespace ssd
