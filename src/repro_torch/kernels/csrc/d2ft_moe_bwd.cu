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
// Only the dW the caller asks for are computed (want: 1 dW_up, 2 dW_gate,
// 4 dW_down): D2FT-LoRA's merged w_gate and w_down are frozen, so its step
// asks for dW_up alone and runs 6 of the 8 matmuls a tile.
//
// What bounds it on this card: operations. A live tile needs 8 matmuls of
// 2 bc D F FLOPs (the recompute of h and g, dmid, two for dx, three dW;
// 4.3 GFLOP a tile at olmoe-1b-7b's 128 x 2048 x 1024) against reading x
// and dy and writing dx (3 MB a tile) and each expert's weights and
// gradients once (50 MB): hundreds of FLOPs per byte. The products run on
// the tensor cores as 3xTF32 (tf32x3.cuh, up to 165 TFLOP/s of float32-
// accurate work), and the kernels are held to that bound.
//
// Design. The TPU kernel walks an expert's capacity blocks in order on one
// core and keeps the expert's three [D, F] dW accumulators resident in
// VMEM across them ("arbitrary" axis). Blocks of a Hopper grid run in no
// order and 3 x 8 MB of accumulators fit no block, so one launcher call
// runs up to six kernels:
//   1. build_work_list: the live (expert, block) tiles of bm's first nb
//      columns at the front of a work list, in ascending order, on the
//      device;
//   2. moe_bwd_dmid_kernel, a block per (128 columns of F, 128 rows, work-
//      list slot): dmid = dy W_down^T (W_down read as [n][k], in place)
//      into the dh half of a [E, nb bc, 2F] scratch;
//   3. moe_bwd_mid_kernel, a block per (64 columns of F, 128 rows, live
//      tile): the recompute of h and g as two accumulators over one walk
//      of x, then, with dmid read back from the scratch, dh = dmid a in
//      place and dg = dmid h act'(g) into its dg half and, when dW_down is
//      wanted, a h into a [E, nb bc, F] scratch. dmid has its own pass
//      because h, g and dmid together are 96 accumulator floats a thread:
//      in one kernel (255 registers, one block an SM) they took 4.75 ms on
//      an H100 at olmoe-1b-7b's shapes (tools/moe_probe.py), in two (128
//      registers, two blocks an SM) 1.28 + 2.76 ms, for 65 MB more of
//      scratch traffic;
//   4. moe_bwd_dx_kernel, a block per (128 columns of D, 128 rows, work-
//      list slot): dx = [dh | dg] [W_up | W_gate]^T as one GEMM of depth
//      2F (both weights read as [n][k], in place; the slabs of each half
//      stop at F, so no slab straddles the two); dead tiles write their
//      zeros. It adds one to the executed-tile counter per live tile;
//   5. moe_bwd_dw_kernel<2> for dW_up and dW_gate (two accumulators sharing
//      the x^T fragments, 128 rows of D x 64 columns of F), or <1> for the
//      one of them that is wanted (128 x 128); not launched when neither is;
//   6. moe_bwd_dw_kernel<1> for dW_down = (a h)^T dy (128 rows of F x 128
//      columns of D); not launched, and no a h written, when it is not
//      wanted.
// Every product is a warp's 64-row share of a 128-row tile on mma.sync
// m16n8k8 in 3xTF32 (d2ft_moe_common.cuh), K in slabs of 32 through 3
// cp.async stages (96 KB), 64 accumulator floats a thread, at most 128
// registers: two blocks (16 warps) an SM.
// Kernels 5-6 give each output tile of an expert to one block, which finds
// the expert's run of live tiles in the work list (ascending) and walks
// their rows in that order, 32 at a time (the K dimension of the sum):
// a fixed summation order and no float atomics, so two calls give the
// same bits, as in the port's other backward kernels. Their A operand is
// a transposed one (x^T, (a h)^T), staged [k][m] as it lies in memory and
// read float by float (tf32x3::load_a_km) from the swizzled tile, on
// distinct banks: ldmatrix's transpose moves 16-bit values, and writing
// dh, dg and a h transposed in kernel 3 would make its stores (and dx's
// A reads) strided instead.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_moe.py) checks
// devices, dtypes, shapes and contiguity, allocates dx (zeroed past nb bc
// slots), the wanted dW outputs, the scratches (ah only for dW_down) and
// the int32 work list (E nb + 1 entries), and passes PyTorch's current
// stream. The entry returns the first launch error.

#include "d2ft_moe_common.cuh"

namespace {

using namespace moe;

// the recompute kernel: 128 rows x 64 columns of F, h and g
struct BMid {
  static constexpr int kBN = 64, kNt = kBN / 32;
  static constexpr int kA = kBM * kBK;          // x slab [128][32]
  static constexpr int kB = kBK * kBN;          // W_up / W_gate [32][64]
  static constexpr int kStage = kA + 2 * kB;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// dmid and dx: 128 rows x 128 columns, B read as [n][k]
struct Nt {
  static constexpr int kBN = 128, kNt = kBN / 32;
  static constexpr int kA = kBM * kBK;          // A slab [128][32]
  static constexpr int kB = kBN * kBK;          // B slab [128 n][32 k]
  static constexpr int kStage = kA + kB;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// dW: 128 rows of M x 128 / NB columns of N, NB accumulators
template <int NB>
struct Dw {
  static constexpr int kBN = 128 / NB, kNt = kBN / 32;
  static constexpr int kA = kBK * kBM;          // A^T slab [32 k][128 m]
  static constexpr int kB = kBK * kBN;          // a B slab [32 k][kBN]
  static constexpr int kStage = kA + NB * kB;
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// A live tile's out[rows][n0 : n0 + 128] = sum over h < NH of A_h B_h^T:
// A_h the tile's rows of a (row stride lda, expert stride sa) from column
// h * a_half, B_h = b_h of expert e stored [N][K] (expert stride sb), out
// rows of stride ldo (expert stride so), K walked in slabs of 32 that stop
// at K, so none straddles two halves. dmid = dy W_down^T (NH 1) and dx =
// [dh | dg] [W_up | W_gate]^T (NH 2, depth 2F). A dead tile returns at
// once for dmid (nothing reads its rows) and writes its zeros for dx.
// vec bits: 1 A, 2 B.
template <int NH>
__device__ __forceinline__ void nt_tile(
    const Tile& t, const float* __restrict__ a, int lda, size_t sa,
    int a_half, const float* __restrict__ b0, const float* __restrict__ b1,
    size_t sb, int K, int N, float* __restrict__ out, int ldo, size_t so,
    int vec) {
  const int n0 = blockIdx.x * Nt::kBN;
  float* oe = out + t.e * so + (size_t)t.r0 * ldo + n0;
  if (!t.live) {
    if (NH == 2)
      for (int idx = threadIdx.x; idx < t.nr * Nt::kBN; idx += kThreads) {
        const int r = idx / Nt::kBN, c = idx % Nt::kBN;
        if (c < N - n0) oe[(size_t)r * ldo + c] = 0.f;
      }
    return;
  }
  extern __shared__ __align__(16) float smem[];
  const int wm = warp_m0(), wn = warp_n0<Nt::kBN>();
  const float* ae = a + t.e * sa + (size_t)t.r0 * lda;
  const size_t boff = t.e * sb + (size_t)n0 * K;
  const int nkh = ceil_div(K, kBK);             // slabs of each half
  float acc[kMt][Nt::kNt][4];
  zero(acc);
  ring<kStages, Nt::kStage>(
      smem, NH * nkh,
      [&](int s, float* st) {
        const int h = s >= nkh, k0 = (s - h * nkh) * kBK;
        tf32x3::stage<kBM, kBK, kBK, kThreads>(st, ae + h * a_half + k0, lda,
                                               t.nr, K - k0, vec & 1);
        tf32x3::stage<Nt::kBN, kBK, kBK, kThreads>(
            st + Nt::kA, (h ? b1 : b0) + boff + k0, K, N - n0, K - k0,
            vec & 2);
      },
      [&](const float* st) {
#pragma unroll 1
        for (int k8 = 0; k8 < kBK; k8 += 8) {
          FragB fb[Nt::kNt];
          load_bs<true>(fb, st + Nt::kA, kBK, wn, k8);
#pragma unroll
          for (int i = 0; i < kMt; ++i) {
            FragA fa;
            load_a1<false>(fa, st, kBK, wm + 16 * i, k8);
            mma_m(acc[i], fa, fb);
          }
        }
      });
  for_each_pair<Nt::kNt>(wm, wn, [&](int r, int c, int i, int j, int hh) {
    if (r >= t.nr) return;
    store_pair(oe + (size_t)r * ldo, c, N - n0, acc[i][j][2 * hh],
               acc[i][j][2 * hh + 1]);
  });
}

// dmid = dy W_down^T into dhg's dh half [E, Cb, 2F] (columns 0 .. F)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    moe_bwd_dmid_kernel(const float* __restrict__ dy,
                        const float* __restrict__ wd,
                        const int32_t* __restrict__ work,
                        float* __restrict__ dhg, int C, int Cb, int nb,
                        int bc, int D, int F, int vec) {
  const Tile t = tile_of(work, gridDim.z, nb, bc);
  nt_tile<1>(t, dy, D, (size_t)C * D, 0, wd, nullptr, (size_t)F * D, D, F,
             dhg, 2 * F, (size_t)Cb * 2 * F, vec);
}

// vec bits: 1 x, 2 W_up and W_gate
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) moe_bwd_mid_kernel(
    const float* __restrict__ x, const float* __restrict__ wu,
    const float* __restrict__ wg, const int32_t* __restrict__ work,
    float* __restrict__ dhg, float* __restrict__ ah, int C, int Cb, int nb,
    int bc, int D, int F, int act, int vec) {
  const Tile t = tile_of(work, gridDim.z, nb, bc);
  if (!t.live) return;
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * BMid::kBN;
  const int wm = warp_m0(), wn = warp_n0<BMid::kBN>();
  const float* xe = x + ((size_t)t.e * C + t.r0) * D;
  const float* wue = wu + (size_t)t.e * D * F + n0;
  const float* wge = wg + (size_t)t.e * D * F + n0;
  float h[kMt][BMid::kNt][4], g[kMt][BMid::kNt][4];
  zero(h);
  zero(g);
  ring<kStages, BMid::kStage>(
      smem, ceil_div(D, kBK),
      [&](int s, float* st) {
        const int k0 = s * kBK;
        tf32x3::stage<kBM, kBK, kBK, kThreads>(st, xe + k0, D, t.nr, D - k0,
                                               vec & 1);
        tf32x3::stage<kBK, BMid::kBN, BMid::kBN, kThreads>(
            st + BMid::kA, wue + (size_t)k0 * F, F, D - k0, F - n0, vec & 2);
        tf32x3::stage<kBK, BMid::kBN, BMid::kBN, kThreads>(
            st + BMid::kA + BMid::kB, wge + (size_t)k0 * F, F, D - k0,
            F - n0, vec & 2);
      },
      [&](const float* st) {
#pragma unroll 1
        for (int k8 = 0; k8 < kBK; k8 += 8) {
          FragB bu[BMid::kNt], bg[BMid::kNt];
          load_bs<false>(bu, st + BMid::kA, BMid::kBN, wn, k8);
          load_bs<false>(bg, st + BMid::kA + BMid::kB, BMid::kBN, wn, k8);
#pragma unroll
          for (int i = 0; i < kMt; ++i) {
            FragA fa;
            load_a1<false>(fa, st, kBK, wm + 16 * i, k8);
            mma_m(h[i], fa, bu);
            mma_m(g[i], fa, bg);
          }
        }
      });
  // dmid (kernel 2's, in the dh half) becomes dh in place: each element is
  // read and written by the same thread
  const size_t srow = (size_t)t.e * Cb + t.r0;
  float* dhe = dhg + srow * 2 * F + n0;
  float* ahe = ah != nullptr ? ah + srow * F + n0 : nullptr;
  for_each_pair<BMid::kNt>(wm, wn, [&](int r, int c, int i, int j, int hh) {
    if (r >= t.nr) return;
    float* dr = dhe + (size_t)r * 2 * F;
    float vh[2], vg[2], va[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float gv = g[i][j][2 * hh + e], hv = h[i][j][2 * hh + e];
      const float dv = c + e < F - n0 ? dr[c + e] : 0.f;
      const float a = act_f(gv, act);
      vh[e] = dv * a;
      vg[e] = dv * hv * act_df(gv, act);
      va[e] = a * hv;
    }
    store_pair(dr, c, F - n0, vh[0], vh[1]);
    store_pair(dr + F, c, F - n0, vg[0], vg[1]);
    if (ahe != nullptr)
      store_pair(ahe + (size_t)r * F, c, F - n0, va[0], va[1]);
  });
}

// dx = [dh | dg] [W_up | W_gate]^T; dead tiles write their zeros
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    moe_bwd_dx_kernel(const float* __restrict__ dhg,
                      const float* __restrict__ wu,
                      const float* __restrict__ wg,
                      const int32_t* __restrict__ work,
                      float* __restrict__ dx,
                      unsigned long long* __restrict__ tiles, int C, int Cb,
                      int nb, int bc, int D, int F, int vec) {
  const Tile t = tile_of(work, gridDim.z, nb, bc);
  nt_tile<2>(t, dhg, 2 * F, (size_t)Cb * 2 * F, F, wu, wg, (size_t)D * F, F,
             D, dx, D, (size_t)C * D, vec);
  if (t.live && tiles != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    atomicAdd(tiles, 1ull);
}

// out_b[e] = A[e]^T B_b[e] over the rows of expert e's live tiles, for
// b < NB: A [E, rows, M] (row stride lda, expert stride sa), B_b [E, rows,
// N] at column offset boff * b (row stride ldb, expert stride sb), out_b
// [E, M, N]. Rows of tile cb are cb * bc .. cb * bc + bc - 1. vec bits:
// 1 A, 2 B.
template <int NB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    moe_bwd_dw_kernel(
    const float* __restrict__ a, int lda, size_t sa, int M,
    const float* __restrict__ b, int ldb, size_t sb, int boff, int N,
    const int32_t* __restrict__ work, float* __restrict__ out0,
    float* __restrict__ out1, int n_tiles, int nb, int bc, int vec) {
  using G = Dw<NB>;
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * G::kBN;
  const int wm = warp_m0(), wn = warp_n0<G::kBN>();
  // the expert's live tiles: one ascending run of the work list
  const int n_live = work[n_tiles];
  const int lo = lower_bound(work, n_live, e * nb);
  const int hi = lower_bound(work, n_live, (e + 1) * nb);
  const int spb = ceil_div(bc, kBK);            // slabs a capacity block
  const float* ae = a + e * sa + m0;
  const float* be = b + e * sb + n0;
  float acc[NB][kMt][G::kNt][4];
#pragma unroll
  for (int q = 0; q < NB; ++q) zero(acc[q]);
  ring<kStages, G::kStage>(
      smem, (hi - lo) * spb,
      [&](int s, float* st) {
        const int cb = work[lo + s / spb] % nb, k0 = (s % spb) * kBK;
        const size_t r = (size_t)cb * bc + k0;
        const int rows = min(kBK, bc - k0);
        tf32x3::stage<kBK, kBM, kBM, kThreads>(st, ae + r * lda, lda, rows,
                                               M - m0, vec & 1);
#pragma unroll
        for (int q = 0; q < NB; ++q)
          tf32x3::stage<kBK, G::kBN, G::kBN, kThreads>(
              st + G::kA + q * G::kB, be + r * ldb + q * boff, ldb, rows,
              N - n0, vec & 2);
      },
      [&](const float* st) {
#pragma unroll 1
        for (int k8 = 0; k8 < kBK; k8 += 8) {
          FragB fb[NB][G::kNt];
#pragma unroll
          for (int q = 0; q < NB; ++q)
            load_bs<false>(fb[q], st + G::kA + q * G::kB, G::kBN, wn, k8);
#pragma unroll
          for (int i = 0; i < kMt; ++i) {
            FragA fa;
            load_a1<true>(fa, st, kBM, wm + 16 * i, k8);
#pragma unroll
            for (int q = 0; q < NB; ++q) mma_m(acc[q][i], fa, fb[q]);
          }
        }
      });
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    float* oe = (q == 0 ? out0 : out1) + (size_t)e * M * N +
                (size_t)m0 * N + n0;
    for_each_pair<G::kNt>(wm, wn, [&](int r, int c, int i, int j, int hh) {
      if (r >= M - m0) return;
      store_pair(oe + (size_t)r * N, c, N - n0, acc[q][i][j][2 * hh],
                 acc[q][i][j][2 * hh + 1]);
    });
  }
}

template <int NB>
cudaError_t launch_dw(const float* a, int lda, size_t sa, int M,
                      const float* b, int ldb, size_t sb, int boff, int N,
                      const int32_t* work, float* out0, float* out1,
                      int n_tiles, int E, int nb, int bc, cudaStream_t st) {
  cudaError_t err = allow_smem(moe_bwd_dw_kernel<NB>, Dw<NB>::kSmem);
  if (err != cudaSuccess) return err;
  const int vec = vec_ok(a, lda) | vec_ok(b, ldb, boff) << 1;
  moe_bwd_dw_kernel<NB><<<dim3(ceil_div(N, Dw<NB>::kBN), ceil_div(M, kBM),
                               E),
                          kThreads, Dw<NB>::kSmem, st>>>(
      a, lda, sa, M, b, ldb, sb, boff, N, work, out0, out1, n_tiles, nb, bc,
      vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. tiles may be null (no
// executed-tile count). x, dy, dx: [E, C, D] with C = n_cb bc; bm [E, n_cb]
// (its first nb columns are read); dhg [E, nb bc, 2F], ah [E, nb bc, F];
// act 0 silu, 1 gelu, 2 relu. want: 1 dW_up, 2 dW_gate, 4 dW_down; the
// outputs (and ah, for dW_down) of the others are not touched and may be
// null.
int d2ft_moe_bwd_f32(const void* x, const void* wu, const void* wg,
                     const void* wd, const void* bm, const void* dy, void* dx,
                     void* dwu, void* dwg, void* dwd, void* dhg, void* ah,
                     void* work, void* tiles, int E, int C, int n_cb, int nb,
                     int bc, int D, int F, int act, int want, void* stream) {
  if (E <= 0 || bc <= 0 || n_cb <= 0 || C != n_cb * bc || nb <= 0 ||
      nb > n_cb || D <= 0 || F <= 0 || act < 0 || act > 2 || want < 0 ||
      want > 7)
    return cudaErrorInvalidValue;
  const int n_tiles = E * nb, Cb = nb * bc;
  if (n_tiles > 65535 || E > 65535 || ceil_div(bc, kBM) > 65535 ||
      ceil_div(D, kBM) > 65535 || ceil_div(F, kBM) > 65535)
    return cudaErrorInvalidValue;
  if (((want & 1) && dwu == nullptr) || ((want & 2) && dwg == nullptr) ||
      ((want & 4) && (dwd == nullptr || ah == nullptr)))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  int32_t* wl = static_cast<int32_t*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(moe_bwd_dmid_kernel, Nt::kSmem);
  if (err == cudaSuccess) err = allow_smem(moe_bwd_mid_kernel, BMid::kSmem);
  if (err == cudaSuccess) err = allow_smem(moe_bwd_dx_kernel, Nt::kSmem);
  if (err != cudaSuccess) return err;
  build_work_list<<<1, kListThreads, 0, st>>>(f(bm), E, n_cb, nb, wl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = ceil_div(bc, kBM);
  moe_bwd_dmid_kernel<<<dim3(ceil_div(F, Nt::kBN), rows, n_tiles), kThreads,
                        Nt::kSmem, st>>>(
      f(dy), f(wd), wl, o(dhg), C, Cb, nb, bc, D, F,
      vec_ok(dy, D) | vec_ok(wd, D) << 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool w4 = vec_ok(wu, F) && vec_ok(wg, F);
  moe_bwd_mid_kernel<<<dim3(ceil_div(F, BMid::kBN), rows, n_tiles), kThreads,
                       BMid::kSmem, st>>>(
      f(x), f(wu), f(wg), wl, o(dhg), (want & 4) ? o(ah) : nullptr, C, Cb,
      nb, bc, D, F, act, vec_ok(x, D) | w4 << 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_bwd_dx_kernel<<<dim3(ceil_div(D, Nt::kBN), rows, n_tiles), kThreads,
                      Nt::kSmem, st>>>(
      f(dhg), f(wu), f(wg), wl, o(dx),
      static_cast<unsigned long long*>(tiles), C, Cb, nb, bc, D, F,
      vec_ok(dhg, 2 * F, F) | w4 << 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dW_up and dW_gate: A = x [rows][D], B = dh | dg [rows][2F]
  const size_t sx = (size_t)C * D, sd = (size_t)Cb * 2 * F;
  if ((want & 3) == 3)
    err = launch_dw<2>(f(x), D, sx, D, f(dhg), 2 * F, sd, F, F, wl, o(dwu),
                       o(dwg), n_tiles, E, nb, bc, st);
  else if (want & 3)
    err = launch_dw<1>(f(x), D, sx, D, f(dhg) + ((want & 2) ? F : 0), 2 * F,
                       sd, 0, F, wl, (want & 1) ? o(dwu) : o(dwg), nullptr,
                       n_tiles, E, nb, bc, st);
  if (err != cudaSuccess) return err;
  // dW_down: A = a h [rows][F], B = dy [rows][D]
  if (want & 4)
    err = launch_dw<1>(f(ah), F, (size_t)Cb * F, F, f(dy), D, sx, 0, D, wl,
                       o(dwd), nullptr, n_tiles, E, nb, bc, st);
  return err;
}

const char* d2ft_moe_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
