// D2FT-gated SSD chunked scan, gate-aware backward, for Hopper (sm_90a),
// float32 accuracy on the tensor cores (3xTF32).
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_ssd.py::_bwd_kernel
// (launcher _backward). For each (sample, SSD head) slice with g_b != 0 it
// computes, from the saved operands, the forward's prevs and the cotangent
// dy, the cotangents dx [B,S,H,P], ddA [B,S,H], and dB, dC [B,S,N] summed
// over the heads (B and C are shared by them, as in the JAX VJP). A slice
// with g_b == 0, or past the dispatch bound, runs nothing and gets exact
// zeros in dx and ddA and nothing in dB and dC. The per-chunk algebra is
// the TPU kernel's, term for term:
//   cb = C B^T, gqk = dy x^T, L = causal exp(cum_q - cum_k)
//   dC = (gqk*L) B + e^cum dy . prev            dx = (cb*L)^T dy + d2e B ds^T
//   dB = (gqk*L)^T C + d2e x . ds               (d2e = exp(tot - cum))
//   dcum = rowsum(m) - colsum(m) + rowsum(dy * y_inter) - w,  m = gqk*cb*L
//   w = d2e * rowsum((B ds^T) * x),  dtot = e^tot sum(ds * prev) + sum(w)
//   ddA = reverse_cumsum(dcum) + dtot
// where ds is the cotangent of the state leaving the chunk:
//   ds_{nc-1} = 0,  ds_{c-1} = exp(tot_c) ds_c + sum_q e^{cum_q} dy_q^T C_q.
//
// What bounds it on this card: operations, ~46 MFLOP a live (slice, chunk)
// at Q = 256, P = 64, N = 128, and C.B^T once a (sample, chunk). Once the
// products run on the tensor cores, bytes come next: per-head dB and dC
// summed outside the kernels would move ~0.8 GB at B 8, S 2048, H 24, more
// time than the products' bound, so the kernels sum them over the heads.
//
// Design: the TPU kernel walks a slice's chunks in reverse grid order and
// carries ds in VMEM scratch. Here, as in Mamba-2's GPU backward, ds
// depends only on each chunk's own dy and C, so six kernels run in one
// launch call:
//   1. ssd_cb_kernel (d2ft_ssd_common.cuh): C.B^T once per (sample, chunk)
//      of a sample with a running slice, its causal tiles, into cb, on
//      float32 FMA in the plain version's order (the header says why);
//   2. ssd_chunk_state_kernel<.., true> (common), one block per (slice,
//      chunk): the chunk's cumulative decay (into cum) and
//      sum_q e^{cum_q} dy_q^T C_q into ds;
//   3. ssd_dstate_pass_kernel, one thread per state element of a slice:
//      the reverse recurrence over chunks, in place, giving ds_c, and the
//      chunk's sum(ds * prev) as a partial per warp of 32 elements;
//   4. ssd_bwd_kernel, one block per (sample, head group of kHeadGroup,
//      chunk, tile, role), the longest first. The q role owns a q tile's
//      rows: dC and the row sums of dcum. The k role owns a k tile's
//      rows: dB, dx and the column sums of dcum and w. Each loops over the
//      running heads of its group in order, so that dC (q role) and dB
//      (k role) are summed over those heads in registers, in a fixed order,
//      and a chunk's dC and dB rows are written by one block per group.
//      Items are staged one ahead: the head's prev or ds, then one item
//      per causal tile of the other kind (x and B rows or dy and C rows,
//      and the C.B^T tile). Splitting the roles keeps every output tile
//      summed in one block without two sweeps of the chunk per block;
//   5. ssd_dda_kernel, one block per (slice, chunk): dcum from the roles'
//      row parts, then ddA's reverse cumulative sum plus dtot, in double:
//      the sum cancels to values far below its terms (|ddA| ~ 200 from
//      terms of ~40 at Q = 256), so a float32 running sum would carry
//      sqrt(Q) roundings of its terms; it counts one executed (slice,
//      chunk) step;
//   6. ssd_group_sum_kernel, when H > kHeadGroup: dB and dC as the sum of
//      the groups' partials [B, G, S, N], in group order, in double.
// Every sum runs in a fixed order and no float atomics are taken: the
// backward is bitwise the same from call to call. The products run on
// mma.sync in 3xTF32, but for two on float32 FMA in the plain version's
// order: C.B^T (the common header says why) and g = dy x^T (fma_rows),
// because m = g o C.B^T o L reaches ddA through row and column sums that
// cancel (|ddA| ~ 200 from terms of ~40 at the N(0, 1) operands): a g
// computed in 3xTF32 moved ddA by 1.14e-4 against the plain version on the
// card, past the 1e-4 the kernels are held to. wgmma takes tf32 only with
// both operands K-major, which x and dy are not in the intra-chunk
// products.
//
// Launch contract: as d2ft_ssd_fwd.cu; the workspaces below are the
// caller's, unfilled.

#include "d2ft_ssd_common.cuh"

namespace {

using namespace ssd;

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_dstate_pass_kernel(
    const float* __restrict__ gate, float* __restrict__ ds,
    const float* __restrict__ prevs, const float* __restrict__ cumw,
    double* __restrict__ dsp, int n, int n_disp, int S, int Q) {
  static_assert((P * N) % kThreads == 0, "whole blocks of elements");
  constexpr long PN = (long)P * N;
  constexpr int kParts = P * N / 32;     // one partial sum a warp
  static_assert(kParts <= kThreads, "ssd_dda_kernel sums them in a block");
  const int s = blockIdx.x, nc = S / Q;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (!gating::slice_runs<kThreads>(gate, n, n_disp, s)) return;
  float* base = ds + s * nc * PN + e;
  const float* pv = prevs + s * nc * PN + e;
  const float* tot = cumw + (long)s * S + Q - 1;
  double* part = dsp + (long)s * nc * kParts + e / 32;
  float run = 0.f;
  // kPassBatch chunks' loads in flight before their recurrence, from the
  // last chunk back
  for (int c0 = nc - 1; c0 >= 0; c0 -= kPassBatch) {
    float v[kPassBatch], p[kPassBatch], dec[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 - j >= 0) {
        v[j] = base[(c0 - j) * PN];
        p[j] = pv[(c0 - j) * PN];
        dec[j] = expf(tot[(long)(c0 - j) * Q]);
      }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 - j >= 0) {
        base[(c0 - j) * PN] = run;       // cotangent of the state leaving c
        // this warp's share of sum(ds * prev) of chunk c, in a fixed order
        double sum = (double)(run * p[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if ((threadIdx.x & 31) == 0) part[(long)(c0 - j) * kParts] = sum;
        run = dec[j] * run + v[j];
      }
  }
}

template <int P, int N>
struct BwdSmem {
  static constexpr int pP = pitch_of(P), pN = pitch_of(N);
  static constexpr int kRows = kT * pN;  // C rows (q role) or B rows (k)
  static constexpr int kHead = kT * pP;  // dy rows (q) or x rows (k)
  // an item: prev / ds [P][pN], or x|dy rows, B|C rows, a C.B^T tile
  static constexpr int kTile = kT * pP + kT * pN + kT * kT;
  static constexpr int kSlot = P * pN > kTile ? P * pN : kTile;
  static constexpr size_t kBytes =
      sizeof(float) * (kRows + 2 * kHead + 2 * kSlot + kT * kT +
                       2 * kMaxQ + 2 * kT);
};

struct BwdArgs {
  const float *x, *Bm, *Cm, *dy, *prevs, *ds, *cumw, *cb, *gate;
  float *dx, *dbo, *dco;
  double *rowp, *colp, *wv;
  int n, n_disp, S, H, Q, G;
  bool vec;
};

// the i-th set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int i) {
  for (; i > 0; --i) m &= m - 1;
  return __ffs(m) - 1;
}

// q role: rows [64 qt, 64 qt + 64) of chunk c. Per running head: item 0
// stages dy rows (kept for the head), prev and the decays, and takes
// y_inter = C prev^T (its row sums with dy) and dC += (dy o e^cum) prev;
// item 1 + kt stages x and B rows of k tile kt and the C.B^T tile (qt, kt)
// and takes g = dy x^T (FMA), T = g o L (shared), m's row sums and
// dC += T B.
template <int P, int N>
__device__ __forceinline__ void bwd_rows(float* sm, const BwdArgs& a, int b,
                                         int grp, int c, int nc, int qt,
                                         unsigned run) {
  using Sm = BwdSmem<P, N>;
  constexpr int pP = Sm::pP, pN = Sm::pN;
  using LP = Lay<kT, P>;
  using LN = Lay<kT, N>;
  float* cs = sm;                        // [64][pN] C rows
  float* hb = cs + Sm::kRows;            // 2 x [64][pP] dy rows, by head
  float* ring = hb + 2 * Sm::kHead;      // 2 items
  float* tt = ring + 2 * Sm::kSlot;      // [64][64] g o L
  float* cum = tt + kT * kT;             // 2 x [256], by head
  float* red = cum + 2 * kMaxQ;          // [2][64] row partials
  const int S = a.S, H = a.H, Q = a.Q, nT = (Q + kT - 1) / kT;
  const int QP = nT * kT, qrows = min(kT, Q - qt * kT), h0 = grp * kHeadGroup;
  const long t0 = (long)b * S + (long)c * Q, q0 = t0 + qt * kT;
  const int per = qt + 2, items = __popc(run) * per;
  auto stage_item = [&](int it) {
    const int j = it / per, r = it % per, h = h0 + nth_bit(run, j);
    const long s = (long)b * H + h;
    float* sl = ring + (it & 1) * Sm::kSlot;
    if (r == 0) {
      if (it == 0) stage_tile<kT, N>(cs, a.Cm + q0 * N, N, qrows, a.vec);
      stage_tile<kT, P>(hb + (j & 1) * Sm::kHead, a.dy + (q0 * H + h) * P,
                        (long)H * P, qrows, a.vec);
      stage_tile<P, N>(sl, a.prevs + (s * nc + c) * P * N, N, P, a.vec);
      stage_cum(cum + (j & 1) * kMaxQ, a.cumw + s * S + (long)c * Q, Q);
    } else {
      const int kt = r - 1, rows = min(kT, Q - kt * kT);
      const long k0 = t0 + kt * kT;
      stage_tile<kT, P>(sl, a.x + (k0 * H + h) * P, (long)H * P, rows,
                        a.vec);
      stage_tile<kT, N>(sl + Sm::kHead, a.Bm + k0 * N, N, rows, a.vec);
      stage_tile<kT, kT>(sl + Sm::kHead + kT * pN,
                         a.cb + ((long)(b * nc + c) * QP + qt * kT) * QP +
                             kt * kT, QP, kT, true);
    }
  };
  float dc[LN::NT][4];
  zero(dc);
  double racc = 0.0;                     // thread r < 64: row r's share
  if (items > 0) stage_item(0);
  tf32x3::commit();
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) stage_item(it + 1);
    tf32x3::commit();
    tf32x3::wait<1>();
    __syncthreads();
    const int j = it / per, r = it % per, h = h0 + nth_bit(run, j);
    const float* dys = hb + (j & 1) * Sm::kHead;
    const float* cm = cum + (j & 1) * kMaxQ;
    const float* sl = ring + (it & 1) * Sm::kSlot;
    const int qa = qt * kT + LN::row0() + lane_g();   // rows qa, qa + 8
    if (r == 0) {
      const float e0 = qa < Q ? expf(cm[qa]) : 0.f;
      const float e8 = qa + 8 < Q ? expf(cm[qa + 8]) : 0.f;
      float yi[LP::NT][4];               // C_q . prev^T
      zero(yi);
      gemm<N>(yi,
              [&](tf32x3::FragA& f, int k0) {
                tf32x3::load_a(f, cs, pN, LP::row0(), k0);
              },
              [&](tf32x3::FragB& f, int k0, int jj) {
                tf32x3::load_b_nk(f, sl, pN, LP::col0() + 8 * jj, k0);
              });
      float r0 = 0.f, r8 = 0.f;
#pragma unroll
      for (int jj = 0; jj < LP::NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = dys[tf32x3::at(pP, acc_row<LP>(e),
                                         acc_col<LP>(jj, e))] *
                          (yi[jj][e] * (e < 2 ? e0 : e8));
          if (e < 2) r0 += v; else r8 += v;
        }
      rows_to_red<LP>(r0, r8, red);
      gemm<P>(dc,
              [&](tf32x3::FragA& f, int k0) {
                load_a_rows(f, dys, pP, LN::row0(), k0, e0, e8);
              },
              [&](tf32x3::FragB& f, int k0, int jj) {
                tf32x3::load_b_kn(f, sl, pN, k0, LN::col0() + 8 * jj);
              });
      __syncthreads();
      if (threadIdx.x < kT) racc += (double)row_total<LP>(red, threadIdx.x);
    } else {
      const int kt = r - 1;
      const float* xs = sl;
      const float* bs = sl + Sm::kHead;
      const float* cbt = bs + kT * pN;
      float g[4][4];                     // dy_q . x_k^T, on FMA
      fma_rows<P>(g, dys, xs, pP);
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
      float rs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rs[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int rr = 4 * ty + i, cc = tx + 16 * jj;
          const int ix = tf32x3::at(kT, rr, cc);
          const float L = decay(cm, qt * kT + rr, kt * kT + cc, Q);
          tt[ix] = g[i][jj] * L;
          rs[i] += (g[i][jj] * cbt[ix]) * L;
        }
      }
      rows16_to_red(rs, red);
      __syncthreads();
      if (threadIdx.x < kT) racc += (double)red[threadIdx.x];
      gemm<kT>(dc,
               [&](tf32x3::FragA& f, int k0) {
                 tf32x3::load_a(f, tt, kT, LN::row0(), k0);
               },
               [&](tf32x3::FragB& f, int k0, int jj) {
                 tf32x3::load_b_kn(f, bs, pN, k0, LN::col0() + 8 * jj);
               });
      if (r == per - 1) {                // the head's last item
        const int i = threadIdx.x;
        if (i < qrows)
          a.rowp[((long)b * H + h) * S + (long)c * Q + qt * kT + i] = racc;
        racc = 0.0;
      }
    }
    __syncthreads();
  }
  store_acc<LN>(dc, a.dco + (((long)b * a.G + grp) * S + (long)c * Q +
                             qt * kT) * N, N, qrows);
}

// k role: rows [64 kt, 64 kt + 64) of chunk c. Dead heads of the group
// get zero dx rows. Per running head: item 0 stages x rows (kept for the
// head), ds and the decays, and takes z = B ds^T, w = d2e rowsum(z o x),
// dx = d2e z and dB += (x o d2e) ds; item 1 + (qt - kt) stages dy and C
// rows of q tile qt and the C.B^T tile (qt, kt) and takes g^T = x dy^T
// (FMA), T = g^T o L (shared), m's column sums, the C.B^T tile times L in
// place, dB += T C and dx += (cb o L)^T dy.
template <int P, int N>
__device__ __forceinline__ void bwd_cols(float* sm, const BwdArgs& a, int b,
                                         int grp, int c, int nc, int kt,
                                         unsigned run) {
  using Sm = BwdSmem<P, N>;
  constexpr int pP = Sm::pP, pN = Sm::pN;
  using LP = Lay<kT, P>;
  using LN = Lay<kT, N>;
  float* bs = sm;                        // [64][pN] B rows
  float* hb = bs + Sm::kRows;            // 2 x [64][pP] x rows, by head
  float* ring = hb + 2 * Sm::kHead;
  float* tt = ring + 2 * Sm::kSlot;      // [64][64] g^T o L
  float* cum = tt + kT * kT;
  float* red = cum + 2 * kMaxQ;
  const int S = a.S, H = a.H, Q = a.Q, nT = (Q + kT - 1) / kT;
  const int QP = nT * kT, krows = min(kT, Q - kt * kT), h0 = grp * kHeadGroup;
  const int nh = min(kHeadGroup, H - h0);
  const long t0 = (long)b * S + (long)c * Q, k0r = t0 + kt * kT;
  for (int j = 0; j < nh; ++j)
    if (!((run >> j) & 1u))
      for (int i = threadIdx.x; i < krows * P; i += kThreads)
        a.dx[((k0r + i / P) * H + h0 + j) * P + i % P] = 0.f;
  const int per = 1 + (nT - kt), items = __popc(run) * per;
  auto stage_item = [&](int it) {
    const int j = it / per, r = it % per, h = h0 + nth_bit(run, j);
    const long s = (long)b * H + h;
    float* sl = ring + (it & 1) * Sm::kSlot;
    if (r == 0) {
      if (it == 0) stage_tile<kT, N>(bs, a.Bm + k0r * N, N, krows, a.vec);
      stage_tile<kT, P>(hb + (j & 1) * Sm::kHead, a.x + (k0r * H + h) * P,
                        (long)H * P, krows, a.vec);
      stage_tile<P, N>(sl, a.ds + (s * nc + c) * P * N, N, P, true);
      stage_cum(cum + (j & 1) * kMaxQ, a.cumw + s * S + (long)c * Q, Q);
    } else {
      const int qt = kt + r - 1, rows = min(kT, Q - qt * kT);
      const long q0 = t0 + qt * kT;
      stage_tile<kT, P>(sl, a.dy + (q0 * H + h) * P, (long)H * P, rows,
                        a.vec);
      stage_tile<kT, N>(sl + Sm::kHead, a.Cm + q0 * N, N, rows, a.vec);
      stage_tile<kT, kT>(sl + Sm::kHead + kT * pN,
                         a.cb + ((long)(b * nc + c) * QP + qt * kT) * QP +
                             kt * kT, QP, kT, true);
    }
  };
  float db[LN::NT][4], dxa[LP::NT][4];
  zero(db);
  zero(dxa);
  double cacc = 0.0;                     // thread r < 64: row r's colsum(m)
  if (items > 0) stage_item(0);
  tf32x3::commit();
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) stage_item(it + 1);
    tf32x3::commit();
    tf32x3::wait<1>();
    __syncthreads();
    const int j = it / per, r = it % per, h = h0 + nth_bit(run, j);
    const float* xs = hb + (j & 1) * Sm::kHead;
    const float* cm = cum + (j & 1) * kMaxQ;
    float* sl = ring + (it & 1) * Sm::kSlot;
    if (r == 0) {
      const float tot = cm[Q - 1];
      const int ka = kt * kT + LN::row0() + lane_g();  // rows ka, ka + 8
      const float d0 = ka < Q ? expf(tot - cm[ka]) : 0.f;
      const float d8 = ka + 8 < Q ? expf(tot - cm[ka + 8]) : 0.f;
      zero(dxa);                         // B_k . ds^T
      gemm<N>(dxa,
              [&](tf32x3::FragA& f, int k0) {
                tf32x3::load_a(f, bs, pN, LP::row0(), k0);
              },
              [&](tf32x3::FragB& f, int k0, int jj) {
                tf32x3::load_b_nk(f, sl, pN, LP::col0() + 8 * jj, k0);
              });
      float r0 = 0.f, r8 = 0.f;
#pragma unroll
      for (int jj = 0; jj < LP::NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = dxa[jj][e] * xs[tf32x3::at(pP, acc_row<LP>(e),
                                                     acc_col<LP>(jj, e))];
          if (e < 2) r0 += v; else r8 += v;
          dxa[jj][e] *= e < 2 ? d0 : d8;
        }
      rows_to_red<LP>(r0, r8, red);
      gemm<P>(db,
              [&](tf32x3::FragA& f, int k0) {
                load_a_rows(f, xs, pP, LN::row0(), k0, d0, d8);
              },
              [&](tf32x3::FragB& f, int k0, int jj) {
                tf32x3::load_b_kn(f, sl, pN, k0, LN::col0() + 8 * jj);
              });
      __syncthreads();
      const int i = threadIdx.x;
      if (i < krows) {
        const float w = row_total<LP>(red, i) *
                        expf(tot - cm[kt * kT + i]);
        a.wv[((long)b * H + h) * S + (long)c * Q + kt * kT + i] = (double)w;
      }
    } else {
      const int qt = kt + r - 1;
      const float* dys = sl;
      const float* cs = sl + Sm::kHead;
      float* cbt = sl + Sm::kHead + kT * pN;     // [q][k]
      float g[4][4];                     // x_k . dy_q^T, on FMA
      fma_rows<P>(g, xs, dys, pP);
      const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
      float rs[4];
      // each (k, q) has one owner thread, which also scales its C.B^T
      // element in place
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rs[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int rr = 4 * ty + i, cc = tx + 16 * jj;   // k, q
          const float L = decay(cm, qt * kT + cc, kt * kT + rr, Q);
          tt[tf32x3::at(kT, rr, cc)] = g[i][jj] * L;
          const int ix = tf32x3::at(kT, cc, rr);
          const float cbv = cbt[ix];
          rs[i] += (g[i][jj] * cbv) * L;
          cbt[ix] = cbv * L;
        }
      }
      rows16_to_red(rs, red);
      __syncthreads();
      if (threadIdx.x < kT) cacc += (double)red[threadIdx.x];
      gemm<kT>(db,
               [&](tf32x3::FragA& f, int k0) {
                 tf32x3::load_a(f, tt, kT, LN::row0(), k0);
               },
               [&](tf32x3::FragB& f, int k0, int jj) {
                 tf32x3::load_b_kn(f, cs, pN, k0, LN::col0() + 8 * jj);
               });
      gemm<kT>(dxa,
               [&](tf32x3::FragA& f, int k0) {
                 tf32x3::load_a_km(f, cbt, kT, k0, LP::row0());
               },
               [&](tf32x3::FragB& f, int k0, int jj) {
                 tf32x3::load_b_kn(f, dys, pP, k0, LP::col0() + 8 * jj);
               });
      if (r == per - 1) {                // the head's last item
        store_acc<LP>(dxa, a.dx + (k0r * H + h) * P, (long)H * P, krows);
        const int i = threadIdx.x;
        if (i < krows)
          a.colp[((long)b * H + h) * S + (long)c * Q + kt * kT + i] = cacc;
        cacc = 0.0;
      }
    }
    __syncthreads();
  }
  store_acc<LN>(db, a.dbo + (((long)b * a.G + grp) * S + (long)c * Q +
                             kt * kT) * N, N, krows);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / a.G, grp = blockIdx.x % a.G;
  const int c = blockIdx.y, nc = gridDim.y, z = blockIdx.z;
  const int nT = (a.Q + kT - 1) / kT, h0 = grp * kHeadGroup;
  const unsigned run = gating::runs_mask<kThreads>(
      a.gate, a.n, a.n_disp, b * a.H + h0, min(kHeadGroup, a.H - h0));
  // the longest first: q tiles from the last, k tiles from the first
  if ((z & 1) == 0)
    bwd_rows<P, N>(sm, a, b, grp, c, nc, nT - 1 - z / 2, run);
  else
    bwd_cols<P, N>(sm, a, b, grp, c, nc, z / 2, run);
}

__global__ void __launch_bounds__(kThreads) ssd_dda_kernel(
    const float* __restrict__ gate, const float* __restrict__ cumw,
    const double* __restrict__ dsp, const double* __restrict__ rowp,
    const double* __restrict__ colp, const double* __restrict__ wv,
    float* __restrict__ dda, unsigned long long* __restrict__ steps, int n,
    int n_disp, int S, int H, int Q, int n_parts) {
  __shared__ double dd[kMaxQ];
  __shared__ double red[kWarps], red2[kWarps];
  const int s = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = s / H, h = s % H, i = threadIdx.x;
  const long t0 = (long)b * S + (long)c * Q, u0 = (long)s * S + (long)c * Q;
  if (!gating::slice_runs<kThreads>(gate, n, n_disp, s)) {
    if (i < Q) dda[(t0 + i) * H + h] = 0.f;
    return;
  }
  double w = 0.0;
  if (i < Q) {
    w = wv[u0 + i];
    dd[i] = rowp[u0 + i] - colp[u0 + i] - w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
  if ((i & 31) == 0) red[i >> 5] = w;
  // sum(ds * prev) of the chunk from the pass's n_parts warp partials
  double pt = i < n_parts ? dsp[((long)s * nc + c) * n_parts + i] : 0.0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pt += __shfl_xor_sync(0xffffffffu, pt, o);
  if ((i & 31) == 0) red2[i >> 5] = pt;
  __syncthreads();
  if (i == 0) {
    double wsum = 0.0, dsprev = 0.0;
    for (int k = 0; k < kWarps; ++k) {
      wsum += red[k];
      dsprev += red2[k];
    }
    const double dtot = (double)expf(cumw[u0 + Q - 1]) * dsprev + wsum;
    double acc = 0.0;
    for (int q = Q - 1; q >= 0; --q) {
      acc += dd[q];
      dd[q] = acc + dtot;
    }
  }
  __syncthreads();
  if (i < Q) dda[(t0 + i) * H + h] = (float)dd[i];
  if (steps != nullptr && i == 0) atomicAdd(steps, 1ull);
}

// dB (z 0) and dC (z 1) of sample y: the G groups' partials summed in
// group order
__global__ void __launch_bounds__(kThreads) ssd_group_sum_kernel(
    const float* __restrict__ part, float* __restrict__ db,
    float* __restrict__ dc, int Bsz, int G, long SN) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y, which = blockIdx.z;
  if (i >= SN) return;
  const float* p = part + (long)(which * Bsz + b) * G * SN + i;
  double acc = 0.0;
  for (int g = 0; g < G; ++g) acc += p[(long)g * SN];
  (which ? dc : db)[(long)b * SN + i] = (float)acc;
}

// Each kernel's dynamic shared memory, its attribute set where it is
// over the 48 KB default.
template <int P, int N>
cudaError_t prepare_kernels(size_t (&smem)[6]) {
  for (size_t& b : smem) b = 0;
  smem[0] = cb_smem<N>();
  smem[1] = chunk_state_smem<P, N>();
  smem[3] = BwdSmem<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem[0]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<P, N, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem[1]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_kernel<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem[3]);
  return err;
}

// Blocks an SM holds of each kernel, in launch order.
template <int P, int N>
cudaError_t occupancy(int* out) {
  size_t smem[6];
  cudaError_t err = prepare_kernels<P, N>(smem);
  const void* fns[6] = {(const void*)ssd_cb_kernel<N>,
                        (const void*)ssd_chunk_state_kernel<P, N, true>,
                        (const void*)ssd_dstate_pass_kernel<P, N>,
                        (const void*)ssd_bwd_kernel<P, N>,
                        (const void*)ssd_dda_kernel,
                        (const void*)ssd_group_sum_kernel};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + i, fns[i],
                                                        kThreads, smem[i]);
  return err;
}

template <int P, int N>
cudaError_t launch(BwdArgs a, const float* da, float* cumw, float* cb,
                   float* dda, float* db, float* dc, float* ds, double* dsp,
                   float* part, unsigned long long* steps, int Bsz,
                   cudaStream_t stream) {
  const int n = a.n, nc = a.S / a.Q, nT = (a.Q + kT - 1) / kT;
  const int n_parts = P * N / 32;
  size_t smem[6];
  cudaError_t err = prepare_kernels<P, N>(smem);
  if (err != cudaSuccess) return err;
  const size_t sm_cb = smem[0], sm_st = smem[1], sm_bwd = smem[3];
  ssd_cb_kernel<N><<<dim3(nT, nc, Bsz), kThreads, sm_cb, stream>>>(
      a.Bm, a.Cm, a.gate, cb, n, a.n_disp, a.S, a.H, a.Q, a.vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_state_kernel<P, N, true>
      <<<dim3(n, nc), kThreads, sm_st, stream>>>(
          a.dy, da, a.Cm, a.gate, ds, cumw, nullptr, n, a.n_disp, a.S, a.H,
          a.Q, a.vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dstate_pass_kernel<P, N>
      <<<dim3(n, P * N / kThreads), kThreads, 0, stream>>>(
          a.gate, ds, a.prevs, cumw, dsp, n, a.n_disp, a.S, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  a.cumw = cumw;
  a.cb = cb;
  a.ds = ds;
  a.dbo = a.G > 1 ? part : db;
  a.dco = a.G > 1 ? part + (long)Bsz * a.G * a.S * N : dc;
  ssd_bwd_kernel<P, N>
      <<<dim3(Bsz * a.G, nc, 2 * nT), kThreads, sm_bwd, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dda_kernel<<<dim3(n, nc), kThreads, 0, stream>>>(
      a.gate, cumw, dsp, a.rowp, a.colp, a.wv, dda, steps, n, a.n_disp,
      a.S, a.H, a.Q, n_parts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.G > 1) {
    const long SN = (long)a.S * N;
    ssd_group_sum_kernel<<<dim3((unsigned)((SN + kThreads - 1) / kThreads),
                                Bsz, 2), kThreads, 0, stream>>>(
        part, db, dc, Bsz, a.G, SN);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. steps may be null.
// Workspaces: cum [B*H, S], cb [B, S/Q, QP, QP] (QP = 64 ceil(Q / 64)),
// ds [B*H, S/Q, P, N] float; dsp [B*H, S/Q, P*N/32], rowp, colp, wv
// [B*H, S] double; part [2, B, G, S, N] float when G > 1 (may be null at
// G 1). G must be ceil(H / 8), the head groups of the backward's blocks.
int d2ft_ssd_bwd_f32(const void* x, const void* da, const void* Bm,
                     const void* Cm, const void* gate, const void* prevs,
                     const void* dy, void* dx, void* dda, void* db, void* dc,
                     void* cum, void* cb, void* ds, void* dsp, void* rowp,
                     void* colp, void* wv, void* part, void* steps, int Bsz,
                     int n_disp, int S, int H, int P, int N, int Q, int G,
                     void* stream) {
  if (Bsz <= 0 || H <= 0 || n_disp <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ ||
      S % Q || G != (H + kHeadGroup - 1) / kHeadGroup ||
      (G > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto d = [](void* p) { return static_cast<double*>(p); };
  const void* staged[] = {x, Bm, Cm, prevs, dy, cb, ds};
  BwdArgs a{f(x), f(Bm), f(Cm), f(dy), f(prevs), nullptr, nullptr, nullptr,
            f(gate), w(dx), nullptr, nullptr, d(rowp), d(colp), d(wv),
            Bsz * H, n_disp, S, H, Q, G, vec_ok(staged, 7)};
  unsigned long long* st = static_cast<unsigned long long*>(steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 16 && N == 16)
    return launch<16, 16>(a, f(da), w(cum), w(cb), w(dda), w(db), w(dc),
                          w(ds), d(dsp), w(part), st, Bsz, s);
  if (P == 64 && N == 128)
    return launch<64, 128>(a, f(da), w(cum), w(cb), w(dda), w(db), w(dc),
                           w(ds), d(dsp), w(part), st, Bsz, s);
  return cudaErrorInvalidValue;
}

// Fills out[0..5] with the blocks an SM holds of the backward's kernels
// (C.B^T, chunk state, pass, roles, ddA, group sum) at (P, N); returns a
// cudaError_t.
int d2ft_ssd_bwd_occupancy(int P, int N, int* out) {
  if (P == 16 && N == 16) return occupancy<16, 16>(out);
  if (P == 64 && N == 128) return occupancy<64, 128>(out);
  return cudaErrorInvalidValue;
}

const char* d2ft_ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
