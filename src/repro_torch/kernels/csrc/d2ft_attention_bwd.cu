// D2FT gate-aware flash-attention backward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_attention.py::
// _bwd_fused_kernel (launcher _backward). Inputs per (sample, head) slice:
// q, k, v, o, do [N = B*H, S, hd], lse [N, S] from the forward, gate g_b
// [N]. Outputs dq, dk, dv [N, S, hd]. A slice with g_b == 0 (p_o and p_s)
// runs no product and writes exact zeros. With s = (q k^T) * scale and
// p = exp(s - lse) under the forward's mask, delta = rowsum(do * o):
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - delta),
//   dq = ds k * scale,  dk = ds^T q * scale.
//
// What bounds it on this card: operations. A live tile pair is 2 R W hd
// FLOPs a product against (R + W) hd * 4 bytes; the bytes the function
// must move are far fewer than its FLOPs over either compute rate. The
// products run on the tensor cores as 3xTF32 (tf32x3.cuh: float32
// accuracy, three TF32 products a step, 165 TFLOP/s of such work against
// 67 TFLOP/s of float32 FMA), and the kernel is held to that bound.
//
// What the design does about the TPU design that does not carry over:
//  * The Pallas kernel keeps the whole per-slice dq [S, hd] resident in
//    VMEM across its (k tile, q tile) grid and accumulates into it, one
//    pass, 5 products per tile. Nothing carries over between Hopper blocks,
//    and f32 atomics on dq would sum in an order that changes from run to
//    run (the fine-tune's acceptance compares trajectories). So this takes
//    FA2's deterministic split into a dQ role and a dK/dV role, every
//    gradient summed in one block in a fixed order:
//      - a dQ block holds 64 query rows and walks the key tiles: dp, s and
//        ds k, 3 products per live tile;
//      - a dK/dV block holds 64 key rows and walks the query tiles: dp^T,
//        s^T, p^T do and ds^T q, 4 products per live tile.
//    7 products per live tile in all, against the TPU kernel's 5. delta =
//    rowsum(do * o) comes first from a small kernel of its own (the Pallas
//    package leaves it to XLA outside the kernel), so both roles run in
//    ONE launch: block row 2 i is dK/dV's key tile i, 2 i + 1 dQ's query
//    tile n_t - 1 - i. Under a causal mask those are the longest walks
//    first, so the short blocks of both roles fill the grid's tail (with
//    one block an SM, two launches in turn left the card idle at the tail
//    of each, most under a causal mask, whose walks differ most).
//  * Every product is a warp-level mma.sync m16n8k8 in 3xTF32 from
//    swizzled shared tiles that no fragment read conflicts on, A read with
//    ldmatrix (tf32x3.cuh). The tensor core's truncating float32 sum is
//    kept to two k-steps in the score products and one in the gradient
//    products, then added in IEEE float32 (tf32x3::mma3). 8 warps; the
//    score tiles (R x W) as 4 x 2 warps of 16 x W/2, the accumulators (R x
//    hd: dq, or dk and dv) as 2 x 4 warps of 32 x hd/4 (4 x 2 of 16 x hd/2
//    at hd 16 and 80, whose hd / 8 n-tiles do not split in 4), held in
//    registers across the walk. Rows of hd 80 are padded to a pitch of 96
//    floats in shared memory (the swizzle permutes within 32-float groups).
//  * Tiles are rectangular: R = 64 resident rows against a walked tile of
//    W = 64 rows up to hd 128 and W = 32 at hd 256. At hd 256 the resident
//    q and do (dQ) or k and v (dK/dV) take 128 KB, a walked pair 64 KB and
//    the score tiles 8 / 16 KB: 205,312 and 213,248 bytes of the 232,448 a
//    block may take, so there is no room for a second walked stage (a
//    64-row walked tile, or two 32-row stages, would need 270 KB). Instead
//    the walked pair streams through cp.async one half at a time, each
//    half's next tile loaded while the other half is still in use: dQ
//    computes dp first (v), then s, ds and ds k (k), so v(next) loads
//    during s, ds and ds k and k(next) during the next dp; dK/dV computes
//    dp^T (do) and s^T (q), then p^T do, loads do(next) during ds^T q and
//    q(next) during the next dp^T. One code path for every hd.
//  * Registers: the dK/dV role holds dk and dv, 2 x 64 hd / 256 floats a
//    thread (128 at hd 256), so the merged kernel takes 255 registers at
//    hd 256, 211 at hd 128 and 115-159 below, with no spills (-Xptxas -v).
//    Capping hd 64 at 128 registers for two blocks an SM spilled and ran
//    no faster, so every hd takes one block of 8 warps an SM.
//  * Compaction and odd S are those of the forward (d2ft_attention_fwd.cu):
//    blocks read their slice id from live_permutation's int32 table; the
//    ragged edge is zero-filled by the copies and masked by qpos, kpos < S
//    (p = 0 there, and where the forward's lse is +2^30). Each role adds
//    its executed (resident, walked) tile pairs to its own counter cell;
//    the host's accounting (kernel_block(hd, kind), kernel_live_tiles,
//    kernel_flops) uses the same tiles.
//  * q, k, v, o and do must be 16-byte aligned (the launcher copies a
//    tensor that is not); every row is hd floats, a multiple of 4.
//
// Launch contract as for the forward: the caller checks and allocates
// (dq, dk, dv and the delta scratch [N, S]); the entry launches the delta
// kernel, then the two roles, and returns the first launch error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::at;

constexpr int kThreads = 256;
constexpr int kRes = 64;                      // resident rows a block

// the walked tile, and the shapes of each warp's work
template <int HD>
struct Geo {
  static constexpr int kW = HD > 128 ? 32 : 64;       // walked rows
  // row pitch, floats: a multiple of 32 for the swizzle (hd 80 takes 96)
  static constexpr int kHp = (HD + 31) / 32 * 32;
  static constexpr int kSnt = kW / 16;                // score n-tiles a warp
  // accumulator warps along the columns: 4, or 2 where hd / 8 n-tiles do
  // not split in 4 (hd 16: 2 n-tiles; hd 80: 10)
  static constexpr int kOwn = (HD / 8) % 4 == 0 ? 4 : 2;
  static constexpr int kOmt = kRes / 16 / (8 / kOwn);  // m-tiles a warp
  static constexpr int kOnt = HD / 8 / kOwn;           // n-tiles a warp
  static_assert(kOnt * kOwn * 8 == HD, "accumulator columns");
  // the dK/dV role's (two score tiles) is the larger
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kRes * kHp + 2 * kW * kHp + 2 * kRes * kW + 2 * kW);
  static_assert(sizeof(float) * (2 * kRes * kHp + 2 * kW * kHp + kRes * kW +
                                 2 * kRes) <= kSmem &&
                kSmem <= 232448,
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
  bool m = qpos < S && kpos < S;
  if (causal) m = m && kpos <= qpos;
  if (window > 0) m = m && kpos > qpos - window;
  return m;
}

// acc[i][j] += A[a_row0 + 16 i, k] B[k, b_col0 + 8 j] over k in [0, K),
// A from a [m][k] tile, B from a [k][n] tile
template <int MT, int NT, int K>
__device__ __forceinline__ void mma_kn(float (&acc)[MT][NT][4],
                                       const float* as, int a_pitch,
                                       int a_row0, const float* bs,
                                       int b_pitch, int b_col0) {
#pragma unroll 1
  for (int k8 = 0; k8 < K; k8 += 8) {
    FragA fa[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      tf32x3::load_a(fa[i], as, a_pitch, a_row0 + 16 * i, k8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragB fb;
      tf32x3::load_b_kn(fb, bs, b_pitch, k8, b_col0 + 8 * j);
#pragma unroll
      for (int i = 0; i < MT; ++i) tf32x3::mma3(acc[i][j], fa[i], fb);
    }
  }
}

// acc[j] += A[a_row0 : +16, :] B[b_row0 + 8 j : +8, :]^T over HD, both
// [row][hd] tiles (a score tile's 16 x 8 n-tiles). Two k-steps a fresh
// tensor-core accumulator, then one IEEE add (tf32x3::mma3 says why).
template <int NT, int HD>
__device__ __forceinline__ void mma_nk(float (&acc)[NT][4], const float* as,
                                       int a_row0, const float* bs,
                                       int b_row0) {
  constexpr int kHp = Geo<HD>::kHp;
#pragma unroll 1
  for (int d16 = 0; d16 < HD; d16 += 16) {
    FragA fa[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tf32x3::load_a(fa[h], as, kHp, a_row0, d16 + 8 * h);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        FragB fb;
        tf32x3::load_b_nk(fb, bs, kHp, b_row0 + 8 * j, d16 + 8 * h);
        tf32x3::mma3_into(t, fa[h], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += t[e];
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// rows [row0, row0 + rows) of a [*, HD] slab into a swizzled tile
template <int ROWS, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows) {
  tf32x3::stage<ROWS, HD, Geo<HD>::kHp, kThreads>(dst, src, HD, rows, HD,
                                                  true);
}

// the accumulators' rows < rows to out [rows, HD], times mul
template <int MT, int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[MT][NT][4],
                                          float* out, int HD, int row0,
                                          int col0, int rows, float mul) {
  const int g = tf32x3::lane_id() >> 2, t = tf32x3::lane_id() & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * i + g + 8 * h;
        if (r < rows) {
          float2 val = make_float2(acc[i][j][2 * h] * mul,
                                   acc[i][j][2 * h + 1] * mul);
          *reinterpret_cast<float2*>(out + (size_t)r * HD + col0 + 8 * j +
                                     2 * t) = val;
        }
      }
}

// delta = rowsum(do * o) of 64 rows a block, one warp a row
template <int HD>
__global__ void __launch_bounds__(kThreads)
d2ft_attn_bwd_delta_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ gate,
                           const int32_t* __restrict__ slice_idx,
                           float* __restrict__ delta, int S) {
  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  if (gate[n] == 0.f) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = blockIdx.y * kRes + warp;
       r < min(S, (int)(blockIdx.y + 1) * kRes); r += kThreads / 32) {
    const size_t row = ((size_t)n * S + r) * HD;
    float part = 0.f;
    for (int c = lane; c < HD; c += 32)
      part = fmaf(dout[row + c], o[row + c], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) delta[(size_t)n * S + r] = part;
  }
}

// The dQ role: dq rows [q0, q0 + 64) of slice n, walking the key tiles.
template <int HD>
__device__ __forceinline__ void dq_block(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int n,
    int q0, float* __restrict__ dq, unsigned long long* __restrict__ tiles,
    int S, int causal, int window, float scale) {
  using G = Geo<HD>;
  constexpr int kW = G::kW, kHp = G::kHp;
  float* q_s = smem;                      // [kRes][kHp], resident
  float* do_s = q_s + kRes * kHp;
  float* k_s = do_s + kRes * kHp;         // [kW][kHp], walked
  float* v_s = k_s + kW * kHp;
  float* ds_s = v_s + kW * kHp;           // [kRes][kW]
  float* lse_s = ds_s + kRes * kW;        // [kRes]
  float* delta_s = lse_s + kRes;          // [kRes]

  const int rows = min(kRes, S - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)n * S * HD;
  const size_t qoff = base + (size_t)q0 * HD;
  const int n_k = (S + kW - 1) / kW;
  auto next_live = [&](int kt) {
    while (kt < n_k &&
           !tile_live(q0, kRes, kt * kW, kW, causal, window, S))
      ++kt;
    return kt;
  };
  auto stage_k = [&](int kt) {
    stage_rows<kW, HD>(k_s, k + base + (size_t)kt * kW * HD,
                       min(kW, S - kt * kW));
  };
  auto stage_v = [&](int kt) {
    stage_rows<kW, HD>(v_s, v + base + (size_t)kt * kW * HD,
                       min(kW, S - kt * kW));
  };

  stage_rows<kRes, HD>(q_s, q + qoff, rows);
  stage_rows<kRes, HD>(do_s, dout + qoff, rows);
  tf32x3::commit();
  int kt = next_live(0);
  if (kt < n_k) stage_v(kt);
  tf32x3::commit();
  if (kt < n_k) stage_k(kt);
  tf32x3::commit();
  for (int r = tid; r < kRes; r += kThreads) {
    lse_s[r] = r < rows ? lse[(size_t)n * S + q0 + r] : 0.f;
    delta_s[r] = r < rows ? delta[(size_t)n * S + q0 + r] : 0.f;
  }

  // score tile: warp rows sr0 + [0, 16), columns sc0 + [0, kW / 2);
  // accumulator: rows or0 + [0, 16 kOmt), columns oc0 + [0, 8 kOnt)
  const int sr0 = (warp >> 1) * 16, sc0 = (warp & 1) * (kW / 2);
  const int or0 = (warp / G::kOwn) * 16 * G::kOmt;
  const int oc0 = (warp % G::kOwn) * 8 * G::kOnt;
  float acc[G::kOmt][G::kOnt][4];
  zero(acc);

  int executed = 0;
  while (kt < n_k) {
    ++executed;
    const int k0 = kt * kW;
    tf32x3::wait<1>();
    __syncthreads();                      // q, do, v(kt) landed
    float dp[1][G::kSnt][4], s[1][G::kSnt][4];
    zero(dp);
    zero(s);
    mma_nk<G::kSnt, HD>(dp[0], do_s, sr0, v_s, sc0);
    __syncthreads();                      // v_s read by every warp
    const int nxt = next_live(kt + 1);
    if (nxt < n_k) stage_v(nxt);
    tf32x3::commit();
    tf32x3::wait<1>();
    __syncthreads();                      // k(kt) landed
    mma_nk<G::kSnt, HD>(s[0], q_s, sr0, k_s, sc0);
#pragma unroll
    for (int j = 0; j < G::kSnt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = sr0 + g + 8 * (e >> 1);
        const int c = sc0 + 8 * j + 2 * t + (e & 1);
        const float p = elem_live(q0 + r, k0 + c, causal, window, S)
                            ? expf(s[0][j][e] * scale - lse_s[r]) : 0.f;
        ds_s[at(kW, r, c)] = p * (dp[0][j][e] - delta_s[r]);
      }
    __syncthreads();                      // ds complete
    mma_kn<G::kOmt, G::kOnt, kW>(acc, ds_s, kW, or0, k_s, kHp, oc0);
    __syncthreads();                      // k_s and ds_s read
    if (nxt < n_k) stage_k(nxt);
    tf32x3::commit();
    kt = nxt;
  }
  tf32x3::wait<0>();

  store_acc(acc, dq + qoff, HD, or0, oc0, rows, scale);
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

// The dK/dV role: dk, dv rows [k0, k0 + 64) of slice n, walking the query
// tiles.
template <int HD>
__device__ __forceinline__ void dkdv_block(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int n,
    int k0, float* __restrict__ dk, float* __restrict__ dv,
    unsigned long long* __restrict__ tiles, int S, int causal, int window,
    float scale) {
  using G = Geo<HD>;
  constexpr int kW = G::kW, kHp = G::kHp;
  float* k_s = smem;                      // [kRes][kHp], resident
  float* v_s = k_s + kRes * kHp;
  float* q_s = v_s + kRes * kHp;          // [kW][kHp], walked
  float* do_s = q_s + kW * kHp;
  float* pt_s = do_s + kW * kHp;          // [kRes keys][kW]: p^T
  float* dst_s = pt_s + kRes * kW;        // ds^T
  float* lse_s = dst_s + kRes * kW;       // [kW]
  float* delta_s = lse_s + kW;            // [kW]

  const int krows = min(kRes, S - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)n * S * HD;
  const size_t koff = base + (size_t)k0 * HD;
  const int n_q = (S + kW - 1) / kW;
  auto next_live = [&](int qt) {
    while (qt < n_q &&
           !tile_live(qt * kW, kW, k0, kRes, causal, window, S))
      ++qt;
    return qt;
  };
  auto stage_do = [&](int qt) {
    stage_rows<kW, HD>(do_s, dout + base + (size_t)qt * kW * HD,
                       min(kW, S - qt * kW));
  };
  auto stage_q = [&](int qt) {            // q rows with their lse, delta
    const int q0 = qt * kW, qrows = min(kW, S - q0);
    stage_rows<kW, HD>(q_s, q + base + (size_t)q0 * HD, qrows);
    for (int r = tid; r < kW; r += kThreads) {
      const size_t i = (size_t)n * S + q0 + min(r, qrows - 1);
      tf32x3::cp_async4(lse_s + r, lse + i, r < qrows ? 4 : 0);
      tf32x3::cp_async4(delta_s + r, delta + i, r < qrows ? 4 : 0);
    }
  };

  stage_rows<kRes, HD>(k_s, k + koff, krows);
  stage_rows<kRes, HD>(v_s, v + koff, krows);
  tf32x3::commit();
  int qt = next_live(0);
  if (qt < n_q) stage_do(qt);
  tf32x3::commit();
  if (qt < n_q) stage_q(qt);
  tf32x3::commit();

  // score tile: key rows sr0 + [0, 16), query columns sc0 + [0, kW / 2);
  // accumulators: key rows or0 + [0, 16 kOmt), columns oc0 + [0, 8 kOnt)
  const int sr0 = (warp >> 1) * 16, sc0 = (warp & 1) * (kW / 2);
  const int or0 = (warp / G::kOwn) * 16 * G::kOmt;
  const int oc0 = (warp % G::kOwn) * 8 * G::kOnt;
  float dk_acc[G::kOmt][G::kOnt][4], dv_acc[G::kOmt][G::kOnt][4];
  zero(dk_acc);
  zero(dv_acc);

  int executed = 0;
  while (qt < n_q) {
    ++executed;
    const int q0 = qt * kW;
    tf32x3::wait<1>();
    __syncthreads();                      // k, v and do(qt) landed
    float dpt[1][G::kSnt][4], st[1][G::kSnt][4];
    zero(dpt);
    zero(st);
    mma_nk<G::kSnt, HD>(dpt[0], v_s, sr0, do_s, sc0);
    tf32x3::wait<0>();
    __syncthreads();                      // q(qt), lse, delta landed
    mma_nk<G::kSnt, HD>(st[0], k_s, sr0, q_s, sc0);
#pragma unroll
    for (int j = 0; j < G::kSnt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = sr0 + g + 8 * (e >> 1);          // key
        const int c = sc0 + 8 * j + 2 * t + (e & 1);   // query
        const float p = elem_live(q0 + c, k0 + r, causal, window, S)
                            ? expf(st[0][j][e] * scale - lse_s[c]) : 0.f;
        pt_s[at(kW, r, c)] = p;
        dst_s[at(kW, r, c)] = p * (dpt[0][j][e] - delta_s[c]);
      }
    __syncthreads();                      // p^T and ds^T complete
    mma_kn<G::kOmt, G::kOnt, kW>(dv_acc, pt_s, kW, or0, do_s, kHp, oc0);
    __syncthreads();                      // do_s read by every warp
    const int nxt = next_live(qt + 1);
    if (nxt < n_q) stage_do(nxt);
    tf32x3::commit();
    mma_kn<G::kOmt, G::kOnt, kW>(dk_acc, dst_s, kW, or0, q_s, kHp, oc0);
    __syncthreads();                      // q_s, tiles, lse, delta read
    if (nxt < n_q) stage_q(nxt);
    tf32x3::commit();
    qt = nxt;
  }
  tf32x3::wait<0>();

  store_acc(dk_acc, dk + koff, HD, or0, oc0, krows, scale);
  store_acc(dv_acc, dv + koff, HD, or0, oc0, krows, 1.f);
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

// One launch for both roles: blockIdx.y = 2 i takes dK/dV's key tile i,
// 2 i + 1 dQ's query tile n_t - 1 - i. Under a causal mask those are the
// longest walks first (key tile 0 and the last query tile walk every
// tile), so the short ones fill the tail of the grid.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
d2ft_attn_bwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ gate,
                     const int32_t* __restrict__ slice_idx,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ dv,
                     unsigned long long* __restrict__ tiles_dkdv,
                     unsigned long long* __restrict__ tiles_dq, int S,
                     int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  const bool is_dq = blockIdx.y & 1;
  const int n_t = gridDim.y / 2;
  const int r0 = (is_dq ? n_t - 1 - blockIdx.y / 2 : blockIdx.y / 2) * kRes;
  const int rows = min(kRes, S - r0);
  const size_t off = ((size_t)n * S + r0) * HD;
  if (gate[n] == 0.f) {                   // p_o / p_s slice: zeros
    for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
      if (is_dq) {
        dq[off + i] = 0.f;
      } else {
        dk[off + i] = 0.f;
        dv[off + i] = 0.f;
      }
    }
    return;
  }
  if (is_dq)
    dq_block<HD>(smem, q, k, v, dout, lse, delta, n, r0, dq, tiles_dq, S,
                 causal, window, scale);
  else
    dkdv_block<HD>(smem, q, k, v, dout, lse, delta, n, r0, dk, dv,
                   tiles_dkdv, S, causal, window, scale);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   const void* gate, const void* slice_idx, void* dq,
                   void* dk, void* dv, void* delta, void* tiles_dkdv,
                   void* tiles_dq, int n_disp, int S, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Geo<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      d2ft_attn_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_t = (S + kRes - 1) / kRes;
  const float* gf = static_cast<const float*>(gate);
  const int32_t* idx = static_cast<const int32_t*>(slice_idx);
  float* deltaf = static_cast<float*>(delta);
  d2ft_attn_bwd_delta_kernel<HD><<<dim3(n_disp, n_t), kThreads, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), gf, idx,
      deltaf, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  d2ft_attn_bwd_kernel<HD><<<dim3(n_disp, 2 * n_t), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), deltaf, gf, idx,
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<unsigned long long*>(tiles_dkdv),
      static_cast<unsigned long long*>(tiles_dq), S, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when every launch succeeded. slice_idx and the
// tile counters may be null. The tiles (64 resident rows; 64 walked, or 32
// at hd 256) must be the caller's kernel_block(hd, "bwd_dq" / "bwd_dkdv").
int d2ft_attn_bwd_f32(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      const void* gate, const void* slice_idx, void* dq,
                      void* dk, void* dv, void* delta, void* tiles_dkdv,
                      void* tiles_dq, int n_disp, int S, int hd, int causal,
                      int window, float scale, void* stream) {
  if (n_disp <= 0 || S <= 0) return cudaErrorInvalidValue;
  auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if ((bits(q) | bits(k) | bits(v) | bits(o) | bits(dout)) & 15)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define D2FT_BWD_CASE(HD)                                                    \
  case HD:                                                                   \
    return launch<HD>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk, dv,    \
                      delta, tiles_dkdv, tiles_dq, n_disp, S, causal, window, \
                      scale, s);
    D2FT_BWD_CASE(16)
    D2FT_BWD_CASE(32)
    D2FT_BWD_CASE(64)
    D2FT_BWD_CASE(80)
    D2FT_BWD_CASE(96)
    D2FT_BWD_CASE(128)
    D2FT_BWD_CASE(256)
#undef D2FT_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

const char* d2ft_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
