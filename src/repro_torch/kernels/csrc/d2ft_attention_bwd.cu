// D2FT gate-aware flash-attention backward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_attention.py::
// _bwd_fused_kernel (launcher _backward). Inputs per (sample, head) slice:
// q, k, v, o, do [N = B*H, S, hd], lse [N, S] from the forward, gate g_b
// [N]. Outputs dq, dk, dv [N, S, hd]. A slice with g_b == 0 (p_o and p_s)
// runs no product and writes exact zeros. With p = exp((q*scale) k^T -
// lse) under the forward's mask, delta = rowsum(do * o):
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - delta),
//   dq = ds k * scale,  dk = ds^T (q * scale).
//
// What bounds it on this card: operations (float32 FMA, 67 TFLOP/s with
// TF32 off), as for the forward; see d2ft_attention_fwd.cu.
//
// What the design does about the TPU design that does not carry over:
//  * The Pallas kernel keeps the whole per-slice dq [S, hd] resident in
//    VMEM across its (k tile, q tile) grid and accumulates into it, one
//    pass, 5 products per tile. Nothing carries over between Hopper blocks,
//    and f32 atomics on dq would sum in an order that changes from run to
//    run (the fine-tune's acceptance compares trajectories). So this takes
//    FA2's deterministic split into two kernels, launched in order on one
//    stream:
//      - the dQ kernel, one block per (dispatched slice, q tile), loops
//        over the k tiles: s, dp and ds*k, 3 products per live tile. It
//        also computes delta for its rows (the Pallas package leaves that
//        to XLA outside the kernel) and stores it for the next kernel;
//      - the dK/dV kernel, one block per (dispatched slice, k tile), loops
//        over the q tiles: s, p^T*do, dp and ds^T*q, 4 products per live
//        tile.
//    7 products per live tile in all, against the TPU kernel's 5.
//  * Compaction, odd S, tiles, thread layout and the executed-tile counter
//    are those of the forward (d2ft_attention_fwd.cu): blocks read their
//    slice id from live_permutation's int32 table, the ragged edge is
//    zero-filled in shared memory and masked by kpos < S (q rows past S get
//    lse = +2^30, so p = 0 there), and each kernel adds its executed tiles
//    to its own counter cell.
//
// Launch contract as for the forward: the caller checks and allocates
// (dq, dk, dv and the delta scratch [N, S]); the entry returns the first
// launch error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;
constexpr int kThreads = 256;             // 16 x 16
constexpr float kNegInf = -1073741824.0f;     // -2^30
constexpr float kLseMasked = 1073741824.0f;   // +2^30

__device__ __forceinline__ bool tile_live(int q0, int k0, int causal,
                                          int window, int S) {
  bool live = q0 < S && k0 < S;
  if (causal) live = live && k0 <= q0 + kB - 1;
  if (window > 0) live = live && k0 + kB - 1 > q0 - window;
  return live;
}

__device__ __forceinline__ bool elem_live(int qpos, int kpos, int causal,
                                          int window, int S) {
  bool m = kpos < S;
  if (causal) m = m && kpos <= qpos;
  if (window > 0) m = m && kpos > qpos - window;
  return m;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [0, kB) of a [*, HD] slab into shared [kB][HD + 1], times mul; rows
// at or past `rows` are zero
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows, float mul) {
  for (int i = threadIdx.x; i < kB * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r < rows ? src[(size_t)r * HD + d] * mul : 0.f;
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (HD + 1) + kB * (kB + 1));
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * kB * (HD + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
d2ft_attn_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ gate,
                        const int32_t* __restrict__ slice_idx,
                        float* __restrict__ dq, float* __restrict__ delta,
                        unsigned long long* __restrict__ tiles, int S,
                        int causal, int window, float scale) {
  constexpr int kLd = HD + 1;
  constexpr int kPd = kB + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [kB][kLd], pre-scaled
  float* do_s = q_s + kB * kLd;
  float* k_s = do_s + kB * kLd;
  float* v_s = k_s + kB * kLd;
  float* ds_s = v_s + kB * kLd;           // [kB][kPd]

  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  const int q0 = blockIdx.y * kB;
  const int rows = min(kB, S - q0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)n * S * HD;
  const size_t qoff = base + (size_t)q0 * HD;
  float* dqb = dq + qoff;

  if (gate[n] == 0.f) {                   // p_o / p_s slice: zeros
    for (int i = tid; i < rows * HD; i += kThreads) dqb[i] = 0.f;
    return;
  }

  load_tile<HD>(q_s, q + qoff, rows, scale);
  load_tile<HD>(do_s, dout + qoff, rows, 1.f);
  __syncthreads();

  float lse_r[4], delta_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float part = 0.f;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        part = fmaf(do_s[r * kLd + tx + 16 * c],
                    o[qoff + (size_t)r * HD + tx + 16 * c], part);
    }
    delta_r[i] = row_sum(part);
    lse_r[i] = r < rows ? lse[(size_t)n * S + q0 + r] : kLseMasked;
    if (tx == 0 && r < rows) delta[(size_t)n * S + q0 + r] = delta_r[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int executed = 0;
  const int n_k = (S + kB - 1) / kB;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kB;
    if (!tile_live(q0, k0, causal, window, S)) continue;
    ++executed;
    const int krows = min(kB, S - k0);
    __syncthreads();
    load_tile<HD>(k_s, k + base + (size_t)k0 * HD, krows, 1.f);
    load_tile<HD>(v_s, v + base + (size_t)k0 * HD, krows, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = q_s[(ty * 4 + i) * kLd + d];
        da[i] = do_s[(ty * 4 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = k_s[(tx + 16 * j) * kLd + d];
        vb[j] = v_s[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sv = elem_live(q0 + r, k0 + c, causal, window, S)
                             ? s[i][j] : kNegInf;
        const float p = expf(sv - lse_r[i]);
        ds_s[r * kPd + c] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kB; ++j) {
      float sa[4], kb[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = ds_s[(ty * 4 + i) * kPd + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kb[c] = k_s[j * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(sa[i], kb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dqb[(size_t)r * HD + tx + 16 * c] = acc[i][c] * scale;
    }
  }
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
d2ft_attn_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ gate,
                          const int32_t* __restrict__ slice_idx,
                          float* __restrict__ dk, float* __restrict__ dv,
                          unsigned long long* __restrict__ tiles, int S,
                          int causal, int window, float scale) {
  constexpr int kLd = HD + 1;
  constexpr int kPd = kB + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                      // [kB][kLd]
  float* v_s = k_s + kB * kLd;
  float* q_s = v_s + kB * kLd;            // pre-scaled
  float* do_s = q_s + kB * kLd;
  float* pt_s = do_s + kB * kLd;          // [kB keys][kPd]: p^T
  float* dst_s = pt_s + kB * kPd;         // ds^T
  float* lse_s = dst_s + kB * kPd;        // [kB]
  float* delta_s = lse_s + kB;            // [kB]

  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  const int k0 = blockIdx.y * kB;
  const int krows = min(kB, S - k0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t base = (size_t)n * S * HD;
  const size_t koff = base + (size_t)k0 * HD;
  float* dkb = dk + koff;
  float* dvb = dv + koff;

  if (gate[n] == 0.f) {
    for (int i = tid; i < krows * HD; i += kThreads) {
      dkb[i] = 0.f;
      dvb[i] = 0.f;
    }
    return;
  }

  load_tile<HD>(k_s, k + koff, krows, 1.f);
  load_tile<HD>(v_s, v + koff, krows, 1.f);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int executed = 0;
  const int n_q = (S + kB - 1) / kB;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kB;
    if (!tile_live(q0, k0, causal, window, S)) continue;
    ++executed;
    const int qrows = min(kB, S - q0);
    __syncthreads();
    load_tile<HD>(q_s, q + base + (size_t)q0 * HD, qrows, scale);
    load_tile<HD>(do_s, dout + base + (size_t)q0 * HD, qrows, 1.f);
    for (int r = tid; r < kB; r += kThreads) {
      lse_s[r] = r < qrows ? lse[(size_t)n * S + q0 + r] : kLseMasked;
      delta_s[r] = r < qrows ? delta[(size_t)n * S + q0 + r] : 0.f;
    }
    __syncthreads();

    // key rows ty*4 + i, query columns tx + 16*j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float ka[4], va[4], qb[4], db[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = k_s[(ty * 4 + i) * kLd + d];
        va[i] = v_s[(ty * 4 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qb[j] = q_s[(tx + 16 * j) * kLd + d];
        db[j] = do_s[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(qb[j], ka[i], st[i][j]);
          dpt[i][j] = fmaf(db[j], va[i], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float sv = elem_live(q0 + c, k0 + r, causal, window, S)
                             ? st[i][j] : kNegInf;
        const float p = expf(sv - lse_s[c]);
        pt_s[r * kPd + c] = p;
        dst_s[r * kPd + c] = p * (dpt[i][j] - delta_s[c]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float pa[4], sa[4], qb[kCols], db[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pt_s[(ty * 4 + i) * kPd + j];
        sa[i] = dst_s[(ty * 4 + i) * kPd + j];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        db[c] = do_s[j * kLd + tx + 16 * c];
        qb[c] = q_s[j * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[i][c] = fmaf(pa[i], db[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sa[i], qb[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < krows) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dkb[(size_t)r * HD + tx + 16 * c] = dk_acc[i][c];
        dvb[(size_t)r * HD + tx + 16 * c] = dv_acc[i][c];
      }
    }
  }
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   const void* gate, const void* slice_idx, void* dq,
                   void* dk, void* dv, void* delta, void* tiles_dkdv,
                   void* tiles_dq, int n_disp, int S, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<HD>();
  constexpr size_t smem_dkdv = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      d2ft_attn_bwd_dq_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(d2ft_attn_bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_disp, (S + kB - 1) / kB);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(gate);
  const int32_t* idx = static_cast<const int32_t*>(slice_idx);
  float* deltaf = static_cast<float*>(delta);
  d2ft_attn_bwd_dq_kernel<HD><<<grid, kThreads, smem_dq, stream>>>(
      qf, kf, vf, static_cast<const float*>(o), dof, lsef, gf, idx,
      static_cast<float*>(dq), deltaf,
      static_cast<unsigned long long*>(tiles_dq), S, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  d2ft_attn_bwd_dkdv_kernel<HD><<<grid, kThreads, smem_dkdv, stream>>>(
      qf, kf, vf, dof, lsef, deltaf, gf, idx, static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<unsigned long long*>(tiles_dkdv),
      S, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when both launches succeeded. slice_idx and the
// tile counters may be null.
int d2ft_attn_bwd_f32(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      const void* gate, const void* slice_idx, void* dq,
                      void* dk, void* dv, void* delta, void* tiles_dkdv,
                      void* tiles_dq, int n_disp, int S, int hd, int causal,
                      int window, float scale, void* stream) {
  if (n_disp <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk, dv,
                        delta, tiles_dkdv, tiles_dq, n_disp, S, causal,
                        window, scale, s);
    case 32:
      return launch<32>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk, dv,
                        delta, tiles_dkdv, tiles_dq, n_disp, S, causal,
                        window, scale, s);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk, dv,
                        delta, tiles_dkdv, tiles_dq, n_disp, S, causal,
                        window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk, dv,
                         delta, tiles_dkdv, tiles_dq, n_disp, S, causal,
                         window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* d2ft_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
