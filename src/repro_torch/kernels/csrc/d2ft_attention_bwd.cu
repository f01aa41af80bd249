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
//  * Tiles at hd 256: 64-row tiles of four [64, 257] float slabs plus the
//    score tiles take 279,808 (dQ) and 296,960 (dK/dV) bytes of shared
//    memory, over the 232,448 a block may take. So the tile is a function
//    of hd, as in the forward: KB = 64 up to hd 128 and 32 at hd 256
//    (135,808 and 140,288 bytes). The 32-row tile keeps every operand of a
//    tile pair in shared memory and the products unchanged; it halves the
//    reuse of each loaded k / q row (16-24 FLOP per byte loaded, most of
//    it from L2, since every tile of a slice reads the same rows). The
//    host's accounting (kernel_block, kernel_flops, kernel_live_tiles) and
//    the tile counter use the same KB.
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

constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.0f;     // -2^30
constexpr float kLseMasked = 1073741824.0f;   // +2^30

// thread layout of a KB x KB tile: kTy rows of threads, 4 rows each; kTx
// lanes share a row, each owning kSc columns tx + kTx*j
template <int KB>
struct Layout {
  static constexpr int kTy = KB / 4;
  static constexpr int kTx = kThreads / kTy;
  static constexpr int kSc = KB / kTx;
};

template <int KB>
__device__ __forceinline__ bool tile_live(int q0, int k0, int causal,
                                          int window, int S) {
  bool live = q0 < S && k0 < S;
  if (causal) live = live && k0 <= q0 + KB - 1;
  if (window > 0) live = live && k0 + KB - 1 > q0 - window;
  return live;
}

__device__ __forceinline__ bool elem_live(int qpos, int kpos, int causal,
                                          int window, int S) {
  bool m = kpos < S;
  if (causal) m = m && kpos <= qpos;
  if (window > 0) m = m && kpos > qpos - window;
  return m;
}

template <int kTx>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kTx / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [0, KB) of a [*, HD] slab into shared [KB][HD + 1], times mul; rows
// at or past `rows` are zero
template <int KB, int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int rows, float mul) {
  for (int i = threadIdx.x; i < KB * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r < rows ? src[(size_t)r * HD + d] * mul : 0.f;
  }
}

template <int KB, int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * KB * (HD + 1) + KB * (KB + 1));
}

template <int KB, int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * KB * (HD + 1) + 2 * KB * (KB + 1) + 2 * KB);
}

template <int KB, int HD>
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
  constexpr int kTx = Layout<KB>::kTx;
  constexpr int kSc = Layout<KB>::kSc;
  constexpr int kLd = HD + 1;
  constexpr int kPd = KB + 1;
  constexpr int kCols = HD / kTx;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [KB][kLd], pre-scaled
  float* do_s = q_s + KB * kLd;
  float* k_s = do_s + KB * kLd;
  float* v_s = k_s + KB * kLd;
  float* ds_s = v_s + KB * kLd;           // [KB][kPd]

  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  const int q0 = blockIdx.y * KB;
  const int rows = min(KB, S - q0);
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const size_t base = (size_t)n * S * HD;
  const size_t qoff = base + (size_t)q0 * HD;
  float* dqb = dq + qoff;

  if (gate[n] == 0.f) {                   // p_o / p_s slice: zeros
    for (int i = tid; i < rows * HD; i += kThreads) dqb[i] = 0.f;
    return;
  }

  load_tile<KB, HD>(q_s, q + qoff, rows, scale);
  load_tile<KB, HD>(do_s, dout + qoff, rows, 1.f);
  __syncthreads();

  float lse_r[4], delta_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    float part = 0.f;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        part = fmaf(do_s[r * kLd + tx + kTx * c],
                    o[qoff + (size_t)r * HD + tx + kTx * c], part);
    }
    delta_r[i] = row_sum<kTx>(part);
    lse_r[i] = r < rows ? lse[(size_t)n * S + q0 + r] : kLseMasked;
    if (tx == 0 && r < rows) delta[(size_t)n * S + q0 + r] = delta_r[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int executed = 0;
  const int n_k = (S + KB - 1) / KB;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * KB;
    if (!tile_live<KB>(q0, k0, causal, window, S)) continue;
    ++executed;
    const int krows = min(KB, S - k0);
    __syncthreads();
    load_tile<KB, HD>(k_s, k + base + (size_t)k0 * HD, krows, 1.f);
    load_tile<KB, HD>(v_s, v + base + (size_t)k0 * HD, krows, 1.f);
    __syncthreads();

    float s[4][kSc], dp[4][kSc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSc; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], da[4], kb[kSc], vb[kSc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = q_s[(ty * 4 + i) * kLd + d];
        da[i] = do_s[(ty * 4 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kSc; ++j) {
        kb[j] = k_s[(tx + kTx * j) * kLd + d];
        vb[j] = v_s[(tx + kTx * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kSc; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < kSc; ++j) {
        const int c = tx + kTx * j;
        const float sv = elem_live(q0 + r, k0 + c, causal, window, S)
                             ? s[i][j] : kNegInf;
        const float p = expf(sv - lse_r[i]);
        ds_s[r * kPd + c] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < KB; ++j) {
      float sa[4], kb[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = ds_s[(ty * 4 + i) * kPd + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kb[c] = k_s[j * kLd + tx + kTx * c];
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
        dqb[(size_t)r * HD + tx + kTx * c] = acc[i][c] * scale;
    }
  }
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

template <int KB, int HD>
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
  constexpr int kTx = Layout<KB>::kTx;
  constexpr int kSc = Layout<KB>::kSc;
  constexpr int kLd = HD + 1;
  constexpr int kPd = KB + 1;
  constexpr int kCols = HD / kTx;
  extern __shared__ float smem[];
  float* k_s = smem;                      // [KB][kLd]
  float* v_s = k_s + KB * kLd;
  float* q_s = v_s + KB * kLd;            // pre-scaled
  float* do_s = q_s + KB * kLd;
  float* pt_s = do_s + KB * kLd;          // [KB keys][kPd]: p^T
  float* dst_s = pt_s + KB * kPd;         // ds^T
  float* lse_s = dst_s + KB * kPd;        // [KB]
  float* delta_s = lse_s + KB;            // [KB]

  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  const int k0 = blockIdx.y * KB;
  const int krows = min(KB, S - k0);
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
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

  load_tile<KB, HD>(k_s, k + koff, krows, 1.f);
  load_tile<KB, HD>(v_s, v + koff, krows, 1.f);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int executed = 0;
  const int n_q = (S + KB - 1) / KB;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * KB;
    if (!tile_live<KB>(q0, k0, causal, window, S)) continue;
    ++executed;
    const int qrows = min(KB, S - q0);
    __syncthreads();
    load_tile<KB, HD>(q_s, q + base + (size_t)q0 * HD, qrows, scale);
    load_tile<KB, HD>(do_s, dout + base + (size_t)q0 * HD, qrows, 1.f);
    for (int r = tid; r < KB; r += kThreads) {
      lse_s[r] = r < qrows ? lse[(size_t)n * S + q0 + r] : kLseMasked;
      delta_s[r] = r < qrows ? delta[(size_t)n * S + q0 + r] : 0.f;
    }
    __syncthreads();

    // key rows ty*4 + i, query columns tx + kTx*j
    float st[4][kSc], dpt[4][kSc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSc; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float ka[4], va[4], qb[kSc], db[kSc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = k_s[(ty * 4 + i) * kLd + d];
        va[i] = v_s[(ty * 4 + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kSc; ++j) {
        qb[j] = q_s[(tx + kTx * j) * kLd + d];
        db[j] = do_s[(tx + kTx * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kSc; ++j) {
          st[i][j] = fmaf(qb[j], ka[i], st[i][j]);
          dpt[i][j] = fmaf(db[j], va[i], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < kSc; ++j) {
        const int c = tx + kTx * j;
        const float sv = elem_live(q0 + c, k0 + r, causal, window, S)
                             ? st[i][j] : kNegInf;
        const float p = expf(sv - lse_s[c]);
        pt_s[r * kPd + c] = p;
        dst_s[r * kPd + c] = p * (dpt[i][j] - delta_s[c]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < KB; ++j) {
      float pa[4], sa[4], qb[kCols], db[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pt_s[(ty * 4 + i) * kPd + j];
        sa[i] = dst_s[(ty * 4 + i) * kPd + j];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        db[c] = do_s[j * kLd + tx + kTx * c];
        qb[c] = q_s[j * kLd + tx + kTx * c];
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
        dkb[(size_t)r * HD + tx + kTx * c] = dk_acc[i][c];
        dvb[(size_t)r * HD + tx + kTx * c] = dv_acc[i][c];
      }
    }
  }
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

template <int KB, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   const void* gate, const void* slice_idx, void* dq,
                   void* dk, void* dv, void* delta, void* tiles_dkdv,
                   void* tiles_dq, int n_disp, int S, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<KB, HD>();
  constexpr size_t smem_dkdv = dkdv_smem_bytes<KB, HD>();
  static_assert(smem_dq <= 232448 && smem_dkdv <= 232448,
                "a tile's shared memory exceeds what one block may take");
  cudaError_t err = cudaFuncSetAttribute(
      d2ft_attn_bwd_dq_kernel<KB, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(d2ft_attn_bwd_dkdv_kernel<KB, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_disp, (S + KB - 1) / KB);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lsef = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(gate);
  const int32_t* idx = static_cast<const int32_t*>(slice_idx);
  float* deltaf = static_cast<float*>(delta);
  d2ft_attn_bwd_dq_kernel<KB, HD><<<grid, kThreads, smem_dq, stream>>>(
      qf, kf, vf, static_cast<const float*>(o), dof, lsef, gf, idx,
      static_cast<float*>(dq), deltaf,
      static_cast<unsigned long long*>(tiles_dq), S, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  d2ft_attn_bwd_dkdv_kernel<KB, HD><<<grid, kThreads, smem_dkdv, stream>>>(
      qf, kf, vf, dof, lsef, deltaf, gf, idx, static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<unsigned long long*>(tiles_dkdv),
      S, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when both launches succeeded. slice_idx and the
// tile counters may be null. The tile (64, or 32 at hd 256) must be the
// caller's kernel_block(hd).
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
      return launch<64, 16>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk,
                            dv, delta, tiles_dkdv, tiles_dq, n_disp, S,
                            causal, window, scale, s);
    case 32:
      return launch<64, 32>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk,
                            dv, delta, tiles_dkdv, tiles_dq, n_disp, S,
                            causal, window, scale, s);
    case 64:
      return launch<64, 64>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk,
                            dv, delta, tiles_dkdv, tiles_dq, n_disp, S,
                            causal, window, scale, s);
    case 128:
      return launch<64, 128>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk,
                             dv, delta, tiles_dkdv, tiles_dq, n_disp, S,
                             causal, window, scale, s);
    case 256:
      return launch<32, 256>(q, k, v, o, dout, lse, gate, slice_idx, dq, dk,
                             dv, delta, tiles_dkdv, tiles_dq, n_disp, S,
                             causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* d2ft_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
