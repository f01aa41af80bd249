// D2FT-gated flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_attention.py::
// _fwd_kernel (launcher _forward). q, k, v: [N = B*H, S, hd] (kv heads
// expanded), gate g_f: [N]. Per (sample, head) slice: o = g_f * softmax(
// (q*scale) k^T, masked) v and lse = m + log(l), in float32; a slice with
// g_f == 0 runs nothing and writes o = 0, lse = LSE_MASKED (+2^30), as do
// rows that saw no live key. Masks: causal, sliding window, and the ragged
// edge kpos < S.
//
// What bounds it on this card: operations. A live (q tile, k tile) pair is
// 2 x 2*KB*KB*hd FLOPs against 2*KB*hd*4 bytes of k and v, KB/2 FLOP per
// byte (32 at KB 64, 16 at KB 32), and the k and v rows of a slice are
// read by each of its q tiles, mostly from L2; the bytes the function must
// move are far fewer than its FLOPs over float32 FMA (67 TFLOP/s, no tensor
// cores with TF32 off) at HBM's 3.35 TB/s.
//
// What the design does about the TPU design that does not carry over:
//  * The Pallas grid (slice, q tile, k tile) carries acc, m and l in VMEM
//    scratch along its sequential k axis. Hopper blocks run in no order, so
//    one block per (dispatched slice, q tile) loops over the k tiles
//    itself, with the online-softmax state in registers. The tile skip
//    (tile_live) and the element mask (elem_live) are the Pallas kernel's
//    _block_live and _tile_mask, with NEG_INF = -2^30 in the mask.
//  * Compaction: instead of gathering live slices to the front and
//    scattering results back (4-5 full copies per call), a block reads its
//    slice id from the int32 table live_permutation builds; the grid's
//    slice dimension is the dispatch count. The caller pre-fills o and lse
//    for slices it does not dispatch (and only then).
//  * Odd S (ViT's 197 is prime): no padded copies; the last tile is ragged,
//    its rows are zero-filled in shared memory and masked by kpos < S.
//  * Tiles are KB x KB in shared memory (rows padded by one float against
//    bank conflicts), KB = 64 up to hd 128 and 32 at hd 256, where three
//    64-row [64, 257] float slabs and the score tile would leave one block
//    per SM and the backward's four would not fit the 232,448 bytes a block
//    may take. 256 threads as (KB/4) x (1024/KB): each owns 4 query rows
//    and KB^2/1024 (scores) or hd*KB/1024 (output) strided columns, float32
//    FMA; the lanes of one row are 16 (KB 64) or a whole warp (KB 32). No
//    wgmma, TMA or cp.async pipelining yet: speed is later work.
//  * Executed-tile counter (replaces the JAX on_backward_block hook): when
//    the caller passes a device int64 cell, each block adds the number of
//    tiles it executed with one atomic.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_attention.py)
// checks devices, dtypes, shapes and contiguity, allocates the outputs and
// passes PyTorch's current stream. The kernel allocates nothing. The entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.0f;     // -2^30
constexpr float kLseMasked = 1073741824.0f;   // +2^30

// thread layout of a KB x KB tile: kTy rows of threads, 4 query rows each;
// kTx lanes share a row, each owning kSc score columns tx + kTx*j
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

// reductions over the kTx lanes that share a ty
template <int kTx>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kTx / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int kTx>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kTx / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int KB, int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * KB * (HD + 1) + KB * (KB + 1));
}

template <int KB, int HD>
__global__ void __launch_bounds__(kThreads)
d2ft_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ gate,
                     const int32_t* __restrict__ slice_idx,
                     float* __restrict__ o, float* __restrict__ lse,
                     unsigned long long* __restrict__ tiles, int S,
                     int causal, int window, float scale) {
  constexpr int kTx = Layout<KB>::kTx;
  constexpr int kSc = Layout<KB>::kSc;
  constexpr int kLd = HD + 1;
  constexpr int kPd = KB + 1;
  constexpr int kCols = HD / kTx;         // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                      // [KB][kLd], pre-scaled
  float* k_s = q_s + KB * kLd;            // [KB][kLd]
  float* v_s = k_s + KB * kLd;            // [KB][kLd]
  float* p_s = v_s + KB * kLd;            // [KB][kPd]

  const int n = slice_idx ? slice_idx[blockIdx.x] : (int)blockIdx.x;
  const int q0 = blockIdx.y * KB;
  const int rows = min(KB, S - q0);
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const size_t base = (size_t)n * S * HD;
  float* ob = o + base + (size_t)q0 * HD;
  float* lb = lse + (size_t)n * S + q0;
  const float g = gate[n];

  if (g == 0.f) {                         // p_s slice: zeros, no compute
    for (int i = tid; i < rows * HD; i += kThreads) ob[i] = 0.f;
    for (int i = tid; i < rows; i += kThreads) lb[i] = kLseMasked;
    return;
  }

  for (int i = tid; i < KB * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    q_s[r * kLd + d] = r < rows ? q[base + (size_t)(q0 + r) * HD + d] * scale
                                : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int executed = 0;
  const int n_k = (S + KB - 1) / KB;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * KB;
    if (!tile_live<KB>(q0, k0, causal, window, S)) continue;  // block-uniform
    ++executed;
    const int krows = min(KB, S - k0);
    __syncthreads();                      // last tile's reads are done
    for (int i = tid; i < KB * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = r < krows;
      const size_t off = base + (size_t)(k0 + r) * HD + d;
      k_s[r * kLd + d] = in ? k[off] : 0.f;
      v_s[r * kLd + d] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float s[4][kSc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kSc; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[kSc];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty * 4 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kSc; ++j) kb[j] = k_s[(tx + kTx * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kSc; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSc; ++j) {
        if (!elem_live(q0 + r, k0 + tx + kTx * j, causal, window, S))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max<kTx>(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSc; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[r * kPd + tx + kTx * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum<kTx>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < KB; ++j) {
      float pa[4], vb[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(ty * 4 + i) * kPd + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vb[c] = v_s[j * kLd + tx + kTx * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows) {
      const bool seen = l[i] > 0.f;
      const float safe = seen ? l[i] : 1.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ob[(size_t)r * HD + tx + kTx * c] =
            seen ? acc[i][c] / safe * g : 0.f;
      if (tx == 0) lb[r] = seen ? m[i] + logf(safe) : kLseMasked;
    }
  }
  if (tiles != nullptr && tid == 0 && executed > 0)
    atomicAdd(tiles, (unsigned long long)executed);
}

template <int KB, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* gate, const void* slice_idx, void* o,
                   void* lse, void* tiles, int n_disp, int S, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KB, HD>();
  static_assert(smem <= 232448,
                "a tile's shared memory exceeds what one block may take");
  cudaError_t err = cudaFuncSetAttribute(
      d2ft_attn_fwd_kernel<KB, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_disp, (S + KB - 1) / KB);
  d2ft_attn_fwd_kernel<KB, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(gate),
      static_cast<const int32_t*>(slice_idx), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<unsigned long long*>(tiles), S,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. slice_idx and tiles may
// be null (every slice dispatched in order; no tile count). The tile (64,
// or 32 at hd 256) must be the caller's kernel_block(hd).
int d2ft_attn_fwd_f32(const void* q, const void* k, const void* v,
                      const void* gate, const void* slice_idx, void* o,
                      void* lse, void* tiles, int n_disp, int S, int hd,
                      int causal, int window, float scale, void* stream) {
  if (n_disp <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<64, 16>(q, k, v, gate, slice_idx, o, lse, tiles, n_disp,
                            S, causal, window, scale, s);
    case 32:
      return launch<64, 32>(q, k, v, gate, slice_idx, o, lse, tiles, n_disp,
                            S, causal, window, scale, s);
    case 64:
      return launch<64, 64>(q, k, v, gate, slice_idx, o, lse, tiles, n_disp,
                            S, causal, window, scale, s);
    case 128:
      return launch<64, 128>(q, k, v, gate, slice_idx, o, lse, tiles, n_disp,
                             S, causal, window, scale, s);
    case 256:
      return launch<32, 256>(q, k, v, gate, slice_idx, o, lse, tiles, n_disp,
                             S, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* d2ft_attn_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
