// Paged flash decode for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode.py::
// _paged_decode_kernel (launcher paged_flash_decode). One query token per
// sequence attends over that sequence's K/V history, which lives in
// fixed-size pages of a shared pool [n_pages, page_size, n_kv, hd] and is
// addressed through the page table [B, n_pmax] (int32, null-padded with
// page 0). Output [B, H, hd].
//
// What bounds it on this card: bytes. Each K/V element is used for
// 2*rep flops per (slot, kv head), far below the ~20 flop/byte the H100
// needs in fp32 before compute matters, so the least time is the K/V bytes
// of the positions each sequence must read, once, over 3.35 TB/s. At small
// batch there are only B * n_kv blocks, so latency bounds it well above that.
//
// What the design does about it:
//  * One thread block per (slot b, kv head g) serves all rep = H / n_kv
//    query heads of the group, so each K/V row is read from device memory
//    once, not rep times (the Pallas grid (B, H, n_pmax) re-reads a kv
//    head's pages for every query head).
//  * The block reads lengths[b] and page_table[b, :] itself and walks only
//    the positions it needs, [max(0, t - window + 1), t], in tiles of
//    kTile positions that may span pages: pages past the length (table
//    padding included) and pages wholly left of the window are never
//    touched, and neither are masked rows inside a live page.
//  * Per tile: each warp loads the K rows of its kTile / kWarps positions
//    at once (their latencies overlap), computes the rep scores of each
//    with warp reductions (lanes split hd); one warp per head updates the
//    f32 online-softmax state; then every thread owns hd / blockDim output
//    dims, loads kVBatch V rows at a time and accumulates P.V for all rep
//    heads in registers.
//  * g_f == 0 heads write exact zeros and skip their dot products; a block
//    whose whole group is gated off writes zeros and loads no K/V.
//  * No wgmma, TMA or split-K across pages yet: speed is later work.
//
// Launch contract: the caller (repro_torch/kernels/paged_decode.py)
// checks devices, dtypes, shapes, contiguity and page-id range, allocates
// the output, and passes PyTorch's current stream. The kernel allocates
// nothing. The entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;      // query heads per kv head a block serves
constexpr int kTile = 64;       // positions per online-softmax step
constexpr int kPosPerWarp = kTile / kWarps;
constexpr int kVBatch = 16;     // V rows each thread loads before using
constexpr float kNegInf = -1073741824.0f;  // -2^30, the JAX package's NEG_INF

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pages,
                        const float* __restrict__ v_pages,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ lengths,
                        const float* __restrict__ gates,
                        float* __restrict__ out,
                        int H, int n_kv, int page_size, int n_pmax,
                        int window, float scale) {
  constexpr int kPerLane = HD / 32;                          // score phase
  constexpr int kPerThread = (HD + kThreads - 1) / kThreads;  // P.V phase
  __shared__ float q_s[kMaxRep * HD];        // pre-scaled queries of the group
  __shared__ float p_s[kMaxRep][kTile];      // scores, then probabilities
  __shared__ long long off_s[kTile];         // pool offset of each K/V row
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], corr_s[kMaxRep];
  __shared__ float gate_s[kMaxRep];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / n_kv;
  const int h0 = g * rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* o = out + ((size_t)b * H + h0) * HD;

  if (tid < rep) {
    gate_s[tid] = gates[(size_t)b * H + h0 + tid];
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  bool any_live = false;
  for (int r = 0; r < rep; ++r) any_live |= gate_s[r] != 0.f;
  if (!any_live) {
    for (int i = tid; i < rep * HD; i += kThreads) o[i] = 0.f;
    return;
  }
  const float* qb = q + ((size_t)b * H + h0) * HD;
  for (int i = tid; i < rep * HD; i += kThreads) q_s[i] = qb[i] * scale;

  // positions [lo, hi] are exactly those the mask keeps: pos <= t and, on
  // local layers, pos > t - window; hi also stops at the table's end
  const int t = lengths[b];
  const int lo = window > 0 ? max(0, t - window + 1) : 0;
  const int hi = min(t, n_pmax * page_size - 1);
  const int32_t* row = page_table + (size_t)b * n_pmax;
  const long long row_stride = (long long)n_kv * HD;

  float acc[kMaxRep][kPerThread];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) acc[r][i] = 0.f;
  __syncthreads();  // q_s complete

  for (int tile0 = lo; tile0 <= hi; tile0 += kTile) {
    const int n = min(kTile, hi - tile0 + 1);
    // scores: warp w takes positions w, w + kWarps, ...; all its K rows
    // are loaded before the first is used, so their latencies overlap
    float kv[kPosPerWarp][kPerLane];
#pragma unroll
    for (int jj = 0; jj < kPosPerWarp; ++jj) {
      const int j = warp + jj * kWarps;
      if (j < n) {
        const int pos = tile0 + j;
        const long long page = row[pos / page_size];
        const long long off = (page * page_size + pos % page_size) *
                                  row_stride + (long long)g * HD;
        if (lane == 0) off_s[j] = off;
        const float* kr = k_pages + off;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) kv[jj][i] = kr[lane + 32 * i];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kPosPerWarp; ++jj) {
      const int j = warp + jj * kWarps;
      if (j < n) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            float s = 0.f;
            if (gate_s[r] != 0.f) {
#pragma unroll
              for (int i = 0; i < kPerLane; ++i)
                s = fmaf(q_s[r * HD + lane + 32 * i], kv[jj][i], s);
              s = warp_sum(s);
            }
            if (lane == 0) p_s[r][j] = s;
          }
        }
      }
    }
    __syncthreads();
    // online softmax: warp r owns head r
    if (warp < rep) {
      const int r = warp;
      const float m_prev = m_s[r];
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r][j]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(p_s[r][j] - m_new);
        p_s[r][j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // P.V: thread owns dims tid, tid + kThreads, ...
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep)
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) acc[r][i] *= corr_s[r];
    for (int j0 = 0; j0 < n; j0 += kVBatch) {
      float vv[kVBatch][kPerThread];      // kVBatch V loads in flight
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        const int j = j0 + u;
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const int d = tid + i * kThreads;
          vv[u][i] = (j < n && d < HD) ? v_pages[off_s[j] + d] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kVBatch; ++u) {
        const int j = j0 + u;
        if (j < n) {
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r)
            if (r < rep)
#pragma unroll
              for (int i = 0; i < kPerThread; ++i)
                acc[r][i] = fmaf(p_s[r][j], vv[u][i], acc[r][i]);
        }
      }
    }
    __syncthreads();  // p_s / off_s are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      const float l = l_s[r];
      const float gate = gate_s[r];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int d = tid + i * kThreads;
        if (d < HD)
          o[r * HD + d] = (gate != 0.f && l > 0.f) ? acc[r][i] / l * gate : 0.f;
      }
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths,
                   const void* gates, void* out, int B, int H, int n_kv,
                   int page_size, int n_pmax, int window, float scale,
                   cudaStream_t stream) {
  const dim3 grid(n_kv, B);
  paged_decode_f32_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<const float*>(gates),
      static_cast<float*>(out), H, n_kv, page_size, n_pmax, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Head dims the kernel is instantiated for, and the largest rep it takes.
int paged_decode_max_rep() { return kMaxRep; }
int paged_decode_supports_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

// Returns a cudaError_t: 0 on a successful launch.
int paged_decode_f32(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* lengths,
                     const void* gates, void* out, int B, int H, int n_kv,
                     int hd, int page_size, int n_pmax, int window,
                     float scale, void* stream) {
  if (B <= 0 || n_kv <= 0 || H % n_kv != 0 || H / n_kv > kMaxRep ||
      page_size <= 0 || n_pmax <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k_pages, v_pages, page_table, lengths, gates, out,
                        B, H, n_kv, page_size, n_pmax, window, scale, s);
    case 64:
      return launch<64>(q, k_pages, v_pages, page_table, lengths, gates, out,
                        B, H, n_kv, page_size, n_pmax, window, scale, s);
    case 128:
      return launch<128>(q, k_pages, v_pages, page_table, lengths, gates, out,
                         B, H, n_kv, page_size, n_pmax, window, scale, s);
    case 256:
      return launch<256>(q, k_pages, v_pages, page_table, lengths, gates, out,
                         B, H, n_kv, page_size, n_pmax, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
