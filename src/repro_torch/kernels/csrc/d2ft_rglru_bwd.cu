// D2FT-gated RG-LRU scan, gate-aware backward, for Hopper (sm_90a),
// float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_rglru.py::_bwd_kernel
// (launcher _backward). For h_t = a_t * h_{t-1} + b_t with a = exp(la),
// the cotangent of h_t carried backwards is
//   g_t = dy_t + a_{t+1} * g_{t+1}     (g past the end = 0)
// and per (sample, channel band) slice with g_b != 0 and per channel
//   db_t  = g_t,
//   dla_t = g_t * a_t * h_{t-1}        (h the forward's output, h_{-1} = 0).
// This is the sequential form of the TPU kernel's chunk sums
//   db_k = sum_{q>=k} exp(lc_q - lc_k) dh_q,
//   dla  = reverse_cumsum(dh * h - b * db):
// the reverse cumulative sum telescopes to g_t * (h_t - b_t), and
// h_t - b_t = a_t * h_{t-1} is taken directly (the difference cancels when
// a is small), so b is not read. g_b <= g_f, so h is the true forward
// output on every slice that runs here. A slice with g_b == 0 runs nothing
// and writes exact-zero dla and db.
//
// What bounds it on this card: bytes. Per element it reads la, h and dy and
// writes dla and db (20 bytes) for ~5 operations.
//
// Design: the forward's chunk split in reverse (see d2ft_rglru_fwd.cu), two
// kernels in one launch call, one thread per channel of a band:
//   1. rglru_bwd_summary_kernel, one block per (dispatched slice, chunk,
//      channel block): from a zero carry at the chunk's end, the chunk's
//      own share of the carry it passes to the chunk before,
//      lead_c = a_first * g_first, and its total log-decay tot_c, into
//      scratch (chunk 0 returns at once: nothing reads its summary);
//   2. rglru_bwd_scan_kernel, the same grid: the carry entering chunk c
//      from the right, folded from the summaries of chunks nc-1..c+1
//        G_{nc-1} = 0,  G_{j-1} = lead_j + exp(tot_j) * G_j,
//      then the chunk's reverse walk from G_c, dla and db written once.
// Compaction, the caller's zero-fill, the padding and the launch contract
// are the forward's; the executed-step counter adds one per executed
// (slice, chunk) in kernel 2.

#include "d2ft_rglru_common.cuh"

namespace {

using namespace rglru;

__global__ void __launch_bounds__(kMaxThreads) rglru_bwd_summary_kernel(
    const float* __restrict__ la, const float* __restrict__ dy,
    const float* __restrict__ gate, const int32_t* __restrict__ slice_idx,
    float* __restrict__ tot, float* __restrict__ lead, int S, int W, int G,
    int Q) {
  // the first chunk's summary has no reader
  if (blockIdx.y == 0) return;
  const Slot t = slot(slice_idx, S, W, G, Q);
  if (!t.valid || gate[t.s] == 0.f) return;
  float carry = 0.f, sum = 0.f;
#pragma unroll 8
  for (int q = Q - 1; q >= 0; --q) {
    const long i = t.base + (long)q * W;
    const float l = la[i];
    carry = expf(l) * (dy[i] + carry);
    sum += l;
  }
  tot[t.sum] = sum;
  lead[t.sum] = carry;
}

__global__ void __launch_bounds__(kMaxThreads) rglru_bwd_scan_kernel(
    const float* __restrict__ la, const float* __restrict__ h,
    const float* __restrict__ dy, const float* __restrict__ gate,
    const int32_t* __restrict__ slice_idx, const float* __restrict__ tot,
    const float* __restrict__ lead, float* __restrict__ dla,
    float* __restrict__ db, unsigned long long* __restrict__ steps, int S,
    int W, int G, int Q) {
  const Slot t = slot(slice_idx, S, W, G, Q);
  const bool live = gate[t.s] != 0.f;
  if (t.valid) {
    if (!live) {
      for (int q = 0; q < Q; ++q) {
        dla[t.base + (long)q * W] = 0.f;
        db[t.base + (long)q * W] = 0.f;
      }
    } else {
      const int Wg = W / G;
      const int c = blockIdx.y;
      float carry = 0.f;
      for (int j = (int)gridDim.y - 1; j > c; --j) {
        const long o = sum_at(t, j, Wg);
        carry = fmaf(expf(tot[o]), carry, lead[o]);
      }
#pragma unroll 8
      for (int q = Q - 1; q >= 0; --q) {
        const long i = t.base + (long)q * W;
        const float g = dy[i] + carry;
        const float hp = (c > 0 || q > 0) ? h[i - W] : 0.f;
        carry = expf(la[i]) * g;
        db[i] = g;
        dla[i] = carry * hp;
      }
    }
  }
  if (live && steps != nullptr && blockIdx.z == 0 && threadIdx.x == 0)
    atomicAdd(steps, 1ull);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. slice_idx and steps may
// be null (every slice dispatched in order; no step count). tot and lead
// are scratch [n_disp, S/Q, W/G]. S must be a multiple of Q, W of G.
int d2ft_rglru_bwd_f32(const void* la, const void* h, const void* dy,
                       const void* gate, const void* slice_idx, void* dla,
                       void* db, void* tot, void* lead, void* steps,
                       int n_disp, int S, int W, int G, int Q, void* stream) {
  if (n_disp <= 0 || S <= 0 || Q <= 0 || S % Q || G <= 0 || W % G ||
      S / Q > 65535)
    return cudaErrorInvalidValue;
  const int Wg = W / G, nc = S / Q;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int32_t* idx = static_cast<const int32_t*>(slice_idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(n_disp, nc, Wg), block = block_of(Wg);
  rglru_bwd_summary_kernel<<<grid, block, 0, st>>>(
      f(la), f(dy), f(gate), idx, static_cast<float*>(tot),
      static_cast<float*>(lead), S, W, G, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_scan_kernel<<<grid, block, 0, st>>>(
      f(la), f(h), f(dy), f(gate), idx, f(tot), f(lead),
      static_cast<float*>(dla), static_cast<float*>(db),
      static_cast<unsigned long long*>(steps), S, W, G, Q);
  return cudaGetLastError();
}

const char* d2ft_rglru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
