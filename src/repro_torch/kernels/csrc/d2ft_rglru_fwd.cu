// D2FT-gated RG-LRU scan, forward, for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_rglru.py::_fwd_kernel
// (launcher _forward). Per (sample, channel band) slice with g_f != 0 and
// per channel, the recurrence
//   h_t = exp(la_t) * h_{t-1} + b_t,   h_{-1} = 0,
// and h [B, S, W] out. A slice with g_f == 0 runs nothing and writes exact
// zeros.
//
// What bounds it on this card: bytes. Per element it reads la and b and
// writes h (12 bytes) for ~3 operations (exp, multiply, add).
//
// Design: the TPU grid (slice, chunk) walks a slice's chunks in order and
// carries the state in VMEM ("arbitrary" axis), each chunk in the
// quadratic log-space form with a [Q, Q, Wg] decay matrix. Here every
// channel is an independent first-order recurrence, so a thread owns one
// channel and steps through time; no decay matrix is built. One thread per
// channel of a slice walking all S steps would give only B*W threads, each
// step waiting on the last, so the time axis is split into chunks of Q
// rows, two kernels in one launch call:
//   1. rglru_summary_kernel, one block per (dispatched slice, chunk,
//      channel block): the chunk's total log-decay tot_c = sum la and its
//      last state from a zero start, last_c, into scratch (the last chunk
//      returns at once: nothing reads its summary);
//   2. rglru_scan_kernel, the same grid: the state entering chunk c,
//      folded from the summaries of chunks 0..c-1
//        h_in(0) = 0,  h_in(j+1) = exp(tot_j) * h_in(j) + last_j
//      (nc <= 32 steps at S 4096, chunk 128, read from L2), then the
//      chunk's recurrence from h_in(c), h written once.
// Kernel 2 recomputes the chunk rather than fixing up kernel 1's output
// with exp(lc_q) * h_in: that writes h once instead of twice, and every h
// is the plain recurrence from its incoming state.
// Compaction: a block reads its slice id from the int32 table
// live_permutation builds; the grid's slice dimension is the dispatch
// count; the caller zero-fills h only when it dispatches fewer slices
// than exist. The executed-step counter (replaces the JAX on_backward_block
// hook): kernel 2 adds one per executed (slice, chunk) with one atomic,
// when the caller passes the int64 cell. Odd S is the caller's zero
// padding (la = 0, b = 0), so there is no length mask.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_rglru.py) checks
// devices, dtypes, shapes and contiguity, allocates h and the scratch and
// passes PyTorch's current stream. The entry returns cudaGetLastError().

#include "d2ft_rglru_common.cuh"

namespace {

using namespace rglru;

__global__ void __launch_bounds__(kMaxThreads) rglru_summary_kernel(
    const float* __restrict__ la, const float* __restrict__ b,
    const float* __restrict__ gate, const int32_t* __restrict__ slice_idx,
    float* __restrict__ tot, float* __restrict__ last, int S, int W, int G,
    int Q) {
  // the last chunk's summary has no reader
  if (blockIdx.y == gridDim.y - 1) return;
  const Slot t = slot(slice_idx, S, W, G, Q);
  if (!t.valid || gate[t.s] == 0.f) return;
  float h = 0.f, sum = 0.f;
#pragma unroll 8
  for (int q = 0; q < Q; ++q) {
    const long i = t.base + (long)q * W;
    const float l = la[i];
    h = fmaf(expf(l), h, b[i]);
    sum += l;
  }
  tot[t.sum] = sum;
  last[t.sum] = h;
}

__global__ void __launch_bounds__(kMaxThreads) rglru_scan_kernel(
    const float* __restrict__ la, const float* __restrict__ b,
    const float* __restrict__ gate, const int32_t* __restrict__ slice_idx,
    const float* __restrict__ tot, const float* __restrict__ last,
    float* __restrict__ h_out, unsigned long long* __restrict__ steps, int S,
    int W, int G, int Q) {
  const Slot t = slot(slice_idx, S, W, G, Q);
  const bool live = gate[t.s] != 0.f;
  if (t.valid) {
    if (!live) {
      for (int q = 0; q < Q; ++q) h_out[t.base + (long)q * W] = 0.f;
    } else {
      const int Wg = W / G;
      float h = 0.f;
      for (int j = 0; j < (int)blockIdx.y; ++j) {
        const long o = sum_at(t, j, Wg);
        h = fmaf(expf(tot[o]), h, last[o]);
      }
#pragma unroll 8
      for (int q = 0; q < Q; ++q) {
        const long i = t.base + (long)q * W;
        h = fmaf(expf(la[i]), h, b[i]);
        h_out[i] = h;
      }
    }
  }
  if (live && steps != nullptr && blockIdx.z == 0 && threadIdx.x == 0)
    atomicAdd(steps, 1ull);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. slice_idx and steps may
// be null (every slice dispatched in order; no step count). tot and last
// are scratch [n_disp, S/Q, W/G]. S must be a multiple of Q, W of G.
int d2ft_rglru_fwd_f32(const void* la, const void* b, const void* gate,
                       const void* slice_idx, void* h, void* tot, void* last,
                       void* steps, int n_disp, int S, int W, int G, int Q,
                       void* stream) {
  if (n_disp <= 0 || S <= 0 || Q <= 0 || S % Q || G <= 0 || W % G ||
      S / Q > 65535)
    return cudaErrorInvalidValue;
  const int Wg = W / G, nc = S / Q;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int32_t* idx = static_cast<const int32_t*>(slice_idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(n_disp, nc, Wg), block = block_of(Wg);
  rglru_summary_kernel<<<grid, block, 0, st>>>(
      f(la), f(b), f(gate), idx, static_cast<float*>(tot),
      static_cast<float*>(last), S, W, G, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_scan_kernel<<<grid, block, 0, st>>>(
      f(la), f(b), f(gate), idx, f(tot), f(last), static_cast<float*>(h),
      static_cast<unsigned long long*>(steps), S, W, G, Q);
  return cudaGetLastError();
}

const char* d2ft_rglru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
