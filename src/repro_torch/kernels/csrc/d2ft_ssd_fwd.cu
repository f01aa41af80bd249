// D2FT-gated SSD chunked scan, forward, for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_ssd.py::_fwd_kernel
// (launcher _forward). Per (sample, SSD head) slice with g_f != 0, and per
// chunk c of Q rows (cum = in-chunk cumulative log-decay, tot = cum[Q-1]):
//   y_q     = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) x_k
//             + exp(cum_q) C_q . prev_c            (prev_c = state entering c)
//   state_c = sum_k exp(tot - cum_k) x_k B_k^T       [P, N]
//   prev_0  = 0,  prev_{c+1} = exp(tot_c) prev_c + state_c
// and it emits y [B, S, H, P] and prevs [B*H, nc, P, N] (the backward's
// residual). A slice with g_f == 0 runs nothing and writes zero y and zero
// prevs.
//
// What bounds it on this card: operations. A live (slice, chunk) at
// Q = 256, P = 64, N = 128 needs ~13 MFLOP (this kernel executes ~23: full
// 64 x 64 tiles on the diagonal, C.B^T per head) of float32 FMA (TF32 off:
// no tensor cores) against ~0.2 MB of its own operands.
//
// Design: the TPU grid (slice, chunk) walks the chunks of a slice in order
// and carries the state in VMEM scratch ("arbitrary" axis). Hopper blocks
// run in no order, and one block per live slice would give only
// B*H*(live share) ~ 144 blocks for 132 SMs at the fine-tune's shapes. So
// this is Mamba-2's own GPU split, three kernels in one launch call:
//   1. ssd_state_kernel, one block per (dispatched slice, chunk): the
//      chunk's own state_c and tot_c (written into prevs[s, c] and a
//      scratch row);
//   2. ssd_state_pass_kernel, one thread per state element of a slice: the
//      short sequential recurrence over chunks, in place, turning state_c
//      into prev_c (zeros for dead slices);
//   3. ssd_scan_kernel, one block per (dispatched slice, chunk): y, with
//      the intra-chunk quadratic term sub-tiled as 64-row q tiles against
//      the causal 64-row k tiles (a whole chunk's Q x Q decay matrix alone
//      would be 256 KB, more than an SM's shared memory).
// Compaction: a block reads its slice id from the int32 table
// live_permutation builds (no gathered copies); the grid's slice dimension
// is the dispatch count; the caller zero-fills outputs only when it
// dispatches fewer slices than exist. B and C are read per sample, never
// broadcast per head. Odd S is the caller's zero padding (da = 0: identity
// decay), so there is no length mask. The executed-step counter (replaces
// the JAX on_backward_block hook): kernel 3 adds one per executed (slice,
// chunk) block with one atomic, when the caller passes the int64 cell.
// Products are 64-row register tiles over shared memory (256 threads, each
// 4 rows x 4..8 strided columns); no wgmma, TMA or cp.async yet.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_ssd.py) checks
// devices, dtypes, shapes and contiguity, allocates outputs and scratch and
// passes PyTorch's current stream. The entry returns cudaGetLastError().

#include "d2ft_ssd_common.cuh"

namespace {

using namespace ssd;

template <int P, int N>
constexpr size_t state_smem() {
  return sizeof(float) * (kT * (N + 1) + kT * (P + 1) + kMaxQ);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(
    const float* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ Bm, const float* __restrict__ gate,
    const int32_t* __restrict__ slice_idx, float* __restrict__ prevs,
    float* __restrict__ tot, int S, int H, int Q) {
  extern __shared__ float sm[];
  float* b_s = sm;                       // [64][N+1]
  float* x_s = b_s + kT * (N + 1);       // [64][P+1]
  float* cum = x_s + kT * (P + 1);       // [256]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int s = slice_idx != nullptr ? slice_idx[d] : d;
  if (gate[s] == 0.f) return;            // the pass writes its zero prevs
  const int b = s / H, h = s % H;
  const long t0 = (long)b * S + (long)c * Q;
  const int nT = (Q + kT - 1) / kT;
  chunk_cumsum(cum, da + t0 * H + h, H, Q, nT * kT, tid);
  const float total = cum[Q - 1];
  if (tid == 0) tot[(long)d * nc + c] = total;

  float acc[P / 16][N / 16];
  zero(acc);
  for (int kt = 0; kt < nT; ++kt) {
    const int rows = min(kT, Q - kt * kT);
    const long r0 = t0 + kt * kT;
    load_tile<N>(b_s, N + 1, Bm + r0 * N, N, rows, tid);
    load_tile<P>(x_s, P + 1, x + (r0 * H + h) * P, (long)H * P, rows, tid);
    __syncthreads();
    for (int i = tid; i < kT * P; i += kThreads) {   // x * decay-to-end
      const int r = i / P, p = i % P;
      x_s[r * (P + 1) + p] *= expf(total - cum[kt * kT + r]);
    }
    __syncthreads();
    mma<P / 16, N / 16, kT, true, false>(acc, x_s, P + 1, b_s, N + 1, ty, tx);
    __syncthreads();
  }
  float* st = prevs + ((long)s * nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < P / 16; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      st[(ty * (P / 16) + i) * N + tx + 16 * j] = acc[i][j];
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_state_pass_kernel(
    const float* __restrict__ gate, const int32_t* __restrict__ slice_idx,
    float* __restrict__ prevs, const float* __restrict__ tot, int nc) {
  const int d = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;   // element of [P][N]
  if (e >= P * N) return;
  const int s = slice_idx != nullptr ? slice_idx[d] : d;
  float* base = prevs + (long)s * nc * P * N + e;
  if (gate[s] == 0.f) {
    for (int c = 0; c < nc; ++c) base[(long)c * P * N] = 0.f;
    return;
  }
  float run = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float st = base[(long)c * P * N];
    base[(long)c * P * N] = run;                        // state before c
    run = run * expf(tot[(long)d * nc + c]) + st;
  }
}

template <int P, int N>
constexpr size_t scan_smem() {
  return sizeof(float) *
         (2 * kT * (N + 1) + kT * (P + 1) + kT * kLdT + 2 * kMaxQ);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ gate, const int32_t* __restrict__ slice_idx,
    const float* __restrict__ prevs, float* __restrict__ y,
    unsigned long long* __restrict__ steps, int S, int H, int Q) {
  extern __shared__ float sm[];
  float* c_s = sm;                       // [64][N+1] C rows of the q tile
  float* b_s = c_s + kT * (N + 1);       // [64][N+1] B rows, or prev [P][N]
  float* x_s = b_s + kT * (N + 1);       // [64][P+1]
  float* t_s = x_s + kT * (P + 1);       // [64][65] (C.B^T) * decay
  float* cum = t_s + kT * kLdT;          // [256]
  float* ecum = cum + kMaxQ;             // [256] exp(cum)
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int s = slice_idx != nullptr ? slice_idx[d] : d;
  const int b = s / H, h = s % H;
  const long t0 = (long)b * S + (long)c * Q;
  if (gate[s] == 0.f) {
    for (int i = tid; i < Q * P; i += kThreads)
      y[((t0 + i / P) * H + h) * P + i % P] = 0.f;
    return;
  }
  const int nT = (Q + kT - 1) / kT;
  chunk_cumsum(cum, da + t0 * H + h, H, Q, nT * kT, tid);
  for (int i = tid; i < nT * kT; i += kThreads) ecum[i] = expf(cum[i]);
  const float* prev = prevs + ((long)s * nc + c) * P * N;

  for (int qt = 0; qt < nT; ++qt) {
    const int qrows = min(kT, Q - qt * kT);
    const long q0 = t0 + qt * kT;
    load_tile<N>(c_s, N + 1, Cm + q0 * N, N, qrows, tid);
    load_tile<N>(b_s, N + 1, prev, N, P, tid);
    __syncthreads();
    float yi[4][P / 16];                 // C_q . prev^T (inter-chunk)
    zero(yi);
    mma<4, P / 16, N, false, true>(yi, c_s, N + 1, b_s, N + 1, ty, tx);
    float acc[4][P / 16];                // intra-chunk
    zero(acc);
    __syncthreads();
    for (int kt = 0; kt <= qt; ++kt) {
      const int krows = min(kT, Q - kt * kT);
      const long k0 = t0 + kt * kT;
      load_tile<N>(b_s, N + 1, Bm + k0 * N, N, krows, tid);
      load_tile<P>(x_s, P + 1, x + (k0 * H + h) * P, (long)H * P, krows,
                   tid);
      __syncthreads();
      float sc[4][4];
      zero(sc);
      mma<4, 4, N, false, true>(sc, c_s, N + 1, b_s, N + 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qt * kT + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kt * kT + tx + 16 * j;
          const float L = k <= q ? expf(cum[q] - cum[k]) : 0.f;
          t_s[(ty * 4 + i) * kLdT + tx + 16 * j] = sc[i][j] * L;
        }
      }
      __syncthreads();
      mma<4, P / 16, kT, false, false>(acc, t_s, kLdT, x_s, P + 1, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < qrows) {
        const float e = ecum[qt * kT + r];
        float* yr = y + ((q0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < P / 16; ++j)
          yr[tx + 16 * j] = acc[i][j] + yi[i][j] * e;
      }
    }
  }
  if (steps != nullptr && tid == 0) atomicAdd(steps, 1ull);
}

template <int P, int N>
cudaError_t launch(const float* x, const float* da, const float* Bm,
                   const float* Cm, const float* gate, const int32_t* idx,
                   float* y, float* prevs, float* tot,
                   unsigned long long* steps, int n_disp, int S, int H,
                   int Q, cudaStream_t stream) {
  const int nc = S / Q;
  constexpr size_t sm_state = state_smem<P, N>();
  constexpr size_t sm_scan = scan_smem<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm_state);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_scan_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm_scan);
  if (err != cudaSuccess) return err;
  ssd_state_kernel<P, N><<<dim3(n_disp, nc), kThreads, sm_state, stream>>>(
      x, da, Bm, gate, idx, prevs, tot, S, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_pass_kernel<P, N>
      <<<dim3(n_disp, (P * N + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(gate, idx, prevs, tot, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<P, N><<<dim3(n_disp, nc), kThreads, sm_scan, stream>>>(
      x, da, Bm, Cm, gate, idx, prevs, y, steps, S, H, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. slice_idx and steps may
// be null (every slice dispatched in order; no step count). tot is scratch
// [n_disp, S/Q]. S must be a multiple of Q, Q <= 256.
int d2ft_ssd_fwd_f32(const void* x, const void* da, const void* Bm,
                     const void* Cm, const void* gate, const void* slice_idx,
                     void* y, void* prevs, void* tot, void* steps, int n_disp,
                     int S, int H, int P, int N, int Q, void* stream) {
  if (n_disp <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ || S % Q)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int32_t* idx = static_cast<const int32_t*>(slice_idx);
  unsigned long long* st = static_cast<unsigned long long*>(steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 16 && N == 16)
    return launch<16, 16>(f(x), f(da), f(Bm), f(Cm), f(gate), idx,
                          static_cast<float*>(y), static_cast<float*>(prevs),
                          static_cast<float*>(tot), st, n_disp, S, H, Q, s);
  if (P == 64 && N == 128)
    return launch<64, 128>(f(x), f(da), f(Bm), f(Cm), f(gate), idx,
                           static_cast<float*>(y),
                           static_cast<float*>(prevs),
                           static_cast<float*>(tot), st, n_disp, S, H, Q, s);
  return cudaErrorInvalidValue;
}

const char* d2ft_ssd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
