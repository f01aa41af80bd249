// D2FT-gated SSD chunked scan, forward, for Hopper (sm_90a), float32
// accuracy on the tensor cores (3xTF32).
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_ssd.py::_fwd_kernel
// (launcher _forward). Per (sample, SSD head) slice with g_f != 0, and per
// chunk c of Q rows (cum = in-chunk cumulative log-decay, tot = cum[Q-1]):
//   y_q     = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) x_k
//             + exp(cum_q) C_q . prev_c            (prev_c = state entering c)
//   state_c = sum_k exp(tot - cum_k) x_k B_k^T       [P, N]
//   prev_0  = 0,  prev_{c+1} = exp(tot_c) prev_c + state_c
// and it emits y [B, S, H, P] and prevs [B*H, nc, P, N] (the backward's
// residual). A slice with g_f == 0, or past the dispatch bound, runs
// nothing and writes zero y and zero prevs.
//
// What bounds it on this card: operations. A live (slice, chunk) at
// Q = 256, P = 64, N = 128 needs ~12.6 MFLOP of its own (the causal half
// of (C.B^T o L) x, the state and inter-chunk products) and its sample
// ~8.4 MFLOP once for C.B^T, against ~0.2 MB of its own operands.
//
// Design: the TPU grid (slice, chunk) walks the chunks of a slice in order
// and carries the state in VMEM scratch. Hopper blocks run in no order, so
// this is Mamba-2's own GPU split, four kernels in one launch call:
//   1. ssd_cb_kernel (d2ft_ssd_common.cuh), one block per (q tile, chunk,
//      sample with a running slice): C.B^T, [Q, Q] of depth N, once per
//      (sample, chunk) rather than once per head, since B and C are shared
//      by the H heads; only the causal 64 x 64 tiles, into the cb
//      workspace (16.8 MB at B 8, S 2048, Q 256), which the 24 heads'
//      blocks then read from L2. A block that held a sample's tiles in
//      shared memory and looped over its heads would compute C.B^T once
//      too, but would hold ~180 KB and run B*nc*nT blocks; this keeps the
//      scan's grid at one block per (slice, chunk, q tile) and its shared
//      memory under half an SM's. C.B^T is the forward's one product on
//      float32 FMA, summed in the plain version's order (the common header
//      says why);
//   2. ssd_chunk_state_kernel<.., false> (common), one block per (slice,
//      chunk): the chunk's cumulative decay (into the cum workspace, read
//      by 3 and 4) and state_c = (x o d2e)^T B into prevs[s, c];
//   3. ssd_state_pass_kernel, one thread per state element of a slice: the
//      short sequential recurrence over chunks, in place, turning state_c
//      into prev_c (zeros for slices that do not run);
//   4. ssd_scan_kernel, one block per (slice, chunk, q tile), the longest
//      rows first: y = (C.B^T o L) x + e^cum C prev^T. Items staged one
//      ahead: prev, then each causal k tile's C.B^T tile and x rows; the
//      decays are applied to the C.B^T tile in shared memory in place.
// The other products run on mma.sync in 3xTF32; wgmma takes tf32 only
// with both operands K-major, which x is not in (C.B^T o L) x. The
// executed-step counter (replaces the JAX on_backward_block hook): kernel 2
// adds one per executed (slice, chunk) block with one atomic, when the
// caller passes the int64 cell. Odd S is the caller's zero padding (da = 0:
// identity decay), so there is no length mask.
//
// Launch contract: the caller (repro_torch/kernels/d2ft_ssd.py) checks
// devices, dtypes, shapes and contiguity, allocates outputs and workspaces
// (unfilled) and passes PyTorch's current stream. The entry returns the
// first launch error.

#include "d2ft_ssd_common.cuh"

namespace {

using namespace ssd;

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_state_pass_kernel(
    const float* __restrict__ gate, float* __restrict__ prevs,
    const float* __restrict__ cumw, int n, int n_disp, int S, int Q) {
  static_assert((P * N) % kThreads == 0, "whole blocks of elements");
  constexpr long PN = (long)P * N;
  const int s = blockIdx.x, nc = S / Q;
  const int e = blockIdx.y * kThreads + threadIdx.x;   // element of [P][N]
  float* base = prevs + s * nc * PN + e;
  if (!gating::slice_runs<kThreads>(gate, n, n_disp, s)) {
    for (int c = 0; c < nc; ++c) base[c * PN] = 0.f;
    return;
  }
  const float* tot = cumw + (long)s * S + Q - 1;
  float run = 0.f;
  // kPassBatch chunks' loads in flight before their recurrence
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float st[kPassBatch], dec[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 + j < nc) {
        st[j] = base[(c0 + j) * PN];
        dec[j] = expf(tot[(long)(c0 + j) * Q]);
      }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (c0 + j < nc) {
        base[(c0 + j) * PN] = run;                      // state before c
        run = run * dec[j] + st[j];
      }
  }
}

template <int P, int N>
struct ScanSmem {
  static constexpr int pP = pitch_of(P), pN = pitch_of(N);
  // an item: prev [P][pN], or a C.B^T tile [64][64] and x rows [64][pP]
  static constexpr int kSlot =
      P * pN > kT * kT + kT * pP ? P * pN : kT * kT + kT * pP;
  static constexpr size_t kBytes =
      sizeof(float) * (kT * pN + 2 * kSlot + kMaxQ);
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ Cm,
    const float* __restrict__ gate, const float* __restrict__ prevs,
    const float* __restrict__ cumw, const float* __restrict__ cb,
    float* __restrict__ y, int n, int n_disp, int S, int H, int Q,
    bool vec) {
  using Sm = ScanSmem<P, N>;
  constexpr int pP = Sm::pP, pN = Sm::pN;
  using L = Lay<kT, P>;
  extern __shared__ __align__(16) float sm[];
  float* cs = sm;                        // [64][pN] C rows of the q tile
  float* ring = cs + kT * pN;            // 2 items
  float* cum = ring + 2 * Sm::kSlot;     // [256]
  const int s = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int nT = (Q + kT - 1) / kT, QP = nT * kT;
  const int qt = nT - 1 - blockIdx.z;
  const int b = s / H, h = s % H, qrows = min(kT, Q - qt * kT);
  const long t0 = (long)b * S + (long)c * Q, q0 = t0 + qt * kT;
  if (!gating::slice_runs<kThreads>(gate, n, n_disp, s)) {
    for (int i = threadIdx.x; i < qrows * P; i += kThreads)
      y[((q0 + i / P) * H + h) * P + i % P] = 0.f;
    return;
  }
  // item 0: prev (and the q tile's C rows and the chunk's decays); item
  // 1 + kt: the C.B^T tile (qt, kt) and x rows of k tile kt
  auto stage_item = [&](int it) {
    float* dst = ring + (it & 1) * Sm::kSlot;
    if (it == 0) {
      stage_tile<kT, N>(cs, Cm + q0 * N, N, qrows, vec);
      stage_tile<P, N>(dst, prevs + ((long)s * nc + c) * P * N, N, P, vec);
      stage_cum(cum, cumw + (long)s * S + (long)c * Q, Q);
    } else {
      const int kt = it - 1;
      stage_tile<kT, kT>(dst, cb + ((long)(b * nc + c) * QP + qt * kT) * QP
                                  + kt * kT, QP, kT, true);
      stage_tile<kT, P>(dst + kT * kT, x + ((t0 + kt * kT) * H + h) * P,
                        (long)H * P, min(kT, Q - kt * kT), vec);
    }
  };
  const int items = qt + 2;
  float yi[L::NT][4], ya[L::NT][4];      // inter-chunk, intra-chunk
  zero(yi);
  zero(ya);
  stage_item(0);
  tf32x3::commit();
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) stage_item(it + 1);
    tf32x3::commit();
    tf32x3::wait<1>();
    __syncthreads();
    float* sl = ring + (it & 1) * Sm::kSlot;
    if (it == 0) {                       // C_q . prev^T
      gemm<N>(yi,
              [&](tf32x3::FragA& a, int k0) {
                tf32x3::load_a(a, cs, pN, L::row0(), k0);
              },
              [&](tf32x3::FragB& f, int k0, int j) {
                tf32x3::load_b_nk(f, sl, pN, L::col0() + 8 * j, k0);
              });
    } else {                             // (C.B^T o L) x over k tile kt
      const int kt = it - 1;
      for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
        const int r = i / kT, cc = i % kT;
        sl[tf32x3::at(kT, r, cc)] *=
            decay(cum, qt * kT + r, kt * kT + cc, Q);
      }
      __syncthreads();
      const float* xs = sl + kT * kT;
      gemm<kT>(ya,
               [&](tf32x3::FragA& a, int k0) {
                 tf32x3::load_a(a, sl, kT, L::row0(), k0);
               },
               [&](tf32x3::FragB& f, int k0, int j) {
                 tf32x3::load_b_kn(f, xs, pP, k0, L::col0() + 8 * j);
               });
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < L::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = acc_row<L>(e);
      if (r < qrows)
        y[((q0 + r) * H + h) * P + acc_col<L>(j, e)] =
            ya[j][e] + yi[j][e] * expf(cum[qt * kT + r]);
    }
}

// Each kernel's dynamic shared memory, its attribute set where it is
// over the 48 KB default.
template <int P, int N>
cudaError_t prepare_kernels(size_t (&smem)[4]) {
  smem[0] = cb_smem<N>();
  smem[1] = chunk_state_smem<P, N>();
  smem[2] = 0;
  smem[3] = ScanSmem<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem[0]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<P, N, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem[1]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_kernel<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem[3]);
  return err;
}

// Blocks an SM holds of each kernel, in launch order.
template <int P, int N>
cudaError_t occupancy(int* out) {
  size_t smem[4];
  cudaError_t err = prepare_kernels<P, N>(smem);
  const void* fns[4] = {(const void*)ssd_cb_kernel<N>,
                        (const void*)ssd_chunk_state_kernel<P, N, false>,
                        (const void*)ssd_state_pass_kernel<P, N>,
                        (const void*)ssd_scan_kernel<P, N>};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + i, fns[i],
                                                        kThreads, smem[i]);
  return err;
}

template <int P, int N>
cudaError_t launch(const float* x, const float* da, const float* Bm,
                   const float* Cm, const float* gate, float* y,
                   float* prevs, float* cumw, float* cb,
                   unsigned long long* steps, int Bsz, int n_disp, int S,
                   int H, int Q, bool vec, cudaStream_t stream) {
  const int n = Bsz * H, nc = S / Q, nT = (Q + kT - 1) / kT;
  size_t smem[4];
  cudaError_t err = prepare_kernels<P, N>(smem);
  if (err != cudaSuccess) return err;
  const size_t sm_cb = smem[0], sm_st = smem[1], sm_scan = smem[3];
  ssd_cb_kernel<N><<<dim3(nT, nc, Bsz), kThreads, sm_cb, stream>>>(
      Bm, Cm, gate, cb, n, n_disp, S, H, Q, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_state_kernel<P, N, false>
      <<<dim3(n, nc), kThreads, sm_st, stream>>>(
          x, da, Bm, gate, prevs, cumw, steps, n, n_disp, S, H, Q, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass_kernel<P, N>
      <<<dim3(n, P * N / kThreads), kThreads, 0, stream>>>(
          gate, prevs, cumw, n, n_disp, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_kernel<P, N><<<dim3(n, nc, nT), kThreads, sm_scan, stream>>>(
      x, Cm, gate, prevs, cumw, cb, y, n, n_disp, S, H, Q, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. steps may be null (no
// step count). Workspaces: cum [B*H, S], cb [B, S/Q, QP, QP] with QP =
// 64 ceil(Q / 64). S must be a multiple of Q, Q <= 256; n_disp bounds the
// running slices (n_disp >= B*H runs every live one).
int d2ft_ssd_fwd_f32(const void* x, const void* da, const void* Bm,
                     const void* Cm, const void* gate, void* y, void* prevs,
                     void* cum, void* cb, void* steps, int Bsz, int n_disp,
                     int S, int H, int P, int N, int Q, void* stream) {
  if (Bsz <= 0 || H <= 0 || n_disp <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ ||
      S % Q)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const void* staged[] = {x, Bm, Cm, prevs, cb};
  const bool vec = vec_ok(staged, 5);
  unsigned long long* st = static_cast<unsigned long long*>(steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 16 && N == 16)
    return launch<16, 16>(f(x), f(da), f(Bm), f(Cm), f(gate), w(y),
                          w(prevs), w(cum), w(cb), st, Bsz, n_disp, S, H, Q,
                          vec, s);
  if (P == 64 && N == 128)
    return launch<64, 128>(f(x), f(da), f(Bm), f(Cm), f(gate), w(y),
                           w(prevs), w(cum), w(cb), st, Bsz, n_disp, S, H,
                           Q, vec, s);
  return cudaErrorInvalidValue;
}

// Fills out[0..3] with the blocks an SM holds of the forward's kernels
// (C.B^T, chunk state, pass, scan) at (P, N); returns a cudaError_t.
int d2ft_ssd_fwd_occupancy(int P, int N, int* out) {
  if (P == 16 && N == 16) return occupancy<16, 16>(out);
  if (P == 64 && N == 128) return occupancy<64, 128>(out);
  return cudaErrorInvalidValue;
}

const char* d2ft_ssd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
