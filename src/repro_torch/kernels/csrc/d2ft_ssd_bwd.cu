// D2FT-gated SSD chunked scan, gate-aware backward, for Hopper (sm_90a),
// float32.
//
// Replaces the Pallas TPU kernel repro/kernels/d2ft_ssd.py::_bwd_kernel
// (launcher _backward). For each (sample, SSD head) slice with g_b != 0 it
// computes, from the saved operands, the forward's prevs and the cotangent
// dy, the cotangents dx [B,S,H,P], ddA [B,S,H] and per-slice dB, dC
// [B,H,S,N] (the caller sums these over the heads, as the JAX VJP does). A
// slice with g_b == 0 runs nothing and writes exact zeros. The per-chunk
// algebra is the TPU kernel's, term for term:
//   cb = C B^T, gqk = dy x^T, L = causal exp(cum_q - cum_k)
//   dC = (gqk*L) B + e^cum dy . prev            dx = (cb*L)^T dy + d2e B ds^T
//   dB = (gqk*L)^T C + d2e x . ds               (d2e = exp(tot - cum))
//   dcum = rowsum(m) - colsum(m) + rowsum(dy * y_inter) - w,  m = gqk*cb*L
//   w = d2e * rowsum((B ds^T) * x),  dtot = e^tot sum(ds * prev) + sum(w)
//   ddA = reverse_cumsum(dcum) + dtot
// where ds is the cotangent of the state leaving the chunk:
//   ds_{nc-1} = 0,  ds_{c-1} = exp(tot_c) ds_c + sum_q e^{cum_q} dy_q^T C_q.
//
// What bounds it on this card: operations (~47 MFLOP needed, ~75 executed
// with the recomputations of the two sweeps, of float32 FMA per live
// (slice, chunk) at Q = 256, P = 64, N = 128, TF32 off).
//
// Design: the TPU kernel walks a slice's chunks in reverse grid order and
// carries ds in VMEM scratch. Here, as in Mamba-2's GPU backward, ds
// depends only on each chunk's own dy and C, so three kernels run in one
// launch call:
//   1. ssd_dstate_kernel, one block per (dispatched slice, chunk): the
//      chunk's sum_q e^{cum_q} dy_q^T C_q and tot_c;
//   2. ssd_dstate_pass_kernel, one thread per state element of a slice:
//      the reverse recurrence over chunks, in place, giving ds_c;
//   3. ssd_bwd_chunk_kernel, one block per (dispatched slice, chunk): all
//      cotangents of the chunk in two sweeps over its causal (q tile,
//      k tile) pairs, FA2-style: q tiles outer (dC and the row sums), then
//      k tiles outer (dB, dx and the column sums), so that every output
//      tile is summed in registers by one block in a fixed order. No f32
//      atomics: the fine-tune is checked by its trajectory, and the order
//      of an atomic sum changes from run to run. dcum and ddA's reverse
//      cumulative sum are summed in double: the sum cancels to values far
//      below its terms (|ddA| ~ 200 from terms of ~40 at Q = 256), so a
//      float32 running sum carries sqrt(Q) roundings of its terms.
// Compaction, zero filling, the absence of a length mask and the step
// counter (ssd_bwd: one per executed (slice, chunk) block of kernel 3) are
// as in d2ft_ssd_fwd.cu.
//
// Launch contract: as d2ft_ssd_fwd.cu; ds [n_disp, nc, P, N] and tot
// [n_disp, nc] are caller-allocated scratch.

#include "d2ft_ssd_common.cuh"

namespace {

using namespace ssd;

template <int P, int N>
constexpr size_t dstate_smem() {
  return sizeof(float) * (kT * (N + 1) + kT * (P + 1) + kMaxQ);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_dstate_kernel(
    const float* __restrict__ da, const float* __restrict__ Cm,
    const float* __restrict__ dy, const float* __restrict__ gate,
    const int32_t* __restrict__ slice_idx, float* __restrict__ ds,
    float* __restrict__ tot, int S, int H, int Q) {
  extern __shared__ float sm[];
  float* c_s = sm;                       // [64][N+1]
  float* t_s = c_s + kT * (N + 1);       // [64][P+1] dy * exp(cum)
  float* cum = t_s + kT * (P + 1);       // [256]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int s = slice_idx != nullptr ? slice_idx[d] : d;
  if (gate[s] == 0.f) return;            // kernel 3 writes its zeros
  const int b = s / H, h = s % H;
  const long t0 = (long)b * S + (long)c * Q;
  const int nT = (Q + kT - 1) / kT;
  chunk_cumsum(cum, da + t0 * H + h, H, Q, nT * kT, tid);
  if (tid == 0) tot[(long)d * nc + c] = cum[Q - 1];

  float acc[P / 16][N / 16];
  zero(acc);
  for (int qt = 0; qt < nT; ++qt) {
    const int rows = min(kT, Q - qt * kT);
    const long r0 = t0 + qt * kT;
    load_tile<N>(c_s, N + 1, Cm + r0 * N, N, rows, tid);
    load_tile<P>(t_s, P + 1, dy + (r0 * H + h) * P, (long)H * P, rows, tid);
    __syncthreads();
    for (int i = tid; i < kT * P; i += kThreads) {
      const int r = i / P, p = i % P;
      t_s[r * (P + 1) + p] *= expf(cum[qt * kT + r]);
    }
    __syncthreads();
    mma<P / 16, N / 16, kT, true, false>(acc, t_s, P + 1, c_s, N + 1, ty, tx);
    __syncthreads();
  }
  float* o = ds + ((long)d * nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < P / 16; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      o[(ty * (P / 16) + i) * N + tx + 16 * j] = acc[i][j];
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_dstate_pass_kernel(
    const float* __restrict__ gate, const int32_t* __restrict__ slice_idx,
    float* __restrict__ ds, const float* __restrict__ tot, int nc) {
  const int d = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= P * N) return;
  const int s = slice_idx != nullptr ? slice_idx[d] : d;
  if (gate[s] == 0.f) return;
  float* base = ds + (long)d * nc * P * N + e;
  float run = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float v = base[(long)c * P * N];
    base[(long)c * P * N] = run;         // cotangent of the state leaving c
    run = expf(tot[(long)d * nc + c]) * run + v;
  }
}

template <int P, int N>
constexpr size_t chunk_smem() {
  return sizeof(float) * (2 * kT * (N + 1) + 2 * kT * (P + 1) +
                          2 * kT * kLdT + kMaxQ) +
         sizeof(double) * (kMaxQ + kThreads / 32);
}

// Sum of a per-thread double over the block (all threads call it).
__device__ __forceinline__ double block_sum(double v, double* red, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ da,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ gate, const int32_t* __restrict__ slice_idx,
    const float* __restrict__ prevs, const float* __restrict__ dy,
    const float* __restrict__ ds, float* __restrict__ dx,
    float* __restrict__ dda, float* __restrict__ db_s,
    float* __restrict__ dc_s, unsigned long long* __restrict__ steps, int S,
    int H, int Q) {
  extern __shared__ float sm[];
  float* c_s = sm;                       // [64][N+1] C rows, or ds [P][N]
  float* b_s = c_s + kT * (N + 1);       // [64][N+1] B rows, or prev [P][N]
  float* dy_s = b_s + kT * (N + 1);      // [64][P+1]
  float* x_s = dy_s + kT * (P + 1);      // [64][P+1]
  float* t1 = x_s + kT * (P + 1);        // [64][65] gqk * L
  float* t2 = t1 + kT * kLdT;            // [64][65] cb * L
  float* cum = t2 + kT * kLdT;           // [256]
  double* dcum = reinterpret_cast<double*>(cum + kMaxQ);   // [256]
  double* red = dcum + kMaxQ;                              // [8]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int s = slice_idx != nullptr ? slice_idx[d] : d;
  const int b = s / H, h = s % H;
  const long t0 = (long)b * S + (long)c * Q;     // row of x, dy, da, B, C
  const long u0 = (long)s * S + (long)c * Q;     // row of dB, dC per slice
  if (gate[s] == 0.f) {
    for (int i = tid; i < Q * P; i += kThreads)
      dx[((t0 + i / P) * H + h) * P + i % P] = 0.f;
    for (int i = tid; i < Q; i += kThreads) dda[(t0 + i) * H + h] = 0.f;
    for (int i = tid; i < Q * N; i += kThreads) {
      db_s[u0 * N + i] = 0.f;
      dc_s[u0 * N + i] = 0.f;
    }
    return;
  }
  const int nT = (Q + kT - 1) / kT;
  chunk_cumsum(cum, da + t0 * H + h, H, Q, nT * kT, tid);
  const float total = cum[Q - 1];
  for (int i = tid; i < kMaxQ; i += kThreads) dcum[i] = 0.0;
  const float* prev = prevs + ((long)s * nc + c) * P * N;
  const float* dsc = ds + ((long)d * nc + c) * P * N;
  double part = 0.0;                     // sum(ds * prev)
  for (int e = tid; e < P * N; e += kThreads) part += (double)(dsc[e] * prev[e]);
  const double dtot_state = (double)expf(total) * block_sum(part, red, tid);

  // ---- sweep 1, q tiles outer: dC, rowsum(m), rowsum(dy * y_inter)
  for (int qt = 0; qt < nT; ++qt) {
    const int qrows = min(kT, Q - qt * kT);
    const long q0 = t0 + qt * kT;
    load_tile<N>(c_s, N + 1, Cm + q0 * N, N, qrows, tid);
    load_tile<P>(dy_s, P + 1, dy + (q0 * H + h) * P, (long)H * P, qrows,
                 tid);
    load_tile<N>(b_s, N + 1, prev, N, P, tid);
    __syncthreads();
    float yi[4][P / 16];                 // C_q . prev^T
    zero(yi);
    mma<4, P / 16, N, false, true>(yi, c_s, N + 1, b_s, N + 1, ty, tx);
    float dc[4][N / 16];                 // dy_q . prev, then * e^cum
    zero(dc);
    mma<4, N / 16, P, false, false>(dc, dy_s, P + 1, b_s, N + 1, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, q = qt * kT + r;
      const float e = expf(cum[q]);
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < P / 16; ++j)
        row += dy_s[r * (P + 1) + tx + 16 * j] * (yi[i][j] * e);
      row = row_sum(row);
      if (tx == 0) dcum[q] += (double)row;
#pragma unroll
      for (int j = 0; j < N / 16; ++j) dc[i][j] *= e;
    }
    __syncthreads();
    for (int kt = 0; kt <= qt; ++kt) {
      const int krows = min(kT, Q - kt * kT);
      const long k0 = t0 + kt * kT;
      load_tile<N>(b_s, N + 1, Bm + k0 * N, N, krows, tid);
      load_tile<P>(x_s, P + 1, x + (k0 * H + h) * P, (long)H * P, krows,
                   tid);
      __syncthreads();
      float cb[4][4], g[4][4];
      zero(cb);
      zero(g);
      mma<4, 4, N, false, true>(cb, c_s, N + 1, b_s, N + 1, ty, tx);
      mma<4, 4, P, false, true>(g, dy_s, P + 1, x_s, P + 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qt * kT + ty * 4 + i;
        float rowm = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kt * kT + tx + 16 * j;
          const float L = k <= q ? expf(cum[q] - cum[k]) : 0.f;
          t1[(ty * 4 + i) * kLdT + tx + 16 * j] = g[i][j] * L;
          rowm += g[i][j] * cb[i][j] * L;
        }
        rowm = row_sum(rowm);
        if (tx == 0) dcum[q] += (double)rowm;
      }
      __syncthreads();
      mma<4, N / 16, kT, false, false>(dc, t1, kLdT, b_s, N + 1, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < qrows) {
        float* o = dc_s + (u0 + qt * kT + r) * N;
#pragma unroll
        for (int j = 0; j < N / 16; ++j) o[tx + 16 * j] = dc[i][j];
      }
    }
  }

  // ---- sweep 2, k tiles outer: dB, dx, colsum(m), w
  double wsum = 0.0;
  for (int kt = 0; kt < nT; ++kt) {
    const int krows = min(kT, Q - kt * kT);
    const long k0 = t0 + kt * kT;
    load_tile<N>(b_s, N + 1, Bm + k0 * N, N, krows, tid);
    load_tile<P>(x_s, P + 1, x + (k0 * H + h) * P, (long)H * P, krows, tid);
    load_tile<N>(c_s, N + 1, dsc, N, P, tid);
    __syncthreads();
    float dxa[4][P / 16];                // B_k . ds^T, then * d2e
    zero(dxa);
    mma<4, P / 16, N, false, true>(dxa, b_s, N + 1, c_s, N + 1, ty, tx);
    float db[4][N / 16];                 // x_k . ds, then * d2e
    zero(db);
    mma<4, N / 16, P, false, false>(db, x_s, P + 1, c_s, N + 1, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, k = kt * kT + r;
      const float d2e = expf(total - cum[k]);
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < P / 16; ++j) {
        row += dxa[i][j] * x_s[r * (P + 1) + tx + 16 * j];
        dxa[i][j] *= d2e;
      }
      row = row_sum(row);
      if (tx == 0) {
        const float w = row * d2e;
        dcum[k] -= (double)w;
        wsum += (double)w;
      }
#pragma unroll
      for (int j = 0; j < N / 16; ++j) db[i][j] *= d2e;
    }
    __syncthreads();
    for (int qt = kt; qt < nT; ++qt) {
      const int qrows = min(kT, Q - qt * kT);
      const long q0 = t0 + qt * kT;
      load_tile<N>(c_s, N + 1, Cm + q0 * N, N, qrows, tid);
      load_tile<P>(dy_s, P + 1, dy + (q0 * H + h) * P, (long)H * P, qrows,
                   tid);
      __syncthreads();
      float cb[4][4], g[4][4];           // transposed: rows k, columns q
      zero(cb);
      zero(g);
      mma<4, 4, N, false, true>(cb, b_s, N + 1, c_s, N + 1, ty, tx);
      mma<4, 4, P, false, true>(g, x_s, P + 1, dy_s, P + 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kt * kT + ty * 4 + i;
        float colm = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = qt * kT + tx + 16 * j;
          const float L = k <= q ? expf(cum[q] - cum[k]) : 0.f;
          t1[(ty * 4 + i) * kLdT + tx + 16 * j] = g[i][j] * L;
          t2[(ty * 4 + i) * kLdT + tx + 16 * j] = cb[i][j] * L;
          colm += g[i][j] * cb[i][j] * L;
        }
        colm = row_sum(colm);
        if (tx == 0) dcum[k] -= (double)colm;
      }
      __syncthreads();
      mma<4, N / 16, kT, false, false>(db, t1, kLdT, c_s, N + 1, ty, tx);
      mma<4, P / 16, kT, false, false>(dxa, t2, kLdT, dy_s, P + 1, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < krows) {
        float* ob = db_s + (u0 + kt * kT + r) * N;
        float* ox = dx + ((k0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < N / 16; ++j) ob[tx + 16 * j] = db[i][j];
#pragma unroll
        for (int j = 0; j < P / 16; ++j) ox[tx + 16 * j] = dxa[i][j];
      }
    }
  }

  // ---- ddA = reverse cumulative sum of dcum + dtot, in double
  const double dtot = dtot_state + block_sum(wsum, red, tid);
  if (tid == 0) {
    double run = 0.0;
    for (int i = Q - 1; i >= 0; --i) {
      run += dcum[i];
      dcum[i] = run + dtot;
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads)
    dda[(t0 + i) * H + h] = (float)dcum[i];
  if (steps != nullptr && tid == 0) atomicAdd(steps, 1ull);
}

template <int P, int N>
cudaError_t launch(const float* x, const float* da, const float* Bm,
                   const float* Cm, const float* gate, const int32_t* idx,
                   const float* prevs, const float* dy, float* dx,
                   float* dda, float* db_s, float* dc_s, float* ds,
                   float* tot, unsigned long long* steps, int n_disp, int S,
                   int H, int Q, cudaStream_t stream) {
  const int nc = S / Q;
  constexpr size_t sm_dstate = dstate_smem<P, N>();
  constexpr size_t sm_chunk = chunk_smem<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_dstate_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm_dstate);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm_chunk);
  if (err != cudaSuccess) return err;
  ssd_dstate_kernel<P, N><<<dim3(n_disp, nc), kThreads, sm_dstate, stream>>>(
      da, Cm, dy, gate, idx, ds, tot, S, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_dstate_pass_kernel<P, N>
      <<<dim3(n_disp, (P * N + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(gate, idx, ds, tot, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<P, N>
      <<<dim3(n_disp, nc), kThreads, sm_chunk, stream>>>(
          x, da, Bm, Cm, gate, idx, prevs, dy, ds, dx, dda, db_s, dc_s,
          steps, S, H, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. slice_idx and steps may
// be null. ds [n_disp, S/Q, P, N] and tot [n_disp, S/Q] are scratch.
int d2ft_ssd_bwd_f32(const void* x, const void* da, const void* Bm,
                     const void* Cm, const void* gate, const void* slice_idx,
                     const void* prevs, const void* dy, void* dx, void* dda,
                     void* db_s, void* dc_s, void* ds, void* tot,
                     void* steps, int n_disp, int S, int H, int P, int N,
                     int Q, void* stream) {
  if (n_disp <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ || S % Q)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const int32_t* idx = static_cast<const int32_t*>(slice_idx);
  unsigned long long* st = static_cast<unsigned long long*>(steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 16 && N == 16)
    return launch<16, 16>(f(x), f(da), f(Bm), f(Cm), f(gate), idx, f(prevs),
                          f(dy), w(dx), w(dda), w(db_s), w(dc_s), w(ds),
                          w(tot), st, n_disp, S, H, Q, s);
  if (P == 64 && N == 128)
    return launch<64, 128>(f(x), f(da), f(Bm), f(Cm), f(gate), idx,
                           f(prevs), f(dy), w(dx), w(dda), w(db_s), w(dc_s),
                           w(ds), w(tot), st, n_disp, S, H, Q, s);
  return cudaErrorInvalidValue;
}

const char* d2ft_ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
