// Paged flash decode for Hopper (sm_90a), float32: a split-KV decode.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode.py::
// _paged_decode_kernel (launcher paged_flash_decode). One query token per
// sequence attends over that sequence's K/V history, which lives in
// fixed-size pages of a shared pool [n_pages, page_size, n_kv, hd] and is
// addressed through the page table [B, n_pmax] (int32, null-padded with
// page 0). Output [B, H, hd].
//
// What bounds it on this card: bytes, and at decode's small batch the
// latency of reading them. Each K/V element is used for 2*rep flops per
// (slot, kv head), far below the ~20 flop/byte the H100 needs in float32
// before compute matters, so the least time is the K/V bytes of the
// positions each sequence must read, once, over 3.35 TB/s: ~3 us for
// gemma3-1b's 4 slots of ~1.4k tokens. That is below what two launches
// take, so the launches and one tile's load latency are the real floor.
//
// What the design does about it:
//  * Split-KV. The history of each (slot b, kv head g) is cut into runs of
//    `split` positions (a multiple of the page size and of kTile; the
//    launcher names it, kernels/paged_decode.py KV_SPLIT). The grid is
//    (n_kv * n_hg, B, n_split) with n_hg head groups per kv head (below)
//    and n_split = ceil(n_pmax * page_size / split) from the table's
//    width, so no host sync sizes it: gemma3-1b's 129-page
//    table at page size 16 gives 33 runs of 64, 132 blocks for 4 slots,
//    one per SM, where one block per (slot, kv head) gave 4 blocks that
//    each walked 33 tiles in turn.
//  * Each block serves up to kMaxRep = 8 query heads of one kv head: all
//    rep = H / n_kv of them when rep <= 8, so each K/V row is read from
//    device memory once, not rep times (the Pallas grid (B, H, n_pmax)
//    re-reads a kv head's pages per query head). A larger rep is cut into
//    n_hg = ceil(rep / 8) head groups of ceil(rep / n_hg) heads (rep 10:
//    two groups of 5), one block each, beside each other in the grid's
//    first dimension (n_kv * n_hg): each K/V row is then read n_hg times,
//    mostly from L2, and the grid has n_hg times the blocks. Holding more
//    heads in one block would take more registers (a float4 of query and
//    one of accumulator per head and lane) than 256 threads have at hd
//    256. It reads lengths[b] and page_table[b, :] itself and touches
//    only positions the mask keeps ([max(0, t - window + 1), t]) inside
//    its run: a run wholly past the length (table padding included) or
//    wholly left of the window writes an empty partial (m = -2^30, l = 0)
//    and loads no K/V; so does a group whose heads are all gated off.
//  * Loads: the page indirection is resolved once a tile, one row offset
//    per position in shared memory; then the whole tile's K rows and V
//    rows (up to 64 + 64 rows, 128 KB at hd 256) are put in flight at once
//    with 16-byte cp.async, neighbouring threads on neighbouring 16 bytes
//    of one row, as two groups: the scores wait only for K, and V lands
//    meanwhile. cp.async rather than TMA: a row's address depends on the
//    page table, so a tile is 64 gathers of one row each, which a TMA
//    tensor map would issue one row per copy anyway; cp.async issues them
//    from all 256 threads at once with no descriptor.
//  * Scores: warp w takes positions w, w + 8, ...; each lane holds its
//    16-byte slices of the rep queries in registers, reads the K row's
//    matching slices from shared memory and the rep dot products are
//    finished with warp reductions. One warp per head then takes the
//    tile's max and exp-sums (float32 online softmax across the run's
//    tiles). P.V: thread (group, column) owns one 16-byte column of V and
//    sums the block's heads over every kGroups-th position, kGroups =
//    floor(256 / (hd / 4)) (at hd 80 and 96, 12 and 10 groups: 240 of the
//    256 threads; the rest idle in P.V); the groups' sums are added in a
//    fixed order through shared memory.
//  * Partials: each block writes, for its heads, the unnormalised
//    accumulator [hd], its running max m and sum l into a float32
//    workspace [B, H, n_split, hd] + [B, H, n_split] x 2 that the launcher
//    allocates. A second kernel, in the same launcher call, merges the
//    partials of each (slot, head) in split order: rescale to the global
//    max, sum, divide by l, multiply by the gate. The order is fixed, so
//    results are bitwise the same on every call; no float atomics.
//  * g_f == 0 heads write exact zeros and skip their dot products; so do
//    slots with no live position.
//
// Launch contract: the caller (repro_torch/kernels/paged_decode.py)
// checks devices, dtypes, shapes, contiguity, alignment and page-id range,
// allocates the output and the workspace, and passes PyTorch's current
// stream. The kernels allocate nothing. The entry launches the split
// kernel, then the merge, and returns the first cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRep = 8;      // query heads a block serves, at most
constexpr int kTile = 64;       // positions per online-softmax step
constexpr int kPosPerWarp = kTile / kWarps;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// P.V layout: kCols threads cover a row in 16-byte columns, kGroups groups
// of them take every kGroups-th position; threads past kGroups * kCols
// (hd 80 and 96) take none
template <int HD>
struct Pv {
  static constexpr int kCols = HD / 4;
  static constexpr int kGroups = kThreads / kCols;
  static constexpr int kSteps = (kTile + kGroups - 1) / kGroups;
  static_assert(HD % 4 == 0 && kCols <= kThreads &&
                kTile * kCols % kThreads == 0 && kTile <= kThreads,
                "layout");
};

template <int HD, int REP>
constexpr size_t split_smem_bytes() {
  return sizeof(float) * (2 * kTile * HD + Pv<HD>::kGroups * REP * HD);
}

// q, pools, gates, lengths and table as paged_decode_f32; acc [B, H,
// n_split, HD], m and l [B, H, n_split] the partials. Block x serves the
// nh <= hpb query heads of head group x % n_hg of kv head x / n_hg. REP
// (1, 2, 4 or 8) is hpb rounded up to a power of two: heads r >= nh of a
// block are phantoms with a zero query, so the unrolled loops over heads
// carry no per-head branch, and their results are never written. (A
// first version with a runtime head bound in those loops, runtime-bounded
// staging loops and the run bounds below visible to the optimizer did not
// compile in minutes; this one takes seconds.)
template <int HD, int REP>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const float* __restrict__ q,
                          const float* __restrict__ k_pages,
                          const float* __restrict__ v_pages,
                          const int32_t* __restrict__ page_table,
                          const int32_t* __restrict__ lengths,
                          const float* __restrict__ gates,
                          float* __restrict__ ws_acc,
                          float* __restrict__ ws_m, float* __restrict__ ws_l,
                          int H, int n_kv, int n_hg, int hpb,
                          int page_size, int n_pmax, int split, int window,
                          float scale) {
  constexpr int kChunks = HD / 4;                  // 16-byte slices a row
  constexpr int kPerLane = (kChunks + 31) / 32;    // of them a lane scores
  constexpr int kCols = Pv<HD>::kCols, kGroups = Pv<HD>::kGroups;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                         // [kTile][HD]
  float* v_s = k_s + kTile * HD;             // [kTile][HD]
  float* red_s = v_s + kTile * HD;           // [kGroups][REP][HD]
  __shared__ float p_s[REP][kTile];          // scores, then probabilities
  __shared__ long long off_s[kTile];         // pool offset of each K/V row
  __shared__ float m_s[REP], l_s[REP], corr_s[REP];
  __shared__ float gate_s[REP];

  const int g = blockIdx.x / n_hg, b = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int rep = H / n_kv;
  const int hg = blockIdx.x % n_hg;
  const int h0 = g * rep + hg * hpb;            // this block's first head
  const int nh = min(hpb, rep - hg * hpb);      // and its head count
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t part0 = ((size_t)b * H + h0) * n_split + sp;  // head h0's

  // positions [lo, hi] are exactly those the mask keeps inside this run:
  // pos <= t, pos > t - window on local layers, and the table's extent
  const int t = lengths[b];
  int lo = max(sp * split, window > 0 ? max(0, t - window + 1) : 0);
  int hi = min(min(t, n_pmax * page_size - 1), sp * split + split - 1);
  // opaque to the optimizer, which need not reason about the loops below
  // through these nested min / max (see the note above the kernel)
  asm("" : "+r"(lo), "+r"(hi));
  if (tid < REP) {
    gate_s[tid] = tid < nh ? gates[(size_t)b * H + h0 + tid] : 0.f;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  bool any_live = false;
  for (int r = 0; r < nh; ++r) any_live |= gate_s[r] != 0.f;
  if (!any_live || lo > hi) {                // an empty partial, no loads
    if (tid < nh) {
      ws_m[part0 + (size_t)tid * n_split] = kNegInf;
      ws_l[part0 + (size_t)tid * n_split] = 0.f;
    }
    return;
  }

  // this lane's 16-byte slices of the rep pre-scaled queries
  float4 qr[REP][kPerLane];
  const float* qb = q + ((size_t)b * H + h0) * HD;
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nh && c < kChunks) {
        x = reinterpret_cast<const float4*>(qb + r * HD)[c];
        x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
      }
      qr[r][i] = x;
    }

  const int32_t* row = page_table + (size_t)b * n_pmax;
  const long long row_stride = (long long)n_kv * HD;
  const int col = tid % kCols, grp = tid / kCols;
  const bool pv = grp < kGroups;             // this thread takes P.V rows
  float4 acc[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile0 = lo; tile0 <= hi; tile0 += kTile) {
    const int n = min(kTile, hi - tile0 + 1);
    if (tid < n) {                            // kTile <= kThreads
      const int pos = tile0 + tid;
      const long long page = row[pos / page_size];
      off_s[tid] = (page * page_size + pos % page_size) * row_stride +
                   (long long)g * HD;
    }
    __syncthreads();                          // off_s; last tile's reads
    // every loop of the tile has a fixed trip count and a guard
#pragma unroll
    for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
      const int i = tid + u * kThreads, j = i / kChunks;
      const int c = (i % kChunks) * 4;
      if (j < n) cp_async16(k_s + j * HD + c, k_pages + off_s[j] + c);
    }
    commit();
#pragma unroll
    for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
      const int i = tid + u * kThreads, j = i / kChunks;
      const int c = (i % kChunks) * 4;
      if (j < n) cp_async16(v_s + j * HD + c, v_pages + off_s[j] + c);
    }
    commit();
    wait<1>();                                // K landed (this thread's)
    __syncthreads();                          // everyone's

    // scores: warp w takes positions w, w + kWarps, ...
#pragma unroll
    for (int jj = 0; jj < kPosPerWarp; ++jj) {
      const int j = warp + jj * kWarps;
      if (j < n) {
        float4 kv[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int c = lane + 32 * i;
          kv[i] = c < kChunks
                      ? reinterpret_cast<const float4*>(k_s + j * HD)[c]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            s = fmaf(qr[r][i].x, kv[i].x, s);
            s = fmaf(qr[r][i].y, kv[i].y, s);
            s = fmaf(qr[r][i].z, kv[i].z, s);
            s = fmaf(qr[r][i].w, kv[i].w, s);
          }
          s = warp_sum(s);
          if (lane == 0) p_s[r][j] = s;
        }
      }
    }
    __syncthreads();
    // online softmax: warp r owns head r
    if (warp < REP) {
      const int r = warp;
      const float m_prev = m_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u)
        if (lane + 32 * u < n) mx = fmaxf(mx, p_s[r][lane + 32 * u]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int j = lane + 32 * u;
        if (j < n) {
          const float e = expf(p_s[r][j] - m_new);
          p_s[r][j] = e;
          sum += e;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    wait<0>();                                // V landed (this thread's)
    __syncthreads();                          // everyone's; p_s, corr_s

    // P.V: thread (grp, col) sums positions grp, grp + kGroups, ...
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float c = corr_s[r];
      acc[r].x *= c; acc[r].y *= c; acc[r].z *= c; acc[r].w *= c;
    }
#pragma unroll 4
    for (int u = 0; u < Pv<HD>::kSteps; ++u) {
      const int j = grp + u * kGroups;
      if (!pv || j >= n) break;
      const float4 vv = reinterpret_cast<const float4*>(v_s + j * HD)[col];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = p_s[r][j];
        acc[r].x = fmaf(p, vv.x, acc[r].x);
        acc[r].y = fmaf(p, vv.y, acc[r].y);
        acc[r].z = fmaf(p, vv.z, acc[r].z);
        acc[r].w = fmaf(p, vv.w, acc[r].w);
      }
    }
  }

  // the groups' sums, added in group order; then the partials out
  if (pv) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
      reinterpret_cast<float4*>(red_s + (grp * REP + r) * HD)[col] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < nh * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    if (gate_s[r] == 0.f) continue;
    float s = 0.f;
    for (int gg = 0; gg < kGroups; ++gg) s += red_s[(gg * REP + r) * HD + d];
    ws_acc[(part0 + (size_t)r * n_split) * HD + d] = s;
  }
  if (tid < nh) {
    const bool live = gate_s[tid] != 0.f;
    ws_m[part0 + (size_t)tid * n_split] = live ? m_s[tid] : kNegInf;
    ws_l[part0 + (size_t)tid * n_split] = live ? l_s[tid] : 0.f;
  }
}

// One block per (head, slot), one thread per output dim (HD rounded up to
// whole warps: at hd 80 and 96, 96 threads): the partials of every run
// merged in split order.
template <int HD>
struct Merge {
  static constexpr int kThreads = (HD + 31) / 32 * 32;
};

template <int HD>
__global__ void __launch_bounds__(Merge<HD>::kThreads)
paged_decode_merge_kernel(const float* __restrict__ ws_acc,
                          const float* __restrict__ ws_m,
                          const float* __restrict__ ws_l,
                          const float* __restrict__ gates,
                          float* __restrict__ out, int H, int n_split) {
  constexpr int kMt = Merge<HD>::kThreads;
  extern __shared__ float w_s[];     // [2][n_split]: weights, weights * l
  __shared__ float red[kMt / 32];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const float gate = gates[bh];
  float* o = out + bh * HD;
  if (gate == 0.f) {
    if (d < HD) o[d] = 0.f;
    return;
  }
  const float* m = ws_m + bh * n_split;
  const float* l = ws_l + bh * n_split;
  // the global max over live runs
  float mx = kNegInf;
  for (int s = d; s < n_split; s += kMt)
    if (l[s] > 0.f) mx = fmaxf(mx, m[s]);
  mx = warp_max(mx);
  if ((d & 31) == 0) red[d >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kMt / 32; ++w) mx = fmaxf(mx, red[w]);
  float* wl_s = w_s + n_split;
  for (int s = d; s < n_split; s += kMt) {
    const float w = l[s] > 0.f ? expf(m[s] - mx) : 0.f;
    w_s[s] = w;
    wl_s[s] = w * l[s];
  }
  __syncthreads();
  if (d >= HD) return;
  // in split order: sum = sum_s w_s l_s, acc = sum_s w_s acc_s; runs with
  // no live position (w = 0) are skipped, their acc never written
  float sum = 0.f, acc = 0.f;
  const float* a = ws_acc + bh * n_split * HD + d;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float w = w_s[s];
    if (w != 0.f) {
      sum += wl_s[s];
      acc = fmaf(w, a[(size_t)s * HD], acc);
    }
  }
  o[d] = sum > 0.f ? acc / sum * gate : 0.f;
}

template <int HD, int REP>
cudaError_t launch_split(const void* q, const void* k_pages,
                         const void* v_pages, const void* page_table,
                         const void* lengths, const float* gates, float* acc,
                         float* m, float* l, int B, int H, int n_kv,
                         int n_hg, int hpb, int page_size, int n_pmax,
                         int split, int n_split, int window, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<HD, REP>();
  static_assert(smem <= 232448, "shared memory exceeds what a block may take");
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_split_kernel<HD, REP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  paged_decode_split_kernel<HD, REP><<<dim3(n_kv * n_hg, B, n_split),
                                       kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), gates, acc, m, l, H, n_kv, n_hg,
      hpb, page_size, n_pmax, split, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths,
                   const void* gates, void* out, void* ws, int B, int H,
                   int n_kv, int page_size, int n_pmax, int split,
                   int n_split, int window, float scale,
                   cudaStream_t stream) {
  float* acc = static_cast<float*>(ws);
  float* m = acc + (size_t)B * H * n_split * HD;
  float* l = m + (size_t)B * H * n_split;
  const float* gf = static_cast<const float*>(gates);
  // rep query heads per kv head, in n_hg groups of at most hpb <= 8
  const int rep = H / n_kv;
  const int n_hg = (rep + kMaxRep - 1) / kMaxRep;
  const int hpb = (rep + n_hg - 1) / n_hg;
  auto split_with = [&](auto rep_pow2) {
    return launch_split<HD, decltype(rep_pow2)::value>(
        q, k_pages, v_pages, page_table, lengths, gf, acc, m, l, B, H, n_kv,
        n_hg, hpb, page_size, n_pmax, split, n_split, window, scale, stream);
  };
  cudaError_t err =
      hpb <= 1   ? split_with(std::integral_constant<int, 1>())
      : hpb <= 2 ? split_with(std::integral_constant<int, 2>())
      : hpb <= 4 ? split_with(std::integral_constant<int, 4>())
                 : split_with(std::integral_constant<int, kMaxRep>());
  if (err != cudaSuccess) return err;
  paged_decode_merge_kernel<HD><<<dim3(H, B), Merge<HD>::kThreads,
                                  2 * sizeof(float) * n_split, stream>>>(
      acc, m, l, gf, static_cast<float*>(out), H, n_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Head dims the kernel is instantiated for (any rep = H / n_kv).
int paged_decode_supports_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 80 || hd == 96 || hd == 128 ||
         hd == 256;
}

// Returns a cudaError_t: 0 when both launches succeeded. ws holds B * H *
// n_split * (hd + 2) floats; n_split = ceil(n_pmax * page_size / split).
int paged_decode_f32(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* lengths,
                     const void* gates, void* out, void* ws, int B, int H,
                     int n_kv, int hd, int page_size, int n_pmax, int split,
                     int window, float scale, void* stream) {
  if (B <= 0 || n_kv <= 0 || H <= 0 || H % n_kv != 0 || page_size <= 0 ||
      n_pmax <= 0 || split <= 0 || split % kTile != 0 ||
      split % page_size != 0)
    return cudaErrorInvalidValue;
  auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if ((bits(q) | bits(k_pages) | bits(v_pages) | bits(ws)) & 15)
    return cudaErrorMisalignedAddress;
  const int n_split = (n_pmax * page_size + split - 1) / split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define PAGED_DECODE_CASE(HD)                                                 \
  case HD:                                                                    \
    return launch<HD>(q, k_pages, v_pages, page_table, lengths, gates, out,   \
                      ws, B, H, n_kv, page_size, n_pmax, split, n_split,      \
                      window, scale, s);
    PAGED_DECODE_CASE(32)
    PAGED_DECODE_CASE(64)
    PAGED_DECODE_CASE(80)
    PAGED_DECODE_CASE(96)
    PAGED_DECODE_CASE(128)
    PAGED_DECODE_CASE(256)
#undef PAGED_DECODE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
