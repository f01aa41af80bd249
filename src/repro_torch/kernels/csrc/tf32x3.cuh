// Float32-accurate products on Hopper's tensor cores (3xTF32), shared by
// the kernels that include it (lora_matmul.cu, d2ft_attention_fwd.cu,
// d2ft_attention_bwd.cu, and d2ft_moe_fwd.cu / d2ft_moe_bwd.cu through
// d2ft_moe_common.cuh).
//
// The port runs float32 with TF32 off, so that it matches the JAX package.
// One TF32 product keeps 11 significant bits of each operand (about three
// decimal digits). 3xTF32 keeps float32's accuracy: each operand is split
// as a = big + small, big = tf32(a) (round to nearest, ties away, as
// cvt.rna), small = a - big (read as tf32 by the tensor core), and each
// product is taken as small*big + big*small + big*big, accumulated in
// float32 (the dropped small*small term is ~2^-22 of |a b|). That is three
// tensor-core products a step, in the order CUTLASS's OpMultiplyAddFastF32
// takes them (the small terms first, big*big last), at up to 495 / 3 = 165
// TFLOP/s of float32-accurate work against 67 TFLOP/s of float32 FMA.
//
// What is here:
//  * the warp-level mma.sync.m16n8k8 tf32 product and its 3xTF32 form on
//    split fragments (FragA 16 x 8, FragB 8 x 8; the PTX ISA's fragment
//    layouts, lane = 4 * group + tig);
//  * a shared-memory tile layout free of bank conflicts for every fragment
//    read the kernels make: rows of a multiple of 32 floats, each row's
//    16-byte chunks permuted by an XOR of swz(row). A (and B stored [n][k])
//    is read with ldmatrix, 8 rows of one 16-byte chunk column at a time;
//    B stored [k][n], and A stored [k][m] (a transposed operand read in
//    place), float by float, the 8 lanes of a group on 8 columns and its
//    4 lanes on 4 rows. swz(row) = ((row & 3) << 3) | (row & 4) puts both
//    on distinct banks, and keeps every 16-byte chunk whole, so cp.async
//    can fill the tile;
//  * an accumulator read back as the A fragment of a following product
//    (acc_as_a), in registers, for the attention forward's P.V, with the
//    row order its B operand is staged in (kpair_row);
//  * cp.async staging (16-byte with zero fill past the valid bytes, and
//    4-byte for sources that are not 16-byte aligned) and commit / wait.
//
// mma.sync rather than wgmma: wgmma takes tf32 only with both operands
// K-major, and the attention backward's p^T do and ds^T q would need
// transposed copies in shared memory. wgmma and TMA are later work.

#pragma once

#include <stdint.h>

namespace tf32x3 {

// ------------------------------------------------------------ arithmetic
// big = tf32(x) rounded to nearest, ties away from zero: the rounding of
// cvt.rna.tf32.f32, as an integer add and mask on the bits (faster on the
// card than the cvt, with the same result for every finite x). small = x -
// big is exact; the tensor core reads its top 19 bits, so small enters
// truncated to tf32, an error of at most 2^-21 |x|.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// a 16 x 8 A tile: a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4), with g = lane / 4 and t = lane % 4
struct FragA {
  uint32_t big[4], small[4];
};

// an 8 x 8 B tile (k x n): b[0] (k t, n g), b[1] (k t + 4, n g)
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// t += a b on the tensor core: the three products of one k-step, in the
// tensor core's own float32 accumulation. t is the 16 x 8 accumulator:
// t[0] (g, 2t), t[1] (g, 2t + 1), t[2] (g + 8, 2t), t[3] (g + 8, 2t + 1).
__device__ __forceinline__ void mma3_into(float (&t)[4], const FragA& a,
                                          const FragB& b) {
  mma(t, a.small, b.big);
  mma(t, a.big, b.small);
  mma(t, a.big, b.big);
}

// d += a b in float32 accuracy. The tensor core's float32 accumulation
// truncates where IEEE float32 rounds: carried through a whole K walk
// (1152 products of the LoRA matmul, 256 of a score) it biases the sum
// toward zero by up to an ulp a step, far past the FMA kernels' error.
// So a step's products go into a fresh accumulator, which is added to d
// in IEEE float32.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3_into(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// The 16 x 8 accumulator c of a product (rows g, g + 8; columns 2t, 2t + 1)
// as the A fragment of a following product over those 8 columns, with no
// value moved between lanes: that product takes its k in the order
// k = t <-> column 2t, k = t + 4 <-> column 2t + 1, so its B operand's
// rows are stored in the same order (kpair_row).
__device__ __forceinline__ void acc_as_a(FragA& f, const float (&c)[4]) {
  split(c[0], f.big[0], f.small[0]);      // (g, k t): column 2t
  split(c[2], f.big[1], f.small[1]);      // (g + 8, k t)
  split(c[1], f.big[2], f.small[2]);      // (g, k t + 4): column 2t + 1
  split(c[3], f.big[3], f.small[3]);      // (g + 8, k t + 4)
}

// the tile row at which row r of acc_as_a's B operand is stored: within
// each 8-row group, row 2i goes to i and row 2i + 1 to i + 4, so that
// load_b_kn's rows k0 + t and k0 + t + 4 are columns 2t and 2t + 1
__device__ __forceinline__ int kpair_row(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// ------------------------------------------------- swizzled shared tiles
// element (row, col) of a tile whose rows are `pitch` floats (a multiple
// of 32) lies at row * pitch + (col ^ swz(row))
__device__ __forceinline__ int swz(int row) {
  return ((row & 3) << 3) | (row & 4);
}

__device__ __forceinline__ int at(int pitch, int row, int col) {
  return row * pitch + (col ^ swz(row));
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix reads 8 x 8 tiles of 16-bit values: read as 32-bit values, a
// tile is 8 rows of 4 floats (16 bytes, one swizzle chunk), and lane l
// gets row l / 4, float l % 4 of it, which is the mma's (g, t). Lane l
// names row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// A = tile[row0 : row0 + 16, col0 : col0 + 8], stored [m][k]: tiles
// (rows 0-7, cols 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) are a[0..3]
__device__ __forceinline__ void load_a(FragA& f, const float* s, int pitch,
                                       int row0, int col0) {
  const int l = lane_id(), j = l >> 3;
  uint32_t raw[4];
  ldsm_x4(raw, s + at(pitch, row0 + (l & 7) + 8 * (j & 1),
                      col0 + 4 * (j >> 1)));
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split(__uint_as_float(raw[e]), f.big[e], f.small[e]);
}

// B (k x n) = tile[n0 : n0 + 8, k0 : k0 + 8]^T, stored [n][k]: tiles
// (rows 0-7, cols 0-3) and (0-7, 4-7) are b[0], b[1]
__device__ __forceinline__ void load_b_nk(FragB& f, const float* s,
                                          int pitch, int n0, int k0) {
  const int l = lane_id();
  uint32_t raw[2];
  ldsm_x2(raw, s + at(pitch, n0 + (l & 7), k0 + 4 * ((l >> 3) & 1)));
#pragma unroll
  for (int e = 0; e < 2; ++e)
    split(__uint_as_float(raw[e]), f.big[e], f.small[e]);
}

// B (k x n) = tile[k0 : k0 + 8, n0 : n0 + 8], stored [k][n]
__device__ __forceinline__ void load_b_kn(FragB& f, const float* s,
                                          int pitch, int k0, int n0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  split(s[at(pitch, k0 + t, n0 + g)], f.big[0], f.small[0]);
  split(s[at(pitch, k0 + t + 4, n0 + g)], f.big[1], f.small[1]);
}

// A = tile[k0 : k0 + 8, m0 : m0 + 16]^T, stored [k][m]: a transposed A
// read in place (ldmatrix's .trans moves 16-bit values, not floats). As
// load_b_kn, float by float: a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4). With m0 a multiple of 8, each of the four reads
// puts the warp's 32 lanes on 32 distinct banks: the 8 lanes of a group
// on 8 consecutive columns, its 4 lanes on rows whose swz differ in bits
// 3-4.
__device__ __forceinline__ void load_a_km(FragA& f, const float* s,
                                          int pitch, int k0, int m0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  split(s[at(pitch, k0 + t, m0 + g)], f.big[0], f.small[0]);
  split(s[at(pitch, k0 + t, m0 + g + 8)], f.big[1], f.small[1]);
  split(s[at(pitch, k0 + t + 4, m0 + g)], f.big[2], f.small[2]);
  split(s[at(pitch, k0 + t + 4, m0 + g + 8)], f.big[3], f.small[3]);
}

// ------------------------------------------------------------- cp.async

// 16 bytes to shared memory, of which the first src_bytes (0 to 16) come
// from global memory and the rest are zeros. src must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 4 bytes, or a zero when src_bytes is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage rows [0, ROWS) x cols [0, COLS) of a row-major source (row stride
// ld floats) into a swizzled tile of pitch PITCH. Rows at or past
// rows_valid and columns at or past cols_valid are zeros. vec: ld is a
// multiple of 4 and src 16-byte aligned, so whole 16-byte chunks move;
// otherwise one float at a time.
template <int ROWS, int COLS, int PITCH, int NTHREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int ld,
                                      int rows_valid, int cols_valid,
                                      bool vec) {
  static_assert(COLS % 4 == 0 && PITCH % 32 == 0 && COLS <= PITCH, "tile");
  if (vec) {
    constexpr int kChunks = ROWS * COLS / 4;
    // a fixed trip count, so the loop unrolls and the index arithmetic
    // folds
#pragma unroll
    for (int j = 0; j < (kChunks + NTHREADS - 1) / NTHREADS; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      if (kChunks % NTHREADS != 0 && i >= kChunks) break;
      const int r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
      const int n = r < rows_valid ? min(4, max(0, cols_valid - c)) : 0;
      cp_async16(dst + at(PITCH, r, c),
                 n > 0 ? src + (size_t)r * ld + c : src, 4 * n);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NTHREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool in = r < rows_valid && c < cols_valid;
      cp_async4(dst + at(PITCH, r, c), in ? src + (size_t)r * ld + c : src,
                in ? 4 : 0);
    }
  }
}

// stage's 16-byte path with each source row r stored at tile row
// kpair_row(r): the B operand of a product whose A is acc_as_a's
template <int ROWS, int COLS, int PITCH, int NTHREADS>
__device__ __forceinline__ void stage_kpairs(float* dst, const float* src,
                                             int ld, int rows_valid) {
  static_assert(COLS % 4 == 0 && PITCH % 32 == 0 && COLS <= PITCH &&
                ROWS % 8 == 0, "tile");
  constexpr int kChunks = ROWS * COLS / 4;
#pragma unroll
  for (int j = 0; j < (kChunks + NTHREADS - 1) / NTHREADS; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    if (kChunks % NTHREADS != 0 && i >= kChunks) break;
    const int r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
    const bool in = r < rows_valid;
    cp_async16(dst + at(PITCH, kpair_row(r), c),
               in ? src + (size_t)r * ld + c : src, in ? 16 : 0);
  }
}

}  // namespace tf32x3
