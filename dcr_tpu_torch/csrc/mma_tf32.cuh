// Split-TF32 (3xTF32) tensor-core building blocks for f32 operands (sm_90a).
//
// A TF32 product keeps 10 explicit mantissa bits of each operand, about
// three decimal digits: too coarse for the f32 paths' 2e-5 parity. Each
// f32 operand is therefore split as x = hi + lo, hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (cvt.rna), and a product is
// taken as hi*hi' + hi*lo' + lo*hi' with f32 accumulators; the dropped
// lo*lo' is about 2^-22 of the product. Each TF32 product of the split
// parts is exact in f32, so the result is close to an f32 product at three
// times the tensor-core work, which still runs ahead of the CUDA cores'
// f32 rate (495 / 3 = 165 against 67 TFLOP/s dense on an H100 SXM).
// torch.backends.cuda.matmul.allow_tf32 does not govern these kernels; this
// split is what keeps them at f32 accuracy.
//
// Fragment layouts of mma.sync m16n8k8 .tf32 (lane = 4 * g + t):
//   A (16 x 8, row major): a0 (row g, col t), a1 (row g+8, col t),
//                          a2 (row g, col t+4), a3 (row g+8, col t+4)
//   B (8 x 8, k x n):      b0 (k t, col g), b1 (k t+4, col g)
//   C (16 x 8, f32):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// The k order inside one 8-wide step is free as long as A and B agree. The
// kernels take k = t <-> 2t and k = t+4 <-> 2t+1: then a thread's A pair
// (a0, a2) and B pair (b0, b1) of a row-major operand are two neighbouring
// elements, one 64-bit shared-memory load each, and an accumulator n-tile
// (c0, c1, c2, c3) is the A fragment (a0, a2, a1, a3) of the next product:
// a softmax P never goes through shared memory.
//
// Shared-memory tiles are [rows][LD] f32 with padded rows, 16-byte aligned
// for cp.async. Row-major operands read as 64-bit pairs (rows g, columns 2t)
// take LD = D + 8, so the four rows of a half warp start 8 banks apart; an
// operand whose rows are the k index (rows 2t and 2t+1, column g: V in
// O = P V) takes LD = D + 4, so rows 2t start 8 banks apart. Both are free
// of bank conflicts.
//
// A tile read both ways (dO in dK/dV: the B operand of dP^T = V dO^T as
// pairs, of dV += P^T dO as k rows) would want both paddings; no padding
// serves both, and there is no 32-bit ldmatrix.trans. Such a tile is
// swizzled instead: [rows][D] with no padding, the 16-byte chunk ch of row
// r stored at chunk ch ^ 2 sw(r), sw(r) = (r ^ r >> 2) & 3 (swz below). For
// row bases that are multiples of 8, sw takes four distinct values over
// rows 0-3, over rows 4-7, over the even rows and over the odd rows; the
// chunk pairs {2j, 2j + 1} stay together. So the 64-bit pairs of rows g
// (one half warp: four rows, eight columns) and the 32-bit elements of rows
// 2t, column g (four rows, eight columns) both fall on 32 distinct banks.
// Rows read whole as float4 by the lanes of a quad (rows g, or rows 2t and
// 2t + 1: eight rows, one 16-byte chunk each) are free of conflicts at
// LD = D + 4.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace mma_tf32 {

constexpr int PAD_PAIRS = 8;   // row padding, f32 elements, of tiles read as 64-bit pairs
constexpr int PAD_K_ROWS = 4;  // row padding of tiles whose rows are the k index

// rows [0, ROWS) of a [S, D] f32 head slice (row stride in elements) ->
// shared tile [ROWS][LD], 16-byte copies spread over NT threads
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                int64_t row_stride, int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  static_assert((ROWS * CH) % NT == 0, "tile chunks must divide over the threads");
  static_assert(LD % 4 == 0, "rows must stay 16-byte aligned");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CH;
    const int ch = c - r * CH;
    mma_bf16::cp_async_16(dst + r * LD + ch * 4, src + r * row_stride + ch * 4);
  }
}

// column of element (r, c) inside row r of a swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return c ^ (((r ^ (r >> 2)) & 3) << 3); }

// rows [0, ROWS) of a [S, D] f32 head slice -> swizzled shared tile [ROWS][D]
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_swz(float* dst, const float* src, int64_t row_stride,
                                              int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  static_assert((ROWS * CH) % NT == 0, "tile chunks must divide over the threads");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CH;
    const int ch = c - r * CH;
    mma_bf16::cp_async_16(dst + r * D + swz(r, ch * 4), src + r * row_stride + ch * 4);
  }
}

// the pair (r, c), (r, c + 1) of a swizzled tile [rows][D], c even
template <int D>
__device__ __forceinline__ float2 pair(const float* tile, int r, int c) {
  return *reinterpret_cast<const float2*>(tile + r * D + swz(r, c));
}

// the element (r, c) of a swizzled tile [rows][D]
template <int D>
__device__ __forceinline__ float elem(const float* tile, int r, int c) {
  return tile[r * D + swz(r, c)];
}

// f32 -> tf32 bit pattern, rounded to nearest with ties away from zero:
// cvt.rna.tf32.f32's result (for every input but a NaN's payload), as an
// integer add and mask, which issue at full rate where a conversion does not
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, tf32 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] += a b[n] for N n-tiles at f32 accuracy from split operands: hi*hi'
// into big, the two small cross terms into small. The tensor cores round
// their f32 sums toward zero, so a separate small accumulator keeps the
// cross terms' sums from adding truncation at the big one's magnitude (big
// and small may be the same array). Consecutive products go to different
// accumulators, so the tensor cores are not held up by the dependency
// between the products of one n-tile.
template <int N>
__device__ __forceinline__ void mma3(float (&big)[N][4], float (&small)[N][4],
                                     const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                     const uint32_t (&b_hi)[N][2],
                                     const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(small[n], a_lo, b_hi[n][0], b_hi[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(small[n], a_hi, b_lo[n][0], b_lo[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(big[n], a_hi, b_hi[n][0], b_hi[n][1]);
}

// A fragment (rows g, g+8; k pair 2t, 2t+1 of one 8-wide step) of a
// row-major tile [rows][ld] that already holds tf32 values; p is the
// thread's element (row g, column 2t)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* p, int ld) {
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  a[0] = __float_as_uint(x0.x);
  a[1] = __float_as_uint(x1.x);
  a[2] = __float_as_uint(x0.y);
  a[3] = __float_as_uint(x1.y);
}

// split B fragments of one n-tile from the thread's pair (k 2t, 2t+1)
__device__ __forceinline__ void split_b(uint32_t (&hi)[2], uint32_t (&lo)[2], float x0,
                                        float x1) {
  split(x0, hi[0], lo[0]);
  split(x1, hi[1], lo[1]);
}

// split A fragments (rows g, g + 8; k pair 2t, 2t + 1) from the f32 pairs
// x0 (row g) and x1 (row g + 8) of a row-major tile
__device__ __forceinline__ void split_a_rows(uint32_t (&hi)[4], uint32_t (&lo)[4], float2 x0,
                                             float2 x1) {
  split(x0.x, hi[0], lo[0]);
  split(x1.x, hi[1], lo[1]);
  split(x0.y, hi[2], lo[2]);
  split(x1.y, hi[3], lo[3]);
}

// acc = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc)))):
// four more steps of an f32 dot product taken in order
__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// an accumulator n-tile as split A fragments of the next product
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

}  // namespace mma_tf32
