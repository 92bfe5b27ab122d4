// bf16 tensor-core building blocks for the flash-attention kernels (sm_90a).
//
// Raw PTX, so no include path beyond the CUDA toolkit's:
// - cp.async.cg 16-byte global -> shared copies with commit/wait groups, to
//   stream tiles through a ring of shared-memory stages while the previous
//   stage is computed on;
// - ldmatrix (plain and .trans) to load m16n8k16 operand fragments from
//   shared memory, four 8x8 matrices per instruction;
// - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with the f32
//   accumulator updated in place.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                           a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same cols)
//   B (16 x 8, k x n):      b0 (k 2t, 2t+1, col g), b1 (k 2t+8, 2t+9, col g)
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so the accumulators of two neighbouring n-tiles, packed to bf16, are the A
// fragment of the next product (pack_a): a softmax P or a dS never needs to
// go through shared memory.
//
// Shared-memory tiles are [rows][D + PAD] bf16, row major. The 16-byte pad
// shifts each row by one 16-byte bank group, so the eight rows an ldmatrix
// phase reads land in eight distinct bank groups (no conflicts) and every
// row start stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;  // bf16 elements (16 bytes) of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, ROWS) of a [S, D] bf16 head slice (row stride in elements) ->
// shared tile [ROWS][D + PAD], 16-byte copies spread over NT threads
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int64_t row_stride, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CH) % NT == 0, "tile chunks must divide over the threads");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CH;
    const int ch = c - r * CH;
    cp_async_16(dst + r * (D + PAD) + ch * 8, src + r * row_stride + ch * 8);
  }
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

// A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a [rows][LD] tile
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0,
                                       int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles when B[k][n] = tile[n][k] (the tile's rows are
// B's columns, e.g. K for S = Q K^T): rows [n0, n0 + 16), cols [k0, k0 + 16).
// b[0], b[1] serve n-tile n0; b[2], b[3] serve n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile, int n0,
                                            int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles when B[k][n] = tile[k][n] (e.g. V for O = P V):
// rows [k0, k0 + 16), cols [n0, n0 + 16), through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile, int k0,
                                             int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                           (lane >> 4) * 8);
}

// d += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// subnormal results flushed to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (16 rows x 16 cols) formed by accumulator n-tiles c[2j], c[2j+1]
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// store an accumulator n-tile (rows row0 + g and row0 + g + 8, cols col0 + 2t,
// 2t+1) of a [S, D] bf16 head slice, scaled
__device__ __forceinline__ void store_c(bf16* g_base, int64_t row_stride, int row0, int col0,
                                        const float (&c)[4], float s0, float s1, int lane) {
  const int g = lane >> 2, t = lane & 3;
  bf16* p0 = g_base + (int64_t)(row0 + g) * row_stride + col0 + 2 * t;
  bf16* p1 = p0 + 8 * row_stride;
  *reinterpret_cast<uint32_t*>(p0) = pack(c[0] * s0, c[1] * s0);
  *reinterpret_cast<uint32_t*>(p1) = pack(c[2] * s1, c[3] * s1);
}

}  // namespace mma_bf16
