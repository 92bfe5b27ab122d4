// Flash-attention forward for Hopper (sm_90a), f32 and bf16 operands.
//
// Replaces the Pallas TPU kernel dcr_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd). Same function: O = softmax(Q K^T * D^-1/2) V by
// online softmax over key tiles (running max m from -1e30, running sum l, f32
// accumulator), plus lse = m + log(l) per query row. Logits, statistics and
// the accumulator are f32; with bf16 operands P is rounded to bf16 before the
// P V product, as the TPU kernel does (p.astype(in_dtype)), and l sums the
// unrounded P. O has the input dtype; lse is written compact as [B*H, Sq] f32
// (no 128-lane broadcast).
//
// Bound on an H100 SXM (700 W data-sheet peaks): 4*Sq*Sk*D flops per (b, h)
// against ~(2*Sq + 2*Sk)*D*bytes of traffic, so at the UNet's shapes
// (S = 256..4096, D = 64) the kernel is bound by operations: by the 989
// TFLOP/s of the bf16 tensor cores for bf16 operands; for f32 operands by
// the 165 TFLOP/s that f32-accurate work gets from the TF32 tensor cores
// (495 / 3, see below), against 67 TFLOP/s on the CUDA cores.
//
// Both kernels share FlashAttention-2's structure on mma.sync:
// - one block of 4 warps per (b*h, query tile), 16 query rows per warp and
//   m-tile; with mma.sync every warp reads its own B fragments (K, V) from
//   shared memory, so shared-memory traffic and instruction issue, not the
//   tensor cores, set the pace;
// - K and V tiles stream through a 2-stage cp.async ring in padded shared
//   memory: tile j+1 is in flight while tile j is computed, with one
//   barrier per tile;
// - S = Q K^T and O += P V are tensor-core products with f32 accumulators;
//   the online softmax runs on the accumulator fragments in registers (quad
//   shuffles for the row max, exp2 with scale*log2(e) folded in, row sums
//   kept per thread and reduced once at the end), and P is the A operand of
//   P V straight from registers;
// - the epilogue normalises by l and stores O; lse is compact.
//
// bf16 (flash_fwd_bf16_kernel): m16n8k16 bf16 products (mma_bf16.cuh). At
// D = 64 each warp owns two 16-row m-tiles (128 query rows per block), and
// every K or V fragment it loads feeds two products; at D = 128 and 256 a
// warp owns one (64 rows per block), which keeps the f32 accumulator in
// registers. Q fragments are loaded once with ldmatrix and stay in
// registers (D <= 128; at D = 256 they are re-read from shared memory); P,
// packed to bf16, meets V through ldmatrix.trans. Keys per tile: 64 at
// D = 64 and 128, 32 at D = 256; 54-99 KB of shared memory.
//
// f32 (flash_fwd_tf32x3_kernel, the sampling path and the f32 training
// mode): split TF32 on the tensor cores (mma_tf32.cuh). One TF32 product
// keeps about three decimal digits and misses the f32 paths' 2e-5 parity,
// so every operand is split into two TF32 parts and each product is taken
// as hi*hi' + hi*lo' + lo*hi' (m16n8k8, f32 accumulators): three times the
// tensor-core work at f32 accuracy, 165 TFLOP/s of f32 work at most
// against 67 on the CUDA cores, which held the FMA kernel this replaces
// near SDPA's time. What bounds it on the card is the work around the
// products: every K, V and P element is split (5 integer and float
// instructions) before it enters a product, and the tensor cores' sums
// round toward zero. The design:
// - Q is split once per block into two shared tiles (hi, lo); K and V are
//   split per fragment as they leave shared memory, P in registers. At
//   D = 64, when the grid still gives every SM two blocks, each warp owns
//   two 16-row m-tiles (128 query rows per block) and every split K or V
//   fragment feeds both; otherwise one (64 rows per block);
// - the cross terms hi*lo' + lo*hi' of S go to an accumulator of their own,
//   added to hi*hi' once per key tile, and so do O's where the registers
//   allow (one m-tile per warp, D <= 128): the sums of the tensor cores
//   truncate, and at the magnitude of the hi*hi' sum that loses the x100
//   logits' parity (S) and half the margin of the others' (O);
// - the k order inside each 8-wide step is permuted (mma_tf32.cuh), so Q and
//   K pairs are 64-bit loads and P is the A operand as it stands;
// - keys per tile: 32 (16 at D = 256); 71-198 KB of shared memory.
//
// The inputs are [B, S, H, D] tensors read through their strides (the last
// dimension contiguous, the others multiples of 16 bytes); O is written
// [B, Sq, H, D] the same way. The C entry point returns cudaGetLastError()
// after the launch so a refused launch reaches the caller.
//
// b*h runs on grid.y, whose limit is 65535. The C entry point launches the
// b*h rows bh0 .. bh0 + bh_count - 1 (bh_count <= 65535); the caller issues
// larger B*H in such chunks (ops/flash_attention.py grid_chunks), and the
// kernels' CHUNKED instantiations add bh0 to blockIdx.y. At B*H <= 65535 it
// is one launch of the instantiations without the offset: the grid, the
// block order and the compiled code of a launch without chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int TILE = 64;     // Sq and Sk are multiples of this; every row and key tile divides it
constexpr int MMA_NT = 128;  // threads per block: 4 warps
constexpr int MAX_GRID_Y = 65535;  // b*h rows of one launch
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Sq, Sk;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int bh0;  // first b*h row of this launch; blockIdx.y counts from it
};

template <int D, int MT>
struct Tf32Tiles {
  static constexpr int BM = 64 * MT;                              // query rows per block
  static constexpr int BN = D == 256 ? 16 : 32;                   // keys per tile
  static constexpr int LDQK = D + mma_tf32::PAD_PAIRS;            // Q and K rows, floats
  static constexpr int LDV = D + mma_tf32::PAD_K_ROWS;            // V rows, floats
  // O's cross terms in their own accumulator where the registers allow
  static constexpr bool OSPLIT = MT == 1 && D <= 128;
  // Qhi, Qlo [BM][LDQK]; K ring of 2 stages [BN][LDQK]; V ring [BN][LDV]
  static constexpr int SMEM = ((2 * BM + 2 * BN) * LDQK + 2 * BN * LDV) * 4;
};

template <int D, int MT, bool CHUNKED>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_tf32x3_kernel(const Params p) {
  using namespace mma_tf32;
  using Tl = Tf32Tiles<D, MT>;
  constexpr int BM = Tl::BM, BN = Tl::BN, LDQK = Tl::LDQK, LDV = Tl::LDV;
  constexpr bool OSPLIT = Tl::OSPLIT;
  constexpr int KD = D / 8;   // k-steps of S over D
  constexpr int NS = BN / 8;  // n-tiles of S (keys), and k-steps of P V
  constexpr int NO = D / 8;   // n-tiles of O (head dim)
  extern __shared__ float4 smem_f4[];
  float* Qhi = reinterpret_cast<float*>(smem_f4);
  float* Qlo = Qhi + BM * LDQK;
  float* Ks = Qlo + BM * LDQK;
  float* Vs = Ks + 2 * BN * LDQK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = CHUNKED ? p.bh0 + blockIdx.y : blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BM;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile_async<BM, D, LDQK, MMA_NT>(Qhi, qg + (int64_t)q0 * p.q_ss, p.q_ss, tid);
  mma_bf16::cp_async_commit();
  load_tile_async<BN, D, LDQK, MMA_NT>(Ks, kg, p.k_ss, tid);
  load_tile_async<BN, D, LDV, MMA_NT>(Vs, vg, p.v_ss, tid);
  mma_bf16::cp_async_commit();

  // split Q once: Qhi = tf32(q), Qlo = tf32(q - Qhi); the loop's first
  // barrier publishes it
  mma_bf16::cp_async_wait<1>();  // the Q group; K/V tile 0 may still be in flight
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BM * D / 4 / MMA_NT; ++i) {
    const int c = tid + i * MMA_NT;
    const int r = c / (D / 4);
    const int d = (c - r * (D / 4)) * 4;
    float4* hp = reinterpret_cast<float4*>(Qhi + r * LDQK + d);
    const float4 x = *hp;
    uint32_t hi[4], lo[4];
    split(x.x, hi[0], lo[0]);
    split(x.y, hi[1], lo[1]);
    split(x.z, hi[2], lo[2]);
    split(x.w, hi[3], lo[3]);
    *hp = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                      __uint_as_float(hi[3]));
    *reinterpret_cast<float4*>(Qlo + r * LDQK + d) =
        make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]),
                    __uint_as_float(lo[3]));
  }
  // this thread's element (row g, column 2t) of its warp's first m-tile of
  // Q; m-tile mt is rows mt * 64 + warp * 16 .. + 16 of the block
  const float* qh = Qhi + (warp * 16 + g) * LDQK + 2 * t;
  const float* ql = Qlo + (warp * 16 + g) * LDQK + 2 * t;

  // O's hi*hi' sum and, where registers allow, its cross terms' (o_x)
  float o[MT][NO][4], o_x[OSPLIT ? MT : 1][OSPLIT ? NO : 1][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        o[mt][n][c] = 0.f;
        if constexpr (OSPLIT) o_x[mt][n][c] = 0.f;
      }
  // rows g and g + 8 of each m-tile; m in log2 units, l per thread until the end
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = NEG_INF, l[mt][0] = l[mt][1] = 0.f;
  const float sl2 = p.scale * LOG2E;

  const int n_tiles = p.Sk / BN;
  for (int j = 0; j < n_tiles; ++j) {
    mma_bf16::cp_async_wait<0>();
    __syncthreads();  // tile j has landed for all, and stage (j+1)&1 is free
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      const int64_t k0 = (int64_t)(j + 1) * BN;
      load_tile_async<BN, D, LDQK, MMA_NT>(Ks + st * BN * LDQK, kg + k0 * p.k_ss, p.k_ss, tid);
      load_tile_async<BN, D, LDV, MMA_NT>(Vs + st * BN * LDV, vg + k0 * p.v_ss, p.v_ss, tid);
      mma_bf16::cp_async_commit();
    }
    // this thread's K element (key g, column 2t) and V element (key 2t, column g)
    const float* Kt = Ks + (j & 1) * BN * LDQK + g * LDQK + 2 * t;
    const float* Vt = Vs + (j & 1) * BN * LDV + 2 * t * LDV + g;

    // S = Q K^T, MT x 16 rows x BN keys per warp: hi*hi' in s, the cross
    // terms in s_x; each split K fragment feeds MT products
    float s[MT][NS][4], s_x[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] = s_x[mt][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t b_hi[NS][2], b_lo[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(Kt + n * 8 * LDQK + kk * 8);
        split_b(b_hi[n], b_lo[n], x.x, x.y);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a_hi[4], a_lo[4];
        load_a(a_hi, qh + mt * 64 * LDQK + kk * 8, LDQK);
        load_a(a_lo, ql + mt * 64 * LDQK + kk * 8, LDQK);
        mma3(s[mt], s_x[mt], a_hi, a_lo, b_hi, b_lo);
      }
    }

    // online softmax on the fragments: each row lives in one quad of lanes;
    // the scale is positive, so the max of the raw logits is taken first
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] += s_x[mt][n][c];
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r] * sl2);
        corr[r] = mma_bf16::exp2_approx(m[mt][r] - m_new);
        m[mt][r] = m_new;
        l[mt][r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[mt][n][c] = mma_bf16::exp2_approx(fmaf(s[mt][n][c], sl2, -m[mt][c >> 1]));
        l[mt][0] += s[mt][n][0] + s[mt][n][1];
        l[mt][1] += s[mt][n][2] + s[mt][n][3];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[mt][n][c] *= corr[c >> 1];
          if constexpr (OSPLIT) o_x[mt][n][c] *= corr[c >> 1];
        }
    }

    // O += P V: P from registers, V's rows in the same permuted key order;
    // each split V fragment feeds MT products
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) split_a(a_hi[mt], a_lo[mt], s[mt][kk]);
      const float* v = Vt + kk * 8 * LDV;
      // D = 256: passes of 8 n-tiles keep the split fragments in registers
      constexpr int NP = NO > 16 ? 8 : NO;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NP) {
        uint32_t b_hi[NP][2], b_lo[NP][2];
#pragma unroll
        for (int n = 0; n < NP; ++n)
          split_b(b_hi[n], b_lo[n], v[(n0 + n) * 8], v[LDV + (n0 + n) * 8]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          auto& big = *reinterpret_cast<float(*)[NP][4]>(&o[mt][n0]);
          if constexpr (OSPLIT)
            mma3(big, *reinterpret_cast<float(*)[NP][4]>(&o_x[mt][n0]), a_hi[mt], a_lo[mt],
                 b_hi, b_lo);
          else
            mma3(big, big, a_hi[mt], a_lo[mt], b_hi, b_lo);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
    const int row0 = q0 + mt * 64 + warp * 16 + g;
    const float inv0 = 1.f / l[mt][0], inv1 = 1.f / l[mt][1];
    float* o0 = og + (int64_t)row0 * p.o_ss + 2 * t;
    float* o1 = o0 + 8 * p.o_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if constexpr (OSPLIT) {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[mt][n][c] += o_x[mt][n][c];
      }
      *reinterpret_cast<float2*>(o0 + n * 8) =
          make_float2(o[mt][n][0] * inv0, o[mt][n][1] * inv0);
      *reinterpret_cast<float2*>(o1 + n * 8) =
          make_float2(o[mt][n][2] * inv1, o[mt][n][3] * inv1);
    }
    if (t == 0) {
      const int64_t row = (int64_t)bh * p.Sq + row0;
      p.lse[row] = (m[mt][0] + log2f(l[mt][0])) * LN2;
      p.lse[row + 8] = (m[mt][1] + log2f(l[mt][1])) * LN2;
    }
  }
}

template <int D>
struct Bf16Tiles {
  static constexpr int MT = D == 64 ? 2 : 1;     // 16-row m-tiles per warp
  static constexpr int BM = 64 * MT;             // query rows per block
  static constexpr int BN = D == 256 ? 32 : 64;  // keys per tile
  static constexpr bool QREG = D <= 128;         // Q fragments held in registers
  static constexpr int LD = D + mma_bf16::PAD;   // shared-memory row, elements
  // Qs [BM][LD], then K and V rings of 2 stages [BN][LD] each
  static constexpr int SMEM = (BM + 4 * BN) * LD * 2;
};

template <int D, bool CHUNKED>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_bf16_kernel(const Params p) {
  using namespace mma_bf16;
  using Tl = Bf16Tiles<D>;
  constexpr int MT = Tl::MT, BN = Tl::BN, LD = Tl::LD;
  constexpr bool QREG = Tl::QREG;
  constexpr int KD = D / 16;  // k-steps of S over D
  constexpr int NS = BN / 8;  // n-tiles of S (keys)
  constexpr int NO = D / 8;   // n-tiles of O (head dim)
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* Ks = Qs + Tl::BM * LD;
  bf16* Vs = Ks + 2 * BN * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = CHUNKED ? p.bh0 + blockIdx.y : blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * Tl::BM;
  // m-tile mt of this warp is rows mt*64 + warp*16 .. +16 of the block: each
  // 64-row half lies wholly inside Sq or wholly past it (Sq % 64 == 0)
  const int halves = min(MT, (p.Sq - q0) / 64);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    if (mt < halves)
      load_tile_async<64, D, MMA_NT>(Qs + mt * 64 * LD, qg + (int64_t)(q0 + mt * 64) * p.q_ss,
                                     p.q_ss, tid);
  cp_async_commit();
  load_tile_async<BN, D, MMA_NT>(Ks, kg, p.k_ss, tid);
  load_tile_async<BN, D, MMA_NT>(Vs, vg, p.v_ss, tid);
  cp_async_commit();

  uint32_t qf[MT][QREG ? KD : 1][4];
  if constexpr (QREG) {
    cp_async_wait<1>();  // the Q group; K/V tile 0 may still be in flight
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        load_a<LD>(qf[mt][kk], Qs, mt * 64 + warp * 16, kk * 16, lane);
  }
  float o[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  // rows g and g + 8 of each m-tile; m in log2 units, l per thread until the end
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = NEG_INF, l[mt][0] = l[mt][1] = 0.f;
  const float sl2 = p.scale * LOG2E;

  const int n_tiles = p.Sk / BN;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed for all, and stage (j+1)&1 is free
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      const int64_t k0 = (int64_t)(j + 1) * BN;
      load_tile_async<BN, D, MMA_NT>(Ks + st * BN * LD, kg + k0 * p.k_ss, p.k_ss, tid);
      load_tile_async<BN, D, MMA_NT>(Vs + st * BN * LD, vg + k0 * p.v_ss, p.v_ss, tid);
      cp_async_commit();
    }
    const bf16* Kt = Ks + (j & 1) * BN * LD;
    const bf16* Vt = Vs + (j & 1) * BN * LD;

    // S = Q K^T, MT x 16 rows x BN keys per warp; each K fragment feeds MT products
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = qf[mt][kk][i];
        } else {
          load_a<LD>(a[mt], Qs, mt * 64 + warp * 16, kk * 16, lane);
        }
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        load_b_rows<LD>(bk, Kt, np * 16, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // online softmax on the fragments: each row lives in one quad of lanes;
    // the scale is positive, so the max of the raw logits is taken first
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r] * sl2);
        corr[r] = exp2_approx(m[mt][r] - m_new);
        m[mt][r] = m_new;
        l[mt][r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[mt][n][0] = exp2_approx(fmaf(s[mt][n][0], sl2, -m[mt][0]));
        s[mt][n][1] = exp2_approx(fmaf(s[mt][n][1], sl2, -m[mt][0]));
        s[mt][n][2] = exp2_approx(fmaf(s[mt][n][2], sl2, -m[mt][1]));
        s[mt][n][3] = exp2_approx(fmaf(s[mt][n][3], sl2, -m[mt][1]));
        l[mt][0] += s[mt][n][0] + s[mt][n][1];
        l[mt][1] += s[mt][n][2] + s[mt][n][3];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[mt][n][0] *= corr[0];
        o[mt][n][1] *= corr[0];
        o[mt][n][2] *= corr[1];
        o[mt][n][3] *= corr[1];
      }
    }

    // O += P V with P (rounded to bf16) as the A operand from registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pack_a(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bv[4];
        load_b_trans<LD>(bv, Vt, kk * 16, dp * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * dp], a[mt], bv[0], bv[1]);
          mma(o[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= halves) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
    const int row0 = q0 + mt * 64 + warp * 16;
    const float inv0 = 1.f / l[mt][0], inv1 = 1.f / l[mt][1];
#pragma unroll
    for (int n = 0; n < NO; ++n) store_c(og, p.o_ss, row0, n * 8, o[mt][n], inv0, inv1, lane);
    if ((lane & 3) == 0) {
      const int64_t row = (int64_t)bh * p.Sq + row0 + (lane >> 2);
      p.lse[row] = (m[mt][0] + log2f(l[mt][0])) * LN2;
      p.lse[row + 8] = (m[mt][1] + log2f(l[mt][1])) * LN2;
    }
  }
}

template <int D, int MT, bool CHUNKED>
cudaError_t launch_f32_mt(const Params& p, int bh, cudaStream_t stream) {
  using Tl = Tf32Tiles<D, MT>;
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D, MT, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / Tl::BM, bh);
  flash_fwd_tf32x3_kernel<D, MT, CHUNKED><<<grid, MMA_NT, Tl::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// at D = 64, two m-tiles per warp halve the split K and V fragments per
// product, but halve the blocks too: they are taken only while the grid
// still gives each of the H100's 132 SMs two blocks
template <int D, bool CHUNKED>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  if constexpr (D == 64)
    if (p.Sq % 128 == 0 && p.Sq / 128 * bh >= 2 * 132)
      return launch_f32_mt<64, 2, CHUNKED>(p, bh, stream);
  return launch_f32_mt<D, 1, CHUNKED>(p, bh, stream);
}

template <int D, bool CHUNKED>
cudaError_t launch_bf16(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = Bf16Tiles<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + Bf16Tiles<D>::BM - 1) / Bf16Tiles<D>::BM, bh);
  flash_fwd_bf16_kernel<D, CHUNKED><<<grid, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool C>
cudaError_t dispatch_d(const Params& p, bool bf16, int bh, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return bf16 ? launch_bf16<64, C>(p, bh, stream) : launch_f32<64, C>(p, bh, stream);
    case 128: return bf16 ? launch_bf16<128, C>(p, bh, stream) : launch_f32<128, C>(p, bh, stream);
    case 256: return bf16 ? launch_bf16<256, C>(p, bh, stream) : launch_f32<256, C>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Launches the b*h rows bh0 .. bh0 +
// bh_count - 1 of the B*H. Returns a cudaError_t (0 = success).
int dcr_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                  int dtype, int B, int H, int Sq, int Sk, int D, int bh0, int bh_count,
                  int64_t q_sb, int64_t q_ss, int64_t q_sh,
                  int64_t k_sb, int64_t k_ss, int64_t k_sh,
                  int64_t v_sb, int64_t v_ss, int64_t v_sh,
                  int64_t o_sb, int64_t o_ss, int64_t o_sh,
                  float scale, void* stream) {
  if (Sq <= 0 || Sk <= 0 || Sq % TILE || Sk % TILE || B <= 0 || H <= 0 || bh0 < 0 ||
      bh_count <= 0 || bh_count > MAX_GRID_Y || (int64_t)bh0 + bh_count > (int64_t)B * H ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, H, Sq, Sk,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale, bh0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // B*H within one grid: the kernels without the base offset, bh0 = 0
  if ((int64_t)B * H <= MAX_GRID_Y)
    return bh0 == 0 && bh_count == B * H ? (int)dispatch_d<false>(p, dtype == 1, bh_count, D, s)
                                         : (int)cudaErrorInvalidValue;
  return (int)dispatch_d<true>(p, dtype == 1, bh_count, D, s);
}

const char* dcr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
