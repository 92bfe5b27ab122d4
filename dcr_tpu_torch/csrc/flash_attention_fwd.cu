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
// TFLOP/s of the bf16 tensor cores for bf16 operands, by the 67 TFLOP/s f32
// rate of the CUDA cores for f32 operands (TF32 would miss the sampling
// path's 2e-5 parity bound).
//
// bf16 design (flash_fwd_bf16_kernel), FlashAttention-2's structure:
// - with mma.sync every warp reads its own B fragments (K, V) from shared
//   memory, so shared-memory bandwidth and instruction issue, not the
//   tensor cores, set the pace; at D = 64 each warp therefore owns two
//   16-row m-tiles (one block of 4 warps per (b*h, 128 query rows)), and
//   every K or V fragment it loads feeds two products. At D = 128 and 256 a
//   warp owns one m-tile (64 rows per block), which keeps the f32
//   accumulator in registers;
// - Q fragments are loaded once with ldmatrix and stay in registers
//   (D <= 128; at D = 256 they are re-read from shared memory);
// - K and V tiles stay bf16 in shared memory (padded rows, conflict-free
//   ldmatrix) and stream through a 2-stage cp.async ring: tile j+1 is in
//   flight while tile j is computed, with one barrier per tile;
// - S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with f32
//   accumulators; the online softmax runs on the accumulator fragments in
//   registers (quad shuffles for the row max, exp2 with scale*log2(e) folded
//   in, row sums kept per thread and reduced once at the end), and P, packed
//   to bf16, is the A operand of P V straight from registers (V enters
//   through ldmatrix.trans);
// - the epilogue normalises by l, packs to bf16 and stores O; lse is compact.
// Keys per tile: 64 at D = 64 and 128, 32 at D = 256. Shared memory is
// 54-99 KB, so every instantiation opts in with cudaFuncSetAttribute.
// The helpers (cp.async, ldmatrix, mma, fragment packing) are in mma_bf16.cuh.
//
// f32 design (flash_fwd_f32_kernel): one block of 256 threads per (b*h,
// 64-row query tile); K and V tiles of 64 keys stream through shared memory;
// S = Q K^T and O += P V are f32 FMA, register-tiled 4 rows x 4 columns per
// thread, with padded shared-memory rows so the 16-byte loads of a quarter
// warp hit distinct banks. Row max and row sum reduce across the 16 threads
// that share a row with warp shuffles. Shared memory is 68 KB at D = 64 and
// 216 KB at D = 256.
//
// The inputs are [B, S, H, D] tensors read through their strides (the last
// dimension contiguous, the others multiples of 16 bytes); O is written
// [B, Sq, H, D] the same way. The C entry point returns cudaGetLastError()
// after the launch so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // keys per tile
constexpr int NT = 256;   // threads per block, viewed as 16 (ty) x 16 (tx)
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
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <int D>
constexpr int smem_floats() {
  // Qs [BM][D+4], Ks [BN][D+4], Vs [BN][D], Ps [BM][BN+4]
  return BM * (D + 4) + BN * (D + 4) + BN * D + BM * (BN + 4);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(const Params p) {
  constexpr int QP = D + 4;
  constexpr int KP = D + 4;
  constexpr int VP = D;
  constexpr int PP = BN + 4;
  constexpr int C4 = D / 4;    // 4-element chunks per row
  constexpr int G = D / 64;    // 64-column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * QP;
  float* Vs = Ks + BN * KP;
  float* Ps = Vs + BN * VP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BM;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int c = tid; c < BM * C4; c += NT) {
    const int r = c / C4;
    const int d = (c - r * C4) * 4;
    *reinterpret_cast<float4*>(&Qs[r * QP + d]) =
        *reinterpret_cast<const float4*>(qg + (int64_t)(q0 + r) * p.q_ss + d);
  }

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = p.Sk / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's readers are done (and Qs is visible)
    const int k0 = kt * BN;
    for (int c = tid; c < BN * C4; c += NT) {
      const int r = c / C4;
      const int d = (c - r * C4) * 4;
      *reinterpret_cast<float4*>(&Ks[r * KP + d]) =
          *reinterpret_cast<const float4*>(kg + (int64_t)(k0 + r) * p.k_ss + d);
      *reinterpret_cast<float4*>(&Vs[r * VP + d]) =
          *reinterpret_cast<const float4*>(vg + (int64_t)(k0 + r) * p.v_ss + d);
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i and keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    // online softmax update of the four rows this thread shares with 15 others
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= p.scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // O += P V for rows ty*4+i and columns g*64 + tx*4 + (0..3)
#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PP + n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vb =
              *reinterpret_cast<const float4*>(&Vs[(n + kk) * VP + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = comp(pa[i], kk);
            acc[i][g * 4 + 0] = fmaf(pv, vb.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(pv, vb.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(pv, vb.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(pv, vb.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float* orow = og + (int64_t)row * p.o_ss;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4 out = make_float4(acc[i][g * 4 + 0] / l[i], acc[i][g * 4 + 1] / l[i],
                               acc[i][g * 4 + 2] / l[i], acc[i][g * 4 + 3] / l[i]);
      *reinterpret_cast<float4*>(orow + g * 64 + tx * 4) = out;
    }
    if (tx == 0) p.lse[(int64_t)bh * p.Sq + row] = m[i] + logf(l[i]);
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

constexpr int MMA_NT = 128;  // 4 warps

template <int D>
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
  const int bh = blockIdx.y;
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

template <int D>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / BM, bh);
  flash_fwd_f32_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = Bf16Tiles<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + Bf16Tiles<D>::BM - 1) / Bf16Tiles<D>::BM, bh);
  flash_fwd_bf16_kernel<D><<<grid, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const Params& p, bool bf16, int bh, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return bf16 ? launch_bf16<64>(p, bh, stream) : launch_f32<64>(p, bh, stream);
    case 128: return bf16 ? launch_bf16<128>(p, bh, stream) : launch_f32<128>(p, bh, stream);
    case 256: return bf16 ? launch_bf16<256>(p, bh, stream) : launch_f32<256>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
int dcr_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                  int dtype, int B, int H, int Sq, int Sk, int D,
                  int64_t q_sb, int64_t q_ss, int64_t q_sh,
                  int64_t k_sb, int64_t k_ss, int64_t k_sh,
                  int64_t v_sb, int64_t v_ss, int64_t v_sh,
                  int64_t o_sb, int64_t o_ss, int64_t o_sh,
                  float scale, void* stream) {
  const int64_t bh = (int64_t)B * H;
  if (Sq <= 0 || Sk <= 0 || Sq % BM || Sk % BN || bh <= 0 || bh > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, H, Sq, Sk,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale};
  return (int)dispatch_d(p, dtype == 1, (int)bh, D, static_cast<cudaStream_t>(stream));
}

const char* dcr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
