// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, f32 and bf16.
//
// Replaces the Pallas TPU kernels of dcr_tpu/ops/flash_attention.py:
//   flash_bwd_dq_bf16_kernel, flash_bwd_dq_tf32x3_kernel   <- _bwd_dq_kernel
//   flash_bwd_dkv_bf16_kernel, flash_bwd_dkv_tf32x3_kernel <- _bwd_dkv_kernel
// (both launched by _flash_bwd; the first of each pair takes bf16
// operands, the second f32). Same functions, by recomputation from the
// forward's log-sum-exp:
//   S = Q K^T * D^-1/2, P = exp(S - lse), dP = dO V^T, delta = rowsum(dO o O),
//   dS = P o (dP - delta), dQ = D^-1/2 dS K, dK = D^-1/2 dS^T Q, dV = P^T dO.
// Logits, statistics and accumulators are f32. With bf16 operands dS (and P
// before dV = P^T dO) is rounded to bf16 before its product, as the TPU
// kernels do (ds.astype(in_dtype), p.astype(in_dtype)); P itself stays f32
// in dS. delta is computed from dO and O in f32 inside each block, per
// query tile, as the TPU kernels do. No mask, no causal; Sq may differ from
// Sk.
//
// Bound on an H100 SXM (700 W data-sheet peaks): the dQ kernel does
// 6*Sq*Sk*D flops per (b, h) (S and dP recomputed, then dQ), the dK/dV kernel
// 8*Sq*Sk*D (S, dP, dV, dK), against ~(4*Sq + 2*Sk)*D elements of traffic, so
// at the UNet's training shapes (S = 256..1024, D = 64) both are bound by
// operations: the 989 TFLOP/s of the bf16 tensor cores for bf16 operands;
// for f32 operands the 165 TFLOP/s that f32-accurate work gets from the
// TF32 tensor cores as split TF32 (mma_tf32.cuh).
//
// The TPU grid runs in order, and its dK/dV kernel carries f32 VMEM
// accumulators across a sequential ("arbitrary") q-block axis. Hopper runs
// blocks in no order, so the dK/dV kernels take one block per (b*h, key
// tile) that loops over every query tile itself, in place of the TPU's
// sequential grid axis; the dQ kernels take one block per (b*h, query tile)
// that loops over every key tile, as the TPU's does. Each block owns its
// rows, loops in a fixed order and writes its gradients once from f32
// registers: no atomics, so the gradients are bit-identical run to run. dQ
// is not folded into the dK/dV kernel (that would need atomics).
//
// With mma.sync every warp reads its own B fragments from shared memory, so
// shared-memory traffic and instruction issue, not the tensor cores, set
// the pace; the accumulators and the fragments a warp keeps fill its
// registers, which sets the tiles and how many warps an SM holds.
//
// dQ, bf16 (flash_bwd_dq_bf16_kernel), flash_attention_fwd.cu's bf16
// structure with three products in place of two:
// - one block of 4 warps per (b*h, 64 query rows), 16 rows per warp. The
//   prologue loads Q, dO and lse, computes delta from dO in shared memory
//   and O from device memory, and keeps the Q and dO fragments in
//   registers (ldmatrix; at D = 256 they are re-read from shared memory);
// - K and V tiles stream in bf16 through a 2-stage cp.async ring (padded
//   rows, conflict-free ldmatrix) with one barrier per tile;
// - S = Q K^T and dP = dO V^T are m16n8k16 products (K and V as B rows);
//   P = exp2(S * scale*log2(e) - lse*log2(e)) and dS = P (dP - delta) are
//   formed on the f32 accumulator fragments, and dS, packed to bf16 in
//   registers, is the A operand of dQ += dS K, K entering through
//   ldmatrix.trans from the same shared tile: each K tile is loaded once
//   and serves two products;
// - dQ accumulates in f32 registers and is scaled once at the end. Keys per
//   tile: 64 at D = 64, 32 at D = 128 and 256, which keeps S, dP, dQ and
//   the fragments in registers; 55-133 KB of shared memory.
//
// dK/dV, bf16 (flash_bwd_dkv_bf16_kernel):
// - a block has 4 warps; each warp owns MT m-tiles of 16 keys, so a block
//   holds 64 * MT keys. MT = 2 (D = 64, when the grid still gives every SM
//   two blocks) makes each Q or dO fragment feed two products and cuts the
//   reads per product by a third; MT = 1 otherwise. The block's K and V
//   stay resident, bf16, in padded shared memory (conflict-free ldmatrix);
// - Q, dO, O and lse of each stage of query rows stream through a 2-stage
//   cp.async ring, so stage i+1 loads while stage i is computed, with two
//   barriers per stage (one for the data, one for delta); delta =
//   rowsum(dO o O) is computed from the O tile in shared memory, not
//   re-read from device memory. The barriers weigh: with MT = 2 a stage is
//   64 rows computed as two 32-row sub-tiles, which halves the barriers per
//   row and timed faster on an H100 than 32-row stages. Forming delta from
//   each thread's own copies to drop one barrier per stage timed slower (it
//   waits for stage i+1 at the end of stage i, and spilled at MT = 2);
// - S^T = K Q^T and dP^T = V dO^T are mma.sync m16n8k16 bf16 products (K
//   and V as A fragments by ldmatrix, Q and dO as B by ldmatrix);
//   P^T = exp2(S^T * scale*log2(e) - lse*log2(e)) and dS^T = P^T (dP^T -
//   delta) are formed on the f32 accumulator fragments in registers, and,
//   packed to bf16, are the A operands of dV += P^T dO and dK += dS^T Q
//   straight from registers (dO and Q enter through ldmatrix.trans);
// - product sub-tiles of 64 query rows at D = 64 with MT = 1, else 32,
//   which keeps the accumulators in registers (the MT = 2 kernel sits at
//   255 registers with no spills; row strides are 32-bit inside it); at
//   D = 256 each block computes half of dK/dV's columns (grid z = 2) and
//   recomputes S^T and dP^T for it, since 16 x 256 f32 dK plus dV per warp
//   would not fit the register file. Shared memory is 73-165 KB; every
//   instantiation opts in.
// The helpers (cp.async, ldmatrix, mma, fragment packing) are in mma_bf16.cuh.
//
// f32 (flash_bwd_dq_tf32x3_kernel, flash_bwd_dkv_tf32x3_kernel; the f32
// training mode): dP and the gradient products are split TF32 on the tensor
// cores (mma_tf32.cuh: x = hi + lo, hi*hi' + hi*lo' + lo*hi' on m16n8k8,
// the k order inside each 8-wide step permuted so P^T, dS and dS^T are A
// operands straight from their accumulator fragments); S stays on the CUDA
// cores. The card holds these kernels at 1e-5 max(1, max|ref|) of the f32
// plain version, logits x100 included. There P = exp(S * scale - lse) with
// S ~ 1e3 turns one unit in the last place of S into ~3e-5 of P, and an S
// rounded in any other way than the plain product's, an exactly rounded S
// too, lands outside that bound (tests/test_torch_flash_attention_bwd.py). So each element of S is one
// f32 fmaf chain over d = 0 .. D-1 in order, as cuBLAS's f32 product (and
// the FMA kernels these replace) round it, and P's exponent is rounded step
// by step as the plain version's; the products after it are as accurate as
// f32. The design:
// - dQ: one block of 4 warps per (b*h, 64 query rows), 16 rows per warp; Q,
//   dO and lse stay in shared memory, delta is computed once per block (O
//   from device memory); K and V tiles (32 keys at D = 64, else 16) stream
//   through a 2-stage cp.async ring. Per key tile each warp computes S in
//   the accumulator layout (rows g, g + 8; keys 2t, 2t + 1 of each n-tile)
//   from float4 rows of Q and K, dP = dO V^T in split TF32, then dS =
//   P (dP - delta) in registers, the A operand of dQ += dS K with K's rows
//   2t, 2t + 1 as B.
// - dK/dV: one block of 4 warps per (b*h, 64 keys), 16 per warp, K and V
//   resident; Q, dO, O and lse of 16 query rows per stage stream through a
//   2-stage cp.async ring, delta per stage from dO and O in shared memory.
//   Per stage each warp computes S^T (its keys against the stage's rows),
//   P^T, dV += P^T dO, dP^T = V dO^T, dS^T and dK += dS^T Q, P^T and dS^T
//   split in registers as A operands. dO is read as pairs (dP^T) and as k
//   rows (dV), so its tile (and O's, to pair up for delta) is swizzled; K,
//   V and Q are padded. At D = 256 each block takes half of dK/dV's columns
//   (grid z = 2) and recomputes S^T and dP^T for it.
// - The tensor cores round their sums toward zero: the cross terms of dP
//   (and, at D = 64, of the long dQ, dK and dV sums) go to accumulators of
//   their own, added in f32 at the end.
// - Every operand is split per fragment as a warp reads it. Splitting once
//   per block into hi/lo shared tiles (dO in dQ; K and V per tile; V, and Q
//   and dO per stage, in dK/dV) cut the instructions but, on an H100, timed
//   slower: the extra shared memory and registers cost more warps per SM
//   than the splits cost (registers already hold each SM to 8-12 warps).
// 61-232 KB of shared memory; every instantiation opts in.
//
// The inputs are [B, S, H, D] tensors read through their strides (the last
// dimension contiguous, the others multiples of 16 bytes); the gradients are
// written [B, S, H, D] the same way. lse is the compact [B*H, Sq] f32 array
// the forward kernel writes. Each C entry point returns cudaGetLastError()
// after its launch so a refused launch reaches the caller.
//
// b*h runs on grid.y (limit 65535): each C entry point launches the b*h rows
// bh0 .. bh0 + bh_count - 1, and the kernels' CHUNKED instantiations add bh0
// to blockIdx.y, as the forward's do; at B*H <= 65535 the instantiations
// without the offset run, the code of a launch without chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int MMA_NT = 128;  // threads of a block: 4 warps
constexpr int MAX_GRID_Y = 65535;  // b*h rows of one launch
constexpr float LOG2E = 1.4426950408889634f;

// stride triples (batch, seq, head) in elements, in this order
enum Operand { Q_ = 0, K_, V_, O_, DO_, DQ_, DK_, DV_, N_OPERANDS };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  void* dq;
  void* dk;
  void* dv;
  int H, Sq, Sk;
  int64_t st[N_OPERANDS][3];
  float scale;
  int bh0;  // first b*h row of this launch; blockIdx.y counts from it
};

// (b, h) head slice of one operand
template <typename T>
__device__ __forceinline__ T* head(const void* base, const int64_t* st, int b, int h) {
  return const_cast<T*>(static_cast<const T*>(base)) + b * st[0] + h * st[2];
}

template <int D>
struct DqTf32Tiles {
  static constexpr int BM = 64;                 // query rows per block, 16 per warp
  static constexpr int BN = D == 64 ? 32 : 16;  // keys per tile
  static constexpr bool XACC = D == 64;         // dQ's cross terms summed apart
  // Q and K rows are read whole (S) or as the k index (dS K); dO and V as pairs
  static constexpr int LDR = D + mma_tf32::PAD_K_ROWS;
  static constexpr int LDP = D + mma_tf32::PAD_PAIRS;
  // Q [BM][LDR]; dO [BM][LDP]; K ring [2][BN][LDR]; V ring [2][BN][LDP];
  // lse, delta [BM]
  static constexpr int DO_OFF = BM * LDR;
  static constexpr int K_OFF = DO_OFF + BM * LDP;
  static constexpr int V_OFF = K_OFF + 2 * BN * LDR;
  static constexpr int LSE_OFF = V_OFF + 2 * BN * LDP;
  static constexpr int SMEM = (LSE_OFF + 2 * BM) * 4;
};

template <int D, bool CHUNKED>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_dq_tf32x3_kernel(const Params p) {
  using namespace mma_tf32;
  using Tl = DqTf32Tiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, LDR = Tl::LDR, LDP = Tl::LDP;
  constexpr bool XACC = Tl::XACC;
  constexpr int KD = D / 8;            // k-steps of dP over D
  constexpr int NS = BN / 8;           // n-tiles of S and dP (keys), k-steps of dQ
  constexpr int NO = D / 8;            // n-tiles of dQ
  constexpr int NP = NO > 8 ? 8 : NO;  // n-tiles per pass of split B fragments
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* dOs = Qs + Tl::DO_OFF;
  float* Ks = Qs + Tl::K_OFF;
  float* Vs = Qs + Tl::V_OFF;
  float* lses = Qs + Tl::LSE_OFF;
  float* deltas = lses + BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = CHUNKED ? p.bh0 + blockIdx.y : blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BM;
  const int qr = warp * 16 + g;  // this thread's query rows qr and qr + 8 of the block

  const float* qg = head<float>(p.q, p.st[Q_], b, h) + (int64_t)q0 * p.st[Q_][1];
  const float* dog = head<float>(p.dout, p.st[DO_], b, h) + (int64_t)q0 * p.st[DO_][1];
  const float* og = head<float>(p.o, p.st[O_], b, h) + (int64_t)q0 * p.st[O_][1];
  const float* kg = head<float>(p.k, p.st[K_], b, h);
  const float* vg = head<float>(p.v, p.st[V_], b, h);
  const int64_t k_ss = p.st[K_][1], v_ss = p.st[V_][1];

  load_tile_async<BM, D, LDR, MMA_NT>(Qs, qg, p.st[Q_][1], tid);
  load_tile_async<BM, D, LDP, MMA_NT>(dOs, dog, p.st[DO_][1], tid);
  if (tid < BM / 4)
    mma_bf16::cp_async_16(lses + tid * 4, p.lse + (int64_t)bh * p.Sq + q0 + tid * 4);
  mma_bf16::cp_async_commit();
  load_tile_async<BN, D, LDR, MMA_NT>(Ks, kg, k_ss, tid);
  load_tile_async<BN, D, LDP, MMA_NT>(Vs, vg, v_ss, tid);
  mma_bf16::cp_async_commit();
  mma_bf16::cp_async_wait<1>();  // Q, dO and lse; K/V tile 0 may still be in flight
  __syncthreads();

  // delta[r] = sum_d dO[r][d] * O[r][d] in f32, TPR threads per row, dO
  // from shared memory and O from device memory, once per block
  {
    constexpr int TPR = MMA_NT / BM;
    constexpr int CPT = D / 4 / TPR;  // 16-byte chunks per thread
    const int r = tid / TPR, part = tid - r * TPR;
    const float* orow = og + (int64_t)r * p.st[O_][1];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = (part + c * TPR) * 4;
      const float4 a = *reinterpret_cast<const float4*>(dOs + r * LDP + d);
      const float4 o = *reinterpret_cast<const float4*>(orow + d);
      sum += a.x * o.x + a.y * o.y + a.z * o.z + a.w * o.w;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) deltas[r] = sum;
  }
  __syncthreads();  // delta is visible
  const float lse0 = lses[qr], lse1 = lses[qr + 8];
  const float dl0 = deltas[qr], dl1 = deltas[qr + 8];
  const float* q_row = Qs + qr * LDR;            // rows qr and qr + 8 of Q
  const float* do_row = dOs + qr * LDP + 2 * t;  // dO's A fragments

  // dQ: the hi*hi' sum and, at D = 64, the cross terms' sum apart
  float dq[NO][4], dq_x[XACC ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dq[n][c] = 0.f;
      if constexpr (XACC) dq_x[n][c] = 0.f;
    }

  const int n_tiles = p.Sk / BN;
  for (int j = 0; j < n_tiles; ++j) {
    mma_bf16::cp_async_wait<0>();
    __syncthreads();  // tile j has landed for all, and stage (j+1)&1 is free
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      const int64_t k0 = (int64_t)(j + 1) * BN;
      load_tile_async<BN, D, LDR, MMA_NT>(Ks + st * BN * LDR, kg + k0 * k_ss, k_ss, tid);
      load_tile_async<BN, D, LDP, MMA_NT>(Vs + st * BN * LDP, vg + k0 * v_ss, v_ss, tid);
      mma_bf16::cp_async_commit();
    }
    const float* Kt = Ks + (j & 1) * BN * LDR;
    const float* Vt = Vs + (j & 1) * BN * LDP;

    // S = Q K^T on the CUDA cores, in the fragment layout (rows qr, qr + 8;
    // keys 8n + 2t, + 1): each element one f32 fmaf chain over d in order,
    // as the plain version's product rounds it
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(q_row + d);
      const float4 a1 = *reinterpret_cast<const float4*>(q_row + 8 * LDR + d);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* kp = Kt + (n * 8 + 2 * t) * LDR + d;
        const float4 b0 = *reinterpret_cast<const float4*>(kp);
        const float4 b1 = *reinterpret_cast<const float4*>(kp + LDR);
        fma4(s[n][0], a0, b0);
        fma4(s[n][1], a0, b1);
        fma4(s[n][2], a1, b0);
        fma4(s[n][3], a1, b1);
      }
    }
    // dP = dO V^T as split TF32: hi*hi' in dp, the cross terms in dp_x
    float dp[NS][4], dp_x[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[n][c] = dp_x[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a_hi[4], a_lo[4], b_hi[NS][2], b_lo[NS][2];
      split_a_rows(a_hi, a_lo, *reinterpret_cast<const float2*>(do_row + kk * 8),
                   *reinterpret_cast<const float2*>(do_row + 8 * LDP + kk * 8));
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(Vt + (n * 8 + g) * LDP + kk * 8 + 2 * t);
        split_b(b_hi[n], b_lo[n], x.x, x.y);
      }
      mma3(dp, dp_x, a_hi, a_lo, b_hi, b_lo);
    }
    // dS = P (dP - delta), P = exp(S * scale - lse) rounded step by step as
    // the plain version rounds it, in place of s
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[n][c] = expf(__fsub_rn(__fmul_rn(s[n][c], p.scale), c < 2 ? lse0 : lse1)) *
                  (dp[n][c] + dp_x[n][c] - (c < 2 ? dl0 : dl1));
    // dQ += dS K: dS from registers is the A operand (k = keys in the
    // permuted order), K's rows 8kk + 2t and + 1 of the tile S came from
    // the B operand
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_a(a_hi, a_lo, s[kk]);
      const float* kp = Kt + (kk * 8 + 2 * t) * LDR + g;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NP) {
        uint32_t b_hi[NP][2], b_lo[NP][2];
#pragma unroll
        for (int n = 0; n < NP; ++n)
          split_b(b_hi[n], b_lo[n], kp[(n0 + n) * 8], kp[LDR + (n0 + n) * 8]);
        auto& big = *reinterpret_cast<float(*)[NP][4]>(&dq[n0]);
        if constexpr (XACC)
          mma3(big, *reinterpret_cast<float(*)[NP][4]>(&dq_x[n0]), a_hi, a_lo, b_hi, b_lo);
        else
          mma3(big, big, a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  float* dqg = head<float>(p.dq, p.st[DQ_], b, h) + (int64_t)(q0 + qr) * p.st[DQ_][1] + 2 * t;
  const int64_t dq8 = 8 * p.st[DQ_][1];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if constexpr (XACC) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dq[n][c] += dq_x[n][c];
    }
    *reinterpret_cast<float2*>(dqg + n * 8) = make_float2(dq[n][0] * p.scale, dq[n][1] * p.scale);
    *reinterpret_cast<float2*>(dqg + dq8 + n * 8) =
        make_float2(dq[n][2] * p.scale, dq[n][3] * p.scale);
  }
}

template <int D>
struct DkvTf32Tiles {
  static constexpr int BN = 64;                    // keys per block, 16 per warp
  static constexpr int BS = 16;                    // query rows per streamed stage
  static constexpr int DOUT = D == 256 ? 128 : D;  // dK/dV columns per block
  static constexpr bool XACC = D == 64;            // dK/dV cross terms summed apart
  // K and Q rows are read whole (S^T) or, Q, as the k index (dS^T Q); V as
  // pairs (at D = 256 the narrower pad keeps shared memory under the
  // limit); dO and O are swizzled
  static constexpr int LDR = D + mma_tf32::PAD_K_ROWS;
  static constexpr int LDV = D + (D == 256 ? mma_tf32::PAD_K_ROWS : mma_tf32::PAD_PAIRS);
  // K [BN][LDR]; V [BN][LDV]; 2 stages of Q [BS][LDR], dO and O [BS][D],
  // lse [BS]; delta [BS]
  static constexpr int KV = BN * LDR + BN * LDV;
  static constexpr int STAGE = BS * LDR + 2 * BS * D + BS;
  static constexpr int SMEM = (KV + 2 * STAGE + BS) * 4;
};

template <int D, bool CHUNKED>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_dkv_tf32x3_kernel(const Params p) {
  using namespace mma_tf32;
  using Tl = DkvTf32Tiles<D>;
  constexpr int BN = Tl::BN, BS = Tl::BS, DOUT = Tl::DOUT, LDR = Tl::LDR, LDV = Tl::LDV;
  constexpr bool XACC = Tl::XACC;
  constexpr int KD = D / 8;            // k-steps of dP^T over D
  constexpr int NQ = BS / 8;           // n-tiles of S^T (queries), k-steps of dK and dV
  constexpr int NO = DOUT / 8;         // n-tiles of dK, dV
  constexpr int NP = NO > 8 ? 8 : NO;  // n-tiles per pass of split B fragments
  extern __shared__ float4 smem_f4[];
  float* Ks = reinterpret_cast<float*>(smem_f4);
  float* Vs = Ks + BN * LDR;
  float* ring = Ks + Tl::KV;
  float* deltas = ring + 2 * Tl::STAGE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = CHUNKED ? p.bh0 + blockIdx.y : blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BN;
  const int c0 = D == DOUT ? 0 : blockIdx.z * DOUT;  // first dK/dV column of this block
  const int kr = warp * 16 + g;  // this thread's key rows kr and kr + 8 of the block

  const float* qg = head<float>(p.q, p.st[Q_], b, h);
  const float* kg = head<float>(p.k, p.st[K_], b, h);
  const float* vg = head<float>(p.v, p.st[V_], b, h);
  const float* og = head<float>(p.o, p.st[O_], b, h);
  const float* dog = head<float>(p.dout, p.st[DO_], b, h);
  const float* lseg = p.lse + (int64_t)bh * p.Sq;
  // row strides fit 32 bits (checked at launch), which spares registers
  const int q_ss = (int)p.st[Q_][1], o_ss = (int)p.st[O_][1], do_ss = (int)p.st[DO_][1];
  const int k_ss = (int)p.st[K_][1], v_ss = (int)p.st[V_][1];

  load_tile_async<BN, D, LDR, MMA_NT>(Ks, kg + (int64_t)k0 * k_ss, k_ss, tid);
  load_tile_async<BN, D, LDV, MMA_NT>(Vs, vg + (int64_t)k0 * v_ss, v_ss, tid);
  mma_bf16::cp_async_commit();
  // stage i: Q, dO, O and lse of query rows i * BS .. + BS
  auto load_stage = [&](int i) {
    float* st = ring + (i & 1) * Tl::STAGE;
    const int64_t q0 = (int64_t)i * BS;
    load_tile_async<BS, D, LDR, MMA_NT>(st, qg + q0 * q_ss, q_ss, tid);
    st += BS * LDR;
    load_tile_swz<BS, D, MMA_NT>(st, dog + q0 * do_ss, do_ss, tid);
    load_tile_swz<BS, D, MMA_NT>(st + BS * D, og + q0 * o_ss, o_ss, tid);
    if (tid < BS / 4) mma_bf16::cp_async_16(st + 2 * BS * D + tid * 4, lseg + q0 + tid * 4);
    mma_bf16::cp_async_commit();
  };
  load_stage(0);
  const float* k_row = Ks + kr * LDR;          // rows kr and kr + 8 of K
  const float* v_row = Vs + kr * LDV + 2 * t;  // V's A fragments

  // dK and dV: hi*hi' sums and, at D = 64, the cross terms' sums apart
  float dk[NO][4], dv[NO][4], dk_x[XACC ? NO : 1][4], dv_x[XACC ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk[n][c] = dv[n][c] = 0.f;
      if constexpr (XACC) dk_x[n][c] = dv_x[n][c] = 0.f;
    }

  // the loop over every query stage replaces the TPU's sequential grid axis
  const int n_tiles = p.Sq / BS;
  for (int i = 0; i < n_tiles; ++i) {
    mma_bf16::cp_async_wait<0>();
    __syncthreads();  // stage i has landed for all, and stage (i+1)&1 is free
    if (i + 1 < n_tiles) load_stage(i + 1);
    const float* Qs = ring + (i & 1) * Tl::STAGE;
    const float* dOs = Qs + BS * LDR;
    const float* Os = dOs + BS * D;
    const float* lses = Os + BS * D;

    // delta[r] = sum_d dO[r][d] * O[r][d] in f32, TPR threads per row; the
    // rows of dO and O share one swizzle, so their chunks pair up in place
    {
      constexpr int TPR = MMA_NT / BS;
      constexpr int CPT = D / 4 / TPR;  // 16-byte chunks per thread
      const int r = tid / TPR, part = tid - r * TPR;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int idx = r * D + (part + c * TPR) * 4;
        const float4 a = *reinterpret_cast<const float4*>(dOs + idx);
        const float4 o = *reinterpret_cast<const float4*>(Os + idx);
        sum += a.x * o.x + a.y * o.y + a.z * o.z + a.w * o.w;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) deltas[r] = sum;
    }
    __syncthreads();

    // S^T = K Q^T on the CUDA cores, in the fragment layout (keys kr, kr + 8;
    // queries 8n + 2t, + 1): each element one f32 fmaf chain over d in
    // order, as the plain version's product rounds S
    float s[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(k_row + d);
      const float4 a1 = *reinterpret_cast<const float4*>(k_row + 8 * LDR + d);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float* qp = Qs + (n * 8 + 2 * t) * LDR + d;
        const float4 b0 = *reinterpret_cast<const float4*>(qp);
        const float4 b1 = *reinterpret_cast<const float4*>(qp + LDR);
        fma4(s[n][0], a0, b0);
        fma4(s[n][1], a0, b1);
        fma4(s[n][2], a1, b0);
        fma4(s[n][3], a1, b1);
      }
    }
    // P^T = exp(S^T * scale - lse[q]) rounded step by step as the plain
    // version rounds it; this thread's queries are 8n + 2t, + 1
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(lses + n * 8 + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[n][c] = expf(__fsub_rn(__fmul_rn(s[n][c], p.scale), (c & 1) ? l.y : l.x));
    }
    // dV += P^T dO: P^T from registers is the A operand (k = queries in the
    // permuted order), dO's rows 8kq + 2t and + 1 the B operand
#pragma unroll
    for (int kq = 0; kq < NQ; ++kq) {
      uint32_t a_hi[4], a_lo[4];
      split_a(a_hi, a_lo, s[kq]);
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NP) {
        uint32_t b_hi[NP][2], b_lo[NP][2];
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const int col = c0 + (n0 + n) * 8 + g;
          split_b(b_hi[n], b_lo[n], elem<D>(dOs, kq * 8 + 2 * t, col),
                  elem<D>(dOs, kq * 8 + 2 * t + 1, col));
        }
        auto& big = *reinterpret_cast<float(*)[NP][4]>(&dv[n0]);
        if constexpr (XACC)
          mma3(big, *reinterpret_cast<float(*)[NP][4]>(&dv_x[n0]), a_hi, a_lo, b_hi, b_lo);
        else
          mma3(big, big, a_hi, a_lo, b_hi, b_lo);
      }
    }
    // dP^T = V dO^T as split TF32: hi*hi' in dp, the cross terms in dp_x
    float dp[NQ][4], dp_x[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[n][c] = dp_x[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a_hi[4], a_lo[4], b_hi[NQ][2], b_lo[NQ][2];
      split_a_rows(a_hi, a_lo, *reinterpret_cast<const float2*>(v_row + kk * 8),
                   *reinterpret_cast<const float2*>(v_row + 8 * LDV + kk * 8));
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 x = pair<D>(dOs, n * 8 + g, kk * 8 + 2 * t);
        split_b(b_hi[n], b_lo[n], x.x, x.y);
      }
      mma3(dp, dp_x, a_hi, a_lo, b_hi, b_lo);
    }
    // dS^T = P^T (dP^T - delta[q]), in place of dP^T
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(deltas + n * 8 + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dp[n][c] = s[n][c] * (dp[n][c] + dp_x[n][c] - ((c & 1) ? dl.y : dl.x));
    }
    // dK += dS^T Q, as dV += P^T dO
#pragma unroll
    for (int kq = 0; kq < NQ; ++kq) {
      uint32_t a_hi[4], a_lo[4];
      split_a(a_hi, a_lo, dp[kq]);
      const float* qp = Qs + (kq * 8 + 2 * t) * LDR + c0 + g;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NP) {
        uint32_t b_hi[NP][2], b_lo[NP][2];
#pragma unroll
        for (int n = 0; n < NP; ++n)
          split_b(b_hi[n], b_lo[n], qp[(n0 + n) * 8], qp[LDR + (n0 + n) * 8]);
        auto& big = *reinterpret_cast<float(*)[NP][4]>(&dk[n0]);
        if constexpr (XACC)
          mma3(big, *reinterpret_cast<float(*)[NP][4]>(&dk_x[n0]), a_hi, a_lo, b_hi, b_lo);
        else
          mma3(big, big, a_hi, a_lo, b_hi, b_lo);
      }
    }
  }

  float* dkg = head<float>(p.dk, p.st[DK_], b, h) + (int64_t)(k0 + kr) * p.st[DK_][1] + c0 + 2 * t;
  float* dvg = head<float>(p.dv, p.st[DV_], b, h) + (int64_t)(k0 + kr) * p.st[DV_][1] + c0 + 2 * t;
  const int64_t dk8 = 8 * p.st[DK_][1], dv8 = 8 * p.st[DV_][1];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if constexpr (XACC) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[n][c] += dk_x[n][c], dv[n][c] += dv_x[n][c];
    }
    *reinterpret_cast<float2*>(dkg + n * 8) = make_float2(dk[n][0] * p.scale, dk[n][1] * p.scale);
    *reinterpret_cast<float2*>(dkg + dk8 + n * 8) =
        make_float2(dk[n][2] * p.scale, dk[n][3] * p.scale);
    *reinterpret_cast<float2*>(dvg + n * 8) = make_float2(dv[n][0], dv[n][1]);
    *reinterpret_cast<float2*>(dvg + dv8 + n * 8) = make_float2(dv[n][2], dv[n][3]);
  }
}

template <int D>
struct DqBf16Tiles {
  static constexpr int BM = 64;                 // query rows per block, 16 per warp
  static constexpr int BN = D == 64 ? 64 : 32;  // keys per tile
  static constexpr bool QREG = D <= 128;        // Q and dO fragments held in registers
  static constexpr int LD = D + mma_bf16::PAD;  // shared-memory row, elements
  // Qs, dOs [BM][LD]; K and V rings of 2 stages [BN][LD]; lse, delta [BM] f32
  static constexpr int SMEM = (2 * BM + 4 * BN) * LD * 2 + 2 * BM * 4;
};

template <int D, bool CHUNKED>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_dq_bf16_kernel(const Params p) {
  using namespace mma_bf16;
  using Tl = DqBf16Tiles<D>;
  constexpr int BM = Tl::BM, BN = Tl::BN, LD = Tl::LD;
  constexpr bool QREG = Tl::QREG;
  constexpr int KD = D / 16;  // k-steps of S and dP over D
  constexpr int NS = BN / 8;  // n-tiles of S and dP (keys)
  constexpr int NO = D / 8;   // n-tiles of dQ (head dim)
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LD;
  bf16* Vs = Ks + 2 * BN * LD;
  float* lses = reinterpret_cast<float*>(Vs + 2 * BN * LD);
  float* deltas = lses + BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int bh = CHUNKED ? p.bh0 + blockIdx.y : blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BM;

  const bf16* qg = head<bf16>(p.q, p.st[Q_], b, h) + (int64_t)q0 * p.st[Q_][1];
  const bf16* dog = head<bf16>(p.dout, p.st[DO_], b, h) + (int64_t)q0 * p.st[DO_][1];
  const bf16* og = head<bf16>(p.o, p.st[O_], b, h) + (int64_t)q0 * p.st[O_][1];
  const bf16* kg = head<bf16>(p.k, p.st[K_], b, h);
  const bf16* vg = head<bf16>(p.v, p.st[V_], b, h);
  const int64_t k_ss = p.st[K_][1], v_ss = p.st[V_][1];

  load_tile_async<BM, D, MMA_NT>(Qs, qg, p.st[Q_][1], tid);
  load_tile_async<BM, D, MMA_NT>(dOs, dog, p.st[DO_][1], tid);
  if (tid < BM / 4) cp_async_16(lses + tid * 4, p.lse + (int64_t)bh * p.Sq + q0 + tid * 4);
  cp_async_commit();
  load_tile_async<BN, D, MMA_NT>(Ks, kg, k_ss, tid);
  load_tile_async<BN, D, MMA_NT>(Vs, vg, v_ss, tid);
  cp_async_commit();
  cp_async_wait<1>();  // Q, dO and lse; K/V tile 0 may still be in flight
  __syncthreads();

  // delta[r] = sum_d dO[r][d] * O[r][d] in f32, TPR threads per row, dO
  // from shared memory and O from device memory, once per block
  {
    constexpr int TPR = MMA_NT / BM;
    constexpr int PER = D / TPR;  // elements per thread, a multiple of 8
    const int r = tid / TPR, part = tid - r * TPR;
    const bf16* orow = og + (int64_t)r * p.st[O_][1];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < PER / 8; ++c) {
      const int d = part * PER + c * 8;
      const uint4 a = *reinterpret_cast<const uint4*>(dOs + r * LD + d);
      const uint4 o = *reinterpret_cast<const uint4*>(orow + d);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(o2[e]);
        sum += x.x * y.x + x.y * y.y;
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) deltas[r] = sum;
  }
  uint32_t qf[QREG ? KD : 1][4], dof[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a<LD>(qf[kk], Qs, warp * 16, kk * 16, lane);
      load_a<LD>(dof[kk], dOs, warp * 16, kk * 16, lane);
    }
  }
  __syncthreads();  // delta is visible
  // rows g and g + 8 of this warp: lse in log2 units, delta
  const float lse0 = lses[warp * 16 + g] * LOG2E, lse1 = lses[warp * 16 + g + 8] * LOG2E;
  const float dl0 = deltas[warp * 16 + g], dl1 = deltas[warp * 16 + g + 8];
  const float sl2 = p.scale * LOG2E;

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int n_tiles = p.Sk / BN;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed for all, and stage (j+1)&1 is free
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      const int64_t k0 = (int64_t)(j + 1) * BN;
      load_tile_async<BN, D, MMA_NT>(Ks + st * BN * LD, kg + k0 * k_ss, k_ss, tid);
      load_tile_async<BN, D, MMA_NT>(Vs + st * BN * LD, vg + k0 * v_ss, v_ss, tid);
      cp_async_commit();
    }
    const bf16* Kt = Ks + (j & 1) * BN * LD;
    const bf16* Vt = Vs + (j & 1) * BN * LD;

    // S = Q K^T and dP = dO V^T, 16 rows x BN keys per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ado[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) aq[i] = qf[kk][i], ado[i] = dof[kk][i];
      } else {
        load_a<LD>(aq, Qs, warp * 16, kk * 16, lane);
        load_a<LD>(ado, dOs, warp * 16, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4], bv[4];
        load_b_rows<LD>(bk, Kt, np * 16, kk * 16, lane);
        load_b_rows<LD>(bv, Vt, np * 16, kk * 16, lane);
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ado, bv[0], bv[1]);
        mma(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta) with P = exp(S * scale - lse) unrounded, in place of S
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2_approx(fmaf(s[n][0], sl2, -lse0)) * (dp[n][0] - dl0);
      s[n][1] = exp2_approx(fmaf(s[n][1], sl2, -lse0)) * (dp[n][1] - dl0);
      s[n][2] = exp2_approx(fmaf(s[n][2], sl2, -lse1)) * (dp[n][2] - dl1);
      s[n][3] = exp2_approx(fmaf(s[n][3], sl2, -lse1)) * (dp[n][3] - dl1);
    }
    // dQ += dS K: dS rounded to bf16 as the A operand from registers, K
    // through ldmatrix.trans from the tile S was computed from
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t bk[4];
        load_b_trans<LD>(bk, Kt, kk * 16, dp2 * 16, lane);
        mma(dq[2 * dp2], a, bk[0], bk[1]);
        mma(dq[2 * dp2 + 1], a, bk[2], bk[3]);
      }
    }
  }
  bf16* dqg = head<bf16>(p.dq, p.st[DQ_], b, h);
  const int row0 = q0 + warp * 16;
#pragma unroll
  for (int n = 0; n < NO; ++n)
    store_c(dqg, p.st[DQ_][1], row0, n * 8, dq[n], p.scale, p.scale, lane);
}

template <int D, int MT>
struct DkvBf16Tiles {
  static constexpr int BN = 64 * MT;             // keys per block: MT m-tiles of 16 per warp
  static constexpr int BQ = D == 64 && MT == 1 ? 64 : 32;  // query rows per product sub-tile
  static constexpr int BS = D == 64 ? 64 : 32;   // query rows per streamed stage
  static constexpr int NSUB = BS / BQ;           // product sub-tiles per stage
  static constexpr int DOUT = D == 256 ? 128 : D;  // dK/dV columns per block
  static constexpr int LD = D + mma_bf16::PAD;   // shared-memory row, elements
  // Ks, Vs [BN][LD]; 2 stages of Qs, dOs, Os [BS][LD] and lse [BS]; delta [BS]
  static constexpr int STAGE = 3 * BS * LD * 2 + BS * 4;
  static constexpr int SMEM = 2 * BN * LD * 2 + 2 * STAGE + BS * 4;
};

template <int D, int MT, bool CHUNKED>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_dkv_bf16_kernel(const Params p) {
  using namespace mma_bf16;
  using Tl = DkvBf16Tiles<D, MT>;
  constexpr int BN = Tl::BN, BQ = Tl::BQ, BS = Tl::BS, NSUB = Tl::NSUB, DOUT = Tl::DOUT;
  constexpr int LD = Tl::LD;
  constexpr int KD = D / 16;    // k-steps of S^T and dP^T over D
  constexpr int NQ = BQ / 8;    // n-tiles of S^T (queries)
  constexpr int NO = DOUT / 8;  // n-tiles of dK, dV
  extern __shared__ uint4 smem_u4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_u4);
  bf16* Ks = reinterpret_cast<bf16*>(base);
  bf16* Vs = Ks + BN * LD;
  unsigned char* ring = base + 2 * BN * LD * 2;
  float* deltas = reinterpret_cast<float*>(ring + 2 * Tl::STAGE);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int bh = CHUNKED ? p.bh0 + blockIdx.y : blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BN;
  const int c0 = D == DOUT ? 0 : blockIdx.z * DOUT;  // first dK/dV column of this block
  // m-tile mt of this warp is keys mt*64 + warp*16 .. +16 of the block: each
  // 64-key part lies wholly inside Sk or wholly past it (Sk % 64 == 0)
  const int parts = min(MT, (p.Sk - k0) / 64);

  const bf16* qg = head<bf16>(p.q, p.st[Q_], b, h);
  const bf16* kg = head<bf16>(p.k, p.st[K_], b, h);
  const bf16* vg = head<bf16>(p.v, p.st[V_], b, h);
  const bf16* og = head<bf16>(p.o, p.st[O_], b, h);
  const bf16* dog = head<bf16>(p.dout, p.st[DO_], b, h);
  const float* lseg = p.lse + (int64_t)bh * p.Sq;
  // row strides fit 32 bits (checked at launch), which spares registers
  const int q_ss = (int)p.st[Q_][1], o_ss = (int)p.st[O_][1], do_ss = (int)p.st[DO_][1];
  const int k_ss = (int)p.st[K_][1], v_ss = (int)p.st[V_][1];

  auto stage = [&](int i, bf16*& Qs, bf16*& dOs, bf16*& Os, float*& lses) {
    unsigned char* st = ring + (i & 1) * Tl::STAGE;
    Qs = reinterpret_cast<bf16*>(st);
    dOs = Qs + BS * LD;
    Os = dOs + BS * LD;
    lses = reinterpret_cast<float*>(Os + BS * LD);
  };
  auto load_stage = [&](int i) {
    bf16 *Qs, *dOs, *Os;
    float* lses;
    stage(i, Qs, dOs, Os, lses);
    const int64_t q0 = (int64_t)i * BS;
    load_tile_async<BS, D, MMA_NT>(Qs, qg + q0 * q_ss, q_ss, tid);
    load_tile_async<BS, D, MMA_NT>(dOs, dog + q0 * do_ss, do_ss, tid);
    load_tile_async<BS, D, MMA_NT>(Os, og + q0 * o_ss, o_ss, tid);
    if (tid < BS / 4) cp_async_16(lses + tid * 4, lseg + q0 + tid * 4);
    cp_async_commit();
  };

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt < parts) {
      const int64_t r = k0 + mt * 64;
      load_tile_async<64, D, MMA_NT>(Ks + mt * 64 * LD, kg + r * k_ss, k_ss, tid);
      load_tile_async<64, D, MMA_NT>(Vs + mt * 64 * LD, vg + r * v_ss, v_ss, tid);
    }
  }
  load_stage(0);

  float dk[MT][NO][4], dv[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[mt][n][c] = dv[mt][n][c] = 0.f;
  const float sl2 = p.scale * LOG2E;

  // the loop over every query stage replaces the TPU's sequential grid axis
  const int n_tiles = p.Sq / BS;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // stage i has landed for all, and stage (i+1)&1 is free
    if (i + 1 < n_tiles) load_stage(i + 1);
    bf16 *Qs0, *dOs0, *Os;
    float* lses0;
    stage(i, Qs0, dOs0, Os, lses0);

    // delta[r] = sum_d dO[r][d] * O[r][d] in f32, TPR threads per row
    {
      const bf16* dOs = dOs0;
      constexpr int TPR = MMA_NT / BS;
      constexpr int PER = D / TPR;  // elements per thread, a multiple of 8
      const int r = tid / TPR, part = tid - r * TPR;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < PER / 8; ++c) {
        const int d = part * PER + c * 8;
        const uint4 a = *reinterpret_cast<const uint4*>(dOs + r * LD + d);
        const uint4 o = *reinterpret_cast<const uint4*>(Os + r * LD + d);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]);
          const float2 y = __bfloat1622float2(o2[e]);
          sum += x.x * y.x + x.y * y.y;
        }
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) deltas[r] = sum;
    }
    __syncthreads();

    // the stage's BS query rows as NSUB sub-tiles of BQ, one after another
#pragma unroll 1
    for (int sub = 0; sub < NSUB; ++sub) {
      const bf16* Qs = Qs0 + sub * BQ * LD;
      const bf16* dOs = dOs0 + sub * BQ * LD;
      const float* lses = lses0 + sub * BQ;
      const float* dls = deltas + sub * BQ;

      // S^T = K Q^T: MT x 16 keys x BQ queries per warp; each Q fragment feeds
      // MT products
      float pt[MT][NQ][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          pt[mt][n][0] = pt[mt][n][1] = pt[mt][n][2] = pt[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_a<LD>(a[mt], Ks, mt * 64 + warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4];
          load_b_rows<LD>(bq, Qs, np * 16, kk * 16, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(pt[mt][2 * np], a[mt], bq[0], bq[1]);
            mma(pt[mt][2 * np + 1], a[mt], bq[2], bq[3]);
          }
        }
      }
      // P^T = exp(S^T * scale - lse[q]); this thread's queries are 8n + 2t, +1
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 lq = *reinterpret_cast<const float2*>(lses + n * 8 + 2 * t);
        const float l0 = lq.x * LOG2E, l1 = lq.y * LOG2E;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pt[mt][n][0] = exp2_approx(fmaf(pt[mt][n][0], sl2, -l0));
          pt[mt][n][1] = exp2_approx(fmaf(pt[mt][n][1], sl2, -l1));
          pt[mt][n][2] = exp2_approx(fmaf(pt[mt][n][2], sl2, -l0));
          pt[mt][n][3] = exp2_approx(fmaf(pt[mt][n][3], sl2, -l1));
        }
      }
      // dV += P^T dO, P^T rounded to bf16 as the A operand from registers
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) pack_a(a[mt], pt[mt][2 * kq], pt[mt][2 * kq + 1]);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t bo[4];
          load_b_trans<LD>(bo, dOs, kq * 16, c0 + dp * 16, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(dv[mt][2 * dp], a[mt], bo[0], bo[1]);
            mma(dv[mt][2 * dp + 1], a[mt], bo[2], bo[3]);
          }
        }
      }
      // dP^T = V dO^T
      float ds[MT][NQ][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          ds[mt][n][0] = ds[mt][n][1] = ds[mt][n][2] = ds[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_a<LD>(a[mt], Vs, mt * 64 + warp * 16, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bo[4];
          load_b_rows<LD>(bo, dOs, np * 16, kk * 16, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(ds[mt][2 * np], a[mt], bo[0], bo[1]);
            mma(ds[mt][2 * np + 1], a[mt], bo[2], bo[3]);
          }
        }
      }
      // dS^T = P^T (dP^T - delta[q]) with the unrounded P^T
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(dls + n * 8 + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ds[mt][n][0] = pt[mt][n][0] * (ds[mt][n][0] - dl.x);
          ds[mt][n][1] = pt[mt][n][1] * (ds[mt][n][1] - dl.y);
          ds[mt][n][2] = pt[mt][n][2] * (ds[mt][n][2] - dl.x);
          ds[mt][n][3] = pt[mt][n][3] * (ds[mt][n][3] - dl.y);
        }
      }
      // dK += dS^T Q, dS^T rounded to bf16 as the A operand from registers
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) pack_a(a[mt], ds[mt][2 * kq], ds[mt][2 * kq + 1]);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t bq[4];
          load_b_trans<LD>(bq, Qs, kq * 16, c0 + dp * 16, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(dk[mt][2 * dp], a[mt], bq[0], bq[1]);
            mma(dk[mt][2 * dp + 1], a[mt], bq[2], bq[3]);
          }
        }
      }
    }
  }
  bf16* dkg = head<bf16>(p.dk, p.st[DK_], b, h);
  bf16* dvg = head<bf16>(p.dv, p.st[DV_], b, h);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= parts) break;
    const int row0 = k0 + mt * 64 + warp * 16;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      store_c(dkg, p.st[DK_][1], row0, c0 + n * 8, dk[mt][n], p.scale, p.scale, lane);
      store_c(dvg, p.st[DV_][1], row0, c0 + n * 8, dv[mt][n], 1.f, 1.f, lane);
    }
  }
}

template <int D, bool C>
cudaError_t launch_dq_tf32(const Params& p, int bh, cudaStream_t stream) {
  using Tl = DqTf32Tiles<D>;
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32x3_kernel<D, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / Tl::BM, bh);
  flash_bwd_dq_tf32x3_kernel<D, C><<<grid, MMA_NT, Tl::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool C>
cudaError_t launch_dkv_tf32(const Params& p, int bh, cudaStream_t stream) {
  using Tl = DkvTf32Tiles<D>;
  for (int t = 0; t < N_OPERANDS; ++t)
    if (p.st[t][1] > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tf32x3_kernel<D, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sk / Tl::BN, bh, D / Tl::DOUT);
  flash_bwd_dkv_tf32x3_kernel<D, C><<<grid, MMA_NT, Tl::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool C>
cudaError_t launch_dq_bf16(const Params& p, int bh, cudaStream_t stream) {
  using Tl = DqBf16Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / Tl::BM, bh);
  flash_bwd_dq_bf16_kernel<D, C><<<grid, MMA_NT, Tl::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int MT, bool C>
cudaError_t launch_dkv_bf16_mt(const Params& p, int bh, cudaStream_t stream) {
  using Tl = DkvBf16Tiles<D, MT>;
  for (int t = 0; t < N_OPERANDS; ++t)
    if (p.st[t][1] > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D, MT, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sk + Tl::BN - 1) / Tl::BN, bh, D / Tl::DOUT);
  flash_bwd_dkv_bf16_kernel<D, MT, C><<<grid, MMA_NT, Tl::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// at D = 64, two key m-tiles per warp cut the shared-memory reads per
// product by a third, but halve the blocks too: they are taken only while
// the grid still gives each of the H100's 132 SMs two blocks
template <int D, bool C>
cudaError_t launch_dkv_bf16(const Params& p, int bh, cudaStream_t stream) {
  if constexpr (D == 64)
    if ((p.Sk + 127) / 128 * bh >= 2 * 132) return launch_dkv_bf16_mt<64, 2, C>(p, bh, stream);
  return launch_dkv_bf16_mt<D, 1, C>(p, bh, stream);
}

// bf16: m16n8k16 bf16 products; f32: split TF32
template <int D, bool C>
cudaError_t launch(bool dq, bool bf16, const Params& p, int bh, cudaStream_t s) {
  if (bf16) return dq ? launch_dq_bf16<D, C>(p, bh, s) : launch_dkv_bf16<D, C>(p, bh, s);
  return dq ? launch_dq_tf32<D, C>(p, bh, s) : launch_dkv_tf32<D, C>(p, bh, s);
}

int run(bool dq, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, void* g0, void* g1, int dtype, int B,
        int H, int Sq, int Sk, int D, int bh0, int bh_count, const int64_t* strides,
        float scale, void* stream) {
  if (Sq <= 0 || Sk <= 0 || Sq % 64 || Sk % 64 || B <= 0 || H <= 0 || bh0 < 0 ||
      bh_count <= 0 || bh_count > MAX_GRID_Y || (int64_t)bh0 + bh_count > (int64_t)B * H ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, lse, dq ? g0 : nullptr, dq ? nullptr : g0,
           dq ? nullptr : g1, H, Sq, Sk, {}, scale, bh0};
  for (int t = 0; t < N_OPERANDS; ++t)
    for (int a = 0; a < 3; ++a) p.st[t][a] = strides[t * 3 + a];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  // B*H within one grid: the kernels without the base offset, bh0 = 0
  const bool chunked = (int64_t)B * H > MAX_GRID_Y;
  if (!chunked && (bh0 != 0 || bh_count != B * H)) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return (int)(chunked ? launch<64, true>(dq, bf16, p, bh_count, s)
                                  : launch<64, false>(dq, bf16, p, bh_count, s));
    case 128: return (int)(chunked ? launch<128, true>(dq, bf16, p, bh_count, s)
                                   : launch<128, false>(dq, bf16, p, bh_count, s));
    case 256: return (int)(chunked ? launch<256, true>(dq, bf16, p, bh_count, s)
                                   : launch<256, false>(dq, bf16, p, bh_count, s));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Launches the b*h rows bh0 .. bh0 +
// bh_count - 1 of the B*H. strides: 8 x (batch, seq, head) element strides of
// q, k, v, o, dO, dQ, dK, dV. Returns a cudaError_t (0 = success).
int dcr_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, int dtype, int B,
                     int H, int Sq, int Sk, int D, int bh0, int bh_count,
                     const int64_t* strides, float scale, void* stream) {
  return run(true, q, k, v, o, dout, lse, dq, nullptr, dtype, B, H, Sq, Sk, D, bh0,
             bh_count, strides, scale, stream);
}

int dcr_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dk, void* dv, int dtype,
                      int B, int H, int Sq, int Sk, int D, int bh0, int bh_count,
                      const int64_t* strides, float scale, void* stream) {
  return run(false, q, k, v, o, dout, lse, dk, dv, dtype, B, H, Sq, Sk, D, bh0, bh_count,
             strides, scale, stream);
}

const char* dcr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
