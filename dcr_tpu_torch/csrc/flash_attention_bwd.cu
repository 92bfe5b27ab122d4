// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, f32 and bf16.
//
// Replaces the Pallas TPU kernels of dcr_tpu/ops/flash_attention.py:
//   flash_bwd_dq_bf16_kernel, flash_bwd_dq_kernel   <- _bwd_dq_kernel  (launched by _flash_bwd)
//   flash_bwd_dkv_bf16_kernel, flash_bwd_dkv_kernel <- _bwd_dkv_kernel (launched by _flash_bwd)
// (the bf16 kernel of each pair runs on the tensor cores, the other takes
// f32 operands). Same functions, by recomputation from the forward's
// log-sum-exp:
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
// TF32 tensor cores as split TF32 (flash_attention_fwd.cu), which the f32
// kernels here, on the CUDA cores' 67 TFLOP/s, do not use.
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
// the pace of the bf16 kernels; the accumulators and the fragments a warp
// keeps fill its registers, which sets the tiles.
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
// f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel; the f32 training mode)
// runs f32 FMA on the CUDA cores:
// - dQ: one block of 256 threads per (b*h, query tile). Q and dO tiles, lse
//   and delta stay in shared memory; K and V tiles stream through it; dQ
//   accumulates in registers over every key tile and is written once.
// - dK/dV: one block per (b*h, key tile), the same loop as above.
// Products are register-tiled 16 x 16 threads, with padded shared-memory
// rows so the 16-byte loads of a quarter warp hit distinct banks. Tiles are
// 64 x 64 at D = 64 and 128; at D = 256 the dK/dV tiles would need 278 KB
// at 64 rows, more than the 227 KB a block may use, so D = 256 takes
// 32 x 32 tiles. Shared memory is 88-171 KB, so every instantiation opts in
// to large dynamic shared memory.
//
// The inputs are [B, S, H, D] tensors read through their strides (the last
// dimension contiguous, the others multiples of 16 bytes); the gradients are
// written [B, S, H, D] the same way. lse is the compact [B*H, Sq] f32 array
// the forward kernel writes. Each C entry point returns cudaGetLastError()
// after its launch so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int NT = 256;      // threads of an f32 block, viewed as 16 (ty) x 16 (tx)
constexpr int MMA_NT = 128;  // threads of a bf16 block: 4 warps
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
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// (b, h) head slice of one operand
template <typename T>
__device__ __forceinline__ T* head(const void* base, const int64_t* st, int b, int h) {
  return const_cast<T*>(static_cast<const T*>(base)) + b * st[0] + h * st[2];
}

// rows [row0, row0 + ROWS) of a [S, D] head slice -> shared tile [ROWS][P]
template <int D, int ROWS, int P>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row_stride,
                                          int row0, int tid) {
  constexpr int C4 = D / 4;
  for (int c = tid; c < ROWS * C4; c += NT) {
    const int r = c / C4;
    const int d = (c - r * C4) * 4;
    *reinterpret_cast<float4*>(&dst[r * P + d]) =
        load4(src + (int64_t)(row0 + r) * row_stride + d);
  }
}

// acc[i][j] = sum_d A[a0 + i][d] * B[tx + 16 j][d], both [rows][P] in shared memory
template <int D, int RA, int RB, int P>
__device__ __forceinline__ void dot_rows(float (&acc)[RA][RB], const float* A, int a0,
                                         const float* B, int tx) {
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RA], bb[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(a0 + i) * P + d]);
#pragma unroll
    for (int j = 0; j < RB; ++j)
      bb[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * P + d]);
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        acc[i][j] = fmaf(a[i].x, bb[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bb[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bb[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bb[j].w, acc[i][j]);
      }
  }
}

// acc[i][g*4 + c] += sum_n X[x0 + i][n] * Y[n][g*64 + tx*4 + c]
// X: [rows][PX], Y: [N][PY], both in shared memory
template <int D, int RA, int N, int PX, int PY>
__device__ __forceinline__ void acc_product(float (&acc)[RA][D / 16], const float* X,
                                            int x0, const float* Y, int tx) {
  constexpr int G = D / 64;
#pragma unroll 2
  for (int n = 0; n < N; n += 4) {
    float4 xa[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      xa[i] = *reinterpret_cast<const float4*>(&X[(x0 + i) * PX + n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 yb =
            *reinterpret_cast<const float4*>(&Y[(n + kk) * PY + g * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < RA; ++i) {
          const float xv = comp(xa[i], kk);
          acc[i][g * 4 + 0] = fmaf(xv, yb.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(xv, yb.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(xv, yb.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(xv, yb.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
}

// delta[r] = sum_d dO[r][d] * O[row0 + r][d] in f32, NT / ROWS threads per row
template <int D, int ROWS, int P>
__device__ __forceinline__ void row_delta(float* delta, const float* dOs, const float* og,
                                          int64_t o_ss, int row0, int tid) {
  constexpr int TPR = NT / ROWS;
  const int r = tid / TPR;
  const int part = tid - r * TPR;
  float sum = 0.f;
  for (int d = part * 4; d < D; d += TPR * 4) {
    const float4 a = *reinterpret_cast<const float4*>(&dOs[r * P + d]);
    const float4 b = load4(og + (int64_t)(row0 + r) * o_ss + d);
    sum += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) delta[r] = sum;
}

// write rows [row0 + i] of a [rows][D] register tile, scaled
template <int D, int RA>
__device__ __forceinline__ void store_rows(float* g, int64_t row_stride, int row0,
                                           const float (&acc)[RA][D / 16], float scale,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    float* row = g + (int64_t)(row0 + i) * row_stride;
#pragma unroll
    for (int gg = 0; gg < D / 64; ++gg) {
      *reinterpret_cast<float4*>(row + gg * 64 + tx * 4) =
          make_float4(acc[i][gg * 4 + 0] * scale, acc[i][gg * 4 + 1] * scale,
                      acc[i][gg * 4 + 2] * scale, acc[i][gg * 4 + 3] * scale);
    }
  }
}

template <int D>
struct Tiles {
  // query rows and keys per tile; D = 256 halves them to fit shared memory
  static constexpr int BM = D == 256 ? 32 : 64;
  static constexpr int BN = D == 256 ? 32 : 64;
};

template <int D>
constexpr int dq_smem_floats() {
  // Qs, dOs [BM][D+4]; Ks, Vs [BN][D+4]; dSs [BM][BN+4]; lse, delta [BM]
  return 2 * Tiles<D>::BM * (D + 4) + 2 * Tiles<D>::BN * (D + 4) +
         Tiles<D>::BM * (Tiles<D>::BN + 4) + 2 * Tiles<D>::BM;
}

template <int D>
constexpr int dkv_smem_floats() {
  // Ks, Vs [BN][D+4]; Qs, dOs [BM][D+4]; P^T, dS^T [BN][BM+4]; lse, delta [BM]
  return 2 * Tiles<D>::BN * (D + 4) + 2 * Tiles<D>::BM * (D + 4) +
         2 * Tiles<D>::BN * (Tiles<D>::BM + 4) + 2 * Tiles<D>::BM;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Params p) {
  constexpr int BM = Tiles<D>::BM, BN = Tiles<D>::BN;
  constexpr int P = D + 4, PS = BN + 4;
  constexpr int RM = BM / 16, RN = BN / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BM * P;
  float* Ks = dOs + BM * P;
  float* Vs = Ks + BN * P;
  float* dSs = Vs + BN * P;
  float* lses = dSs + BM * PS;
  float* deltas = lses + BM;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.x * BM;

  const float* qg = head<float>(p.q, p.st[Q_], b, h);
  const float* kg = head<float>(p.k, p.st[K_], b, h);
  const float* vg = head<float>(p.v, p.st[V_], b, h);
  const float* og = head<float>(p.o, p.st[O_], b, h);
  const float* dog = head<float>(p.dout, p.st[DO_], b, h);
  float* dqg = head<float>(p.dq, p.st[DQ_], b, h);

  load_tile<D, BM, P>(Qs, qg, p.st[Q_][1], q0, tid);
  load_tile<D, BM, P>(dOs, dog, p.st[DO_][1], q0, tid);
  if (tid < BM) lses[tid] = p.lse[(int64_t)bh * p.Sq + q0 + tid];
  __syncthreads();
  row_delta<D, BM, P>(deltas, dOs, og, p.st[O_][1], q0, tid);

  float acc[RM][D / 16];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int n_tiles = p.Sk / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's readers are done (and delta is visible)
    const int k0 = kt * BN;
    load_tile<D, BN, P>(Ks, kg, p.st[K_][1], k0, tid);
    load_tile<D, BN, P>(Vs, vg, p.st[V_][1], k0, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows ty*RM + i and keys tx + 16 j
    float s[RM][RN], dp[RM][RN];
    dot_rows<D, RM, RN, P>(s, Qs, ty * RM, Ks, tx);
    dot_rows<D, RM, RN, P>(dp, dOs, ty * RM, Vs, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const float l = lses[r];
      const float dl = deltas[r];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float pr = expf(s[i][j] * p.scale - l);
        dSs[r * PS + tx + 16 * j] = pr * (dp[i][j] - dl);
      }
    }
    __syncthreads();

    // dQ += dS K for rows ty*RM + i and columns g*64 + tx*4 + (0..3)
    acc_product<D, RM, BN, PS, P>(acc, dSs, ty * RM, Ks, tx);
  }
  store_rows<D, RM>(dqg, p.st[DQ_][1], q0 + ty * RM, acc, p.scale, tx);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Params p) {
  constexpr int BM = Tiles<D>::BM, BN = Tiles<D>::BN;
  constexpr int P = D + 4, PT = BM + 4;
  constexpr int RK = BN / 16, RQ = BM / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BN * P;
  float* Qs = Vs + BN * P;
  float* dOs = Qs + BM * P;
  float* PTs = dOs + BM * P;
  float* dSTs = PTs + BN * PT;
  float* lses = dSTs + BN * PT;
  float* deltas = lses + BM;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.x * BN;

  const float* qg = head<float>(p.q, p.st[Q_], b, h);
  const float* kg = head<float>(p.k, p.st[K_], b, h);
  const float* vg = head<float>(p.v, p.st[V_], b, h);
  const float* og = head<float>(p.o, p.st[O_], b, h);
  const float* dog = head<float>(p.dout, p.st[DO_], b, h);
  float* dkg = head<float>(p.dk, p.st[DK_], b, h);
  float* dvg = head<float>(p.dv, p.st[DV_], b, h);

  load_tile<D, BN, P>(Ks, kg, p.st[K_][1], k0, tid);
  load_tile<D, BN, P>(Vs, vg, p.st[V_][1], k0, tid);

  float dk[RK][D / 16], dv[RK][D / 16];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  // the loop over every query tile replaces the TPU's sequential grid axis
  const int n_tiles = p.Sq / BM;
  for (int qt = 0; qt < n_tiles; ++qt) {
    __syncthreads();  // the previous tile's readers are done
    const int q0 = qt * BM;
    load_tile<D, BM, P>(Qs, qg, p.st[Q_][1], q0, tid);
    load_tile<D, BM, P>(dOs, dog, p.st[DO_][1], q0, tid);
    if (tid < BM) lses[tid] = p.lse[(int64_t)bh * p.Sq + q0 + tid];
    __syncthreads();
    row_delta<D, BM, P>(deltas, dOs, og, p.st[O_][1], q0, tid);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for keys ty*RK + i and queries tx + 16 j
    float s[RK][RQ], dp[RK][RQ];
    dot_rows<D, RK, RQ, P>(s, Ks, ty * RK, Qs, tx);
    dot_rows<D, RK, RQ, P>(dp, Vs, ty * RK, dOs, tx);
#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      const int m = tx + 16 * j;
      const float l = lses[m];
      const float dl = deltas[m];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int n = ty * RK + i;
        const float pr = expf(s[i][j] * p.scale - l);
        PTs[n * PT + m] = pr;
        dSTs[n * PT + m] = pr * (dp[i][j] - dl);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for keys ty*RK + i, columns g*64 + tx*4 + (0..3)
    acc_product<D, RK, BM, PT, P>(dv, PTs, ty * RK, dOs, tx);
    acc_product<D, RK, BM, PT, P>(dk, dSTs, ty * RK, Qs, tx);
  }
  store_rows<D, RK>(dkg, p.st[DK_][1], k0 + ty * RK, dk, p.scale, tx);
  store_rows<D, RK>(dvg, p.st[DV_][1], k0 + ty * RK, dv, 1.f, tx);
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

template <int D>
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
  const int bh = blockIdx.y;
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

template <int D, int MT>
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
  const int bh = blockIdx.y;
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

template <int D>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dq_smem_floats<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / Tiles<D>::BM, bh);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dkv_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sk / Tiles<D>::BN, bh);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const Params& p, int bh, cudaStream_t stream) {
  using Tl = DqBf16Tiles<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / Tl::BM, bh);
  flash_bwd_dq_bf16_kernel<D><<<grid, MMA_NT, Tl::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int MT>
cudaError_t launch_dkv_bf16_mt(const Params& p, int bh, cudaStream_t stream) {
  using Tl = DkvBf16Tiles<D, MT>;
  for (int t = 0; t < N_OPERANDS; ++t)
    if (p.st[t][1] > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sk + Tl::BN - 1) / Tl::BN, bh, D / Tl::DOUT);
  flash_bwd_dkv_bf16_kernel<D, MT><<<grid, MMA_NT, Tl::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// at D = 64, two key m-tiles per warp cut the shared-memory reads per
// product by a third, but halve the blocks too: they are taken only while
// the grid still gives each of the H100's 132 SMs two blocks
template <int D>
cudaError_t launch_dkv_bf16(const Params& p, int bh, cudaStream_t stream) {
  if constexpr (D == 64)
    if ((p.Sk + 127) / 128 * bh >= 2 * 132) return launch_dkv_bf16_mt<64, 2>(p, bh, stream);
  return launch_dkv_bf16_mt<D, 1>(p, bh, stream);
}

// bf16: the tensor-core kernels; f32: the FMA kernels
template <int D>
cudaError_t launch(bool dq, bool bf16, const Params& p, int bh, cudaStream_t s) {
  if (bf16) return dq ? launch_dq_bf16<D>(p, bh, s) : launch_dkv_bf16<D>(p, bh, s);
  return dq ? launch_dq<D>(p, bh, s) : launch_dkv<D>(p, bh, s);
}

int run(bool dq, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, void* g0, void* g1, int dtype, int B,
        int H, int Sq, int Sk, int D, const int64_t* strides, float scale,
        void* stream) {
  const int64_t bh = (int64_t)B * H;
  if (Sq <= 0 || Sk <= 0 || Sq % 64 || Sk % 64 || bh <= 0 || bh > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, lse, dq ? g0 : nullptr, dq ? nullptr : g0,
           dq ? nullptr : g1, H, Sq, Sk, {}, scale};
  for (int t = 0; t < N_OPERANDS; ++t)
    for (int a = 0; a < 3; ++a) p.st[t][a] = strides[t * 3 + a];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  switch (D) {
    case 64: return (int)launch<64>(dq, bf16, p, (int)bh, s);
    case 128: return (int)launch<128>(dq, bf16, p, (int)bh, s);
    case 256: return (int)launch<256>(dq, bf16, p, (int)bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 8 x (batch, seq, head) element
// strides of q, k, v, o, dO, dQ, dK, dV. Returns a cudaError_t (0 = success).
int dcr_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, int dtype, int B,
                     int H, int Sq, int Sk, int D, const int64_t* strides, float scale,
                     void* stream) {
  return run(true, q, k, v, o, dout, lse, dq, nullptr, dtype, B, H, Sq, Sk, D, strides,
             scale, stream);
}

int dcr_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dk, void* dv, int dtype,
                      int B, int H, int Sq, int Sk, int D, const int64_t* strides,
                      float scale, void* stream) {
  return run(false, q, k, v, o, dout, lse, dk, dv, dtype, B, H, Sq, Sk, D, strides,
             scale, stream);
}

const char* dcr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
