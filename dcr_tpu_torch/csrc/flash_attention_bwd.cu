// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, f32 and bf16.
//
// Replaces the Pallas TPU kernels of dcr_tpu/ops/flash_attention.py:
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (launched by _flash_bwd)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (launched by _flash_bwd)
// Same functions, by recomputation from the forward's log-sum-exp:
//   S = Q K^T * D^-1/2, P = exp(S - lse), dP = dO V^T, delta = rowsum(dO o O),
//   dS = P o (dP - delta), dQ = D^-1/2 dS K, dK = D^-1/2 dS^T Q, dV = P^T dO.
// Logits, statistics and accumulators are f32. With bf16 operands dS (and P
// before dV = P^T dO) is rounded to bf16 before its product, as the TPU
// kernels do (ds.astype(in_dtype), p.astype(in_dtype)); delta is computed
// from dO and O in f32 inside each block, per query tile, as the TPU kernels
// do. No mask, no causal; Sq may differ from Sk.
//
// Bound on an H100 SXM (700 W data-sheet peaks): the dQ kernel does
// 6*Sq*Sk*D flops per (b, h) (S and dP recomputed, then dQ), the dK/dV kernel
// 8*Sq*Sk*D (S, dP, dV, dK), against ~(4*Sq + 2*Sk)*D elements of traffic, so
// at the UNet's training shapes (S = 256..1024, D = 64) both are bound by
// operations. This first version computes in f32 FMA on the CUDA cores (no
// TF32, no tensor cores) for either dtype, so its ceiling is the 67 TFLOP/s
// f32 rate; mma/wgmma and TMA are later work.
//
// Design. The TPU grid runs in order, and its dK/dV kernel carries f32 VMEM
// accumulators across a sequential ("arbitrary") q-block axis. Hopper runs
// blocks in no order, so here:
// - dQ: one block of 256 threads per (b*h, query tile). Q and dO tiles, lse
//   and delta stay in shared memory; K and V tiles stream through it; dQ
//   accumulates in registers over every key tile and is written once.
// - dK/dV: one block per (b*h, key tile). K and V stay in shared memory; the
//   block loops over every query tile itself, in place of the TPU's
//   sequential grid axis, and dK and dV accumulate in f32 registers and are
//   written once. No atomics: both gradients are bit-identical from run to
//   run.
// Products are register-tiled as in flash_attention_fwd.cu: 16 x 16 threads,
// padded shared-memory rows so the 16-byte loads of a quarter warp hit
// distinct banks. Tiles are 64 x 64 at D = 64 and 128; at D = 256 the f32
// tiles of the dK/dV kernel would need 278 KB at 64 rows, more than the
// 227 KB a block may use, so D = 256 takes 32 x 32 tiles. Shared memory is
// 88-171 KB, so every instantiation opts in to large dynamic shared memory.
//
// The inputs are [B, S, H, D] tensors read through their strides (the last
// dimension must be contiguous); the gradients are written [B, S, H, D] the
// same way. lse is the compact [B*H, Sq] f32 array the forward kernel writes.
// Each C entry point returns cudaGetLastError() after its launch so a refused
// launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block, viewed as 16 (ty) x 16 (tx)

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

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// (b, h) head slice of one operand
template <typename T>
__device__ __forceinline__ T* head(const void* base, const int64_t* st, int b, int h) {
  return const_cast<T*>(static_cast<const T*>(base)) + b * st[0] + h * st[2];
}

// rows [row0, row0 + ROWS) of a [S, D] head slice -> f32 shared tile [ROWS][P]
template <typename T, int D, int ROWS, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row_stride,
                                          int row0, int tid) {
  constexpr int C4 = D / 4;
  for (int c = tid; c < ROWS * C4; c += NT) {
    const int r = c / C4;
    const int d = (c - r * C4) * 4;
    *reinterpret_cast<float4*>(&dst[r * P + d]) =
        Elem<T>::load4(src + (int64_t)(row0 + r) * row_stride + d);
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
template <typename T, int D, int ROWS, int P>
__device__ __forceinline__ void row_delta(float* delta, const float* dOs, const T* og,
                                          int64_t o_ss, int row0, int tid) {
  constexpr int TPR = NT / ROWS;
  const int r = tid / TPR;
  const int part = tid - r * TPR;
  float sum = 0.f;
  for (int d = part * 4; d < D; d += TPR * 4) {
    const float4 a = *reinterpret_cast<const float4*>(&dOs[r * P + d]);
    const float4 b = Elem<T>::load4(og + (int64_t)(row0 + r) * o_ss + d);
    sum += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) delta[r] = sum;
}

// write rows [row0 + i] of a [rows][D] register tile, scaled
template <typename T, int D, int RA>
__device__ __forceinline__ void store_rows(T* g, int64_t row_stride, int row0,
                                           const float (&acc)[RA][D / 16], float scale,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    T* row = g + (int64_t)(row0 + i) * row_stride;
#pragma unroll
    for (int gg = 0; gg < D / 64; ++gg) {
      Elem<T>::store4(row + gg * 64 + tx * 4,
                      make_float4(acc[i][gg * 4 + 0] * scale, acc[i][gg * 4 + 1] * scale,
                                  acc[i][gg * 4 + 2] * scale, acc[i][gg * 4 + 3] * scale));
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

template <typename T, int D>
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

  const T* qg = head<T>(p.q, p.st[Q_], b, h);
  const T* kg = head<T>(p.k, p.st[K_], b, h);
  const T* vg = head<T>(p.v, p.st[V_], b, h);
  const T* og = head<T>(p.o, p.st[O_], b, h);
  const T* dog = head<T>(p.dout, p.st[DO_], b, h);
  T* dqg = head<T>(p.dq, p.st[DQ_], b, h);

  load_tile<T, D, BM, P>(Qs, qg, p.st[Q_][1], q0, tid);
  load_tile<T, D, BM, P>(dOs, dog, p.st[DO_][1], q0, tid);
  if (tid < BM) lses[tid] = p.lse[(int64_t)bh * p.Sq + q0 + tid];
  __syncthreads();
  row_delta<T, D, BM, P>(deltas, dOs, og, p.st[O_][1], q0, tid);

  float acc[RM][D / 16];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int n_tiles = p.Sk / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's readers are done (and delta is visible)
    const int k0 = kt * BN;
    load_tile<T, D, BN, P>(Ks, kg, p.st[K_][1], k0, tid);
    load_tile<T, D, BN, P>(Vs, vg, p.st[V_][1], k0, tid);
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
        dSs[r * PS + tx + 16 * j] = Elem<T>::round(pr * (dp[i][j] - dl));
      }
    }
    __syncthreads();

    // dQ += dS K for rows ty*RM + i and columns g*64 + tx*4 + (0..3)
    acc_product<D, RM, BN, PS, P>(acc, dSs, ty * RM, Ks, tx);
  }
  store_rows<T, D, RM>(dqg, p.st[DQ_][1], q0 + ty * RM, acc, p.scale, tx);
}

template <typename T, int D>
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

  const T* qg = head<T>(p.q, p.st[Q_], b, h);
  const T* kg = head<T>(p.k, p.st[K_], b, h);
  const T* vg = head<T>(p.v, p.st[V_], b, h);
  const T* og = head<T>(p.o, p.st[O_], b, h);
  const T* dog = head<T>(p.dout, p.st[DO_], b, h);
  T* dkg = head<T>(p.dk, p.st[DK_], b, h);
  T* dvg = head<T>(p.dv, p.st[DV_], b, h);

  load_tile<T, D, BN, P>(Ks, kg, p.st[K_][1], k0, tid);
  load_tile<T, D, BN, P>(Vs, vg, p.st[V_][1], k0, tid);

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
    load_tile<T, D, BM, P>(Qs, qg, p.st[Q_][1], q0, tid);
    load_tile<T, D, BM, P>(dOs, dog, p.st[DO_][1], q0, tid);
    if (tid < BM) lses[tid] = p.lse[(int64_t)bh * p.Sq + q0 + tid];
    __syncthreads();
    row_delta<T, D, BM, P>(deltas, dOs, og, p.st[O_][1], q0, tid);
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
        PTs[n * PT + m] = Elem<T>::round(pr);
        dSTs[n * PT + m] = Elem<T>::round(pr * (dp[i][j] - dl));
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for keys ty*RK + i, columns g*64 + tx*4 + (0..3)
    acc_product<D, RK, BM, PT, P>(dv, PTs, ty * RK, dOs, tx);
    acc_product<D, RK, BM, PT, P>(dk, dSTs, ty * RK, Qs, tx);
  }
  store_rows<T, D, RK>(dkg, p.st[DK_][1], k0 + ty * RK, dk, p.scale, tx);
  store_rows<T, D, RK>(dvg, p.st[DV_][1], k0 + ty * RK, dv, 1.f, tx);
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dq_smem_floats<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / Tiles<D>::BM, bh);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * dkv_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sk / Tiles<D>::BN, bh);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dq, const Params& p, int bh, int d, cudaStream_t s) {
  switch (d) {
    case 64: return dq ? launch_dq<T, 64>(p, bh, s) : launch_dkv<T, 64>(p, bh, s);
    case 128: return dq ? launch_dq<T, 128>(p, bh, s) : launch_dkv<T, 128>(p, bh, s);
    case 256: return dq ? launch_dq<T, 256>(p, bh, s) : launch_dkv<T, 256>(p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dq, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, void* g0, void* g1, int dtype, int B,
        int H, int Sq, int Sk, int D, const int64_t* strides, float scale,
        void* stream) {
  const int64_t bh = (int64_t)B * H;
  if (Sq <= 0 || Sk <= 0 || Sq % 64 || Sk % 64 || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, lse, dq ? g0 : nullptr, dq ? nullptr : g0,
           dq ? nullptr : g1, H, Sq, Sk, {}, scale};
  for (int t = 0; t < N_OPERANDS; ++t)
    for (int a = 0; a < 3; ++a) p.st[t][a] = strides[t * 3 + a];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(dq, p, (int)bh, D, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(dq, p, (int)bh, D, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
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
