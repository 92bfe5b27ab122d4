// Flash-attention forward for Hopper (sm_90a), f32 and bf16 operands.
//
// Replaces the Pallas TPU kernel dcr_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd). Same function: O = softmax(Q K^T * D^-1/2) V by
// online softmax over key tiles (running max m from -1e30, running sum l, f32
// accumulator), plus lse = m + log(l) per query row. Logits, statistics and
// the accumulator are f32; with bf16 operands P is rounded to bf16 before the
// P V product, as the TPU kernel does (p.astype(in_dtype)). O has the input
// dtype; lse is written compact as [B*H, Sq] f32 (no 128-lane broadcast).
//
// Bound on an H100 SXM (700 W data-sheet peaks): 4*Sq*Sk*D flops per (b, h)
// against ~(2*Sq + 2*Sk)*D*bytes of traffic, so at the UNet's shapes
// (S = 256..4096, D = 64) the kernel is bound by operations, not bytes. This
// first version computes in f32 FMA on the CUDA cores (no TF32, no tensor
// cores), so its ceiling is the 67 TFLOP/s f32 rate for either dtype; a
// wgmma/TMA version is later work.
//
// Design: one block of 256 threads per (b*h, 64-row query tile). K and V
// tiles of 64 keys stream through shared memory; S = Q K^T and O += P V are
// register-tiled, 4 rows x 4 columns per thread, with padded shared-memory
// rows so the 16-byte loads of a quarter warp hit distinct banks. Row max and
// row sum reduce across the 16 threads that share a row with warp shuffles.
// Shared memory (f32 tiles) is 68 KB at D=64 and 216 KB at D=256, so every
// instantiation opts in to large dynamic shared memory.
//
// The inputs are [B, S, H, D] tensors read through their strides (the last
// dimension must be contiguous); O is written [B, Sq, H, D] the same way.
// The C entry point returns cudaGetLastError() after the launch so a refused
// launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // keys per tile
constexpr int NT = 256;   // threads per block, viewed as 16 (ty) x 16 (tx)
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr int smem_floats() {
  // Qs [BM][D+4], Ks [BN][D+4], Vs [BN][D], Ps [BM][BN+4]
  return BM * (D + 4) + BN * (D + 4) + BN * D + BM * (BN + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int c = tid; c < BM * C4; c += NT) {
    const int r = c / C4;
    const int d = (c - r * C4) * 4;
    *reinterpret_cast<float4*>(&Qs[r * QP + d]) =
        Elem<T>::load4(qg + (int64_t)(q0 + r) * p.q_ss + d);
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
          Elem<T>::load4(kg + (int64_t)(k0 + r) * p.k_ss + d);
      *reinterpret_cast<float4*>(&Vs[r * VP + d]) =
          Elem<T>::load4(vg + (int64_t)(k0 + r) * p.v_ss + d);
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
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = Elem<T>::round(e);
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
    T* orow = og + (int64_t)row * p.o_ss;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4 out = make_float4(acc[i][g * 4 + 0] / l[i], acc[i][g * 4 + 1] / l[i],
                               acc[i][g * 4 + 2] / l[i], acc[i][g * 4 + 3] / l[i]);
      Elem<T>::store4(orow + g * 64 + tx * 4, out);
    }
    if (tx == 0) p.lse[(int64_t)bh * p.Sq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.Sq / BM, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int bh, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(p, bh, stream);
    case 128: return launch<T, 128>(p, bh, stream);
    case 256: return launch<T, 256>(p, bh, stream);
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
  if (Sq <= 0 || Sk <= 0 || Sq % BM || Sk % BN || bh <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, H, Sq, Sk,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(p, (int)bh, D, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, (int)bh, D, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* dcr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
