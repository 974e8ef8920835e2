// Causal / sliding-window GQA prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (`flash_attention` :73, `_flash_kernel` :23), and computes what the
// reference trains with, the XLA form repro/nn/attention.py:90
// (`chunked_attention`):
//   o[b, r, h] = softmax_c(q[b, r, h] . k[b, c, h/G] / sqrt(D)) @ v[b, :, h/G]
// over the columns c allowed by the causal mask (c <= r; also c > r - window
// when window > 0), plus the per-row log-sum-exp lse[b, h, r] in f32, which
// the backward (kernels/flash_attention.py, in tensor ops) uses to rebuild P.
//
// What bounds it: operations.  At the training path's server shape
// (B=2, S=T=4096, 32/8 heads, D=128, causal) the two products take
// 2.75e11 flops against 168 MB moved, far above the ~295 flops/byte where
// the tensor cores, not the memory, become the limit.  This first kernel
// runs the products as scalar f32 FMAs, so it is held to the 67 TFLOP/s
// f32 rate at best, not the 989 TFLOP/s bf16 tensor-core rate its bound is
// counted against; mma/wgmma, TMA and a pipelined K/V ring are later work.
//
// Design: one block of 128 threads per (64 query rows, q head, batch row).
// The TPU kernel walked the KV blocks along a sequential grid axis and kept
// its running max / sum / accumulator in VMEM scratch between grid steps;
// Hopper blocks run in no order, so the block loops over the KV tiles itself
// and keeps m, l and the output accumulator in registers.  Per KV tile of 64
// rows: K and V go to shared memory; each thread computes an 8 x 4 patch of
// the 64 x 64 score tile (rows rg + 8i, cols cg + 16j; rg = tid / 16,
// cg = tid % 16), so the 16 threads of a half-warp own whole rows and the
// online-softmax row max and row sum are half-warp shuffles; p goes to
// shared memory rounded to the input dtype (the XLA form rounds p to the
// value dtype before the PV product); then each thread accumulates an
// 8 x (DP/16) patch of the output, DP being D rounded up to a multiple of
// 32: at D = 112 (zamba2's shared block) the 16 threads of a row take 8
// output columns each and the last two own only columns >= D, which V's
// tile holds as zeros and the output store skips by index.  Shared Q and K
// rows are padded by 4 elements so the 8- and 16-byte reads of a half-warp
// fall in distinct banks.
// KV tiles wholly above the causal diagonal or wholly outside the window are
// skipped (flash_attention.py:35-43); p is re-masked to 0 where the score is
// masked, so a row whose running max is still -inf adds nothing (:59-61);
// l is clamped at 1e-30 (:69).  Ragged S and T are masked by index (the TPU
// kernel asserted S % bq == 0).  Query tiles are issued heaviest first
// (the last causal tile does the most KV tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // KV rows per tile
constexpr int kPad = 4;  // elements of padding per shared row

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using Raw4 = uint2;  // 4 elements
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
  __device__ static void ld4(const __nv_bfloat16* p, float (&x)[4]) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  }
  __device__ static void ld2(const __nv_bfloat16* p, float (&x)[2]) {
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x; x[1] = a.y;
  }
};

template <>
struct Elem<float> {
  using Raw4 = uint4;
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
  __device__ static void ld4(const float* p, float (&x)[4]) {
    float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static void ld2(const float* p, float (&x)[2]) {
    float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  }
};

// Copy 8 contiguous elements of one row (16-byte aligned in global memory)
// to shared memory as two 4-element stores, or write zeros past the end.
template <typename T>
__device__ __forceinline__ void row8_to_shared(const T* src, bool valid,
                                               T* dst) {
  using Raw4 = typename Elem<T>::Raw4;
  Raw4 a{}, b{};
  if (valid) {
    a = reinterpret_cast<const Raw4*>(src)[0];
    b = reinterpret_cast<const Raw4*>(src)[1];
  }
  reinterpret_cast<Raw4*>(dst)[0] = a;
  reinterpret_cast<Raw4*>(dst + 4)[0] = b;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// D rounded up to a multiple of 32: the output columns of a row split
// evenly over its 16 threads (32, 64, 128 map to themselves; 112 to 128)
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + 31) / 32 * 32;
}

template <int D, typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * ((size_t)kBK * padded_dim<D>()  // sV
                      + (size_t)kBQ * (D + kPad)  // sQ
                      + (size_t)kBK * (D + kPad)  // sK
                      + (size_t)kBQ * (kBK + kPad));  // sP
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int S, int Tk, int Hkv, int G,
                       float scale, int window) {
  using E = Elem<T>;
  constexpr int DP = padded_dim<D>();  // sV row stride
  constexpr int NJ = DP / 16;       // output columns per thread
  constexpr int RS = D + kPad;      // sQ / sK row stride
  constexpr int PS = kBK + kPad;    // sP row stride
  constexpr int C8 = D / 8;         // 8-element chunks per row
  static_assert(D % 16 == 0 && DP <= 128, "head dim 32, 64, 112 or 128");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sV = reinterpret_cast<T*>(smem_raw);  // [kBK][DP], columns >= D zero
  T* sQ = sV + kBK * DP;                   // [kBQ][RS]
  T* sK = sQ + kBQ * RS;                   // [kBK][RS]
  T* sP = sK + kBK * RS;                   // [kBQ][PS]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Hq = Hkv * G;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int cg = tid % 16;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, S) - 1;

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * S * Hq + h) * D;
  const T* kb = k + ((size_t)b * Tk * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Tk * Hkv + hk) * D;

  for (int c = tid; c < kBQ * C8; c += kThreads) {
    const int r = c / C8;
    const int d0 = (c % C8) * 8;
    row8_to_shared(qb + (size_t)(q0 + r) * q_stride + d0, q0 + r < S,
                   sQ + r * RS + d0);
  }

  float acc[8][NJ];
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // KV tiles that hold any allowed column for rows q0..q_last
  const int k_end = min(Tk, q_last + 1);
  const int k_begin = window ? (max(0, q0 - window + 1) / kBK) * kBK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kBK * (DP / 8); c += kThreads) {
      const int j = c / (DP / 8);
      const int d0 = (c % (DP / 8)) * 8;
      const bool ok = k0 + j < Tk && d0 < D;
      const size_t off = (size_t)(k0 + j) * kv_stride + d0;
      if (d0 < D) row8_to_shared(kb + off, ok, sK + j * RS + d0);
      row8_to_shared(vb + off, ok, sV + j * DP + d0);
    }
    __syncthreads();

    // scores of this tile: rows rg + 8i, columns cg + 16j
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float kx[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) E::ld4(sK + (cg + 16 * j) * RS + d, kx[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float qx[4];
        E::ld4(sQ + (rg + 8 * i) * RS + d, qx);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qx[e], kx[j][e], s[i][j]);
      }
    }

    // online softmax over the tile, one half-warp per row
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + rg + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        const bool ok = r < S && col < Tk && col <= r &&
                        (!window || col > r - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        sP[(rg + 8 * i) * PS + cg + 16 * j] = E::from_f(p);
      }
      sum = half_warp_sum(sum);
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    // acc += p @ v: rows rg + 8i, columns cg * NJ .. cg * NJ + NJ - 1
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float vx[4][NJ];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* vrow = sV + (kk + e) * DP + cg * NJ;
        if constexpr (NJ % 4 == 0) {
#pragma unroll
          for (int jj = 0; jj < NJ; jj += 4) {
            float t4[4];
            E::ld4(vrow + jj, t4);
#pragma unroll
            for (int x = 0; x < 4; ++x) vx[e][jj + x] = t4[x];
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < NJ; jj += 2) {
            float t2[2];
            E::ld2(vrow + jj, t2);
            vx[e][jj] = t2[0];
            vx[e][jj + 1] = t2[1];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float px[4];
        E::ld4(sP + (rg + 8 * i) * PS + kk, px);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            acc[i][jj] = fmaf(px[e], vx[e][jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + rg + 8 * i;
    if (r >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * S + r) * Hq + h) * D + cg * NJ;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      if (cg * NJ + jj < D) orow[jj] = E::from_f(acc[i][jj] / li);
    if (cg == 0)
      lse[((size_t)b * Hq + h) * S + r] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int Tk, int Hkv, int G, float scale, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, T>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, Hkv * G, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk, Hkv, G, scale,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int Tk, int Hkv, int G, float scale,
                 int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, Tk, Hkv, G, scale, window, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, Tk, Hkv, G, scale, window, s);
    case 112: return launch<T, 112>(q, k, v, o, lse, B, S, Tk, Hkv, G, scale, window, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, Tk, Hkv, G, scale, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, Hkv*G, D); k, v: (B, T, Hkv, D); lse: (B, Hkv*G, S) f32; all
// contiguous, 16-byte aligned, on one device.  dtype: 0 = bfloat16,
// 1 = float32.  window = 0: no window.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int S, int T,
                               int Hkv, int G, int D, int dtype, float scale,
                               int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, o, lse, B, S, T, Hkv, G,
                                       scale, window, s);
  if (dtype == 1)
    return dispatch_dim<float>(D, q, k, v, o, lse, B, S, T, Hkv, G, scale,
                               window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
