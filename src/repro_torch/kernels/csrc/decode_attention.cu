// Single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (`decode_attention` :59, `_decode_kernel` :23), and computes the XLA form
// that the reference's serving path runs (repro/nn/attention.py:136):
//   o[b, h*G+g] = softmax_t(q[b, h*G+g] . k[b, t, h] / sqrt(D)) @ v[b, :, h]
// over the valid cache prefix t < min(pos[b] + 1, C).  `pos` is a (B,)
// vector, so rows at different depths (the per-stream server catch-up) go
// in one launch.  With pos >= 0 the ring mask of a sliding-window cache
// (idx < min(pos+1, C)) and the linear mask (idx <= pos) are the same
// prefix, so the kernel takes no window: one mask serves both caches.
//
// Rounding points follow the XLA form, not the Pallas kernel: q is taken in
// the cache dtype, scores are f32 and scaled by 1/sqrt(D), p is rounded to
// the cache dtype before the PV product, sums are f32, and the output is
// written in q's dtype.  (The Pallas kernel keeps p in f32.)  Because the
// softmax is online, p is rounded before its normalisation by l, where the
// XLA form rounds the normalised p; both round to the same precision.
//
// What bounds it: bytes.  Each step reads the valid K and V rows once
// (2 * n_valid * Hkv * D elements per batch row) and does 4 flops per
// element read, far below the ~295 flops/byte where the tensor cores
// would become the limit.
//
// Design: one block per (kv head, batch row), 128 threads, looping over
// the cache in tiles of 64 rows.  A row of K or V is read as 16-byte
// loads by DP/8 neighbouring threads (DP: D rounded up to a power of two,
// so a row's threads split the warp evenly; at D = 112, zamba2's shared
// block, 16 threads take a row and the last two, whose columns are >= D,
// load nothing and add zeros), and all G query heads of the group
// use that one read (the GQA saving the TPU grid made explicit too).
// Per tile: scores -> shared memory, one warp per query head updates the
// running max/sum, then every thread folds p*V into f32 accumulators for
// its 8 output dims.  Only the valid prefix is read, and tails are masked
// by index, so C needs no relation to the tile size.  Row groups reduce
// through shared memory at the end.  At B=8, Hkv=8 this is 64 blocks on
// 132 SMs; splitting the cache axis across blocks (split-K) is left to a
// later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // cache rows per tile
constexpr int kEPT = 8;    // elements of a row per thread

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  __device__ static void load8(const __nv_bfloat16* p, float (&x)[kEPT]) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Elem<float> {
  __device__ static void load8(const float* p, float (&x)[kEPT]) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

// D rounded up to a power of two (32, 64, 128, 256 map to themselves)
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int C, int Hkv, float scale) {
  constexpr int DP = padded_dim<D>();
  constexpr int TPP = DP / kEPT;         // threads per cache row
  constexpr int RPI = kThreads / TPP;    // rows in flight per iteration
  constexpr int RPT = kTile / RPI;       // rows per thread group per tile
  static_assert(D % kEPT == 0 && TPP <= 32 && kTile % RPI == 0,
                "unsupported head dim");
  static_assert(kTile == 64, "the softmax step gives each lane two rows");

  __shared__ float s_p[G][kTile];        // scores, then p, of one tile
  __shared__ float s_alpha[G];
  __shared__ float s_m[G];
  __shared__ float s_l[G];
  __shared__ float s_red[RPI][G][DP];    // per-row-group partial outputs

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int grp = tid / TPP;
  const int lane = tid % TPP;
  const int d0 = lane * kEPT;
  const bool has_cols = d0 < D;          // false only for columns >= D
  const int Hq = Hkv * G;
  const int n_valid = min(pos[b] + 1, C);

  float qr[G][kEPT];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (has_cols) {
      Elem<T>::load8(q + ((size_t)b * Hq + h * G + g) * D + d0, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kEPT; ++e) qr[g][e] = 0.f;
    }
  }

  float acc[G][kEPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kEPT; ++e) acc[g][e] = 0.f;

  if (tid < G) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  const size_t row_stride = (size_t)Hkv * D;
  const size_t base = ((size_t)b * C * Hkv + h) * D + d0;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int t0 = 0; t0 < n_valid; t0 += kTile) {
    // scores of this tile
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int j = i * RPI + grp;
      const int r = t0 + j;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      if (r < n_valid && has_cols) {
        float kx[kEPT];
        Elem<T>::load8(kb + (size_t)r * row_stride, kx);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < kEPT; ++e) part[g] += qr[g][e] * kx[e];
      }
#pragma unroll
      for (int off = TPP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          s_p[g][j] = (r < n_valid) ? part[g] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    const int warp = tid / 32;
    const int wl = tid % 32;
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = s_p[g][wl];
      const float s1 = s_p[g][wl + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);  // finite: row t0 is valid
      const float e0 = (s0 == -INFINITY) ? 0.f : expf(s0 - m_new);
      const float e1 = (s1 == -INFINITY) ? 0.f : expf(s1 - m_new);
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      s_p[g][wl] = Elem<T>::round(e0);
      s_p[g][wl + 32] = Elem<T>::round(e1);
      if (wl == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
        s_alpha[g] = alpha;
      }
    }
    __syncthreads();

    // fold p * V into the accumulators
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = s_alpha[g];
#pragma unroll
      for (int e = 0; e < kEPT; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int j = i * RPI + grp;
      const int r = t0 + j;
      if (r < n_valid && has_cols) {
        float vx[kEPT];
        Elem<T>::load8(vb + (size_t)r * row_stride, vx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = s_p[g][j];
#pragma unroll
          for (int e = 0; e < kEPT; ++e) acc[g][e] += pg * vx[e];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kEPT; ++e) s_red[grp][g][d0 + e] = acc[g][e];
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < RPI; ++r) sum += s_red[r][g][d];
    const float o = n_valid > 0 ? sum / s_l[g] : 0.f;
    out[((size_t)b * Hq + h * G + g) * D + d] = Elem<T>::from_float(o);
  }
}

template <typename T, int D, int G>
void launch(const void* q, const void* k, const void* v, const int* pos,
            void* out, int B, int C, int Hkv, float scale,
            cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_attention_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), C, Hkv, scale);
}

template <typename T, int D>
int dispatch_group(int G, const void* q, const void* k, const void* v,
                   const int* pos, void* out, int B, int C, int Hkv,
                   float scale, cudaStream_t stream) {
  switch (G) {
    case 1: launch<T, D, 1>(q, k, v, pos, out, B, C, Hkv, scale, stream); break;
    case 2: launch<T, D, 2>(q, k, v, pos, out, B, C, Hkv, scale, stream); break;
    case 4: launch<T, D, 4>(q, k, v, pos, out, B, C, Hkv, scale, stream); break;
    case 8: launch<T, D, 8>(q, k, v, pos, out, B, C, Hkv, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, int G, const void* q, const void* k, const void* v,
                 const int* pos, void* out, int B, int C, int Hkv,
                 float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_group<T, 32>(G, q, k, v, pos, out, B, C, Hkv, scale, stream);
    case 64: return dispatch_group<T, 64>(G, q, k, v, pos, out, B, C, Hkv, scale, stream);
    case 112: return dispatch_group<T, 112>(G, q, k, v, pos, out, B, C, Hkv, scale, stream);
    case 128: return dispatch_group<T, 128>(G, q, k, v, pos, out, B, C, Hkv, scale, stream);
    case 256: return dispatch_group<T, 256>(G, q, k, v, pos, out, B, C, Hkv, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, Hkv*G, D); k, v: (B, C, Hkv, D); pos: (B,) int32; all
// contiguous on one device.  dtype: 0 = bfloat16, 1 = float32.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* pos, void* out, int B, int C,
                                int Hkv, int G, int D, int dtype, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<__nv_bfloat16>(D, G, q, k, v, pos, out, B, C, Hkv, scale, s);
  if (dtype == 1)
    return dispatch_dim<float>(D, G, q, k, v, pos, out, B, C, Hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
