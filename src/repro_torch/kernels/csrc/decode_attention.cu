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
// softmax is online, p is rounded relative to a running max before its
// normalisation, where the XLA form rounds the normalised p; both round to
// the same relative precision.
//
// What bounds it: bytes.  Each step reads the valid K and V rows once
// (2 * n_valid * Hkv * D elements per batch row) and does 4 flops per
// element read, far below the ~295 flops/byte where the tensor cores
// would become the limit.  At the granite server shape (B = 8, 8 kv heads
// of 128, a full 512-row cache) that is 16.8 MB, 5 us at 3.35 TB/s, so
// the kernel has to keep the whole card's memory system busy at once.
//
// Design: the cache axis is split over the blocks of a thread-block
// cluster.  The grid is (kv head, batch row, split) with a cluster of
// n_split blocks along the split axis; the host picks n_split from B * Hkv
// and C alone (it cannot read pos without a sync: kernels/
// decode_attention.py `n_split`): at least two blocks share a (kv head,
// row) pair's cache, and enough to reach about two blocks per SM, with no
// split below 16 cache rows.  Each block takes its
// contiguous share of the valid prefix, computed on the device from pos[b]
// (a split left with no rows contributes m = -inf and l = 0), and keeps its
// K and V tiles of 32 rows in flight together with 16-byte cp.async copies
// into a double-buffered shared ring, so the V loads overlap the scores.
// Per tile: scores (a row read once by DP/8 neighbouring threads, 16 bytes
// each, for all G query heads of the group: DP is D rounded up to a power
// of two, and at D = 112 the last two threads of a row hold zeros; each
// thread's partial dot products for its rows and heads are summed over the
// row's threads by one reduce-scatter), then one warp per query head
// updates the running max and sum, then every thread folds p V into f32
// accumulators for its 8 output dims.  The block's row groups reduce
// through shuffles and shared memory into its partial (m, l, acc) for the
// G heads.  The cluster combines its partials through distributed shared
// memory: after cluster.sync() each block combines 1/n_split of the G x D
// outputs, reading every split's (m, l, acc) entry in one round trip and
// weighting each split by exp(m_j - M) / L, then waits at a second
// cluster.sync() so no block leaves while a peer still reads its shared
// memory.  One launch, no scratch in device memory.
//
// The partial entry (`decode_attention_partial`) runs the same kernel on one
// time slice of a cache split over ranks (flash-decode): the slice holds
// global rows base .. base + C - 1, and row b attends to the entries with
// base + t <= pos[b] (n_valid = clamp(pos[b] + 1 - base, 0, C); base = 0 is
// the whole-cache kernel).  Its epilogue writes the slice's output in f32,
// normalised by the slice's own sum L, and the log-sum-exp M + log(L) of
// the scaled scores, so the ranks combine their partials in f32
// (kernels/decode_attention.py `combine_partials`) and round to q's dtype
// once, after the combine, as the reference's sharded program does.  A
// cluster whose splits are all empty writes o = 0 and lse = -inf.  The
// entry is a runtime branch of the same instantiations.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // cache rows per tile: one per lane in the softmax
constexpr int kEPT = 8;       // elements of a row per thread
constexpr int kMaxSplit = 8;  // portable cluster size

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

__host__ __device__ constexpr int pow2_floor(int x) {
  return x >= 16 ? 16 : x >= 8 ? 8 : x >= 4 ? 4 : x >= 2 ? 2 : 1;
}
__host__ __device__ constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}

// the K and V ring: 2 stages x kTile rows each; after the cache loop the
// same bytes hold the per-warp partial outputs [kWarps][G][DP] (f32), which
// always fit: 16 G DP <= 128 DP <= 256 D bytes (G <= 8)
template <typename T, int D>
constexpr size_t ring_bytes() {
  return 2 * 2 * (size_t)kTile * D * sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Sums each of N values (a power of two) over the TPP threads of an aligned
// group (a power of two <= 32) so that each thread ends with max(N / TPP, 1)
// totals: while a
// thread holds more than one value it keeps the upper or lower half at each
// shuffle level (by its bit of `lane`) and adds the partner's copy of it;
// then plain butterfly levels.  Totals land in v[0 .. max(N / TPP, 1)).
template <int N, int TPP>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  int n = N;
#pragma unroll
  for (int o = TPP / 2; o > 0; o /= 2) {
    if (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        if (i < n / 2) {
          const float send = up ? v[i] : v[i + n / 2];
          const float keep = up ? v[i + n / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      n /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// At most 128 registers a thread at G <= 4: four blocks an SM, enough to
// hold every cluster of the planned splits at once.  (Five an SM made the
// G = 4 instantiations spill and measured slower at the planned splits.)
// G = 5 and 6 (qwen2.5-32b's 40/8 heads, mixtral's 48/8) keep the G = 8
// bound of two blocks an SM: 264 resident blocks hold the 256 of the
// planned split at their server shapes (B = 8, 8 kv heads, 4 splits).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, G <= 4 ? 4 : 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int C, int Hkv, float scale,
                        int base, float* __restrict__ o_part,
                        float* __restrict__ lse) {
  constexpr int DP = padded_dim<D>();
  constexpr int TPP = DP / kEPT;         // threads per cache row
  constexpr int RPI = kThreads / TPP;    // rows in flight per pass
  constexpr int RPT = kTile / RPI;       // passes per tile
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int EPC = 16 / (int)sizeof(T);      // elements per chunk
  static_assert(D % kEPT == 0 && TPP <= 32 && kTile % RPI == 0,
                "unsupported head dim");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kTile][D]
  T* sV = sK + 2 * kTile * D;              // [2][kTile][D]
  float* s_red = reinterpret_cast<float*>(smem_raw);  // [kWarps][G][DP]
  __shared__ float s_p[G][kTile];        // scores, then p, of one tile
  __shared__ float s_alpha[G];
  __shared__ float s_m[G];               // this block's partial, read by
  __shared__ float s_l[G];               // the cluster's other blocks
  __shared__ float s_acc[G][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_split = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int grp = tid / TPP;
  const int lane = tid % TPP;
  const int d0 = lane * kEPT;
  const bool has_cols = d0 < D;          // false only for columns >= D
  const int Hq = Hkv * G;

  // this split's rows [r_begin, r_end) of the valid prefix (of the slice
  // base .. base + C - 1 of the global cache; base = 0 but for the partial
  // entry)
  const int n_valid = min(pos[b] + 1 - base, C);
  const int per = (max(n_valid, 0) + n_split - 1) / n_split;
  const int r_begin = min(split * per, max(n_valid, 0));
  const int r_end = min(r_begin + per, max(n_valid, 0));

  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * C * Hkv + h) * D;
  const T* vb = v + ((size_t)b * C * Hkv + h) * D;
  // K and V rows [t0, min(t0 + kTile, r_end)) into stage `buf`, one group
  auto load_tile = [&](int t0, int buf) {
    const int rows = min(kTile, r_end - t0);
    for (int c = tid; c < rows * CPR; c += kThreads) {
      const int j = c / CPR;
      const int x = (c % CPR) * EPC;
      const size_t g = (size_t)(t0 + j) * row_stride + x;
      cp_async16(sK + (buf * kTile + j) * D + x, kb + g);
      cp_async16(sV + (buf * kTile + j) * D + x, vb + g);
    }
    cp_async_commit();
  };
  load_tile(r_begin, 0);
  load_tile(r_begin + kTile, 1);

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

  int buf = 0;
  for (int t0 = r_begin; t0 < r_end; t0 += kTile, buf ^= 1) {
    cp_async_wait<1>();  // this tile's group has landed (the next may not)
    __syncthreads();
    const T* tk = sK + buf * kTile * D;
    const T* tv = sV + buf * kTile * D;

    // scores of this tile: each thread's partial dot products for PC of its
    // RPT rows x G heads at a time (at most 16 values, to bound registers),
    // summed over the TPP threads of a row by a reduce-scatter (each
    // shuffle level halves the values a thread keeps): log2(TPP) levels
    // for all of them where a reduction per value would take PC * G times
    // that.  PC is a power of two, so it divides RPT; the reduce-scatter
    // halves a power of two of values, so a G that is not one (5, 6) pads
    // its NV = PC * G values with zeros to NVP (2 rows x 5 or 6 heads: 16).
    // After it, value kk of this thread is the total of index
    // (lane / SHARE) * KV + kk, index = pass * G + head within the chunk
    // (NVP values over TPP threads: KV = NVP / TPP each, at least 1; with
    // fewer values than threads SHARE = TPP / NVP threads hold each total,
    // and the first of them writes it; the padding's totals go unwritten).
    constexpr int PC = pow2_floor(RPT < 16 / G ? RPT : 16 / G);
    constexpr int NV = PC * G;
    constexpr int NVP = pow2_ceil(NV);
    constexpr int KV = NVP >= TPP ? NVP / TPP : 1;
    constexpr int SHARE = NVP >= TPP ? 1 : TPP / NVP;
#pragma unroll
    for (int i0 = 0; i0 < RPT; i0 += PC) {
      float v[NVP];
#pragma unroll
      for (int i = NV; i < NVP; ++i) v[i] = 0.f;
#pragma unroll
      for (int i = 0; i < PC; ++i) {
        const int j = (i0 + i) * RPI + grp;
#pragma unroll
        for (int g = 0; g < G; ++g) v[i * G + g] = 0.f;
        if (t0 + j < r_end && has_cols) {
          float kx[kEPT];
          Elem<T>::load8(tk + j * D + d0, kx);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < kEPT; ++e) v[i * G + g] += qr[g][e] * kx[e];
        }
      }
      reduce_scatter<NVP, TPP>(v, lane);
      if (lane % SHARE == 0) {
#pragma unroll
        for (int kk = 0; kk < KV; ++kk) {
          const int idx = (lane / SHARE) * KV + kk;
          const int j = (i0 + idx / G) * RPI + grp;
          if (idx < NV)
            s_p[idx % G][j] = t0 + j < r_end ? v[kk] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, one row per lane
    const int warp = tid / 32;
    const int wl = tid % 32;
    for (int g = warp; g < G; g += kWarps) {
      const float s = s_p[g][wl];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);  // finite: row t0 is valid
      const float e = (s == -INFINITY) ? 0.f : expf(s - m_new);
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      s_p[g][wl] = Elem<T>::round(e);
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
      if (t0 + j < r_end && has_cols) {
        float vx[kEPT];
        Elem<T>::load8(tv + j * D + d0, vx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = s_p[g][j];
#pragma unroll
          for (int e = 0; e < kEPT; ++e) acc[g][e] += pg * vx[e];
        }
      }
    }
    __syncthreads();  // every reader is done with this stage
    load_tile(t0 + 2 * kTile, buf);
  }
  cp_async_wait<0>();

  // this block's partial: row groups of a warp by shuffles, warps through
  // shared memory (the ring's bytes, free now)
#pragma unroll
  for (int off = TPP; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kEPT; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  __syncthreads();
  if (tid % 32 < TPP) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kEPT; ++e)
        s_red[((tid / 32) * G + g) * DP + d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_red[(w * G + g) * DP + d];
    s_acc[g][d] = sum;
  }

  // combine the cluster's partials; each block writes 1/n_split of o.  A
  // thread reads every split's m, l and acc entry for its output together
  // (unrolled over the largest cluster, predicated on the real one), so the
  // combine waits for one round trip through distributed shared memory.
  cluster.sync();
  const int share = (G * D + n_split - 1) / n_split;
  const int i_end = min(G * D, (split + 1) * share);
  for (int idx = split * share + tid; idx < i_end; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mj[kMaxSplit], lj[kMaxSplit], aj[kMaxSplit];
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      mj[j] = j < n_split ? *cluster.map_shared_rank(&s_m[g], j) : -INFINITY;
      lj[j] = j < n_split ? *cluster.map_shared_rank(&s_l[g], j) : 0.f;
      aj[j] = j < n_split ? *cluster.map_shared_rank(&s_acc[g][d], j) : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) M = fmaxf(M, mj[j]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplit; ++j) {
      const float w = mj[j] == -INFINITY ? 0.f : expf(mj[j] - M);
      L += w * lj[j];
      o += w * aj[j];
    }
    const size_t row = (size_t)b * Hq + h * G + g;
    if (lse == nullptr) {
      out[row * D + d] = Elem<T>::from_float(L > 0.f ? o / L : 0.f);
    } else {  // the partial entry: f32 output and log-sum-exp
      o_part[row * D + d] = L > 0.f ? o / L : 0.f;
      if (d == 0) lse[row] = L > 0.f ? M + logf(L) : -INFINITY;
    }
  }
  cluster.sync();  // peers' shared memory stays alive until every read
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, int B, int C, int Hkv, int n_split, float scale,
           int base, float* o_part, float* lse, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, D, G>;
  constexpr size_t smem = ring_bytes<T, D>();
  if (smem > 48 * 1024) {  // above the default limit: ask once
    static bool raised = false;
    if (!raised) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      raised = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv, B, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), C, Hkv, scale,
      base, o_part, lse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int D, int G>
int max_clusters(int n_split, int* count) {
  auto kern = decode_attention_kernel<T, D, G>;
  constexpr size_t smem = ring_bytes<T, D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, kern, &cfg);
}

// Runs F<T, D, G>(args...) for the runtime (dtype, D, G).
#define DECODE_DISPATCH(F, ...)                                               \
  switch (dtype * 10000 + D * 10 + G) {                                       \
    DECODE_CASES(0, __nv_bfloat16, F, __VA_ARGS__)                            \
    DECODE_CASES(1, float, F, __VA_ARGS__)                                    \
    default: return (int)cudaErrorInvalidValue;                               \
  }
#define DECODE_CASES(DT, T, F, ...)                                           \
  DECODE_D(DT, T, 32, F, __VA_ARGS__) DECODE_D(DT, T, 64, F, __VA_ARGS__)     \
  DECODE_D(DT, T, 112, F, __VA_ARGS__) DECODE_D(DT, T, 128, F, __VA_ARGS__)   \
  DECODE_D(DT, T, 256, F, __VA_ARGS__)                                        \
  case DT * 10000 + 128 * 10 + 5: return F<T, 128, 5>(__VA_ARGS__);           \
  case DT * 10000 + 128 * 10 + 6: return F<T, 128, 6>(__VA_ARGS__);
#define DECODE_D(DT, T, DD, F, ...)                                           \
  case DT * 10000 + DD * 10 + 1: return F<T, DD, 1>(__VA_ARGS__);             \
  case DT * 10000 + DD * 10 + 2: return F<T, DD, 2>(__VA_ARGS__);             \
  case DT * 10000 + DD * 10 + 4: return F<T, DD, 4>(__VA_ARGS__);             \
  case DT * 10000 + DD * 10 + 8: return F<T, DD, 8>(__VA_ARGS__);

bool valid_split(int n_split) {
  return n_split == 1 || n_split == 2 || n_split == 4 || n_split == 8;
}

}  // namespace

// q, out: (B, Hkv*G, D); k, v: (B, C, Hkv, D); pos: (B,) int32; all
// contiguous, 16-byte aligned, on one device.  G in (1, 2, 4, 8) at every
// D, and G = 5 or 6 at D = 128.  dtype: 0 = bfloat16,
// 1 = float32.  n_split: blocks per cluster along the cache axis, 1, 2, 4
// or 8 (kernels/decode_attention.py `n_split`).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* pos, void* out, int B, int C,
                                int Hkv, int G, int D, int dtype, int n_split,
                                float scale, void* stream) {
  if (!valid_split(n_split)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DECODE_DISPATCH(launch, q, k, v, pos, out, B, C, Hkv, n_split, scale, 0,
                  nullptr, nullptr, s)
}

// The partial entry: q (B, Hkv*G, D); k, v: (B, C, Hkv, D), one time slice
// holding global cache rows base .. base + C - 1; pos: (B,) int32 global
// positions.  Writes o_part (B, Hkv*G, D) f32, normalised by the slice's
// own sum, and lse (B, Hkv*G) f32; a row with no valid entry in the slice
// gets o = 0 and lse = -inf.  Other arguments as `decode_attention`.
extern "C" int decode_attention_partial(const void* q, const void* k,
                                        const void* v, const int* pos,
                                        float* o_part, float* lse, int B,
                                        int C, int Hkv, int G, int D,
                                        int dtype, int n_split, int base,
                                        float scale, void* stream) {
  if (!valid_split(n_split) || o_part == nullptr || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DECODE_DISPATCH(launch, q, k, v, pos, nullptr, B, C, Hkv, n_split, scale,
                  base, o_part, lse, s)
}

// How many clusters of `n_split` blocks of the (dtype, D, G) kernel the card
// holds at once (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int decode_attention_max_clusters(int D, int G, int dtype,
                                             int n_split, int* count) {
  if (!valid_split(n_split)) return (int)cudaErrorInvalidValue;
  DECODE_DISPATCH(max_clusters, n_split, count)
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
