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
// the tensor cores, not the memory, become the limit: 278 us at the
// 989 TFLOP/s bf16 tensor-core rate.  The kernel of the first port ran the
// products as scalar f32 FMAs out of shared memory and was held under the
// 67 TFLOP/s f32 rate (10.0 ms at this shape).
//
// bf16 (the training path): FlashAttention-3's shape, warp-specialised.
// One block of 288 threads per (128 query rows, q head, batch row): two
// consumer warpgroups of 64 rows each and one producer warp.
// - The producer loads Q once and keeps a 2-stage ring of 128-row K and V
//   tiles in flight through TMA (cp.async.bulk.tensor, 4-D tensor maps over
//   (D, heads, rows, batch) with 128-byte swizzle); each stage has a "full"
//   mbarrier for K, one for V (completed by the copies' byte counts) and an
//   "empty" one the consumers' 8 warps arrive at when they are done with it.
// - A row of 128 bytes holds 64 bf16, so a tile is loaded as DP/64 boxes of
//   64 columns, DP being D rounded up to 64 or 128.  At D = 112 (zamba2's
//   shared block) the second box covers columns 64..127 of a map whose
//   inner extent is 112: TMA fills 112..127 with zeros, which add nothing to
//   Q K^T, and P V's extra output columns are never stored (1/8 of the
//   products wasted).  D = 32 loads as one zero-padded box of 64 (half the
//   products wasted; no main path runs it).  Rows past S or T are zero-filled
//   the same way and masked by index.
// - Each consumer warpgroup runs S = Q K^T as wgmma m64n128k16 with both
//   operands from shared memory (K-major), and O += P V as wgmma m64nDPk16
//   with P from registers and V's tile as the MN-major B operand.  The
//   accumulator fragment of S is the A fragment of P V (rows 16w + lane/4
//   and +8, column pairs 2 (lane % 4)), so the online softmax runs in
//   registers: the row max and row sum are reductions over the 4 threads of
//   a quad.  The softmax is in base 2: the max is taken over the raw scores
//   and scaled once, each p is one FFMA (score x scale log2(e) - max) and
//   one ex2.approx (exp2f's accurate path is several instructions more).
//   The two warpgroups overlap each other's softmax with their products.
//   (Issuing the next tile's Q K^T before the softmax, FlashAttention-3's
//   overlap inside a warpgroup, measured slower here.)
// - p is rounded to bf16 relative to the running max before the PV product
//   (the XLA form rounds p to the value dtype), l sums the unrounded p and
//   is clamped at 1e-30 (flash_attention.py:69), and a row with no allowed
//   column gives lse = -inf.  KV tiles wholly above the causal diagonal or
//   wholly outside the window are skipped (flash_attention.py:35-43), the
//   others are masked by index only where they cross the diagonal, the
//   window's edge or T.  Query tiles are scheduled heaviest first (the last
//   causal tile does the most KV tiles).  The epilogue writes o and lse by
//   index, never past S.
//
// f32 (the gradient witness and the f32 tests, which hold the model in f32
// to 2e-5): the scalar kernel of the first port, one block of 128 threads
// per (64 query rows, q head, batch row), both products as f32 FMAs out of
// shared memory, held to the 67 TFLOP/s f32 rate.  The tensor cores' f32
// input type is TF32, whose 10-bit mantissa cannot hold 2e-5, so f32 keeps
// this kernel; the entry point dispatches on the dtype, and raises on a dtype
// or D it has no kernel for.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------- bf16: wgmma + TMA
constexpr int kQRows = 128;          // query rows per block
constexpr int kKRows = 128;          // K/V rows per tile
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreadsTc = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;

// D rounded up to a whole number of 64-column (128-byte) boxes
template <int D>
__host__ __device__ constexpr int box_cols() { return D <= 64 ? 64 : 128; }

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, then kStages x (K, V); 1024 bytes of slack to align the swizzle atoms
  return 1024 + 2 * ((size_t)kQRows * box_cols<D>()
                     + 2 * (size_t)kStages * kKRows * box_cols<D>());
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile laid out as TMA's 128-byte swizzle
// writes it: rows of 128 bytes, 8-row atoms of 1024 bytes (the stride byte
// offset).  `lbo` (leading byte offset) is the distance between 64-column
// boxes, read only for an MN-major operand wider than 64.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)(1024 >> 4) << 32
         | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes across the
// asynchronous products that own these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers, B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers, B from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x on the special function unit (2 ulp; results below 2^-126 flush to
// 0, which no p or rescale factor here needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int S, int Tk, int Hq, int G, float scale_log2,
                   int window) {
  constexpr int DP = box_cols<D>();
  constexpr int BK = kKRows;
  constexpr int NB = DP / 64;                // boxes per row
  constexpr int Q_BOX = kQRows * 64;         // elements of one Q box
  constexpr int KV_BOX = BK * 64;            // elements of one K or V box
  constexpr uint32_t Q_BYTES = 2u * kQRows * DP;
  constexpr uint32_t KV_BYTES = 2u * BK * DP;

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages], v_full[kStages],
      empty[kStages];
  // swizzle atoms are 1024-byte aligned
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sK = sQ + NB * Q_BOX;              // [stage][box][BK][64]
  __nv_bfloat16* sV = sK + kStages * NB * KV_BOX;   // [stage][box][BK][64]

  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;  // heaviest first
  const int q_last = min(q0 + kQRows, S) - 1;
  // KV tiles that hold any allowed column for rows q0..q_last
  const int k_end = min(Tk, q_last + 1);
  const int k_begin = window ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread starts every copy
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(sQ + c * Q_BOX, &qmap, &q_full, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        const int k0 = k_begin + i * BK;
        mbar_expect_tx(&k_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(sK + (s * NB + c) * KV_BOX, &kmap, &k_full[s], 64 * c, hk,
                   k0, b);
        mbar_expect_tx(&v_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(sV + (s * NB + c) * KV_BOX, &vmap, &v_full[s], 64 * c, hk,
                   k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // and row0 + 8
  const int col_in = 2 * (lane % 4);  // first column of each 8-column chunk

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, base 2, scaled
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  mbar_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = k_begin + i * BK;

    // S = Q K^T
    float sc[BK / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / 4, x = 16 * (kk % 4);  // box, column in the box
      wgmma_ss_n128(sc, desc_sw128(sQ + c * Q_BOX + 64 * 64 * wg + x, 0),
                    desc_sw128(sK + (s * NB + c) * KV_BOX + x, 0), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragment: sc[4j + e] is row row0 + 8 (e / 2),
    // column k0 + 8 j + col_in + e % 2
    const bool masked = k0 + BK - 1 > q0 || k0 + BK > Tk ||
                        (window && k0 <= q_last - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int r = row0 + 8 * (e / 2);
          const int col = k0 + 8 * j + col_in + e % 2;
          const bool ok = col < Tk && col <= r && (!window || col > r - window);
          if (!ok) sc[4 * j + e] = -INFINITY;
        }
        mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
      }
    }
    // the max of the raw scores, scaled once (the scale is positive)
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing yet
      alpha[r] = ex2(m[r] - base[r]);             // 0 while m is -inf
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(sc[4 * j + e], scale_log2, -base[e / 2]));
        sum[e / 2] += p[e];
      }
      // the accumulator's column pairs are the A fragment's: chunk j is
      // k-slice j / 2, registers 2 (j % 2) (row0) and 2 (j % 2) + 1 (row0+8)
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V
    mbar_wait(&v_full[s], parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(acc, pa[kk],
                   desc_sw128(sV + s * NB * KV_BOX + 16 * 64 * kk,
                              2u * KV_BOX));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: o and lse by index, rows < S, columns < D
  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float li = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= S) continue;
    const float inv = 1.f / li;
    __nv_bfloat16* orow = o + (((size_t)b * S + row) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col_in;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[((size_t)b * Hq + h) * S + row] =
          m[r] == -INFINITY ? -INFINITY : (m[r] + log2f(li)) * kLn2;
  }
}

// ------------------------------------------------- f32: scalar FMA kernel
// One block of 128 threads per (64 query rows, q head, batch row).  Per KV
// tile of 64 rows: K and V go to shared memory; each thread computes an
// 8 x 4 patch of the 64 x 64 score tile (rows rg + 8i, cols cg + 16j;
// rg = tid / 16, cg = tid % 16), so the 16 threads of a half-warp own whole
// rows and the online-softmax row max and row sum are half-warp shuffles;
// p goes to shared memory; then each thread accumulates an 8 x (DP/16)
// patch of the output, DP being D rounded up to a multiple of 32 (at
// D = 112 the last two threads of a row own only columns >= D, which V's
// tile holds as zeros and the store skips).  Shared rows are padded by 4
// floats so the 16-byte reads of a half-warp fall in distinct banks.
constexpr int kThreadsF32 = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // KV rows per tile
constexpr int kPad = 4;  // floats of padding per shared row

__device__ __forceinline__ void ld4(const float* p, float (&x)[4]) {
  float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

// 8 contiguous floats of one row (16-byte aligned) to shared memory, or
// zeros past the end.
__device__ __forceinline__ void row8_to_shared(const float* src, bool valid,
                                               float* dst) {
  float4 a{}, b{};
  if (valid) {
    a = reinterpret_cast<const float4*>(src)[0];
    b = reinterpret_cast<const float4*>(src)[1];
  }
  reinterpret_cast<float4*>(dst)[0] = a;
  reinterpret_cast<float4*>(dst)[1] = b;
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

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)kBK * padded_dim<D>()  // sV
                          + (size_t)kBQ * (D + kPad)       // sQ
                          + (size_t)kBK * (D + kPad)       // sK
                          + (size_t)kBQ * (kBK + kPad));   // sP
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int S, int Tk, int Hkv, int G,
                    float scale, int window) {
  constexpr int DP = padded_dim<D>();  // sV row stride
  constexpr int NJ = DP / 16;       // output columns per thread
  constexpr int RS = D + kPad;      // sQ / sK row stride
  constexpr int PS = kBK + kPad;    // sP row stride
  constexpr int C8 = D / 8;         // 8-element chunks per row
  static_assert(D % 16 == 0 && DP <= 128, "head dim 32, 64, 112 or 128");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sV = reinterpret_cast<float*>(smem_raw);  // [kBK][DP], cols >= D zero
  float* sQ = sV + kBK * DP;                       // [kBQ][RS]
  float* sK = sQ + kBQ * RS;                       // [kBK][RS]
  float* sP = sK + kBK * RS;                       // [kBQ][PS]

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
  const float* qb = q + ((size_t)b * S * Hq + h) * D;
  const float* kb = k + ((size_t)b * Tk * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Tk * Hkv + hk) * D;

  for (int c = tid; c < kBQ * C8; c += kThreadsF32) {
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
    for (int c = tid; c < kBK * (DP / 8); c += kThreadsF32) {
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
      for (int j = 0; j < 4; ++j) ld4(sK + (cg + 16 * j) * RS + d, kx[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float qx[4];
        ld4(sQ + (rg + 8 * i) * RS + d, qx);
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
        sP[(rg + 8 * i) * PS + cg + 16 * j] = p;
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
        const float* vrow = sV + (kk + e) * DP + cg * NJ;
        if constexpr (NJ % 4 == 0) {
#pragma unroll
          for (int jj = 0; jj < NJ; jj += 4) {
            float t4[4];
            ld4(vrow + jj, t4);
#pragma unroll
            for (int x = 0; x < 4; ++x) vx[e][jj + x] = t4[x];
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < NJ; jj += 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(vrow + jj);
            vx[e][jj] = t2.x;
            vx[e][jj + 1] = t2.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float px[4];
        ld4(sP + (rg + 8 * i) * PS + kk, px);
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
    float* orow = o + (((size_t)b * S + r) * Hq + h) * D + cg * NJ;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      if (cg * NJ + jj < D) orow[jj] = acc[i][jj] / li;
    if (cg == 0)
      lse[((size_t)b * Hq + h) * S + r] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(li);
  }
}

// ------------------------------------------------------------------- host
// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so the library links nothing beyond the runtime.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 (B, rows, heads, D) tensor as a 4-D map (D, heads, rows, batch),
// boxes of 64 columns x `box_rows` rows of one head, 128-byte swizzle,
// zeros outside the tensor.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
                int D, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * rows};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int Tk, int Hkv, int G,
              float scale, int window, int block_q, int block_k,
              cudaStream_t stream) {
  if (block_q != kQRows || block_k != kKRows)
    return (int)cudaErrorInvalidValue;
  const int Hq = Hkv * G;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(&qmap, q, B, S, Hq, D, kQRows) ||
      !encode_map(&kmap, k, B, Tk, Hkv, D, kKRows) ||
      !encode_map(&vmap, v, B, Tk, Hkv, D, kKRows))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem_bytes<D>();
  auto kern = flash_attention_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq * B, (S + kQRows - 1) / kQRows);
  kern<<<grid, kThreadsTc, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, S, Tk, Hq, G,
      scale * 1.4426950408889634f, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int Tk, int Hkv, int G, float scale,
               int window, int block_q, int block_k, cudaStream_t stream) {
  if (block_q != kBQ || block_k != kBK) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = f32_smem_bytes<D>();
  auto kern = flash_attention_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, Hkv * G, B);
  kern<<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Tk, Hkv,
      G, scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, S, Hkv*G, D); k, v: (B, T, Hkv, D); lse: (B, Hkv*G, S) f32; all
// contiguous, 16-byte aligned, on one device.  dtype: 0 = bfloat16 (the
// tensor-core kernel), 1 = float32 (the scalar kernel).  window = 0: no
// window.  block_q, block_k: the tiling the caller planned
// (kernels/flash_attention.py `flash_plan`), checked against the kernel's.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int S, int T,
                               int Hkv, int G, int D, int dtype, float scale,
                               int window, int block_q, int block_k,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, o, lse, B, S, T, Hkv, G, scale, window, block_q, \
                   block_k, s
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_tc<32>(FLASH_ARGS);
      case 64: return launch_tc<64>(FLASH_ARGS);
      case 112: return launch_tc<112>(FLASH_ARGS);
      case 128: return launch_tc<128>(FLASH_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_f32<32>(FLASH_ARGS);
      case 64: return launch_f32<64>(FLASH_ARGS);
      case 112: return launch_f32<112>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
