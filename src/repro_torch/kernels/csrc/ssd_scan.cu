// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py (`ssd_scan` :53,
// `_ssd_kernel` :22), and computes what the reference trains with, the XLA
// form repro/nn/ssm.py:72 (`ssd_chunked`), on the pre-activated inputs
// xdt = x * dt (B, S, H, P), la = dt * A (B, S, H) and the shared B, C
// (B, S, N), all f32:
//   h_t = exp(la_t) h_{t-1} + xdt_t B_t^T          (the (P, N) state)
//   y_t = h_t C_t
// in the chunked form: per chunk of L rows, with cum = cumsum(la) inside the
// chunk,
//   y[t]   = exp(cum_t) (h C_t) + sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s)
//            xdt[s]                                 (h: state entering)
//   h_next = exp(cum_last) h + sum_s exp(cum_last - cum_s) xdt[s] B_s^T.
// Every weight is the exp of a difference of cumulative log-decays, as in
// the reference: zamba2's decays reach la ~ -11 per step and cum ~ -1400
// over a chunk, so factoring exp(cum_t) * exp(-cum_s) would overflow to
// inf * 0.  The cumulative sum is taken in f64, and each score weight is
// 2^x of the f64 difference x of log2(e)-scaled cumsums, rounded once to
// f32 (the same rounding as the exponent of exp, then ex2.approx): at
// |cum| ~ 1000 an f32 cumsum carries ~1e-4 of absolute error into every
// exponent.  Unlike the TPU kernel it also writes the final state h_final
// (B, H, P, N), which the reference's kernel path drops.
//
// What bounds it: bytes.  At the hybrid train shape (B=2, S=4096, H=112,
// P=N=64, L=128) it must move 481.3 MB (xdt in, y out, 235 MB each:
// 143.7 us at 3.35 TB/s) and do 2.268e10 flop, counting C B^T once per
// (batch row, chunk): 338.5 us at the 67 TFLOP/s f32 rate, 137.4 us in the
// tensor cores at 3xTF32 (495 / 3 TFLOP/s).  One TF32 product keeps 10
// mantissa bits, too few for the scan's 5e-4 tolerance; three (lo hi +
// hi lo + hi hi, each operand split as hi = tf32(a), lo = tf32(a - hi))
// keep ~21, as tests/test_torch_ssd_precision.py shows by emulating this
// arithmetic.  B and C are shared by all heads, so C B^T is a quarter of
// the work if it is formed per head; scalar FMAs fed from shared memory
// would run at the rate of its loads (32 floats a clock against 128 FMAs).
//
// Design: two kernels in one call.
//   ssd_prep_kernel  one block per (batch row, chunk, part k): C B^T rows
//       32 k.. once per (batch row, chunk), (B, nch, L, L) f32 in plain f32
//       FMAs, only the columns the scan reads (4.2 MB at the train shape:
//       it stays in L2); and, from a coalesced slice of la, the records of
//       heads 32 k.. for the chunk, 4 L floats each: the f64 inclusive
//       cumsum of la times log2(e) (2 L floats), exp(cum_t) and
//       exp(cum_last - cum_t).  Rows past S read as zeros, so the cumsum
//       stays at its last real row.
//   ssd_chunk_kernel<PT>  one block of four warps per (PT columns of P,
//       head, batch row), grid (P / PT, H, B): each row p of the state
//       evolves on its own, h[p,:] <- e^{la} h[p,:] + xdt[p] B^T and
//       y[:,p] = h[p,:] . C, so a block owns columns p0..p0+PT of xdt, y
//       and h and needs nothing from the others.  It walks its chunks in
//       order (one pass over xdt and y) and keeps the next chunk's xdt
//       columns and record in flight by cp.async (two stages) while the
//       current one computes.  Each warp owns all PT columns, so the score
//       weights of a (batch row, head, chunk) are formed once; per chunk,
//       on mma.sync m16n8k8 TF32 tensor cores, each product as three (the
//       lo hi terms of every tile, then hi lo, then hi hi) into f32
//       accumulators:
//         carried  y (the warp's row tiles 7 - w and w: the triangle's
//                  work shared evenly) = exp(cum_t) C h^T, C from L2;
//         steps    over the chunk's 8-row steps s, the xdt fragments
//                  (shared memory) split once and fed to both
//                    h^T (the warp's 16 state columns x PT) = exp(cum_last)
//                      h^T + (B dte)^T xdt, B from L2, in registers;
//                    y += G xdt for s on or below each tile's diagonal, G =
//                      CB * 2^(cum_t - cum_s) formed in registers as the A
//                      fragment (CB from L2), so the (L, L) score tile
//                      never takes shared memory.
//       The state the carried product reads is the one entering the chunk:
//       it stays in shared memory until every warp is done with it, then
//       the new state is written over it.  The loops hold no branches (an
//       absent tile repeats a real one and is not stored; entries above
//       the diagonal are selected to zero), so the products of different
//       accumulators interleave.
//   PT = 64 (92 KB of shared memory, two blocks an SM) forms the weights
//   once per (batch row, head, chunk); PT = 32 and 16 form them two and
//   four times, for more blocks on small grids.  ssm_scan.py's ssd_plan
//   picks PT.
// The chunk length, P and N are run-time values (multiples of 16, at most
// 128, 64 and 64); a ragged last chunk is masked by index.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxL = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 64;

// ---------------------------------------------------------------- prep
constexpr int kPrepThreads = 256;
constexpr int kCBRows = 32;     // rows of C B^T per prep block

constexpr int kHeadGroup = 32;  // heads whose records a prep block writes

// Shared memory of a prep block, in floats: B^T [N][L + 1] and the band's
// rows of C^T [N][kCBRows + 1], then (reused) la [kHeadGroup][L + 1].
__host__ __device__ inline int prep_smem_floats(int L, int N) {
  return max(N * (L + 1) + N * (kCBRows + 1), kHeadGroup * (L + 1));
}

constexpr double kLog2e = 1.4426950408889634;

// The record of one (batch row, head, chunk) from its la in shared memory
// (L floats, zeros past S), by one warp, four rows a lane: log2(e) cum
// (f64: the score weights are 2^x of their differences), exp(cum_t) and
// exp(cum_last - cum_t).  Rows past S add nothing, so the cumsum stays at
// its last real row.
__device__ void chunk_record(const float* sla, float* __restrict__ r, int L,
                             int lane) {
  double part[4];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = 4 * lane + e;
    run += t < L ? (double)sla[t] : 0.0;
    part[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const double base = incl - run;  // sum over the lanes before this one
  // row L - 1 is the last of lane (L - 1) / 4 (L % 4 == 0)
  const double cum_last =
      __shfl_sync(0xffffffffu, base + part[3], (L - 1) / 4);
  if (4 * lane >= L) return;
  double cv[4];
  float ec[4], dte[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cv[e] = base + part[e];
    ec[e] = expf((float)cv[e]);
    dte[e] = expf((float)(cum_last - cv[e]));
  }
  double2* rc = reinterpret_cast<double2*>(r) + 2 * lane;
  rc[0] = make_double2(kLog2e * cv[0], kLog2e * cv[1]);
  rc[1] = make_double2(kLog2e * cv[2], kLog2e * cv[3]);
  reinterpret_cast<float4*>(r + 2 * L)[lane] =
      make_float4(ec[0], ec[1], ec[2], ec[3]);
  reinterpret_cast<float4*>(r + 3 * L)[lane] =
      make_float4(dte[0], dte[1], dte[2], dte[3]);
}

// One block per (batch row b, chunk c, part k): C B^T rows 32 k.. in plain
// f32, only the columns s < 32 (k + 1) that the scan reads (if 32 k < L),
// then the records of chunk c for heads 32 k.. 32 k + 31 (if 32 k < H).
__global__ void __launch_bounds__(kPrepThreads)
ssd_prep_kernel(const float* __restrict__ la, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ cb,
                float* __restrict__ rec, int B, int S, int H, int N, int L,
                int nch, int parts) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int k = blockIdx.x % parts;
  const int c = (blockIdx.x / parts) % nch;
  const int b = blockIdx.x / (parts * nch);
  const int c0 = c * L, nv = min(L, S - c0);
  const int LS = L + 1;
  if (kCBRows * k < L) {
    const int ncols = min(L, kCBRows * (k + 1));
    const int RS = kCBRows + 1, N4 = N / 4;
    float* sBt = smem;           // [N][LS]
    float* sCt = smem + N * LS;  // [N][RS]
    // loads first, all in flight together, then the transposed stores
    constexpr int kBPer = kMaxL * (kMaxN / 4) / kPrepThreads;
    constexpr int kCPer = kCBRows * (kMaxN / 4) / kPrepThreads;
    float4 bv4[kBPer], cv4[kCPer];
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + i * kPrepThreads, t = idx / N4;
      bv4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nv && t < ncols)
        bv4[i] = *reinterpret_cast<const float4*>(
            Bm + ((size_t)b * S + c0 + t) * N + 4 * (idx % N4));
    }
#pragma unroll
    for (int i = 0; i < kCPer; ++i) {
      const int idx = tid + i * kPrepThreads, t = k * kCBRows + idx / N4;
      cv4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nv && idx < kCBRows * N4)
        cv4[i] = *reinterpret_cast<const float4*>(
            Cm + ((size_t)b * S + c0 + t) * N + 4 * (idx % N4));
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int idx = tid + i * kPrepThreads, t = idx / N4, n = 4 * (idx % N4);
      if (t >= ncols) continue;
      sBt[(n + 0) * LS + t] = bv4[i].x;
      sBt[(n + 1) * LS + t] = bv4[i].y;
      sBt[(n + 2) * LS + t] = bv4[i].z;
      sBt[(n + 3) * LS + t] = bv4[i].w;
    }
#pragma unroll
    for (int i = 0; i < kCPer; ++i) {
      const int idx = tid + i * kPrepThreads, tl = idx / N4;
      const int n = 4 * (idx % N4);
      if (tl >= kCBRows) continue;
      sCt[(n + 0) * RS + tl] = cv4[i].x;
      sCt[(n + 1) * RS + tl] = cv4[i].y;
      sCt[(n + 2) * RS + tl] = cv4[i].z;
      sCt[(n + 3) * RS + tl] = cv4[i].w;
    }
    __syncthreads();
    // thread (ty, tx) = (tid / 32, tid % 32): rows ty + 8 i, columns tx + 32 j
    const int ty = tid / 32, tx = tid % 32;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = sCt[n * RS + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = tx + 32 * j < ncols ? sBt[n * LS + tx + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = k * kCBRows + ty + 8 * i;
      if (t >= L) continue;
      float* row = cb + (((size_t)b * nch + c) * L + t) * L;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 32 * j < ncols) row[tx + 32 * j] = acc[i][j];
    }
    __syncthreads();  // the la slice below reuses the shared memory
  }
  const int h0 = kHeadGroup * k;
  if (h0 >= H) return;
  float* sla = smem;  // [kHeadGroup][LS], a head's rows contiguous
  constexpr int kLaPer = kMaxL * kHeadGroup / kPrepThreads;
  float lv[kLaPer];
#pragma unroll
  for (int i = 0; i < kLaPer; ++i) {
    const int idx = tid + i * kPrepThreads;
    const int t = idx / kHeadGroup, hh = idx % kHeadGroup;
    lv[i] = t < nv && h0 + hh < H
                ? la[((size_t)b * S + c0 + t) * H + h0 + hh]
                : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kLaPer; ++i) {
    const int idx = tid + i * kPrepThreads;
    const int t = idx / kHeadGroup, hh = idx % kHeadGroup;
    if (t < L) sla[hh * LS + t] = lv[i];
  }
  __syncthreads();
  for (int hh = tid / 32; hh < kHeadGroup && h0 + hh < H;
       hh += kPrepThreads / 32)
    chunk_record(sla + hh * LS,
                 rec + (((size_t)b * H + h0 + hh) * nch + c) * 4 * L, L,
                 tid % 32);
}

// ---------------------------------------------------------------- scan
constexpr int kScanThreads = 128;  // four warps, each owning all PT columns

// blocks an SM the registers of each tile are budgeted for
// (ssm_scan.py REG_BLOCKS)
template <int PT>
constexpr int min_blocks() {
  return PT == 64 ? 2 : 3;
}

// Shared memory of a scan block, in floats.  xdt rows are PT + 4 long, so
// the four rows s = 2 q that a fragment load touches sit 8 banks apart;
// state rows are N + 8 long, so its float2 loads of four rows do too.
struct Smem {
  int xs, hs;
  int x0, x1, r0, r1, h, total;
};

__host__ __device__ inline Smem smem_layout(int PT, int L, int N) {
  Smem o;
  o.xs = PT + 4;
  o.hs = N + 8;
  o.x0 = 0;                  // xdt chunk [L][xs], stage 0
  o.x1 = o.x0 + L * o.xs;    // stage 1
  o.r0 = o.x1 + L * o.xs;    // record [4 L]: cum (f64), exp(cum), dte
  o.r1 = o.r0 + 4 * L;
  o.h = o.r1 + 4 * L;        // state entering the chunk [PT][hs]
  o.total = o.h + PT * o.hs;
  return o;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a = hi + lo, each rounded to TF32 (nearest, ties away: what cvt.rna.tf32
// gives, here in integer ops on the bits)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  const float r = a - __uint_as_float(hi);
  lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i][j] += a[i] b[j] in 3xTF32 for i < NI, j < NJ: the lo hi terms of
// every tile, then the hi lo terms, then hi hi, so that products into one
// accumulator are NI NJ instructions apart
template <int NI, int NJ, int DI, int DJ>
__device__ __forceinline__ void mma3(float (&d)[DI][DJ][4],
                                     const uint32_t (&ah)[DI][4],
                                     const uint32_t (&al)[DI][4],
                                     const uint32_t (&bh)[DJ][2],
                                     const uint32_t (&bl)[DJ][2]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(d[i][j], al[i], bh[j]);
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(d[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma(d[i][j], ah[i], bh[j]);
}

// Fragments of m16n8k8 (lane = 4 g + q) with the k axis permuted so that a
// thread's two k slots are adjacent: slot q is k = 2 q, slot q + 4 is
// k = 2 q + 1.  A (16 x 8): a0 = A[g][2q], a1 = A[g+8][2q], a2 = A[g][2q+1],
// a3 = A[g+8][2q+1]; B (8 x 8): b0 = B[2q][g], b1 = B[2q+1][g]; D (16 x 8):
// d0, d1 = D[g][2q, 2q+1], d2, d3 = D[g+8][2q, 2q+1].

// y += C h^T for NI row tiles of the warp (rows row[i], row[i] + 8 of the
// chunk, from L2 one 8-column step ahead) and the warp's YN column tiles of
// the state entering the chunk (shared memory, rows col0 + 8 j).
template <int NI, int YN>
__device__ __forceinline__ void y_carried(float (&acc)[2][YN][4],
                                          const float* const (&crow)[2][2],
                                          const float* sH, int hs, int col0,
                                          int q, int N) {
  float2 nxt[NI][2];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      nxt[i][r] = __ldg(reinterpret_cast<const float2*>(crow[i][r]));
  const int steps = N / 8;
#pragma unroll 2
  for (int kk = 0; kk < steps; ++kk) {
    const int kn = min(kk + 1, steps - 1);
    uint32_t ah[2][4], al[2][4], bh[YN][2], bl[YN][2];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float2 c0 = nxt[i][0], c1 = nxt[i][1];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        nxt[i][r] = __ldg(reinterpret_cast<const float2*>(crow[i][r] + 8 * kn));
      split(c0.x, ah[i][0], al[i][0]);
      split(c1.x, ah[i][1], al[i][1]);
      split(c0.y, ah[i][2], al[i][2]);
      split(c1.y, ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < YN; ++j) {
      const float2 hv = *reinterpret_cast<const float2*>(
          sH + (col0 + 8 * j) * hs + 8 * kk + 2 * q);
      split(hv.x, bh[j][0], bl[j][0]);
      split(hv.y, bh[j][1], bl[j][1]);
    }
    mma3<NI, YN>(acc, ah, al, bh, bl);
  }
}

// 2^x (ex2.approx: within 2 ulp; 0 below 2^-126)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The 8-row steps k0 <= ks < k1 of the chunk, for one warp.  The xdt
// fragments (shared memory) are split once and feed both products:
//   state  h^T (16 state columns x YN 8-column tiles) += (B dte)^T xdt, B
//          from L2 one step ahead (rows past S read row 0: xdt is zero
//          there);
//   scores for NI row tiles, y += G xdt with G[t][s] = CB[t][s]
//          exp(cum_t - cum_s) for s <= t, formed in registers from CB (L2,
//          one step ahead) and the f64 cumsum.
template <int NI, int YN>
__device__ __forceinline__ void chunk_steps(
    int k0, int k1, int nv, float (&acc)[2][YN][4], float (&hacc)[1][YN][4],
    const float* const (&cbrow)[2], const int (&row)[2],
    const double (&ct)[2][2], const float* bcol, int N, const double* sCum,
    const float* sDte, const float* sX, int xs, int col0, int q, int L) {
  if (k0 >= k1) return;
  float2 nc[NI > 0 ? NI : 1][2];
  float nb[4];
  auto fetch = [&](int ks) {
    const int s = 8 * ks + 2 * q;
    const float* r0 = bcol + (size_t)(s < nv ? s : 0) * N;
    const float* r1 = bcol + (size_t)(s + 1 < nv ? s + 1 : 0) * N;
    nb[0] = __ldg(r0);
    nb[1] = __ldg(r0 + 8);
    nb[2] = __ldg(r1);
    nb[3] = __ldg(r1 + 8);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        nc[i][r] = __ldg(reinterpret_cast<const float2*>(cbrow[i] + 8 * r * L
                                                         + 8 * ks));
  };
  fetch(k0);
#pragma unroll 2
  for (int ks = k0; ks < k1; ++ks) {
    const int s = 8 * ks + 2 * q;
    const float b00 = nb[0], b01 = nb[1], b10 = nb[2], b11 = nb[3];
    float2 v[NI > 0 ? NI : 1][2];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      v[i][0] = nc[i][0];
      v[i][1] = nc[i][1];
    }
    fetch(min(ks + 1, k1 - 1));
    uint32_t xh[YN][2], xl[YN][2];
    const float* x0 = sX + s * xs + col0;
    const float* x1 = x0 + xs;
#pragma unroll
    for (int j = 0; j < YN; ++j) {
      split(x0[8 * j], xh[j][0], xl[j][0]);
      split(x1[8 * j], xh[j][1], xl[j][1]);
    }
    const float2 d = *reinterpret_cast<const float2*>(sDte + s);
    uint32_t bh[1][4], bl[1][4];
    split(b00 * d.x, bh[0][0], bl[0][0]);
    split(b01 * d.x, bh[0][1], bl[0][1]);
    split(b10 * d.y, bh[0][2], bl[0][2]);
    split(b11 * d.y, bh[0][3], bl[0][3]);
    mma3<1, YN>(hacc, bh, bl, xh, xl);
    if constexpr (NI > 0) {
      const double2 cs = *reinterpret_cast<const double2*>(sCum + s);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int t0 = row[i], t1 = row[i] + 8;
        const float g00 = v[i][0].x * exp2_approx((float)(ct[i][0] - cs.x));
        const float g01 = v[i][0].y * exp2_approx((float)(ct[i][0] - cs.y));
        const float g10 = v[i][1].x * exp2_approx((float)(ct[i][1] - cs.x));
        const float g11 = v[i][1].y * exp2_approx((float)(ct[i][1] - cs.y));
        split(s <= t0 ? g00 : 0.f, ah[i][0], al[i][0]);
        split(s <= t1 ? g10 : 0.f, ah[i][1], al[i][1]);
        split(s + 1 <= t0 ? g01 : 0.f, ah[i][2], al[i][2]);
        split(s + 1 <= t1 ? g11 : 0.f, ah[i][3], al[i][3]);
      }
      mma3<NI, YN>(acc, ah, al, xh, xl);
    }
  }
}

template <int PT>
__global__ void __launch_bounds__(kScanThreads, min_blocks<PT>())
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ rec,
                 const float* __restrict__ cb, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ h_out, int S, int H, int P, int N, int L,
                 int nch) {
  constexpr int YN = PT / 8;  // 8-column tiles of the warp
  extern __shared__ __align__(16) float smem[];
  const Smem lo = smem_layout(PT, L, N);
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int wq = warp;
  const int col0 = g;
  // the warp's 16 state columns; where N has fewer than 4 x 16, a warp
  // past them repeats the last 16 (computed, never stored)
  const bool has_state = 16 * wq < N;
  const int sn0 = min(16 * wq, N - 16);
  // the warp's 16-row tiles of y: 7 - wq and wq, the triangle's work shared
  // evenly; tile[0] is the larger valid one, tile[1] the other (-1: none)
  const int Lm = L / 16;
  const int big = 7 - wq < Lm ? 7 - wq : -1, small = wq < Lm ? wq : -1;
  const int tile[2] = {big >= 0 ? big : small, big >= 0 ? small : -1};
  const int n_tiles = (tile[0] >= 0) + (tile[1] >= 0);
  // rows of an absent tile repeat tile 0's: computed, never stored
  const int row[2] = {16 * max(tile[0], 0) + g,
                      16 * (tile[1] >= 0 ? tile[1] : max(tile[0], 0)) + g};
  float* sH = smem + lo.h;

  auto load_x = [&](int c, int st) {  // xdt's columns and the record
    const int c0 = c * L, nv = min(L, S - c0);
    float* sX = smem + (st ? lo.x1 : lo.x0);
    constexpr int V = PT / 4;
    for (int idx = tid; idx < L * V; idx += kScanThreads) {
      const int t = idx / V, v = idx % V;
      const bool ok = t < nv;
      cp_async16(sX + t * lo.xs + 4 * v,
                 xdt + (((size_t)b * S + c0 + (ok ? t : 0)) * H + h) * P + p0
                     + 4 * v,
                 ok);
    }
    float* sR = smem + (st ? lo.r1 : lo.r0);
    const float* r = rec + (((size_t)b * H + h) * nch + c) * 4 * L;
    for (int idx = tid; idx < L; idx += kScanThreads)
      cp_async16(sR + 4 * idx, r + 4 * idx, true);
  };

  // h^T: the warp's 16 state columns (rows of the tile) x the PT columns
  // of P
  float hacc[1][YN][4];
#pragma unroll
  for (int j = 0; j < YN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[0][j][e] = 0.f;
  for (int idx = tid; idx < PT * lo.hs; idx += kScanThreads) sH[idx] = 0.f;
  load_x(0, 0);
  cp_async_commit();

  for (int c = 0; c < nch; ++c) {
    const int st = c & 1;
    const int c0 = c * L, nv = min(L, S - c0);
    const int ksteps = (nv + 7) / 8;  // 8-row steps holding real rows
    cp_async_wait_all();
    __syncthreads();  // chunk c's xdt and record have landed; sH is h_in
    if (c + 1 < nch) load_x(c + 1, st ^ 1);
    cp_async_commit();
    const float* sX = smem + (st ? lo.x1 : lo.x0);
    const float* sR = smem + (st ? lo.r1 : lo.r0);
    const double* sCum = reinterpret_cast<const double*>(sR);
    const float* sEc = sR + 2 * L;
    const float* sDte = sR + 3 * L;

    float acc[2][YN][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < YN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // C and C B^T rows of the tiles (rows past S read row 0: never stored)
    const float* crow[2][2];
    const float* cbrow[2];
    double ct[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = row[i] + 8 * r;
        crow[i][r] = Cm + ((size_t)b * S + c0 + (t < nv ? t : 0)) * N + 2 * q;
        ct[i][r] = sCum[t];
      }
      cbrow[i] = cb + (((size_t)b * nch + c) * L + row[i]) * L + 2 * q;
    }

    // ---- y = exp(cum_t) (C h^T) over the state entering the chunk ------
    if (n_tiles == 2)
      y_carried<2, YN>(acc, crow, sH, lo.hs, col0, q, N);
    else if (n_tiles == 1)
      y_carried<1, YN>(acc, crow, sH, lo.hs, col0, q, N);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float e0 = sEc[row[i]], e1 = sEc[row[i] + 8];
#pragma unroll
      for (int j = 0; j < YN; ++j) {
        acc[i][j][0] *= e0;
        acc[i][j][1] *= e0;
        acc[i][j][2] *= e1;
        acc[i][j][3] *= e1;
      }
    }

    // ---- h = exp(cum_last) h + (B dte)^T xdt;  y += G xdt ---------------
    const float decay = sEc[L - 1];
#pragma unroll
    for (int j = 0; j < YN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[0][j][e] *= decay;
    const float* bcol = Bm + ((size_t)b * S + c0) * N + sn0 + g;
    // 8-row steps on or below each tile's diagonal: both tiles up to the
    // smaller one's end, then the larger, then the state alone
    const int k0 = tile[0] >= 0 ? min(2 * tile[0] + 2, ksteps) : 0;
    const int k1 = tile[1] >= 0 ? min(2 * tile[1] + 2, ksteps) : 0;
    chunk_steps<2, YN>(0, k1, nv, acc, hacc, cbrow, row, ct, bcol, N,
                           sCum, sDte, sX, lo.xs, col0, q, L);
    chunk_steps<1, YN>(k1, k0, nv, acc, hacc, cbrow, row, ct, bcol, N,
                           sCum, sDte, sX, lo.xs, col0, q, L);
    chunk_steps<0, YN>(k0, ksteps, nv, acc, hacc, cbrow, row, ct, bcol,
                           N, sCum, sDte, sX, lo.xs, col0, q, L);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (tile[i] < 0) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = row[i] + 8 * r;
        if (t >= nv) continue;
        float* yrow = y + (((size_t)b * S + c0 + t) * H + h) * P + p0 + 2 * q;
#pragma unroll
        for (int j = 0; j < YN; ++j)
          *reinterpret_cast<float2*>(yrow + 8 * j) =
              make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
      }
    }
    __syncthreads();  // every warp is done with h_in: write the new state
    if (has_state) {
#pragma unroll
      for (int j = 0; j < YN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sH[(8 * j + 2 * q + (e & 1)) * lo.hs + sn0 + g + 8 * (e >> 1)] =
              hacc[0][j][e];
    }
  }

  // h_final (B, H, P, N)
  if (has_state) {
#pragma unroll
    for (int j = 0; j < YN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 8 * j + 2 * q + (e & 1);
        h_out[(((size_t)b * H + h) * P + p) * N + sn0 + g + 8 * (e >> 1)] =
            hacc[0][j][e];
      }
  }
}

template <int PT>
cudaError_t set_smem(int L, int N, size_t* bytes) {
  *bytes = (size_t)smem_layout(PT, L, N).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_chunk_kernel<PT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              100);
}

template <int PT>
cudaError_t launch_chunk(const float* xdt, const float* rec, const float* cb,
                         const float* Bm, const float* Cm, float* y,
                         float* h_out, int B, int S, int H, int P, int N,
                         int L, int nch, cudaStream_t stream) {
  size_t bytes;
  cudaError_t err = set_smem<PT>(L, N, &bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PT, H, B);
  ssd_chunk_kernel<PT><<<grid, kScanThreads, bytes, stream>>>(
      xdt, rec, cb, Bm, Cm, y, h_out, S, H, P, N, L, nch);
  return cudaGetLastError();
}

template <int PT>
cudaError_t occupancy(int L, int N, int* blocks) {
  size_t bytes;
  cudaError_t err = set_smem<PT>(L, N, &bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_chunk_kernel<PT>, kScanThreads, bytes);
}

bool bad_shape(int L, int P, int N, int pt) {
  return L <= 0 || L > kMaxL || L % 16 || P <= 0 || P > kMaxP || P % 16 ||
         N <= 0 || N > kMaxN || N % 16 ||
         (pt != 16 && pt != 32 && pt != 64) || P % pt;
}

}  // namespace

// xdt, y: (B, S, H, P); la: (B, S, H); Bm, Cm: (B, S, N); h_out:
// (B, H, P, N); cb: (B, nch, L, L) and rec: (B, H, nch, 4 L) scratch, with
// nch = ceil(S / L); all f32, contiguous, 16-byte aligned, on one device.
// L: the chunk length; pt: the columns of P a block owns (16, 32 or 64,
// dividing P).  L, P and N are multiples of 16 with L <= 128, P <= 64 and
// N <= 64.  Launches the prep and the scan kernels on `stream`; returns the
// cudaError_t of the launches (0 on success).
extern "C" int ssd_scan(const float* xdt, const float* la, const float* Bm,
                        const float* Cm, float* y, float* h_out, float* cb,
                        float* rec, int B, int S, int H, int P, int N, int L,
                        int pt, void* stream) {
  if (bad_shape(L, P, N, pt) || B <= 0 || B > 65535 || S <= 0 || H <= 0 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (S + L - 1) / L;
  const int parts = max((L + kCBRows - 1) / kCBRows,
                        (H + kHeadGroup - 1) / kHeadGroup);
  const size_t prep_bytes = (size_t)prep_smem_floats(L, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)prep_bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_prep_kernel<<<B * nch * parts, kPrepThreads, prep_bytes, st>>>(
      la, Bm, Cm, cb, rec, B, S, H, N, L, nch, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (pt) {
    case 16:
      return (int)launch_chunk<16>(xdt, rec, cb, Bm, Cm, y, h_out, B, S, H, P,
                                   N, L, nch, st);
    case 32:
      return (int)launch_chunk<32>(xdt, rec, cb, Bm, Cm, y, h_out, B, S, H, P,
                                   N, L, nch, st);
    default:
      return (int)launch_chunk<64>(xdt, rec, cb, Bm, Cm, y, h_out, B, S, H, P,
                                   N, L, nch, st);
  }
}

// Blocks of the scan kernel with tile pt that one SM holds at once, at
// chunk length L and state size N (the card's own occupancy calculation,
// to hold ssm_scan.py's ssd_plan to).
extern "C" int ssd_max_active_blocks(int pt, int L, int N, int* out) {
  if (bad_shape(L, pt, N, pt)) return (int)cudaErrorInvalidValue;
  switch (pt) {
    case 16: return (int)occupancy<16>(L, N, out);
    case 32: return (int)occupancy<32>(L, N, out);
    default: return (int)occupancy<64>(L, N, out);
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
