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
//   y[t]   = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) xdt[s]
//            + exp(cum_t) (h C_t)                       (h: state entering)
//   h_next = exp(cum_last) h + sum_s exp(cum_last - cum_s) xdt[s] B_s^T.
// Every weight is the exp of a difference of cumulative log-decays, as in
// the reference: zamba2's decays reach la ~ -11 per step and cum ~ -1400
// over a chunk, so factoring exp(cum_t) * exp(-cum_s) would overflow to
// inf * 0.  The cumulative sum is taken in f64 and each weight's exponent
// is the f64 difference rounded once to f32: at |cum| ~ 1000 an f32 cumsum
// carries ~1e-4 of absolute error into every exponent, which on the H100
// put the kernel's y up to 6e-4 from an f64 evaluation where the f32 plain
// version stays within 3e-4.  All other sums are f32.  Unlike the TPU
// kernel it also writes the final state h_final (B, H, P, N), which the
// reference's kernel path drops.
//
// What bounds it: operations.  At the hybrid train shape (B=2, S=4096,
// H=112, P=N=64, L=128) it moves ~481 MB (xdt in, y out, 235 MB each) and
// does ~3.0e10 flop in its lower-triangular form, ~449 us at the 67 TFLOP/s
// f32 rate against ~144 us of device memory time.  (TF32 tensor cores,
// 495 TFLOP/s, keep 10 mantissa bits, too few for the scan's 5e-4
// tolerance.)  This first kernel runs the products as scalar f32 FMAs from
// shared memory; wgmma, TMA and sharing C B^T across the heads (the TPU
// kernel, like this one, recomputes it for every head) are later work.
//
// Design: one block of 256 threads per (head, batch row) walks the chunks
// in order and carries the (P, N) state itself: the TPU ran the chunk axis
// as a sequential grid dimension with the state in VMEM scratch, while
// Hopper blocks run in no order.  At the train shape that is 224 blocks on
// 132 SMs, one block per SM (~187 KB of shared memory).  Per chunk:
//   load   xdt (L x P), B and C transposed (N x L), la; rows past S are
//          zeros (la = 0 keeps cum_last at the last real row);
//   scan   the inclusive cumsum of la in f64, one warp, four rows a lane;
//   scores G[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, in shared
//          memory; thread (ty, tx) = (tid / 16, tid % 16) owns rows
//          ty + 16 i and columns tx + 16 j, and skips the blocks j > i
//          that lie above the diagonal;
//   output y[t][p] = exp(cum_t) sum_n C[t][n] H[n][p] + sum_{s<=t} G[t][s]
//          xdt[s][p], rows ty + 16 i, columns tx + 16 j; rows past S are
//          not written;
//   state  xdt rows scaled by exp(cum_last - cum_s), then each thread
//          updates its 4 x 4 patch of H (rows n = ty + 16 i), kept in
//          registers and mirrored to shared memory for the next chunk.
// The chunk length, P and N are run-time values (multiples of 16, at most
// 128, 64 and 64); the loops over their 16-row blocks are uniform across a
// warp, so smaller shapes skip the work without divergence.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 layout
constexpr int kMaxL = 128;     // rows of a chunk
constexpr int kMaxP = 64;
constexpr int kMaxN = 64;
constexpr int kRT = kMaxL / 16;  // chunk rows per thread: t = ty + 16 i
constexpr int kPT = kMaxP / 16;  // head dims per thread: p = tx + 16 j
constexpr int kNT = kMaxN / 16;  // state rows per thread: n = ty + 16 i

// Shared memory, in floats.  sBt / sCt rows are L + 1 long, so the two rows
// a warp reads at one column fall in different banks; sG rows are L + 16
// long, so the two rows a warp writes at once sit 16 banks apart.
struct Layout {
  int LS, GS;
  int cum, x, bt, ct, g, hs, ec, dte, total;
};

__host__ __device__ inline Layout layout(int L, int P, int N) {
  Layout o;
  o.LS = L + 1;
  o.GS = L + 16;
  o.cum = 0;                 // f64 cumsum of la [L] (2 L floats)
  o.x = o.cum + 2 * L;       // xdt chunk [L][P] (float4 stores: 2 L % 4 == 0)
  o.bt = o.x + L * P;        // B^T [N][LS]
  o.ct = o.bt + N * o.LS;    // C^T [N][LS]
  o.g = o.ct + N * o.LS;     // scores [L][GS]
  o.hs = o.g + L * o.GS;     // state [N][P]
  o.ec = o.hs + N * P;       // exp(cum_t) [L]
  o.dte = o.ec + L;          // exp(cum_last - cum_t) [L]
  o.total = o.dte + L;
  return o;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const Layout lo = layout(L, P, N);
  float* sX = smem + lo.x;
  float* sBt = smem + lo.bt;
  float* sCt = smem + lo.ct;
  float* sG = smem + lo.g;
  float* sH = smem + lo.hs;
  double* sCum = reinterpret_cast<double*>(smem + lo.cum);
  float* sEc = smem + lo.ec;
  float* sDte = smem + lo.dte;
  const int LS = lo.LS, GS = lo.GS;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int Lt = L / 16, Pt = P / 16, Nt = N / 16;
  const int P4 = P / 4, N4 = N / 4;

  float hreg[kNT][kPT];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int j = 0; j < kPT; ++j) hreg[i][j] = 0.f;
  for (int idx = tid; idx < N * P; idx += kThreads) sH[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int nv = min(L, S - c0);  // real rows of this chunk

    // ---- load ------------------------------------------------------------
    for (int idx = tid; idx < L * P4; idx += kThreads) {
      const int t = idx / P4, p4 = idx % P4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nv)
        v = reinterpret_cast<const float4*>(
            xdt + (((size_t)b * S + c0 + t) * H + h) * P)[p4];
      reinterpret_cast<float4*>(sX + t * P)[p4] = v;
    }
    for (int idx = tid; idx < L * N4; idx += kThreads) {
      const int t = idx / N4, n = 4 * (idx % N4);
      float4 vb = make_float4(0.f, 0.f, 0.f, 0.f), vc = vb;
      if (t < nv) {
        const size_t off = ((size_t)b * S + c0 + t) * N + n;
        vb = *reinterpret_cast<const float4*>(Bm + off);
        vc = *reinterpret_cast<const float4*>(Cm + off);
      }
      sBt[(n + 0) * LS + t] = vb.x;
      sBt[(n + 1) * LS + t] = vb.y;
      sBt[(n + 2) * LS + t] = vb.z;
      sBt[(n + 3) * LS + t] = vb.w;
      sCt[(n + 0) * LS + t] = vc.x;
      sCt[(n + 1) * LS + t] = vc.y;
      sCt[(n + 2) * LS + t] = vc.z;
      sCt[(n + 3) * LS + t] = vc.w;
    }
    if (tid < L)
      sCum[tid] = tid < nv ? la[((size_t)b * S + c0 + tid) * H + h] : 0.f;
    __syncthreads();

    // ---- inclusive cumsum of la in f64: one warp, four rows a lane ----
    if (tid < 32) {
      double part[4];
      double run = 0.0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * tid + e;
        run += t < L ? sCum[t] : 0.0;
        part[e] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const double base = incl - run;  // sum over the lanes before this one
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * tid + e;
        if (t < L) sCum[t] = base + part[e];
      }
    }
    __syncthreads();
    const double cum_last = sCum[L - 1];
    if (tid < L) {  // read after the next barrier
      sEc[tid] = expf((float)sCum[tid]);
      sDte[tid] = expf((float)(cum_last - sCum[tid]));
    }

    // ---- scores G[t][s], s <= t -------------------------------------------
    {
      float acc[kRT][kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kRT; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kRT], bv[kRT];
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          cv[i] = i < Lt ? sCt[n * LS + ty + 16 * i] : 0.f;
          bv[i] = i < Lt ? sBt[n * LS + tx + 16 * i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          if (i < Lt) {
#pragma unroll
            for (int j = 0; j <= i; ++j)
              acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        if (i < Lt) {
          const int t = ty + 16 * i;
          const double ct = sCum[t];
#pragma unroll
          for (int j = 0; j < kRT; ++j) {
            if (j < Lt) {
              const int s = tx + 16 * j;
              float g = 0.f;
              if (j < i || (j == i && tx <= ty))
                g = acc[i][j] * expf((float)(ct - sCum[s]));
              sG[t * GS + s] = g;
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- output y -------------------------------------------------------
    {
      float acc[kRT][kPT];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[i][j] = 0.f;
      // carried state: exp(cum_t) sum_n C[t][n] H[n][p]
      for (int n = 0; n < N; ++n) {
        float cv[kRT], hv[kPT];
#pragma unroll
        for (int i = 0; i < kRT; ++i)
          cv[i] = i < Lt ? sCt[n * LS + ty + 16 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < kPT; ++j)
          hv[j] = j < Pt ? sH[n * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kRT; ++i) {
          if (i < Lt) {
#pragma unroll
            for (int j = 0; j < kPT; ++j)
              acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        if (i < Lt) {
          const float e = sEc[ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kPT; ++j) acc[i][j] *= e;
        }
      }
      // within the chunk: sum_{s <= t} G[t][s] xdt[s][p], 16 columns of G
      // at a time; rows of a block i < sb lie wholly above the diagonal
      for (int sb = 0; sb < Lt; ++sb) {
#pragma unroll 4
        for (int ss = 0; ss < 16; ++ss) {
          const int s = 16 * sb + ss;
          float xv[kPT];
#pragma unroll
          for (int j = 0; j < kPT; ++j)
            xv[j] = j < Pt ? sX[s * P + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < kRT; ++i) {
            if (i >= sb && i < Lt) {
              const float g = sG[(ty + 16 * i) * GS + s];
#pragma unroll
              for (int j = 0; j < kPT; ++j)
                acc[i][j] = fmaf(g, xv[j], acc[i][j]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        const int t = ty + 16 * i;
        if (i < Lt && t < nv) {
          float* yrow = y + (((size_t)b * S + c0 + t) * H + h) * P + tx;
#pragma unroll
          for (int j = 0; j < kPT; ++j)
            if (j < Pt) yrow[16 * j] = acc[i][j];
        }
      }
    }
    __syncthreads();

    // ---- state: H = exp(cum_last) H + sum_s exp(cum_last - cum_s) B_s xdt_s
    for (int idx = tid; idx < L * P; idx += kThreads) sX[idx] *= sDte[idx / P];
    __syncthreads();
    {
      const float decay = expf((float)cum_last);
      float acc[kNT][kPT];
#pragma unroll
      for (int i = 0; i < kNT; ++i)
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < nv; ++s) {  // rows past S have B = 0
        float bv[kNT], xv[kPT];
#pragma unroll
        for (int i = 0; i < kNT; ++i)
          bv[i] = i < Nt ? sBt[(ty + 16 * i) * LS + s] : 0.f;
#pragma unroll
        for (int j = 0; j < kPT; ++j)
          xv[j] = j < Pt ? sX[s * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (i < Nt) {
#pragma unroll
            for (int j = 0; j < kPT; ++j)
              acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        if (i < Nt) {
#pragma unroll
          for (int j = 0; j < kPT; ++j) {
            if (j < Pt) {
              hreg[i][j] = decay * hreg[i][j] + acc[i][j];
              sH[(ty + 16 * i) * P + tx + 16 * j] = hreg[i][j];
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk's loads overwrite sX, sBt, sCt
  }

  // h_final (B, H, P, N)
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    if (i < Nt) {
#pragma unroll
      for (int j = 0; j < kPT; ++j)
        if (j < Pt)
          h_out[(((size_t)b * H + h) * P + tx + 16 * j) * N + ty + 16 * i] =
              hreg[i][j];
    }
  }
}

}  // namespace

// xdt, y: (B, S, H, P); la: (B, S, H); Bm, Cm: (B, S, N); h_out: (B, H, P, N);
// all f32, contiguous, 16-byte aligned, on one device.  L: the chunk length.
// L, P and N are multiples of 16 with L <= 128, P <= 64 and N <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_scan(const float* xdt, const float* la, const float* Bm,
                        const float* Cm, float* y, float* h_out, int B, int S,
                        int H, int P, int N, int L, void* stream) {
  if (L <= 0 || L > kMaxL || L % 16 || P <= 0 || P > kMaxP || P % 16 ||
      N <= 0 || N > kMaxN || N % 16 || B <= 0 || S <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const Layout lo = layout(L, P, N);
  const size_t smem = (size_t)lo.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xdt, la, Bm, Cm, y, h_out, S, H, P, N, L);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
