// Fused monitor combine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/monitor_combine.py
// (`monitor_combine` :52, `_combine_kernel` :30).  Over flat (N,) f32
// score vectors u, v, f it computes, in one pass:
//   fhat   = u - s * sigmoid(v)
//   mask   = u > threshold - margin            (as 0/1 f32)
//   counts = [sum(mask), sum(f > u)]           (as f32)
//
// What bounds it: bytes, 12 read and 8 written per element and a handful
// of flops: 0.05 ns at the serving paths' N = batch = 8, so one launch's
// latency is the whole cost there: a fill kernel to zero a scratch for the
// counts would double it.
//
// Design: a grid-stride elementwise pass; tails are masked by index (no
// padding, no (rows, 128) tiles).  Each block sums its two counts with warp
// reductions.  Where N fits one block's grid-stride loop (the wrapper's
// plan, monitor_combine.py::combine_blocks), one block does all the work and
// writes the counts itself: one device kernel, no scratch, no atomics.
// Larger N runs many blocks, which add their counts to int32 totals in a
// zeroed scratch with atomicAdd (integer sums are exact, so the order of
// the atomics cannot change the result), and the last block to finish
// writes the totals as f32.  The product and the difference of fhat are
// kept apart (__fmul_rn/__fsub_rn) so nvcc cannot contract them into an FMA
// that rounds differently from the plain version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

template <bool kOneBlock>
__global__ void __launch_bounds__(kThreads)
monitor_combine_kernel(const float* __restrict__ u, const float* __restrict__ v,
                       const float* __restrict__ f, float* __restrict__ fhat,
                       float* __restrict__ mask, int* __restrict__ scratch,
                       float* __restrict__ counts, int n, float s, float thr) {
  unsigned int n_trig = 0, n_viol = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float ui = u[i];
    const float sig = 1.f / (1.f + expf(-v[i]));
    fhat[i] = __fsub_rn(ui, __fmul_rn(s, sig));
    const bool trig = ui > thr;
    mask[i] = trig ? 1.f : 0.f;
    n_trig += trig;
    n_viol += f[i] > ui;
  }
  n_trig = __reduce_add_sync(0xffffffffu, n_trig);
  n_viol = __reduce_add_sync(0xffffffffu, n_viol);

  __shared__ unsigned int s_trig[kThreads / 32];
  __shared__ unsigned int s_viol[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_trig[warp] = n_trig;
    s_viol[warp] = n_viol;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int bt = 0, bv = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    bt += s_trig[w];
    bv += s_viol[w];
  }
  if (kOneBlock) {
    counts[0] = (float)bt;
    counts[1] = (float)bv;
    return;
  }
  atomicAdd(&scratch[0], bt);
  atomicAdd(&scratch[1], bv);
  __threadfence();
  if (atomicAdd(&scratch[2], 1) == (int)gridDim.x - 1) {
    counts[0] = (float)atomicAdd(&scratch[0], 0);
    counts[1] = (float)atomicAdd(&scratch[1], 0);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// u, v, f, fhat, mask: (n,) f32; counts: (2,) f32; blocks: 1, or up to 1024
// with scratch 3 int32 zeros (unused with one block, may be null).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int monitor_combine(const float* u, const float* v, const float* f,
                               float* fhat, float* mask, int* scratch,
                               float* counts, int n, int blocks, float s,
                               float thr, void* stream) {
  if (n <= 0 || blocks <= 0 || blocks > kMaxBlocks ||
      (blocks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks == 1)
    monitor_combine_kernel<true><<<1, kThreads, 0, st>>>(
        u, v, f, fhat, mask, scratch, counts, n, s, thr);
  else
    monitor_combine_kernel<false><<<blocks, kThreads, 0, st>>>(
        u, v, f, fhat, mask, scratch, counts, n, s, thr);
  return (int)cudaGetLastError();
}

// An empty kernel of one warp: the launch floor chip_smoke.py prints
// beside the combine's time.
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
