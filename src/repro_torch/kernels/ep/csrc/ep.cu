// NPB EP Gaussian-pair kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `ep_pairs_pallas` (src/repro/kernels/ep/kernel.py,
// body `_ep_kernel`).  Given n uniform pairs (x, y) in (-1, 1)^2 stored as a
// [2, n] f32 array, it applies the Marsaglia polar acceptance 0 < t <= 1
// with t = x*x + y*y, forms X = x*sqrt(-2 ln t / t) and Y likewise, counts
// the accepted pairs into 10 annuli by clip(int(max(|X|, |Y|)), 0, 9) and
// sums X and Y.
//
// Design: a grid-stride loop over the pairs.  Every product and sum is
// written with __fmul_rn / __fadd_rn / __fdiv_rn and the root with
// __fsqrt_rn, so nvcc contracts nothing into a fused multiply-add and each
// pair's values equal the plain torch version's (separate elementwise ops).
// Each warp counts its accepted pairs per annulus in its own ten shared
// uint32 bins (atomicAdd, contended only within the warp), and each thread
// sums X and Y in double; warp shuffles and one shared-memory pass reduce
// them per block into a [blocks, 12] double partial buffer (10 counts, 2
// sums).  A rejected pair contributes 0 to both sums, as the reference's
// where(accept, ., 0) does, so it is skipped.  A second one-block launch
// adds the partials over blocks in a fixed order (a warp per column) and
// rounds once to f32.  No float atomics anywhere, so a run repeats bit for
// bit.  (The sums are the f32 rounding of a double sum, so they equal the
// plain version's, itself a double sum in another order, unless the exact
// sum lies within ~1e-16 of an f32 rounding boundary.)
//
// Bound, at the published rates of an H100 SXM at its 700 W limit
// (3.35 TB/s, 67 TFLOP/s f32): each pair's 8 input bytes are read once:
// 8n bytes, 0.16 us at the workload's batch of 2^16 pairs and 10 us at
// 2^22 pairs.  The ~20 operations per pair (the log, the root and the
// division counted as one each) take less, so bytes bound it.  At 2^16 pairs
// the launch latency of the two kernels is what the call pays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAnnuli = 10;
constexpr int kCols = kAnnuli + 2;      // partial row: 10 counts, sum X, sum Y
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
ep_partial(const float* __restrict__ u, long long n,
           double* __restrict__ partial) {
  __shared__ unsigned bins[kWarps][kAnnuli];
  __shared__ double red[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < kAnnuli) bins[warp][lane] = 0u;
  __syncwarp();
  double sx = 0.0, sy = 0.0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float x = u[i];
    const float y = u[n + i];
    const float t = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    const bool accept = (t <= 1.0f) && (t > 0.0f);
    if (!accept) continue;
    const float factor = __fsqrt_rn(__fdiv_rn(__fmul_rn(-2.0f, logf(t)), t));
    const float gx = __fmul_rn(x, factor);
    const float gy = __fmul_rn(y, factor);
    // min before the conversion: a non-finite deviate (t below ~2.6e-37,
    // where the factor overflows) lands in the last annulus, as in the
    // plain version (fmaxf/fminf ignore a NaN operand)
    const int ann = (int)fminf(fmaxf(fabsf(gx), fabsf(gy)), kAnnuli - 1.0f);
    atomicAdd(&bins[warp][ann], 1u);
    sx += (double)gx;
    sy += (double)gy;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_down_sync(kFull, sx, off);
    sy += __shfl_down_sync(kFull, sy, off);
  }
  if (lane == 0) {
    red[warp][0] = sx;
    red[warp][1] = sy;
  }
  __syncthreads();
  if (threadIdx.x < kCols) {
    const int c = threadIdx.x;
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w)
      s += c < kAnnuli ? (double)bins[w][c] : red[w][c - kAnnuli];
    partial[(long long)blockIdx.x * kCols + c] = s;
  }
}

// One block, one warp per partial column: lane l adds blocks l, l + 32, ...
// in index order, then a fixed shuffle tree adds the 32 lane sums, so the
// result does not depend on timing.
__global__ void __launch_bounds__(kCols * 32)
ep_finish(const double* __restrict__ partial, int blocks,
          float* __restrict__ hist, float* __restrict__ sums) {
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) s += partial[(long long)b * kCols + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  if (lane != 0) return;
  if (c < kAnnuli) hist[c] = (float)s;      // integer counts, exact below 2^53
  else sums[c - kAnnuli] = (float)s;
}

}  // namespace

// C interface (loaded with ctypes).  u: [2, n] f32; partial: [blocks, 12]
// f64 scratch; hist: [10] f32; sums: [2] f32; all contiguous device memory.
// stream: a cudaStream_t.  Returns cudaGetLastError() after the launches.
extern "C" int ep_pairs_launch(const float* u, long long n, double* partial,
                               int blocks, float* hist, float* sums,
                               void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ep_partial<<<blocks, kThreads, 0, s>>>(u, n, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ep_finish<<<1, kCols * 32, 0, s>>>(partial, blocks, hist, sums);
  return (int)cudaGetLastError();
}
