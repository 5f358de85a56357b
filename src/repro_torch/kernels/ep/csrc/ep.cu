// NPB EP Gaussian-pair kernel for Hopper (sm_90a), over a whole draw pass.
//
// Replaces the TPU kernel `ep_pairs_pallas` (src/repro/kernels/ep/kernel.py,
// body `_ep_kernel`) together with the carry of the reference's scan
// (src/repro/workloads/ep.py, `body`).  Given nb batches of n uniform pairs
// (x, y) in (-1, 1)^2 stored as a [nb, 2, n] f32 array, it applies to each
// pair the Marsaglia polar acceptance 0 < t <= 1 with t = x*x + y*y, forms
// X = x*sqrt(-2 ln t / t) and Y likewise, counts the accepted pairs of each
// batch into 10 annuli by clip(int(max(|X|, |Y|)), 0, 9) and sums X and Y;
// then, batch by batch in index order, it adds the batch's f32 counts and
// sums into the f32 carries hist [10] and sums [2], exactly as the scan body
// `hist + h, sx + s[0], sy + s[1]` does.
//
// Design.  `ep_partial` runs over grid (blocks per batch) x nb, each thread
// 8 pairs per step through two 16-byte loads per row when the call has
// enough pairs to fill the card that way and u allows them (n a multiple
// of 4, u 16-byte aligned), else 1 pair through scalar loads.  Every product
// and sum is written with __fmul_rn / __fadd_rn / __fdiv_rn and the root with
// __fsqrt_rn, so nvcc contracts nothing into a fused multiply-add and each
// pair's values equal the plain torch version's (separate elementwise ops).
// Each warp counts its accepted pairs per annulus in its own ten shared
// uint32 bins (integer atomicAdd, contended only within the warp), and
// each thread sums X and Y in double; warp shuffles and one
// shared-memory pass reduce them per block into a row of 12 doubles (10
// counts, 2 sums) of the [nb * blocks, 12] partial buffer.  `ep_finish`,
// one block, adds each batch's rows over blocks in a fixed order, rounds
// once to f32, and adds the batches into the carries in index order with
// __fadd_rn, so the carries round as the reference's f32 carry does
// (counts past 2^24 included).  No float atomics, so a run repeats bit for
// bit.  (A batch's sums are the f32 rounding of a double sum, so they
// equal the plain version's, itself a double sum in another order, unless
// the exact sum lies within ~1e-16 of an f32 rounding boundary.)
//
// Bound, at the published rates of an H100 SXM at its 700 W limit
// (3.35 TB/s, 67 TFLOP/s f32): each pair's 8 input bytes are read once,
// 8 nb n bytes: 2.5 us for the workload's draw pass of 16 batches of 2^16
// pairs.  The ~20 operations per pair (the log, the root and the division
// counted as one each) take less, so bytes bound the function.  What
// bounds this kernel is instruction throughput: the accurate logf, IEEE
// division and root that the plain version's arithmetic needs come to
// ~100 instructions a pair, ~3 us for the draw pass on 132 SMs.
// One call per draw pass replaces nb calls whose launches, not their
// bytes, were the cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAnnuli = 10;
constexpr int kCols = kAnnuli + 2;      // partial row: 10 counts, sum X, sum Y
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 1024;
constexpr int kLoads = 8;               // partial loads in flight per lane
constexpr int kMinLanes = 4;            // least finish lanes per item
constexpr unsigned kFull = 0xffffffffu;

// One pair: acceptance, deviates and annulus.  A rejected pair computes
// with t = 0.5, whose factor is a normal number (t = 1 would send the
// root of 0 down __fsqrt_rn's slow path and hold up the warp), and the
// caller skips it.
__device__ __forceinline__ void ep_pair(float x, float y, bool& accept,
                                        float& gx, float& gy, int& ann) {
  const float t = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
  accept = (t <= 1.0f) && (t > 0.0f);
  const float ts = accept ? t : 0.5f;
  const float factor = __fsqrt_rn(__fdiv_rn(__fmul_rn(-2.0f, logf(ts)), ts));
  gx = __fmul_rn(x, factor);
  gy = __fmul_rn(y, factor);
  // min before the conversion: a non-finite deviate (t below ~2.6e-37,
  // where the factor overflows) lands in the last annulus, as in the
  // plain version (fmaxf/fminf ignore a NaN operand)
  ann = (int)fminf(fmaxf(fabsf(gx), fabsf(gy)), kAnnuli - 1.0f);
}

// Grid: blocks x nb blocks, flattened (batch b = blockIdx.x / blocks).
// A thread takes VEC * U pairs per step: U loads of VEC (4: one 16-byte
// load) from each of the x and y rows, all in flight before any pair is
// computed.  Instances: <4, 2> (8 pairs) and <1, 1>.
template <int VEC, int U>
__global__ void __launch_bounds__(kThreads)
ep_partial(const float* __restrict__ u, long long n, int blocks,
           double* __restrict__ partial) {
  constexpr int P = VEC * U;
  __shared__ unsigned bins[kWarps][kAnnuli];
  __shared__ double red[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / blocks;
  const int blk = blockIdx.x - (int)(b * blocks);
  const float* ux = u + b * 2 * n;
  const float* uy = ux + n;
  if (lane < kAnnuli) bins[warp][lane] = 0u;
  __syncwarp();
  double sx = 0.0, sy = 0.0;
  const long long stride = (long long)blocks * kThreads * P;
  // a warp's step covers 32 * P pairs, lane l the VEC-runs l, l + 32, ...
  for (long long base = ((long long)blk * kThreads + warp * 32) * P;
       base < n; base += stride) {
    float x[P], y[P];
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const long long i = base + ((long long)r * 32 + lane) * VEC;
      if constexpr (VEC == 4) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
        if (i < n) {  // n % 4 == 0 here, so all four pairs are in
          a = *reinterpret_cast<const float4*>(ux + i);
          c = *reinterpret_cast<const float4*>(uy + i);
        }
        x[4 * r] = a.x; x[4 * r + 1] = a.y; x[4 * r + 2] = a.z;
        x[4 * r + 3] = a.w;
        y[4 * r] = c.x; y[4 * r + 1] = c.y; y[4 * r + 2] = c.z;
        y[4 * r + 3] = c.w;
      } else {
        x[r] = i < n ? ux[i] : 0.f;   // (0, 0) is rejected
        y[r] = i < n ? uy[i] : 0.f;
      }
    }
#pragma unroll
    for (int v = 0; v < P; ++v) {
      bool accept;
      float gx, gy;
      int ann;
      ep_pair(x[v], y[v], accept, gx, gy, ann);
      if (accept) {
        atomicAdd(&bins[warp][ann], 1u);
        sx += (double)gx;
        sy += (double)gy;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_down_sync(kFull, sx, off);
    sy += __shfl_down_sync(kFull, sy, off);
  }
  __syncwarp();
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

// Adds, with kLoads loads in flight, the block rows k0, k0 + lanes, ...
// of one partial column p (stride kCols): groups of kLoads rows in a fixed
// pairwise tree (no add can start before two loads land, so all the
// group's loads go out first), the groups in index order.  +0.0 past
// the last block adds nothing: no partial is -0.0.
__device__ __forceinline__ double sum_rows(const double* __restrict__ p,
                                           int k0, int lanes, int blocks) {
  double s = 0.0;
  for (; k0 < blocks; k0 += lanes * kLoads) {
    double v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int k = k0 + j * lanes;
      v[j] = k < blocks ? p[(long long)k * kCols] : 0.0;
    }
#pragma unroll
    for (int w = 1; w < kLoads; w *= 2)
#pragma unroll
      for (int j = 0; j < kLoads; j += 2 * w) v[j] += v[j + w];
    s += v[0];
  }
  return s;
}

// One block for any number of batches.  `lanes` lanes (a power of two,
// 4 to 32) take one item, column i % 12 of batch i / 12 of a step of
// batches (lane g adds rows g, g + lanes, ..., a shuffle tree the lane
// sums), and the f32 rounding goes to shared memory.  Then thread c adds
// column c of the step's batches into its carry in batch order.
__global__ void __launch_bounds__(kFinishThreads)
ep_finish(const double* __restrict__ partial, int nb, int blocks, int lanes,
          float* __restrict__ hist, float* __restrict__ sums,
          int zero_carry) {
  __shared__ float batch[kFinishThreads / kMinLanes];
  const int kBatches = blockDim.x / lanes / kCols;   // per step
  const int c = threadIdx.x, item = c / lanes, g = c % lanes;
  float carry = 0.0f;
  if (c < kCols && !zero_carry)
    carry = c < kAnnuli ? hist[c] : sums[c - kAnnuli];
  for (int b0 = 0; b0 < nb; b0 += kBatches) {
    const int items = (nb - b0 < kBatches ? nb - b0 : kBatches) * kCols;
    double s = 0.0;
    if (item < items)
      s = sum_rows(partial + ((long long)(b0 + item / kCols) * blocks) *
                                 kCols + item % kCols, g, lanes, blocks);
    for (int off = lanes / 2; off > 0; off >>= 1)
      s += __shfl_down_sync(kFull, s, off, lanes);
    if (g == 0 && item < items) batch[item] = (float)s;  // counts exact < 2^24
    __syncthreads();
    if (c < kCols) {
#pragma unroll 8
      for (int i = c; i < items; i += kCols) carry = __fadd_rn(carry, batch[i]);
    }
    __syncthreads();
  }
  if (c < kAnnuli) hist[c] = carry;
  else if (c < kCols) sums[c - kAnnuli] = carry;
}

}  // namespace

// C interface (loaded with ctypes).  u: [nb, 2, n] f32; partial:
// [nb * blocks, 12] f64 scratch; hist: [10] f32 and sums: [2] f32, the
// carries, read unless zero_carry (then taken as 0) and written; all
// contiguous device memory.  ppt: pairs per thread and step, 8 (two
// 16-byte loads per row; taken only where n % 4 == 0 and u is 16-byte
// aligned) or 1 (scalar loads).  stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launches.
extern "C" int ep_pairs_launch(const float* u, int nb, long long n,
                               double* partial, int blocks, int ppt,
                               float* hist, float* sums, int zero_carry,
                               void* stream) {
  if (nb <= 0 || n <= 0 || blocks <= 0 ||
      (long long)nb * blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)nb * (unsigned)blocks;
  if (ppt == 8 && n % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0)
    ep_partial<4, 2><<<grid, kThreads, 0, s>>>(u, n, blocks, partial);
  else
    ep_partial<1, 1><<<grid, kThreads, 0, s>>>(u, n, blocks, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // as many lanes per item as let one step hold every batch (a warp for
  // one or two batches, so each lane adds at most 16 rows), at least 4;
  // whole warps, no more than the items need
  int lanes = 32;
  while (lanes > kMinLanes && nb * kCols * lanes > kFinishThreads) lanes /= 2;
  const int need = (nb * kCols * lanes + 31) / 32 * 32;
  ep_finish<<<1, need < kFinishThreads ? need : kFinishThreads, 0, s>>>(
      partial, nb, blocks, lanes, hist, sums, zero_carry);
  return (int)cudaGetLastError();
}
