// Kth-free-time radix select for Hopper (sm_90a).
//
// Replaces the TPU kernel `kth_free_pallas` / `kth_free_pallas_batched`
// (src/repro/kernels/kth_free/kernel.py, body `_kth_free_kernel`,
// algorithm `radix_select_kth`).  Per row of a [rows, n] f32 node-free
// table it returns the clip(n_req, 1, n)-th smallest value: the f32 times
// map to order-preserving uint32 keys, and 32 passes MSB -> LSB count the
// still-active keys whose current bit is 0 and descend into the half that
// holds rank k.  The selected key is an input element, so the result is
// bit-exact against a sort.
//
// Design: one warp per row.  A thread holds ceil(n / 32) keys in
// registers (n <= 256), or the warp stages its row in shared memory (larger
// n).  Each pass counts with __ballot_sync + __popc, so the rank bookkeeping
// is warp-uniform and no block-level synchronisation exists.  Rows are
// independent (grid lanes x systems, with any leading candidate axis), so
// one launch covers a whole campaign step.
//
// Bound: each input byte is read once and one f32 is written per row.  At
// the campaign step's shape [B=20, S=4, n=136] that is ~44 KB, ~13 ns at
// 3.35 TB/s: far below launch latency, which is what bounds this kernel on
// the scheduler's path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t to_ordered(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int clip_rank(int k, int n) {
  return k < 1 ? 1 : (k > n ? n : k);
}

// Keys in registers: thread `lane` holds columns lane, lane + 32, ...
template <int KPT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
kth_free_regs(const float* __restrict__ free, const int* __restrict__ nreq,
              float* __restrict__ out, long long rows, int n) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (row >= rows) return;  // warp-uniform: the whole warp leaves
  const float* r = free + row * n;
  uint32_t keys[KPT];
  bool valid[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int c = lane + i * kWarp;
    valid[i] = c < n;
    keys[i] = valid[i] ? to_ordered(r[c]) : 0u;
  }
  int k = clip_rank(nreq[row], n);
  uint32_t prefix = 0u, mask = 0u;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t b = 1u << bit;
    int zeros = 0;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const bool z = valid[i] && (keys[i] & mask) == prefix && !(keys[i] & b);
      zeros += __popc(__ballot_sync(kFull, z));
    }
    if (k > zeros) {
      prefix |= b;
      k -= zeros;
    }
    mask |= b;
  }
  if (lane == 0) out[row] = from_ordered(prefix);
}

// Keys in shared memory: each warp owns an n-key slice of the block's
// dynamic shared memory.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
kth_free_smem(const float* __restrict__ free, const int* __restrict__ nreq,
              float* __restrict__ out, long long rows, int n) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  uint32_t* keys = smem + (size_t)warp * n;
  const float* r = free + row * n;
  for (int c = lane; c < n; c += kWarp) keys[c] = to_ordered(r[c]);
  __syncwarp();
  int k = clip_rank(nreq[row], n);
  uint32_t prefix = 0u, mask = 0u;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t b = 1u << bit;
    int zeros = 0;
    for (int base = 0; base < n; base += kWarp) {
      const int c = base + lane;
      bool z = false;
      if (c < n) {
        const uint32_t key = keys[c];
        z = (key & mask) == prefix && !(key & b);
      }
      zeros += __popc(__ballot_sync(kFull, z));
    }
    if (k > zeros) {
      prefix |= b;
      k -= zeros;
    }
    mask |= b;
  }
  if (lane == 0) out[row] = from_ordered(prefix);
}

}  // namespace

// C interface (loaded with ctypes).  free: [rows, n] f32, nreq: [rows]
// int32, out: [rows] f32, all contiguous device memory; stream: a
// cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int kth_free_launch(const float* free, const int* nreq,
                               float* out, long long rows, int n,
                               void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kWarp * kWarpsPerBlock);
  if (n <= 32) {
    kth_free_regs<1><<<grid, block, 0, s>>>(free, nreq, out, rows, n);
  } else if (n <= 64) {
    kth_free_regs<2><<<grid, block, 0, s>>>(free, nreq, out, rows, n);
  } else if (n <= 128) {
    kth_free_regs<4><<<grid, block, 0, s>>>(free, nreq, out, rows, n);
  } else if (n <= 256) {
    kth_free_regs<8><<<grid, block, 0, s>>>(free, nreq, out, rows, n);
  } else {
    const size_t bytes = (size_t)kWarpsPerBlock * n * sizeof(uint32_t);
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kth_free_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    kth_free_smem<<<grid, block, bytes, s>>>(free, nreq, out, rows, n);
  }
  return (int)cudaGetLastError();
}
