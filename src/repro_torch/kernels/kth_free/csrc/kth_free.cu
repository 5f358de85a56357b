// Kth-free-time select for Hopper (sm_90a).
//
// Replaces the TPU kernel `kth_free_pallas` / `kth_free_pallas_batched`
// (src/repro/kernels/kth_free/kernel.py, body `_kth_free_kernel`,
// algorithm `radix_select_kth`).  Per row of a [rows, n] f32 node-free
// table it returns the clip(n_req, 1, n)-th smallest value.  The f32 times
// map to order-preserving uint32 keys, so the result is an input element
// and bit-exact against a sort and against the radix select.
//
// Bound: each input byte is read once and one f32 is written per row.  At
// the campaign step's shape [B=20, S=4, n=136] that is ~44 KB, ~13 ns at
// 3.35 TB/s: far below launch latency.  What the call pays is the launch
// and the longest dependent chain inside a row, so the design shortens
// that chain.
//
// n <= 256 (every JSCC row; the scheduler's path): rank by comparison.
// One block per row, one thread per key, the row's keys in shared memory.
// A thread counts lt = #{keys < its key} over the row (broadcast 16-byte
// reads, four independent counting chains), and its key is a candidate
// when lt < k.  The k-th smallest value v is the largest candidate: every
// key <= v has lt < k, every key > v has lt >= #{keys <= v} >= k.  A warp
// max (redux.sync) and one pass over the warps' maxima give v.  The chain
// is one load, one barrier, n / 4 compare-and-add steps on each of four
// chains and two reductions, against the 32 dependent ballot passes of a
// bit walk; the rows spread over the SMs one block each.  With many rows
// (the EASY window's 1,360) the n^2 compares, two instructions each,
// bound it instead.
//
// n > 256: the 32-pass MSB -> LSB bit walk, a warp per row with its keys
// in shared memory (ballot + popcount counting, warp-uniform bookkeeping):
// its work grows as 32 n per row, the comparison's as n^2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRankMaxN = 256;          // widest row the rank kernel takes
constexpr int kWalkWarpsPerBlock = 4;
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

// lt += (key < x): a compare and a predicated add (nvcc's own lowering of
// the bool sum takes a third instruction)
__device__ __forceinline__ void count_below(int& lt, uint32_t key,
                                            uint32_t x) {
  asm("{\n\t.reg .pred p;\n\tsetp.lt.u32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}" : "+r"(lt) : "r"(key), "r"(x));
}

// One block of ceil(n / 32) * 32 threads per row; thread t owns key t.
// Slots from n up hold UINT32_MAX, which is never below a key, and put
// forward no candidate.
__global__ void __launch_bounds__(kRankMaxN)
kth_free_rank(const float* __restrict__ free, const int* __restrict__ nreq,
              float* __restrict__ out, int n) {
  __shared__ __align__(16) uint32_t keys[kRankMaxN];
  __shared__ uint32_t warp_max[kRankMaxN / kWarp];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, lane = t & (kWarp - 1), warp = t / kWarp;
  const int k = clip_rank(nreq[row], n);
  const uint32_t x = t < n ? to_ordered(free[row * n + t]) : 0xffffffffu;
  keys[t] = x;
  __syncthreads();
  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  int lt[4] = {0, 0, 0, 0};   // four independent chains, one per lane of v
#pragma unroll 4
  for (int j = 0; j < (n + 3) / 4; ++j) {
    const uint4 v = k4[j];
    count_below(lt[0], v.x, x);
    count_below(lt[1], v.y, x);
    count_below(lt[2], v.z, x);
    count_below(lt[3], v.w, x);
  }
  const int below = (lt[0] + lt[1]) + (lt[2] + lt[3]);
  const uint32_t m = __reduce_max_sync(kFull, (t < n && below < k) ? x : 0u);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < (int)blockDim.x / kWarp ? warp_max[lane] : 0u;
    const uint32_t v = __reduce_max_sync(kFull, w);
    if (lane == 0) out[row] = from_ordered(v);
  }
}

// Wide rows: each warp owns an n-key slice of the block's dynamic shared
// memory and walks the 32 bits MSB -> LSB, at each bit counting the
// candidates whose bit is 0 and descending into the half that holds rank k.
__global__ void __launch_bounds__(kWarp * kWalkWarpsPerBlock)
kth_free_smem(const float* __restrict__ free, const int* __restrict__ nreq,
              float* __restrict__ out, long long rows, int n) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long row = (long long)blockIdx.x * kWalkWarpsPerBlock + warp;
  if (row >= rows) return;  // warp-uniform: the whole warp leaves
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
  if (n <= kRankMaxN) {
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int threads = (n + kWarp - 1) / kWarp * kWarp;
    kth_free_rank<<<(unsigned)rows, threads, 0, s>>>(free, nreq, out, n);
    return (int)cudaGetLastError();
  }
  const long long blocks = (rows + kWalkWarpsPerBlock - 1) / kWalkWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)kWalkWarpsPerBlock * n * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kth_free_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kth_free_smem<<<(unsigned)blocks, kWarp * kWalkWarpsPerBlock, bytes, s>>>(
      free, nreq, out, rows, n);
  return (int)cudaGetLastError();
}
