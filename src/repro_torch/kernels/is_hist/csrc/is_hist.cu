// NPB IS key-histogram kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `key_histogram_pallas`
// (src/repro/kernels/is_hist/kernel.py, body `_hist_kernel`): the count of
// int32 keys per bucket `key >> bucket_shift` (arithmetic shift), into
// n_buckets counts returned as f32.  Buckets that are negative or
// >= n_buckets are dropped, as the Pallas kernel's one-hot drops them.
//
// Design: one pass over the keys, grid-stride.  The TPU kernel reduces a
// one-hot [n_buckets, block] matrix because scatter is not a TPU primitive;
// here each block counts into a uint32 histogram in shared memory with
// atomicAdd and then adds its non-zero bins into a global uint32 buffer
// with one atomicAdd each.  Histograms above 48 KB of shared memory (more
// than 12,288 buckets) take a second path of the same kernel that adds
// straight into the global buffer.  A last small launch converts the counts
// to f32.  The counts are integers, so any order of the atomics gives the
// same, exact result.
//
// Bound: each key's 4 bytes are read once: 4n bytes, 10 us for the 2^23 keys
// of IS class A at an H100 SXM's published 3.35 TB/s (700 W limit).  The shift, the range test and one shared
// atomic per key are well below the vector rate, so bytes bound it; skewed
// keys (many in one bucket) serialise on that bucket's atomic instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBuckets = 48 * 1024 / 4;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
key_hist(const int* __restrict__ keys, long long n, int n_buckets, int shift,
         unsigned* __restrict__ counts) {
  extern __shared__ unsigned bins[];
  if (kShared) {
    for (int b = threadIdx.x; b < n_buckets; b += kThreads) bins[b] = 0u;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int b = keys[i] >> shift;
    if (b < 0 || b >= n_buckets) continue;
    if (kShared) atomicAdd(&bins[b], 1u);
    else atomicAdd(&counts[b], 1u);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_buckets; b += kThreads) {
      const unsigned c = bins[b];
      if (c) atomicAdd(&counts[b], c);
    }
  }
}

__global__ void counts_to_f32(const unsigned* __restrict__ counts, int n,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (float)counts[i];
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

}  // namespace

// C interface (loaded with ctypes).  keys: [n] int32; counts: [n_buckets]
// uint32 scratch; out: [n_buckets] f32; all contiguous device memory.
// 0 <= shift <= 31.  stream: a cudaStream_t.  Returns cudaGetLastError()
// after the launches.
extern "C" int key_histogram_launch(const int* keys, long long n,
                                    int n_buckets, int shift,
                                    unsigned* counts, float* out,
                                    void* stream) {
  if (n < 0 || n_buckets <= 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(unsigned) * n_buckets, s);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = 4LL * sm_count();
    if (blocks > cap) blocks = cap;
    if (n_buckets <= kSmemBuckets) {
      key_hist<true><<<(unsigned)blocks, kThreads,
                       sizeof(unsigned) * n_buckets, s>>>(keys, n, n_buckets,
                                                          shift, counts);
    } else {
      key_hist<false><<<(unsigned)blocks, kThreads, 0, s>>>(keys, n, n_buckets,
                                                             shift, counts);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  counts_to_f32<<<(n_buckets + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      counts, n_buckets, out);
  return (int)cudaGetLastError();
}
