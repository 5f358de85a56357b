// NPB IS key-histogram kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `key_histogram_pallas`
// (src/repro/kernels/is_hist/kernel.py, body `_hist_kernel`): the count of
// int32 keys per bucket `key >> bucket_shift` (arithmetic shift), into
// n_buckets counts returned as f32.  Buckets that are negative or
// >= n_buckets are dropped, as the Pallas kernel's one-hot drops them.
//
// Bound: each key's 4 bytes are read once: 4n bytes, 10 us for the 2^23 keys
// of IS class A at an H100 SXM's published 3.35 TB/s (700 W limit).  The
// shift, the range test and one shared atomic per key are well below the
// vector rate, so bytes bound it; skewed keys (many in one bucket)
// serialise on that bucket's atomic instead.
//
// Design.  The TPU kernel reduces a one-hot [n_buckets, block] matrix
// because scatter is not a TPU primitive; here each block counts into a
// uint32 histogram in shared memory with atomicAdd.
//   Loads: one persistent wave, sized by the occupancy API; each block reads
//   a contiguous range of 16-byte int4 vectors, four in flight per thread
//   (16 keys, 64 KB per SM at 1,024 threads: enough bytes in flight to
//   cover the latency of L2 and HBM), with 32-bit offsets inside its range.
//   The keys before the first 16-byte boundary and the last n % 4 (at most
//   3 + 3) are read one by one by block 0.
//   Merge: blocks run in clusters of 8 (the portable size).  After
//   cluster.sync(), block r sums the r-th eighth of the buckets over the 8
//   blocks' shared histograms through distributed shared memory and adds
//   each non-zero sum to the output with one atomic: 8x fewer global
//   atomics than a flush per block.  A second cluster.sync() keeps every
//   block's shared memory alive until the cluster has read it.
//   Result: below 2^24 keys (IS class A has 2^23) every partial count of a
//   bucket is an integer below 2^24, exact in f32, so the merge adds
//   straight into the f32 output (atomicAdd on float: exact in any order).
//   A call is then two device operations, a memset of the output and the
//   kernel, and keeps nothing between calls.  From 2^24 keys on, the
//   kernel counts in uint32 in the output's memory and a second launch
//   converts the counts to f32 in place.
// Above 12,288 buckets (48 KB of counts) the shared histogram does not fit:
// key_hist_global adds each key straight into the output, in f32 or uint32
// as above.  The counts are integers, so any order of the atomics gives the
// same, exact result.

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                 // int4 loads in flight per thread
constexpr int kCluster = 8;              // blocks per cluster (portable)
constexpr int kSmemBuckets = 48 * 1024 / 4;
constexpr int kMaxDevices = 64;
// below this many keys every count is exact in f32
constexpr long long kExactF32 = 1LL << 24;

// Counts the keys of the block's range: block 0 also takes the unaligned
// head (keys[0, head)) and the tail (the last `tail` keys after the n4
// vectors).
template <typename Count>
__device__ __forceinline__ void count_keys(const int* __restrict__ keys,
                                           int head, long long n4, int tail,
                                           int per_block, Count count) {
  if (blockIdx.x == 0) {
    if ((int)threadIdx.x < head) count(__ldg(keys + threadIdx.x));
    if ((int)threadIdx.x < tail)
      count(__ldg(keys + head + 4 * n4 + threadIdx.x));
  }
  const long long start = (long long)blockIdx.x * per_block;
  const int len = start < n4 ? (int)min((long long)per_block, n4 - start) : 0;
  const int4* v = reinterpret_cast<const int4*>(keys + head) + start;
  int i = threadIdx.x;
  for (; i + (kVecs - 1) * kThreads < len; i += kVecs * kThreads) {
    int4 q[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) q[u] = __ldg(v + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      count(q[u].x);
      count(q[u].y);
      count(q[u].z);
      count(q[u].w);
    }
  }
  for (; i < len; i += kThreads) {
    const int4 q = __ldg(v + i);
    count(q.x);
    count(q.y);
    count(q.z);
    count(q.w);
  }
}

// Adds c to a bucket of the output: in f32 (exact below 2^24 keys) or in
// uint32 (converted afterwards by counts_to_f32).
__device__ __forceinline__ void add_count(float* out, int b, unsigned c) {
  atomicAdd(out + b, (float)c);
}
__device__ __forceinline__ void add_count(unsigned* out, int b, unsigned c) {
  atomicAdd(out + b, c);
}

template <typename Count>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
key_hist_cluster(const int* __restrict__ keys, int head, long long n4,
                 int tail, int per_block, int n_buckets, int shift,
                 Count* out) {
  extern __shared__ unsigned bins[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int b = threadIdx.x; b < n_buckets; b += kThreads) bins[b] = 0u;
  __syncthreads();
  unsigned* hist = bins;
  count_keys(keys, head, n4, tail, per_block, [=](int key) {
    const unsigned b = (unsigned)(key >> shift);
    if (b < (unsigned)n_buckets) atomicAdd(&hist[b], 1u);
  });
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int slice = (n_buckets + kCluster - 1) / kCluster;
  const int hi = min(n_buckets, (rank + 1) * slice);
  for (int b = rank * slice + threadIdx.x; b < hi; b += kThreads) {
    unsigned c = 0u;
#pragma unroll
    for (int q = 0; q < kCluster; ++q)
      c += cluster.map_shared_rank(bins, q)[b];
    if (c) add_count(out, b, c);
  }
  cluster.sync();
}

template <typename Count>
__global__ void __launch_bounds__(kThreads)
key_hist_global(const int* __restrict__ keys, int head, long long n4,
                int tail, int per_block, int n_buckets, int shift,
                Count* out) {
  count_keys(keys, head, n4, tail, per_block, [=](int key) {
    const unsigned b = (unsigned)(key >> shift);
    if (b < (unsigned)n_buckets) add_count(out, b, 1u);
  });
}

// In place: the uint32 count of each bucket becomes its f32 value.
__global__ void counts_to_f32(unsigned* counts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) counts[i] = __float_as_uint((float)counts[i]);
}

// The most blocks of one wave on device `dev`, into *blocks: for the
// cluster kernel with `smem` bytes of histogram (whole clusters), else for
// the global kernel.  Cached per device as (smem << 32 | blocks): the
// occupancy queries cost more than the launch.
std::atomic<unsigned long long> wave_cache[2][kMaxDevices];

cudaError_t wave_blocks(int dev, bool cluster, unsigned smem, int* blocks) {
  std::atomic<unsigned long long>* slot =
      dev >= 0 && dev < kMaxDevices ? &wave_cache[cluster][dev] : nullptr;
  if (slot) {
    const unsigned long long hit = slot->load(std::memory_order_relaxed);
    if (hit && (unsigned)(hit >> 32) == smem) {
      *blocks = (int)(hit & 0xffffffffu);
      return cudaSuccess;
    }
  }
  cudaError_t e;
  int n = 0;
  if (cluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&n, key_hist_cluster<float>, &cfg);
    n *= kCluster;
  } else {
    int sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, key_hist_global<float>, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n *= sms;
  }
  if (e != cudaSuccess) return e;
  if (n < kCluster) n = kCluster;
  if (slot)
    slot->store((unsigned long long)smem << 32 | (unsigned)n,
                std::memory_order_relaxed);
  *blocks = n;
  return cudaSuccess;
}

}  // namespace

template <typename Count>
void launch_count(bool cluster, unsigned blocks, unsigned smem, cudaStream_t s,
                  const int* keys, int head, long long n4, int tail,
                  int per_block, int n_buckets, int shift, Count* out) {
  if (cluster)
    key_hist_cluster<Count><<<blocks, kThreads, smem, s>>>(
        keys, head, n4, tail, per_block, n_buckets, shift, out);
  else
    key_hist_global<Count><<<blocks, kThreads, 0, s>>>(
        keys, head, n4, tail, per_block, n_buckets, shift, out);
}

// C interface (loaded with ctypes).  keys: [n] int32 device memory (4-byte
// aligned, any 16-byte offset); out: [n_buckets] f32 device memory.
// 0 <= shift <= 31.  stream: a cudaStream_t.  Returns the first CUDA error
// of the memset, the occupancy query or the launches.
extern "C" int key_histogram_launch(const int* keys, long long n,
                                    int n_buckets, int shift, float* out,
                                    void* stream) {
  if (n < 0 || n_buckets <= 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_buckets, s);
  if (e != cudaSuccess || n == 0) return (int)e;   // no keys: all zeros
  long long head = (long long)(((16u - ((uintptr_t)keys & 15u)) & 15u) / 4u);
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  const int tail = (int)(n - head - 4 * n4);
  const bool cluster = n_buckets <= kSmemBuckets;
  const unsigned smem = cluster ? sizeof(unsigned) * n_buckets : 0u;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  int wave = 0;
  if ((e = wave_blocks(dev, cluster, smem, &wave)) != cudaSuccess)
    return (int)e;
  const long long per_vecs = (long long)kThreads * kVecs;
  long long blocks = (n4 + per_vecs - 1) / per_vecs;
  if (cluster) blocks = (blocks + kCluster - 1) / kCluster * kCluster;
  if (blocks > wave) blocks = wave;
  if (blocks < (cluster ? kCluster : 1)) blocks = cluster ? kCluster : 1;
  const long long per_block = (n4 + blocks - 1) / blocks;
  if (per_block > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n < kExactF32) {
    launch_count(cluster, (unsigned)blocks, smem, s, keys, (int)head, n4,
                 tail, (int)per_block, n_buckets, shift, out);
    return (int)cudaGetLastError();
  }
  unsigned* counts = reinterpret_cast<unsigned*>(out);
  launch_count(cluster, (unsigned)blocks, smem, s, keys, (int)head, n4, tail,
               (int)per_block, n_buckets, shift, counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  counts_to_f32<<<(n_buckets - 1) / kThreads + 1, kThreads, 0, s>>>(
      counts, n_buckets);
  return (int)cudaGetLastError();
}
