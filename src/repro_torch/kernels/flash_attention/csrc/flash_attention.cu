// Flash attention forward for Hopper (sm_90a): blocked online-softmax
// attention with grouped-query heads, f32 and bf16, in two kernels chosen
// by the C entry from its arguments.
//
// Replaces the TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`) and
// computes what it computes: scores q . k scaled by hd^-0.5 in f32; an
// online softmax with f32 running max m, sum l and accumulator; a causal
// mask q_pos >= k_pos with both positions counted from 0 (top-left, also
// when sk != sq), a masked score being -1e30 as in the reference; the
// output acc / max(l, 1e-30) stored in q's dtype.  q is [b, sq, h, hd] and
// k, v are [b, sk, kv, hd], read in place through their strides (the last
// dimension contiguous); query head hh reads KV head hh / (h / kv), and KV
// is never replicated.
//
// Bound on this card (H100 SXM, published rates at the 700 W limit): the
// two products take 4 * hd operations per (query, key) pair that the mask
// keeps -- 0.28 ms for one causal layer of the tinyllama prefill
// (b 4, s 4096, 32 heads of 64) at the 989 TFLOP/s of the bf16 tensor
// cores, against 45 us to move q, k, v and the output once at 3.35 TB/s.
// So operations bound it; for f32 inputs the rate is the 67 TFLOP/s of the
// f32 cores, and the bound 4.1 ms.
//
// Routes.  bf16 inputs at head dims 64, 96 and 128 whose rows cp.async can
// copy 16 bytes at a time (q, k, v 16-byte aligned, every stride a
// multiple of 8 elements) take flash_fwd_tc on the tensor cores; f32
// inputs, head dims 32 and 256 and unaligned views take flash_fwd on the
// f32 cores.
//
// flash_fwd_tc.  The rows of one (batch, KV head) pair -- the (position,
// query head) pairs of the h / kv query heads that share it, so the 8
// heads of one position in tinyllama share every K/V tile in shared memory
// rather than through L2 -- are cut into blocks of 128 rows, two consumer
// warpgroups of 64 rows each (256 threads).  The queries stay in shared
// memory; K/V tiles of 64 keys pass through a 2-stage ring filled by
// cp.async.cg 16-byte copies (keys past sk zero-filled), all in the
// 128-byte swizzled layout that the wgmma descriptors name.  Per tile and
// warpgroup: S = Q K^T by hd / 16 wgmma.mma_async m64n64k16 (bf16 in, f32
// accumulate, both operands K-major in shared memory); the scale and
// log2(e) applied to each f32 score inside the exponent's FMA (exact
// against the reference's (q * scale) . k at hd 64, where the scale is a
// power of two; one f32 rounding of each score at hd 128); the mask only
// on tiles that cross the diagonal or the end of the keys; the row max
// over a quad of threads (two shuffles), l summed from the f32 p; then
// O += P V with P in registers as the A operand and V the B operand read
// MN-major (transposed by the descriptor, never in memory).  P goes in
// split: hi = bf16(p), lo = bf16(p - hi), two m64n{hd}k16 wgmma per 16
// keys into one accumulator, so the kernel issues 6 hd operations per
// pair (0.42 ms at the path shape) for the function's 4 hd.  Rounding p
// once to bf16 puts the bf16 output 8-18x over the 2-ulp bound that the
// card checks (a CPU emulation at the reference's shapes); the split
// keeps it under half of it (0.49 at the path shape on an H100).  Key
// tiles wholly above the diagonal are skipped, and blocks start heaviest
// (latest positions) first.  Head dim 96 (phi-3-vision) runs the hd 128
// layout with its last 32 columns zero-filled: six k-steps of S = Q K^T
// read the 96 real columns, and O += P V runs at n 128 over V's zero
// columns (a third more P V operations than the 96 columns need; the
// padded columns of O are not stored), since a 96-wide B operand read
// MN-major would end in half a 64-column swizzle atom.  ptxas (sm_90a):
// 127 registers at hd 64, 169 at hd 128, no spills; 49 KB (hd 64) / 97 KB
// (hd 96 and 128) of dynamic shared memory.
//
// flash_fwd (f32 cores).  The same rows in blocks of kRows = 64, one block
// of 8 warps per tile, 8 rows per warp.  The block stages the tile's
// scaled queries once in shared memory and then walks the keys in tiles
// of 32, staging K and V as f32 in shared memory so that every row of the
// block reuses them.  Scores: lane j computes the full dot product of each
// of its warp's 8 rows with key j (K rows padded by one float so that the
// 32 lanes hit 32 banks).  Softmax: a warp max and a warp sum per row.
// P @ V: each lane owns hd/32 output columns, reads p from shared memory
// as float4 broadcasts and V as conflict-free column reads; the
// accumulator lives in registers (8 x hd/32 floats per lane).  Causal key
// tiles that lie wholly above the block's last row are not visited, and
// blocks are started heaviest (latest positions) first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per tile
constexpr float kNegInf = -1e30f;             // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int HD>
constexpr int smem_floats() {
  return kRows * HD                      // scaled queries [kRows][HD]
         + kKeys * HD                    // V tile [kKeys][HD]
         + kWarps * kRowsPerWarp * kKeys // probabilities [warp][row][key]
         + kKeys * (HD + 1);             // K tile [kKeys][HD + 1] (padded)
}

struct Strides {
  long long b, s, h;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
          int h, int kvh, Strides qs, Strides ks, Strides vs, int causal,
          float scale) {
  constexpr int NI = HD / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* v_s = q_s + kRows * HD;
  float* p_s = v_s + kKeys * HD;
  float* k_s = p_s + kWarps * kRowsPerWarp * kKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = h / kvh;
  const int bi = blockIdx.y / kvh, g = blockIdx.y % kvh;
  const long long n_rows = (long long)sq * rep;
  const long long row0 = (long long)(gridDim.x - 1 - blockIdx.x) * kRows;

  // the block's queries, scaled in f32 (rows past the end are zero)
  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const long long row = row0 + idx / HD;
    float x = 0.0f;
    if (row < n_rows) {
      const long long pos = row / rep;
      const int head = g * rep + (int)(row % rep);
      x = to_f32(q[bi * qs.b + pos * qs.s + head * qs.h + idx % HD]) * scale;
    }
    q_s[idx] = x;
  }

  int pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NI];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    pos[r] = (int)((row0 + warp * kRowsPerWarp + r) / rep);
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.0f;
  }
  const float* q_w = q_s + warp * kRowsPerWarp * HD;
  float* p_w = p_s + warp * kRowsPerWarp * kKeys;

  const long long last_row = min(row0 + kRows, n_rows) - 1;
  const int k_end = causal ? (int)min((long long)sk, last_row / rep + 1) : sk;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int idx = threadIdx.x; idx < kKeys * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, key = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < sk) {
        kx = to_f32(k[bi * ks.b + (long long)key * ks.s + g * ks.h + d]);
        vx = to_f32(v[bi * vs.b + (long long)key * vs.s + g * vs.h + d]);
      }
      k_s[j * (HD + 1) + d] = kx;
      v_s[j * HD + d] = vx;
    }
    __syncthreads();

    // scores: lane j against key k0 + j, for the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    const float* k_row = k_s + lane * (HD + 1);
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float k0v = k_row[d], k1v = k_row[d + 1], k2v = k_row[d + 2],
                  k3v = k_row[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * HD + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float sr = s[r];
      if (key >= sk) sr = -INFINITY;  // no such key: weight exactly 0
      else if (causal && key > pos[r]) sr = kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      p_w[r * kKeys + lane] = p;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += p @ V: lane owns columns lane + 32 i
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float vv[4][NI];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < NI; ++i)
          vv[jj][i] = v_s[(j + jj) * HD + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(p_w + r * kKeys + j);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          acc[r][i] = fmaf(pv.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(pv.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(pv.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(pv.w, vv[3][i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

  // out [b, sq, h, hd], contiguous
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const int head = g * rep + (int)(row % rep);
    T* o = out + (((long long)bi * sq + pos[r]) * h + head) * HD;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) store(o + lane + 32 * i, acc[r][i] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int h, int kvh, Strides qs, Strides ks, Strides vs,
           int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kernel = flash_fwd<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)sq * (h / kvh) + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL || (long long)b * kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)(b * kvh));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, h, kvh, qs, ks,
      vs, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int b, int sq, int sk, int h, int kvh, Strides qs,
                Strides ks, Strides vs, int causal, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                           causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                           causal, scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                            causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                            causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: bf16 q, k, v at head dims 64, 96 and 128.

namespace tc {

constexpr int kWG = 2;                // warpgroups per block, 64 rows each
constexpr int kRows = 64 * kWG;       // query rows per block
constexpr int kKeys = 64;             // keys per tile
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 2;    // K/V ring depth

// The head dim a tile is laid out at: 96 is padded to 128.
__host__ __device__ constexpr int padded(int hd) { return hd == 96 ? 128 : hd; }

// Bytes of one [rows][hd] bf16 tile: padded(hd) / 64 column blocks of
// [rows][64], each row 128 bytes.
template <int HD>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * padded(HD) * 2;
}
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<HD>(kRows) + 2 * kStages * tile_bytes<HD>(kKeys) +
         1024;  // room to align the base to the 1,024-byte swizzle atom
}

// Byte offset of 16-byte chunk c (of hd / 8) of row r in a [rows][hd] tile
// laid out for wgmma's 128-byte swizzle: column block c / 8, then the row,
// then chunk c % 8 XOR the row's low three bits.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or reuse of registers that an
// in-flight wgmma owns across the fence / wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p as the two bf16 halves of a split: hi = bf16(p), lo = bf16(p - hi),
// packed in pairs (lower column in the lower 16 bits)
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - __low2float(h),
                                                 p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b);
template <>
__device__ __forceinline__ void pv_product<64>(float (&o)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  wgmma_rs_n64(o, a, b);
}
template <>
__device__ __forceinline__ void pv_product<128>(float (&o)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  wgmma_rs_n128(o, a, b);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int sq, int sk, int h, int kvh,
             Strides qs, Strides ks, Strides vs, int causal, float scale) {
  constexpr int HP = padded(HD);      // the tiles' head dim
  constexpr int CH = HD / 8;          // 16-byte chunks of a row
  constexpr int CP = HP / 8;          // ... of a tile row (past CH: zero)
  constexpr int NO = HP / 2;          // output accumulator floats per thread
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + tile_bytes<HD>(kRows);
  const uint32_t sV = sK + kStages * tile_bytes<HD>(kKeys);

  constexpr int NS = kKeys / 2;       // score floats per thread
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid / 32) % 4;  // warp within its group
  const int rep = h / kvh;
  const int bi = blockIdx.y / kvh, g = blockIdx.y % kvh;
  const long long n_rows = (long long)sq * rep;
  const long long row0 = (long long)(gridDim.x - 1 - blockIdx.x) * kRows;
  const long long last_row = min(row0 + kRows, n_rows) - 1;
  const int first_pos = (int)(row0 / rep);
  const int k_end =
      causal ? (int)min((long long)sk, last_row / rep + 1) : sk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  // the query tile (rows past the end and padded columns are zero)
  for (int idx = tid; idx < kRows * CP; idx += kThreads) {
    const int r = idx / CP, c = idx % CP;
    const long long row = row0 + r;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (row < n_rows && c < CH) {
      const long long pos = row / rep;
      const int head = g * rep + (int)(row % rep);
      src = q + bi * qs.b + pos * qs.s + head * qs.h + c * 8;
      bytes = 16;
    }
    cp_async16(sQ + swz(r, c, kRows), src, bytes);
  }
  // one K/V tile into ring stage st (keys past sk and padded columns are
  // zero).  This thread copies chunk c of rows r_base + i * R of every
  // tile.
  constexpr int R = kThreads / CP, NL = kKeys / R;
  const int r_base = tid / CP, c_ld = tid % CP;
  const bool real_col = c_ld < CH;
  const __nv_bfloat16* k_row = k + bi * ks.b + g * ks.h + c_ld * 8;
  const __nv_bfloat16* v_row = v + bi * vs.b + g * vs.h + c_ld * 8;
  const uint32_t d_ld = swz(r_base, c_ld, kKeys);
  auto load_kv = [&](int t, int st) {
    const uint32_t dk = sK + st * tile_bytes<HD>(kKeys) + d_ld;
    const uint32_t dv = sV + st * tile_bytes<HD>(kKeys) + d_ld;
    const int key0 = t * kKeys + r_base;
    const __nv_bfloat16* kp = k_row + (long long)key0 * ks.s;
    const __nv_bfloat16* vp = v_row + (long long)key0 * vs.s;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const bool in = real_col && key0 + i * R < sk;
      cp_async16(dk + i * R * 128, in ? kp + (long long)i * R * ks.s : k,
                 in ? 16 : 0);
      cp_async16(dv + i * R * 128, in ? vp + (long long)i * R * vs.s : v,
                 in ? 16 : 0);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // this thread's two rows: wg * 64 + warp * 16 + lane / 4, 8 below it
  int pos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    pos[hf] = (int)((row0 + wg * 64 + warp * 16 + lane / 4 + 8 * hf) / rep);
  // scores stay unscaled: the scale, with log2(e) folded in, is applied
  // to each f32 score in the exponent's FMA, and a masked score is
  // kNegInf / scale, i.e. -1e30 once scaled
  const float sl2 = scale * kLog2e, mask = kNegInf / scale;
  float m[2] = {mask, mask}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile t (and the queries) have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T on the tensor cores: hd / 16 steps of m64n64k16
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    reg_fence(s);
    wg_fence();
    const uint32_t kt = sK + st * tile_bytes<HD>(kKeys);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // column block kk / 4 of hd, 32 bytes (16 values) per step inside it
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n64(s,
                desc(sQ + (kk / 4) * tile_bytes<64>(kRows) + wg * 8192 + off,
                     16, 1024),
                desc(kt + (kk / 4) * tile_bytes<64>(kKeys) + off, 16, 1024));
    }
    wg_commit();
    wg_wait0();
    reg_fence(s);

    // scale, mask (only tiles that cross the diagonal or the end of the
    // keys), online softmax.  s[4 nb + 2 hf + e] is row hf, key
    // 8 nb + 2 (lane % 4) + e of the tile.
    const int k0 = t * kKeys;
    const bool masked =
        (causal && k0 + kKeys - 1 > first_pos) || k0 + kKeys > sk;
    if (masked) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        if (key >= sk) s[i] = -INFINITY;  // no such key: weight exactly 0
        else if (causal && key > pos[(i / 2) % 2]) s[i] = mask;
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * hf], s[4 * nb + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      alpha[hf] = ex2((m[hf] - mx) * sl2);
      m[hf] = mx;
    }
    const float ml[2] = {m[0] * sl2, m[1] * sl2};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = ex2(fmaf(s[i], sl2, -ml[(i / 2) % 2]));
      rs[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + rs[hf];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];

    // P as A operand fragments, split: hi = bf16(p), lo = bf16(p - hi).
    // Key step kk (16 keys) is s[8 kk .. 8 kk + 7], pairs in order.
    uint32_t phi[NS / 2], plo[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i)
      split2(s[2 * i], s[2 * i + 1], phi[i], plo[i]);

    // O += P_hi V + P_lo V: V is the B operand read MN-major (transposed
    // by the descriptor; 8-key groups 1,024 bytes apart, 64-column blocks
    // of hd one tile column block apart)
    const uint32_t vt = sV + st * tile_bytes<HD>(kKeys);
    reg_fence(o);
    reg_fence(phi);
    reg_fence(plo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {phi[4 * kk], phi[4 * kk + 1], phi[4 * kk + 2],
                             phi[4 * kk + 3]};
      pv_product<HP>(o, a, desc(vt + kk * 2048, tile_bytes<64>(kKeys), 1024));
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {plo[4 * kk], plo[4 * kk + 1], plo[4 * kk + 2],
                             plo[4 * kk + 3]};
      pv_product<HP>(o, a, desc(vt + kk * 2048, tile_bytes<64>(kKeys), 1024));
    }
    wg_commit();
    wg_wait0();
    reg_fence(o);
    reg_fence(phi);
    reg_fence(plo);
    __syncthreads();  // every warp is done with stage st before its refill
  }

  // out [b, sq, h, hd] contiguous: acc / max(l, 1e-30)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(~0u, lt, 1);
    lt += __shfl_xor_sync(~0u, lt, 2);
    const long long row = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * hf;
    if (row >= n_rows) continue;
    const int head = g * rep + (int)(row % rep);
    __nv_bfloat16* dst =
        out + (((long long)bi * sq + pos[hf]) * h + head) * HD + 2 * (lane % 4);
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nb) = __floats2bfloat162_rn(
          o[4 * nb + 2 * hf] / den, o[4 * nb + 2 * hf + 1] / den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int h, int kvh, Strides qs, Strides ks, Strides vs,
           int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  auto kernel = flash_fwd_tc<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)sq * (h / kvh) + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL || (long long)b * kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)(b * kvh));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, sk, h, kvh, qs, ks, vs, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The tensor-core route takes bf16 inputs at head dims 64, 96 and 128
// whose rows cp.async can copy 16 bytes at a time: q, k, v 16-byte aligned
// and every stride a multiple of 8 elements.  Everything else takes
// flash_fwd.
bool tensor_core_route(int dtype, int hd, const void* q, const void* k,
                       const void* v, const long long* strides) {
  if (dtype != 1 || (hd != 64 && hd != 96 && hd != 128)) return false;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// C interface (loaded with ctypes).  q: [b, sq, h, hd], k and v:
// [b, sk, kv, hd], each with unit stride in its last dimension and the
// given element strides for batch, sequence and head; out: [b, sq, h, hd]
// contiguous, in the inputs' dtype (dtype 0: f32, 1: bf16).  hd in
// {32, 64, 96, 128, 256}; h % kv == 0; scale is hd^-0.5 rounded to f32.
// stream: a cudaStream_t.  *route (if not null) is set to 1 when the
// tensor-core kernel runs, 0 for flash_fwd.  Returns the CUDA error of the
// launch (0 if it was accepted).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int b,
    int sq, int sk, int h, int kvh, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    void* stream, int* route) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tensor_cores = tensor_core_route(dtype, hd, q, k, v, strides);
  if (route != nullptr) *route = tensor_cores ? 1 : 0;
  if (tensor_cores) {
    if (hd == 64)
      return tc::launch<64>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                            causal, scale, st);
    if (hd == 96)
      return tc::launch<96>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                            causal, scale, st);
    return tc::launch<128>(q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                           causal, scale, st);
  }
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                              causal, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, b, sq, sk, h, kvh, qs,
                                      ks, vs, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
