// Flash attention forward for Hopper (sm_90a): blocked online-softmax
// attention with grouped-query heads, f32 and bf16.
//
// Replaces the TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`) and
// computes what it computes: q scaled by hd^-0.5 in f32 before the dot;
// an online softmax with f32 running max m, sum l and accumulator; a
// causal mask q_pos >= k_pos with both positions counted from 0 (top-left,
// also when sk != sq), a masked score being -1e30 as in the reference;
// the output acc / max(l, 1e-30) stored in q's dtype.  q is [b, sq, h, hd]
// and k, v are [b, sk, kv, hd], read in place through their strides (the
// last dimension contiguous); query head hh reads KV head hh / (h / kv),
// and KV is never replicated.
//
// Bound on this card (H100 SXM, published rates at the 700 W limit): the
// two products take 4 * hd operations per (query, key) pair that the mask
// keeps -- 0.28 ms for one causal layer of the tinyllama prefill
// (b 4, s 4096, 32 heads of 64) at the 989 TFLOP/s of the bf16 tensor
// cores, against 45 us to move q, k, v and the output once at 3.35 TB/s.
// So operations bound it; for f32 inputs the rate is the 67 TFLOP/s of the
// f32 cores, and the bound 4.1 ms.
//
// Design (simple and right first; wgmma, TMA and the tensor cores are
// later work): the rows of one (batch, KV head) pair -- the (position,
// query head) pairs of the h / kv query heads that share it -- are cut
// into tiles of kRows = 64 rows, one block of 8 warps per tile, 8 rows per
// warp.  The block stages the tile's scaled queries once in shared memory
// and then walks the keys in tiles of 32, staging K and V as f32 in shared
// memory so that every row of the block reuses them (8x for the GQA heads
// of one position in tinyllama).  Scores: lane j computes the full dot
// product of each of its warp's 8 rows with key j (K rows padded by one
// float so that the 32 lanes hit 32 banks; each K value is reused across
// the 8 rows in registers).  Softmax: a warp max and a warp sum per row.
// P @ V: each lane owns hd/32 output columns, reads p from shared memory
// as float4 broadcasts and V as conflict-free column reads; the
// accumulator lives in registers (8 x hd/32 floats per lane).  Causal key
// tiles that lie wholly above the block's last row are not visited, and
// blocks are started heaviest (latest positions) first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// C interface (loaded with ctypes).  q: [b, sq, h, hd], k and v:
// [b, sk, kv, hd], each with unit stride in its last dimension and the
// given element strides for batch, sequence and head; out: [b, sq, h, hd]
// contiguous, in the inputs' dtype (dtype 0: f32, 1: bf16).  hd in
// {32, 64, 128, 256}; h % kv == 0; scale is hd^-0.5 rounded to f32.
// stream: a cudaStream_t.  Returns the CUDA error of the launch (0 if it
// was accepted).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int b,
    int sq, int sk, int h, int kvh, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, b, sq, sk, h, kvh, qs, ks, vs,
                              causal, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, b, sq, sk, h, kvh, qs,
                                      ks, vs, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
