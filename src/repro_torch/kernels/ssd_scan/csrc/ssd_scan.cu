// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 and bf16 inputs, f32
// arithmetic and outputs.
//
// Replaces the TPU kernel `ssd_scan_pallas`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_kernel`) and computes
// what it computes, for every head row and chunk of Q positions:
//   cum      = cumsum(dA) over the chunk
//   y_diag_i = sum_{j <= i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
//   y_off_i  = exp(cum_i) C_i . state^T           (state entering the chunk)
//   state'   = state exp(cum_last) + x^T (B exp(cum_last - cum) dt)
// and writes y [rows, l, p] and the final state [rows, p, n].  x is read
// through the strides of a head-major view [b, h, l, p], dt and dA of
// [b, h, l], B and C of [b, g, l, n] (the last dimension of x, B, C
// contiguous), so the model hands over views of its [b, l, h, p] and
// [b, l, g, n] activations; head row r = bi * h + hi reads the B/C row of
// group r / (h / g), and B and C are never copied per head.  y is written
// through the strides of its own head-major view.
//
// Bound on this card (H100 SXM, published rates at the 700 W limit): at the
// mamba2-780m prefill (192 head rows x 4,096 positions, p 64, n 128, Q 256)
// one call does 6.4e10 operations on the pairs the mask keeps and moves
// 3.2e8 bytes -- 65 us at the 989 TFLOP/s of the bf16 tensor cores
// against 96 us at 3.35 TB/s, and 0.96 ms at the 67 TFLOP/s of the f32
// cores.  This kernel multiplies on the f32 cores.
//
// Design (simple and right first; tensor cores and a CB product shared by
// the heads of a group are later work).  The TPU kernel walks the chunks of
// a row in order with the state in VMEM.  Here the chunks run in parallel,
// as the reference's `ssd_chunked` splits the work, in three launches:
//   1. ssd_chunk_state, one block per (row, chunk): the chunk's cumsum
//      (a block scan), its decay exp(cum_last) and its own state
//      x^T (B w), w_j = exp(cum_last - cum_j) dt_j, into a scratch
//      [rows, chunks, p, n];
//   2. ssd_state_scan, one thread per (row, state element): the recurrence
//      prev' = prev * decay + state over the chunks, replacing each chunk's
//      state by the state entering it and writing the final state;
//   3. ssd_chunk_out, one block per (row, chunk): y = exp(cum_i) C_i .
//      prev^T plus the intra-chunk term, in 64 x 64 output tiles.
// Every product is a 64 x 64 tile of 256 threads, each owning 4 x 4
// outputs in registers, over operands staged k-major in shared memory
// (slices of 16, float4 reads).  The intra-chunk term takes only the key
// tiles at or left of the query tile, and inside the diagonal tile only
// the pairs j <= i: exp(cum_i - cum_j) is computed for those alone (for
// j > i it overflows, and a 0/1 mask would turn it into NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;         // output tile edge
constexpr int kDepth = 16;        // depth of one staged slice
constexpr int kLd = kTile + 4;    // padded row of a staged operand
constexpr int kMaxChunk = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Strides (elements) of a head-major view [batch, head, position, last].
struct View {
  long long sb, sh, sl;
};

template <typename T>
struct Params {
  const T* x;
  const float* dt;
  const float* dA;
  const T* B;
  const T* C;
  float* y;
  float* state;   // [rows, p, n], the final state
  float* states;  // scratch [rows, chunks, p, n]
  float* decay;   // scratch [rows, chunks]
  int h, g, rep, p, n, q, nc;
  View xs, dts, dAs, Bs, Cs, ys;
};

// Offset of head row r (or group row) of a view with `per` rows per batch.
__device__ __forceinline__ long long row_offset(const View& v, int r,
                                                int per) {
  return (long long)(r / per) * v.sb + (long long)(r % per) * v.sh;
}

// cum[t] = dA[0] + ... + dA[t] for t < q (an inclusive block scan: warp
// shuffles, then the warp totals).  Ends with a barrier.
__device__ void chunk_cumsum(const float* dA, long long sl, int q,
                             float* cum, float* tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float v = t < q ? dA[t * sl] : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? tot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    __syncwarp();
    if (lane < kWarps) tot[lane] = s;
  }
  __syncthreads();
  if (t < q) cum[t] = warp > 0 ? v + tot[warp - 1] : v;
  __syncthreads();
}

// dst[k][m] = src[(k0 + k) * rs + m0 + m] (times scale[k0 + k] if given),
// 0 outside k0 + k < kmax, m0 + m < mmax; k < rows, m < kTile.
template <typename T>
__device__ __forceinline__ void stage_rows(float (*dst)[kLd], int rows,
                                           const T* src, long long rs, int k0,
                                           int kmax, int m0, int mmax,
                                           const float* scale) {
  const int m = threadIdx.x % kTile;
  for (int k = threadIdx.x / kTile; k < rows; k += kThreads / kTile) {
    const int gk = k0 + k, gm = m0 + m;
    float v = 0.f;
    if (gk < kmax && gm < mmax) {
      v = to_f32(src[gk * rs + gm]);
      if (scale != nullptr) v *= scale[gk];
    }
    dst[k][m] = v;
  }
}

// dst[k][m] = src[(m0 + m) * rs + k0 + k], 0 outside the bounds; k < kDepth,
// m < kTile (a transposing stage: rows of src become columns of dst).
template <typename T>
__device__ __forceinline__ void stage_cols(float (*dst)[kLd], const T* src,
                                           long long rs, int m0, int mmax,
                                           int k0, int kmax) {
  const int k = threadIdx.x % kDepth;
  for (int m = threadIdx.x / kDepth; m < kTile; m += kThreads / kDepth) {
    const int gk = k0 + k, gm = m0 + m;
    dst[k][m] = (gk < kmax && gm < mmax) ? to_f32(src[gm * rs + gk]) : 0.f;
  }
}

// acc[i][j] += sum_k A[k][ty * 4 + i] * Bm[k][tx * 4 + j]
template <int K>
__device__ __forceinline__ void mma(float (*A)[kLd], float (*Bm)[kLd],
                                    float acc[4][4], int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&A[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bm[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state(const Params<T> a) {
  __shared__ float cum[kMaxChunk], w[kMaxChunk], tot[kWarps];
  __shared__ __align__(16) float As[kDepth][kLd];
  __shared__ __align__(16) float Bm[kDepth][kLd];
  const int c = blockIdx.x, r = blockIdx.y, t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const long long pos0 = (long long)c * a.q;
  const float* dA = a.dA + row_offset(a.dAs, r, a.h) + pos0 * a.dAs.sl;
  const float* dt = a.dt + row_offset(a.dts, r, a.h) + pos0 * a.dts.sl;
  chunk_cumsum(dA, a.dAs.sl, a.q, cum, tot);
  const float last = cum[a.q - 1];
  for (int j = t; j < a.q; j += kThreads)
    w[j] = expf(last - cum[j]) * dt[j * a.dts.sl];
  if (t == 0) a.decay[(long long)r * a.nc + c] = expf(last);
  __syncthreads();
  const T* x = a.x + row_offset(a.xs, r, a.h) + pos0 * a.xs.sl;
  const T* B = a.B + row_offset(a.Bs, r / a.rep, a.g) + pos0 * a.Bs.sl;
  float* out = a.states + ((long long)r * a.nc + c) * a.p * a.n;
  // state[pp][nn] = sum_j x_j[pp] w_j B_j[nn]
  for (int m0 = 0; m0 < a.p; m0 += kTile)
    for (int n0 = 0; n0 < a.n; n0 += kTile) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < a.q; k0 += kDepth) {
        stage_rows(As, kDepth, x, a.xs.sl, k0, a.q, m0, a.p, w);
        stage_rows(Bm, kDepth, B, a.Bs.sl, k0, a.q, n0, a.n, nullptr);
        __syncthreads();
        mma<kDepth>(As, Bm, acc, ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = m0 + ty * 4 + i, nn = n0 + tx * 4 + j;
          if (pr < a.p && nn < a.n) out[pr * a.n + nn] = acc[i][j];
        }
    }
}

// Over the chunks of row blockIdx.y: each chunk's own state becomes the
// state entering it, prev' = prev * decay + own; the last prev is the
// final state.
__global__ void __launch_bounds__(kThreads)
    ssd_state_scan(float* states, const float* decay, float* state, int nc,
                   int pn) {
  const int r = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  float* s = states + (long long)r * nc * pn + e;
  const float* d = decay + (long long)r * nc;
  float prev = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float own = s[(long long)c * pn];
    s[(long long)c * pn] = prev;
    prev = prev * d[c] + own;
  }
  state[(long long)r * pn + e] = prev;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_out(const Params<T> a) {
  __shared__ float cum[kMaxChunk], dts[kMaxChunk], tot[kWarps];
  __shared__ __align__(16) float As[kDepth][kLd];
  __shared__ __align__(16) float Bm[kDepth][kLd];
  __shared__ __align__(16) float Ms[kTile][kLd];  // M^T: [key j][query i]
  __shared__ __align__(16) float Xs[kTile][kLd];  // x: [key j][p]
  const int c = blockIdx.x, r = blockIdx.y, t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const long long pos0 = (long long)c * a.q;
  const float* dA = a.dA + row_offset(a.dAs, r, a.h) + pos0 * a.dAs.sl;
  const float* dt = a.dt + row_offset(a.dts, r, a.h) + pos0 * a.dts.sl;
  for (int j = t; j < a.q; j += kThreads) dts[j] = dt[j * a.dts.sl];
  chunk_cumsum(dA, a.dAs.sl, a.q, cum, tot);
  const T* x = a.x + row_offset(a.xs, r, a.h) + pos0 * a.xs.sl;
  const int grow = r / a.rep;
  const T* B = a.B + row_offset(a.Bs, grow, a.g) + pos0 * a.Bs.sl;
  const T* C = a.C + row_offset(a.Cs, grow, a.g) + pos0 * a.Cs.sl;
  const float* prev = a.states + ((long long)r * a.nc + c) * a.p * a.n;
  float* y = a.y + row_offset(a.ys, r, a.h) + pos0 * a.ys.sl;
  for (int i0 = 0; i0 < a.q; i0 += kTile)
    for (int p0 = 0; p0 < a.p; p0 += kTile) {
      // y_off[i][pp] = exp(cum_i) sum_n C_i[n] prev[pp][n]
      float acc[4][4] = {};
      for (int k0 = 0; k0 < a.n; k0 += kDepth) {
        stage_cols(As, C, a.Cs.sl, i0, a.q, k0, a.n);
        stage_cols(Bm, prev, (long long)a.n, p0, a.p, k0, a.n);
        __syncthreads();
        mma<kDepth>(As, Bm, acc, ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = i0 + ty * 4 + i;
        const float e = ii < a.q ? expf(cum[ii]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // y_diag: key tiles at or left of the query tile
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        float s[4][4] = {};
        for (int k0 = 0; k0 < a.n; k0 += kDepth) {
          stage_cols(As, C, a.Cs.sl, i0, a.q, k0, a.n);
          stage_cols(Bm, B, a.Bs.sl, j0, a.q, k0, a.n);
          __syncthreads();
          mma<kDepth>(As, Bm, s, ty, tx);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ii = i0 + ty * 4 + i, jj = j0 + tx * 4 + j;
            Ms[tx * 4 + j][ty * 4 + i] =
                (jj <= ii && ii < a.q)
                    ? s[i][j] * expf(cum[ii] - cum[jj]) * dts[jj]
                    : 0.f;
          }
        stage_rows(Xs, kTile, x, a.xs.sl, j0, a.q, p0, a.p, nullptr);
        __syncthreads();
        mma<kTile>(Ms, Xs, acc, ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ii = i0 + ty * 4 + i, pp = p0 + tx * 4 + j;
          if (ii < a.q && pp < a.p) y[ii * a.ys.sl + pp] = acc[i][j];
        }
    }
}

template <typename T>
int launch(const Params<T>& a, int rows, cudaStream_t st) {
  const dim3 grid(a.nc, rows);
  ssd_chunk_state<T><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pn = a.p * a.n;
  ssd_state_scan<<<dim3((pn + kThreads - 1) / kThreads, rows), kThreads, 0,
                   st>>>(a.states, a.decay, a.state, a.nc, pn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out<T><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const float* dt, const float* dA, const void* B,
        const void* C, float* y, float* state, float* states, float* decay,
        int b, int h, int g, int l, int p, int n, int q,
        const long long* s, cudaStream_t st) {
  Params<T> a;
  a.x = static_cast<const T*>(x);
  a.dt = dt;
  a.dA = dA;
  a.B = static_cast<const T*>(B);
  a.C = static_cast<const T*>(C);
  a.y = y;
  a.state = state;
  a.states = states;
  a.decay = decay;
  a.h = h;
  a.g = g;
  a.rep = h / g;
  a.p = p;
  a.n = n;
  a.q = q;
  a.nc = l / q;
  View* views[6] = {&a.xs, &a.dts, &a.dAs, &a.Bs, &a.Cs, &a.ys};
  for (int i = 0; i < 6; ++i) *views[i] = View{s[3 * i], s[3 * i + 1],
                                               s[3 * i + 2]};
  return launch(a, b * h, st);
}

}  // namespace

// x [b, h, l, p], B and C [b, g, l, n] (T: dtype 0 float32, 1 bfloat16);
// dt, dA [b, h, l] f32; y [b, h, l, p] f32 -- each through the 3 strides
// (batch, head, position) in `strides` (x, dt, dA, B, C, y in that order,
// 18 values, elements; the last dimension of x, B, C, y contiguous).
// state: [b * h, p, n] f32 contiguous.  states [b * h, l / chunk, p, n] and
// decay [b * h, l / chunk] are f32 scratch.  Returns a cudaError_t code.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* dA, const void* B, const void* C,
                               float* y, float* state, float* states,
                               float* decay, int dtype, int b, int h, int g,
                               int l, int p, int n, int chunk,
                               const long long* strides, void* stream) {
  if (b <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0 || n <= 0 ||
      chunk <= 0 || chunk > kMaxChunk || l <= 0 || l % chunk != 0 ||
      b * h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, dt, dA, B, C, y, state, states, decay, b, h, g, l,
                      p, n, chunk, strides, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, dt, dA, B, C, y, state, states, decay, b, h,
                              g, l, p, n, chunk, strides, st);
  return (int)cudaErrorInvalidValue;
}
