// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 and bf16 inputs, f32
// sums and outputs.
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
// cores.  So bytes bound it.
//
// The TPU kernel walks the chunks of a row in order with the state in
// VMEM.  Here the chunks run in parallel, as the reference's `ssd_chunked`
// splits the work, and the recurrence over chunks is a launch of its own:
// ssd_state_scan, one thread per (row, state element), turns each chunk's
// own state into the state entering it (prev' = prev * decay + own) and
// writes the final state, reading its loads a batch of chunks at a time.
//
// Routes, by dtype.  f32 x, B, C take three launches on the f32 cores
// (their test contract, atol 2e-4, is held on f32 data); bf16 x, B, C take
// four on the tensor cores.
//
// Tensor-core route (bf16).  Products by mma.sync m16n8k16 (bf16 in, f32
// accumulate) from ldmatrix fragments of 64 x 64 tiles in shared memory,
// four warps of 16 output rows per block.  mma.sync rather than wgmma:
// the tiles are small and ragged at the reference's shapes (p 8-64,
// n 8-128, Q 16-256, zero-padded to 64), every operand is staged and most
// are transformed (scaled, masked, split) by the threads anyway, and the
// call is bound by bytes, not by the tensor cores.  Each derived f32
// operand goes in split, hi = bf16(a) and lo = bf16(a - hi), as two
// products into one accumulator: rounded once to bf16, y and the state
// miss their band 16-21x at the path's magnitudes (a CPU emulation);
// split, they use about a tenth of it at the path shape on an H100.  Tiles are copied by cp.async.cg
// (16-byte rows; plain loads where a view's rows are not 16-byte aligned),
// the next round's while the current one is split and multiplied.
//   1. ssd_cb, one block per (batch x group, chunk, 64 x 64 tile j0 <= i0):
//      C_i . B_j once per group -- the 48 heads of mamba2-780m share it --
//      into an f32 scratch [b g, chunks, Q, Q].
//   2. ssd_chunk_state_tc, one block per (row, chunk): the cumsum, decay
//      and own state x^T (B w), B w split, in 64 x 128 tiles.
//   3. ssd_state_scan, writing the entering states split into a bf16
//      scratch [2, rows, chunks, p, n] (hi, lo) instead of in place.
//   4. ssd_chunk_out_tc, one block per (row, chunk, 64-row query tile,
//      64-column tile of p): y_off = exp(cum_i) C_i . prev^T with the split
//      state, then y_diag = M x over the key tiles at or left of the query
//      tile, M_ij = CB_ij exp(cum_i - cum_j) dt_j split.
// ptxas (sm_90a): ssd_chunk_out_tc 168 registers and 75,808 B of dynamic
// shared memory, ssd_chunk_state_tc 166 and 90,144 B, ssd_cb 127 and
// 18,432 B, ssd_state_scan 80; an 8-byte spill in ssd_chunk_out_tc, none
// elsewhere.
//
// f32-core route.  ssd_chunk_state (one block per (row, chunk): cumsum,
// decay, own state into a scratch [rows, chunks, p, n]), ssd_state_scan
// (in place) and ssd_chunk_out (one block per (row, chunk): both output
// terms in 64 x 64 tiles).  Every product is a 64 x 64 tile of 256
// threads, each owning 4 x 4 outputs in registers, over operands staged
// k-major in shared memory (slices of 16, float4 reads).
//
// Both routes take only the key tiles at or left of the query tile, and
// inside the diagonal tile only the pairs j <= i: exp(cum_i - cum_j) is
// computed for those alone (for j > i it overflows, and a 0/1 mask would
// turn it into NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;         // output tile edge
constexpr int kDepth = 16;        // depth of one staged slice
constexpr int kLd = kTile + 4;    // padded row of a staged operand
constexpr int kMaxChunk = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }

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
// final state.  The own states are read kScanBatch chunks at a time before
// any is overwritten, so the loads of a batch are in flight together
// rather than one after each store.  With split (the tensor-core route)
// the entering states go to split[0] = bf16(prev) and split[1] =
// bf16(prev - split[0]), each [rows, chunks, p, n], and states is only
// read.
constexpr int kScanBatch = 8;
__global__ void __launch_bounds__(kThreads)
    ssd_state_scan(float* __restrict__ states,
                   const float* __restrict__ decay,
                   float* __restrict__ state, int nc, int pn,
                   __nv_bfloat16* __restrict__ split) {
  const int r = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  const long long at = (long long)r * nc * pn + e;
  float* s = states + at;
  const float* d = decay + (long long)r * nc;
  const long long half = (long long)gridDim.y * nc * pn;
  float prev = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kScanBatch) {
    float own[kScanBatch];
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i)
      own[i] = c0 + i < nc ? s[(long long)(c0 + i) * pn] : 0.f;
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i)
      if (c0 + i < nc) {
        const long long ci = (long long)(c0 + i) * pn;
        if (split == nullptr) {
          s[ci] = prev;
        } else {
          const __nv_bfloat16 hi = __float2bfloat16_rn(prev);
          split[at + ci] = hi;
          split[half + at + ci] =
              __float2bfloat16_rn(prev - __bfloat162float(hi));
        }
        prev = prev * d[c0 + i] + own[i];
      }
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

// ---------------------------------------------------------------------------
// Tensor-core route: bf16 x, B, C.  Products by mma.sync m16n8k16 (bf16 in,
// f32 accumulate) over 64 x 64 bf16 tiles staged in shared memory and read
// with ldmatrix; a derived f32 operand goes in as hi = bf16(a) and
// lo = bf16(a - hi), two products into one accumulator.

namespace tc {

constexpr int kTcThreads = 128;   // 4 warps, 16 output rows each
constexpr int kT = 64;            // tile edge
constexpr int kLd = kT + 8;       // row pitch of a 64-wide bf16 tile (144 B)
constexpr int kLdW = 2 * kT + 8;  // row pitch of a 128-wide bf16 tile
constexpr int kLdF = kT + 8;      // row pitch of a 64-wide f32 tile (288 B)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A[m0 .. m0 + 16][0 .. 64) B[0 .. 64)[8 nt ..] over one
// 64-deep slice, for the calling warp.  A is stored [m][k] (LDA pitch) or,
// with AT, [k][m]; B is stored [n][k] or, with BT, [k][n].
template <int NT, bool AT, bool BT, int LDA, int LDB>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const bf16* A, int m0,
                                          const bf16* Bm) {
  const int L = threadIdx.x & 31;
  const uint32_t a_base = smem_addr(A), b_base = smem_addr(Bm);
#pragma unroll
  for (int k0 = 0; k0 < kT; k0 += 16) {
    uint32_t a[4];
    if (AT)
      ldsm_t(a, a_base + ((k0 + (L & 7) + 8 * (L >> 4)) * LDA + m0 +
                          8 * ((L >> 3) & 1)) * 2);
    else
      ldsm(a, a_base + ((m0 + (L & 7) + 8 * ((L >> 3) & 1)) * LDA + k0 +
                        8 * (L >> 4)) * 2);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      if (BT)
        ldsm_t(b, b_base + ((k0 + (L & 7) + 8 * ((L >> 3) & 1)) * LDB +
                            8 * nt + 8 * (L >> 4)) * 2);
      else
        ldsm(b, b_base + ((8 * nt + (L & 7) + 8 * (L >> 4)) * LDB + k0 +
                          8 * ((L >> 3) & 1)) * 2);
      mma(acc[nt], a, b[0], b[1]);
      mma(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

// Four consecutive values split into hi = bf16(a) and lo = bf16(a - hi),
// each half stored 8 bytes at a time.
__device__ __forceinline__ void split4(const float (&a)[4], bf16* hi,
                                       bf16* lo) {
  __nv_bfloat162 h[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    h[e] = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
    l[e] = __floats2bfloat162_rn(a[2 * e] - __low2float(h[e]),
                                 a[2 * e + 1] - __high2float(h[e]));
  }
  *reinterpret_cast<uint2*>(hi) = *reinterpret_cast<const uint2*>(h);
  *reinterpret_cast<uint2*>(lo) = *reinterpret_cast<const uint2*>(l);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) and columns [c0, c0 + W) of a matrix of T (bf16 or
// f32) with row stride rs into dst (row pitch LD), zero outside rows < rmax
// and columns < cmax: with vec (16-byte aligned rows, cmax a multiple of
// the elements per 16 bytes) as cp.async copies that land with the
// caller's next wait, else by plain loads and stores.
template <typename T, int W, int LD>
__device__ __forceinline__ void fill(T* dst, const T* src, long long rs,
                                     int r0, int rmax, int c0, int cmax,
                                     bool vec) {
  constexpr int E = 16 / sizeof(T), V = W / E;
  if (vec) {
#pragma unroll
    for (int it = 0; it < kT * V / kTcThreads; ++it) {
      const int idx = threadIdx.x + it * kTcThreads, r = idx / V;
      const int k = E * (idx % V);
      const bool ok = r0 + r < rmax && c0 + k < cmax;
      cp_async16(dst + r * LD + k, ok ? src + (r0 + r) * rs + c0 + k : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kT * W; idx += kTcThreads) {
      const int r = idx / W, k = idx % W;
      dst[r * LD + k] = (r0 + r < rmax && c0 + k < cmax)
                            ? src[(r0 + r) * rs + c0 + k]
                            : T(0.f);
    }
  }
}

// cum[t] = dA[0] + ... + dA[t] for t < q <= 256 with any number of warps:
// the same segment scans of 32 and the same scan of their totals as
// chunk_cumsum with 256 threads, so the two routes' cumsums are equal.
// Ends with a barrier.
__device__ void chunk_cumsum(const float* dA, long long sl, int q,
                             float* cum, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int sg = warp; sg < kWarps; sg += nw) {
    const int t = sg * 32 + lane;
    float v = t < q ? dA[t * sl] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (t < q) cum[t] = v;
    if (lane == 31) tot[sg] = v;
  }
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
  for (int t = threadIdx.x; t < q; t += blockDim.x)
    if (t >= 32) cum[t] += tot[t / 32 - 1];
  __syncthreads();
}

struct Params {
  const bf16* x;
  const float* dt;
  const float* dA;
  const bf16* B;
  const bf16* C;
  float* y;
  float* state;
  float* states;  // scratch [rows, chunks, p, n]: the chunks' own states
  float* decay;   // scratch [rows, chunks]
  float* cb;      // scratch [b * g, chunks, q, q]: C_i . B_j
  bf16* prev;     // scratch [2, rows, chunks, p, n]: entering states, split
  int h, g, rep, p, n, q, nc;
  View xs, dts, dAs, Bs, Cs, ys;
  // 16-byte copies: x rows (p % 8 == 0), B and C rows (n % 8 == 0), the
  // split state rows (n % 8 == 0) and C.B rows (q % 4 == 0)
  bool vx, vbc, vprev, vcb;
};

// CB[i][j] = C_i . B_j for one (batch, group) row, chunk and 64 x 64 tile
// (i0, j0) with j0 <= i0: once per group, not per head.
__global__ void __launch_bounds__(kTcThreads) ssd_cb(const Params a) {
  __shared__ __align__(16) bf16 Cs[kT][kLd];
  __shared__ __align__(16) bf16 Bsm[kT][kLd];
  int ti = 0, tj = blockIdx.x;
  while (tj > ti) tj -= ++ti;
  const int c = blockIdx.y, gr = blockIdx.z, warp = threadIdx.x >> 5;
  const int i0 = ti * kT, j0 = tj * kT;
  const long long pos0 = (long long)c * a.q;
  const bf16* C = a.C + row_offset(a.Cs, gr, a.g) + pos0 * a.Cs.sl;
  const bf16* B = a.B + row_offset(a.Bs, gr, a.g) + pos0 * a.Bs.sl;
  float acc[8][4] = {};
  for (int n0 = 0; n0 < a.n; n0 += kT) {
    fill<bf16, kT, kLd>(&Cs[0][0], C, a.Cs.sl, i0, a.q, n0, a.n, a.vbc);
    fill<bf16, kT, kLd>(&Bsm[0][0], B, a.Bs.sl, j0, a.q, n0, a.n, a.vbc);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    warp_gemm<8, false, false, kLd, kLd>(acc, &Cs[0][0], warp * 16,
                                         &Bsm[0][0]);
    __syncthreads();
  }
  float* out = a.cb + ((long long)gr * a.nc + c) * a.q * a.q;
  const int L = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + warp * 16 + L / 4 + 8 * (e / 2);
      const int j = j0 + 8 * nt + 2 * (L % 4) + e % 2;
      if (i < a.q && j < a.q) out[(long long)i * a.q + j] = acc[nt][e];
    }
}

// Shared memory of ssd_chunk_state_tc: two stages of raw tiles (x [j][pp],
// B [j][nn]) and the split operand B w.
struct StateSmem {
  float cum[kMaxChunk], w[kMaxChunk], tot[kWarps];
  struct {
    bf16 x[kT][kLd];
    bf16 b[kT][kLdW];
  } stage[2];
  bf16 hi[kT][kLdW], lo[kT][kLdW];
};

// The chunk's own state x^T (B w), w_j = exp(cum_last - cum_j) dt_j, with
// B w split; one block per (head row, chunk), in rounds of 64 positions
// (per 64 x 128 tile of the state), round r + 1 copied (cp.async) while
// round r is split and multiplied.
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_state_tc(const Params a) {
  extern __shared__ __align__(16) unsigned char smem_buf[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_buf);
  const int c = blockIdx.x, r = blockIdx.y, t = threadIdx.x;
  const int warp = t >> 5, L = t & 31;
  const long long pos0 = (long long)c * a.q;
  const bf16* x = a.x + row_offset(a.xs, r, a.h) + pos0 * a.xs.sl;
  const bf16* B = a.B + row_offset(a.Bs, r / a.rep, a.g) + pos0 * a.Bs.sl;
  float* out = a.states + ((long long)r * a.nc + c) * a.p * a.n;
  // round rd: state tile (m0, n0) = tile rd / kq, positions k0 = 64 (rd % kq)
  const int kq = (a.q + kT - 1) / kT, nt = (a.n + 2 * kT - 1) / (2 * kT);
  const int rounds = (a.p + kT - 1) / kT * nt * kq;
  auto issue = [&](int rd, int st) {
    const int tile = rd / kq, k0 = (rd % kq) * kT;
    fill<bf16, kT, kLd>(&sm.stage[st].x[0][0], x, a.xs.sl, k0, a.q,
                        (tile / nt) * kT, a.p, a.vx);
    fill<bf16, 2 * kT, kLdW>(&sm.stage[st].b[0][0], B, a.Bs.sl, k0, a.q,
                             (tile % nt) * 2 * kT, a.n, a.vbc);
  };
  issue(0, 0);
  cp_async_commit();
  const float* dA = a.dA + row_offset(a.dAs, r, a.h) + pos0 * a.dAs.sl;
  const float* dt = a.dt + row_offset(a.dts, r, a.h) + pos0 * a.dts.sl;
  chunk_cumsum(dA, a.dAs.sl, a.q, sm.cum, sm.tot);
  const float last = sm.cum[a.q - 1];
  for (int j = t; j < a.q; j += kTcThreads)
    sm.w[j] = expf(last - sm.cum[j]) * dt[j * a.dts.sl];
  if (t == 0) a.decay[(long long)r * a.nc + c] = expf(last);

  float acc[16][4] = {};
  for (int rd = 0; rd < rounds; ++rd) {
    const int st = rd & 1, k0 = (rd % kq) * kT;
    if (rd + 1 < rounds) issue(rd + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // round rd has landed
    __syncthreads();
    // B w, split; this thread takes columns k .. k + 7 of rows t / 16 + 8 it
    const int k = 8 * (t % 16);
#pragma unroll 2
    for (int it = 0; it < kT / 8; ++it) {
      const int j = t / 16 + 8 * it;
      const uint4 raw = *reinterpret_cast<const uint4*>(&sm.stage[st].b[j][k]);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
      const float wj = k0 + j < a.q ? sm.w[k0 + j] : 0.f;
#pragma unroll
      for (int e4 = 0; e4 < 8; e4 += 4) {
        const float m[4] = {__bfloat162float(v[e4]) * wj,
                            __bfloat162float(v[e4 + 1]) * wj,
                            __bfloat162float(v[e4 + 2]) * wj,
                            __bfloat162float(v[e4 + 3]) * wj};
        split4(m, &sm.hi[j][k + e4], &sm.lo[j][k + e4]);
      }
    }
    __syncthreads();
    warp_gemm<16, true, true, kLd, kLdW>(acc, &sm.stage[st].x[0][0],
                                         warp * 16, &sm.hi[0][0]);
    warp_gemm<16, true, true, kLd, kLdW>(acc, &sm.stage[st].x[0][0],
                                         warp * 16, &sm.lo[0][0]);
    if (rd % kq == kq - 1) {  // the tile's last positions: store it
      const int tile = rd / kq, m0 = (tile / nt) * kT;
      const int n0 = (tile % nt) * 2 * kT;
#pragma unroll
      for (int q8 = 0; q8 < 16; ++q8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pr = m0 + warp * 16 + L / 4 + 8 * (e / 2);
          const int nn = n0 + 8 * q8 + 2 * (L % 4) + e % 2;
          if (pr < a.p && nn < a.n) out[pr * a.n + nn] = acc[q8][e];
          acc[q8][e] = 0.f;
        }
    }
    __syncthreads();  // stage st and the split tile are free again
  }
}

// Shared memory of ssd_chunk_out_tc: two stages of raw tiles and the split
// operand.  A stage holds a bf16 tile (C or x) and a tile of f32 C.B, whose
// storage also holds the two bf16 halves of the entering state.
struct OutStage {
  bf16 a[kT][kLd];
  float f[kT][kLdF];
};
struct OutSmem {
  float cum[kMaxChunk], dts[kMaxChunk], tot[kWarps];
  OutStage stage[2];
  bf16 hi[kT][kLd], lo[kT][kLd];
};
static_assert(sizeof(float) * kT * kLdF == 2 * sizeof(bf16) * kT * kLd,
              "a stage's f32 tile holds two bf16 tiles");

// y for one (head row, chunk, 64-row query tile, 64-column tile of p), in
// rounds of 64 x 64 tiles, round r + 1 copied (cp.async) while round r is
// multiplied:
//   y_off rounds (n / 64): C [i][n] times the entering state [pp][n], split
//   by the scan, then each row scaled by exp(cum_i);
//   y_diag rounds (key tiles j0 <= i0): M_ij = CB_ij exp(cum_i - cum_j)
//   dt_j, split here (the exp taken only for j <= i), times x [j][pp].
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_out_tc(const Params a) {
  extern __shared__ __align__(16) unsigned char smem_buf[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_buf);
  const int qt = (a.q + kT - 1) / kT;
  const int i0 = (blockIdx.x % qt) * kT, p0 = (blockIdx.x / qt) * kT;
  const int c = blockIdx.y, r = blockIdx.z, t = threadIdx.x;
  const int warp = t >> 5, L = t & 31;
  const long long pos0 = (long long)c * a.q;
  const int grow = r / a.rep;
  const bf16* x = a.x + row_offset(a.xs, r, a.h) + pos0 * a.xs.sl;
  const bf16* C = a.C + row_offset(a.Cs, grow, a.g) + pos0 * a.Cs.sl;
  const long long pn = (long long)a.p * a.n;
  const bf16* prev_hi = a.prev + ((long long)r * a.nc + c) * pn;
  const bf16* prev_lo = prev_hi + (long long)gridDim.z * a.nc * pn;
  const float* cb = a.cb + ((long long)grow * a.nc + c) * a.q * a.q;
  const int n_off = (a.n + kT - 1) / kT, rounds = n_off + i0 / kT + 1;
  auto issue = [&](int rd, int st) {
    OutStage& g = sm.stage[st];
    bf16* halves = reinterpret_cast<bf16*>(&g.f[0][0]);
    if (rd < n_off) {
      const int n0 = rd * kT;
      fill<bf16, kT, kLd>(&g.a[0][0], C, a.Cs.sl, i0, a.q, n0, a.n, a.vbc);
      fill<bf16, kT, kLd>(halves, prev_hi, a.n, p0, a.p, n0, a.n, a.vprev);
      fill<bf16, kT, kLd>(halves + kT * kLd, prev_lo, a.n, p0, a.p, n0, a.n,
                      a.vprev);
    } else {
      const int j0 = (rd - n_off) * kT;
      fill<float, kT, kLdF>(&g.f[0][0], cb, a.q, i0, a.q, j0, a.q, a.vcb);
      fill<bf16, kT, kLd>(&g.a[0][0], x, a.xs.sl, j0, a.q, p0, a.p, a.vx);
    }
  };
  issue(0, 0);
  cp_async_commit();
  const float* dA = a.dA + row_offset(a.dAs, r, a.h) + pos0 * a.dAs.sl;
  const float* dt = a.dt + row_offset(a.dts, r, a.h) + pos0 * a.dts.sl;
  for (int j = t; j < a.q; j += kTcThreads) sm.dts[j] = dt[j * a.dts.sl];
  chunk_cumsum(dA, a.dAs.sl, a.q, sm.cum, sm.tot);

  float acc[8][4] = {};
  for (int rd = 0; rd < rounds; ++rd) {
    const int st = rd & 1;
    OutStage& g = sm.stage[st];
    if (rd + 1 < rounds) issue(rd + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // round rd has landed
    __syncthreads();
    if (rd < n_off) {
      const bf16* halves = reinterpret_cast<const bf16*>(&g.f[0][0]);
      warp_gemm<8, false, false, kLd, kLd>(acc, &g.a[0][0], warp * 16,
                                           halves);
      warp_gemm<8, false, false, kLd, kLd>(acc, &g.a[0][0], warp * 16,
                                           halves + kT * kLd);
    } else {
      if (rd == n_off) {  // y_off is complete: scale row i by exp(cum_i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + warp * 16 + L / 4 + 8 * (e / 2);
          const float s = i < a.q ? expf(sm.cum[i]) : 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) acc[nt][e] *= s;
        }
      }
      // M from C.B, split; this thread takes columns k .. k + 3 of rows
      // t / 16 + 8 it
      const int j0 = (rd - n_off) * kT, k = 4 * (t % 16);
      float cj[4], dj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = min(j0 + k + e, kMaxChunk - 1);
        cj[e] = sm.cum[j];
        dj[e] = sm.dts[j];
      }
#pragma unroll 2
      for (int it = 0; it < kT / 8; ++it) {
        const int rr = t / 16 + 8 * it, i = i0 + rr;
        const float4 v4 = *reinterpret_cast<const float4*>(&g.f[rr][k]);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        const float ci = sm.cum[min(i, kMaxChunk - 1)];
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + k + e;
          m[e] = (j <= i && i < a.q) ? v[e] * __expf(ci - cj[e]) * dj[e]
                                     : 0.f;
        }
        split4(m, &sm.hi[rr][k], &sm.lo[rr][k]);
      }
      __syncthreads();
      warp_gemm<8, false, true, kLd, kLd>(acc, &sm.hi[0][0], warp * 16,
                                          &g.a[0][0]);
      warp_gemm<8, false, true, kLd, kLd>(acc, &sm.lo[0][0], warp * 16,
                                          &g.a[0][0]);
    }
    __syncthreads();  // stage st and the split tile are free again
  }
  float* y = a.y + row_offset(a.ys, r, a.h) + pos0 * a.ys.sl;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + warp * 16 + L / 4 + 8 * (e / 2);
      const int pp = p0 + 8 * nt + 2 * (L % 4) + e % 2;
      if (i < a.q && pp < a.p) y[i * a.ys.sl + pp] = acc[nt][e];
    }
}

int launch(const Params& a, int b, int rows, cudaStream_t st) {
  const int qt = (a.q + kT - 1) / kT, pt = (a.p + kT - 1) / kT;
  ssd_cb<<<dim3(qt * (qt + 1) / 2, a.nc, b * a.g), kTcThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int state_smem = sizeof(StateSmem);
  err = cudaFuncSetAttribute(ssd_chunk_state_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_tc<<<dim3(a.nc, rows), kTcThreads, state_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pn = a.p * a.n;
  ssd_state_scan<<<dim3((pn + kThreads - 1) / kThreads, rows),
                   kThreads, 0, st>>>(a.states, a.decay, a.state, a.nc, pn,
                                      a.prev);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = sizeof(OutSmem);
  err = cudaFuncSetAttribute(ssd_chunk_out_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out_tc<<<dim3(qt * pt, a.nc, rows), kTcThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T>
int launch(const Params<T>& a, int rows, cudaStream_t st) {
  const dim3 grid(a.nc, rows);
  ssd_chunk_state<T><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pn = a.p * a.n;
  ssd_state_scan<<<dim3((pn + kThreads - 1) / kThreads, rows), kThreads, 0,
                   st>>>(a.states, a.decay, a.state, a.nc, pn, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out<T><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Fill the fields that both routes' parameter blocks share.
template <typename P, typename T>
void fill_params(P& a, const void* x, const float* dt, const float* dA,
          const void* B, const void* C, float* y, float* state, float* states,
          float* decay, int h, int g, int l, int p, int n, int q,
          const long long* s) {
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
}

}  // namespace

// x [b, h, l, p], B and C [b, g, l, n] (dtype 0 float32: the f32-core
// launches; 1 bfloat16: the tensor-core launches); dt, dA [b, h, l] f32;
// y [b, h, l, p] f32 -- each through the 3 strides (batch, head, position)
// in `strides` (x, dt, dA, B, C, y in that order, 18 values, elements; the
// last dimension of x, B, C, y contiguous).  state: [b * h, p, n] f32
// contiguous.  states [b * h, l / chunk, p, n] and decay [b * h, l / chunk]
// are f32 scratch; for bf16 so are cb [b * g, l / chunk, chunk, chunk]
// f32 and prev [2, b * h, l / chunk, p, n] bf16 (both may be null for
// f32).  *route (if not null) is set to 1 for the tensor-core launches, 0
// for the f32-core ones.  Returns a cudaError_t code.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* dA, const void* B, const void* C,
                               float* y, float* state, float* states,
                               float* decay, int dtype, int b, int h, int g,
                               int l, int p, int n, int chunk,
                               const long long* strides, void* stream,
                               float* cb, void* prev, int* route) {
  if (b <= 0 || h <= 0 || g <= 0 || h % g != 0 || p <= 0 || n <= 0 ||
      chunk <= 0 || chunk > kMaxChunk || l <= 0 || l % chunk != 0 ||
      b * h > 65535 || b * g > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != nullptr) *route = dtype == 1 ? 1 : 0;
  if (dtype == 0) {
    Params<float> a;
    fill_params<Params<float>, float>(a, x, dt, dA, B, C, y, state, states,
                                      decay, h, g, l, p, n, chunk, strides);
    return launch(a, b * h, st);
  }
  if (dtype == 1 && cb != nullptr && prev != nullptr) {
    tc::Params a;
    fill_params<tc::Params, __nv_bfloat16>(a, x, dt, dA, B, C, y, state,
                                           states, decay, h, g, l, p, n,
                                           chunk, strides);
    a.cb = cb;
    a.prev = static_cast<__nv_bfloat16*>(prev);
    const auto rows16 = [](const void* ptr, const View& v) {
      return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && v.sb % 8 == 0 &&
             v.sh % 8 == 0 && v.sl % 8 == 0;
    };
    a.vx = rows16(x, a.xs) && p % 8 == 0;
    a.vbc = rows16(B, a.Bs) && rows16(C, a.Cs) && n % 8 == 0;
    a.vprev = n % 8 == 0;
    a.vcb = chunk % 4 == 0;
    return tc::launch(a, b, b * h, st);
  }
  return (int)cudaErrorInvalidValue;
}
