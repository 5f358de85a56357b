// 7-point 3D stencil for Hopper (sm_90a): the BT/SP/LU right-hand side.
//
// Replaces the TPU kernel `stencil7_pallas`
// (src/repro/kernels/stencil3d/kernel.py, body `_stencil_kernel`):
// out = coef_c * u + coef_n * (sum of the 6 face neighbours) over an
// [nx, ny, nz] f32 grid, with zero Dirichlet boundaries (a neighbour outside
// the grid contributes 0).
//
// Bound: each point is read once and written once: 8 * nx*ny*nz bytes,
// 0.63 us for the 64^3 grid of class A at an H100 SXM's published
// 3.35 TB/s (700 W limit).  The 8 f32 operations per point (6 adds, 2
// multiplies) take less at its 67 TFLOP/s, so bytes bound it.  At 64^3 the
// bound is half the launch floor, so what the call pays is the launch and
// the longest chain of dependent memory operations in a thread.
//
// Design.  A block of 32 x 8 threads owns a tile of 32 z by 8 y and a chunk
// of 4 x planes; blocks tile (z, y, x chunk) in a 3-D launch, so no thread
// divides an index (64^3: 256 blocks of 256 threads).  Each thread marches
// along x down its (y, z) column: it loads its column's 6 values (the chunk
// and one plane either side) and keeps them in registers, so u[i-1], u[i]
// and u[i+1] cost 1.5 loads a point.  The y and z neighbours come from
// shared memory: the first and last warps also load the y halo rows, the
// first and last lanes the z halo columns.  A thread issues all its loads
// before it stores any value into the tile, so that they are in flight
// together (a halo load followed by its store, in turn, costs an L2 round
// trip each); then one barrier, and each thread reads four neighbours a
// point from the tile.
// A value outside the grid is stored as 0, which is the Dirichlet
// boundary at every tile and chunk edge, so any shape takes the same path.
// The sum is taken in the reference's order,
// coef_c*u + coef_n*(((((up + dn) + yp) + ym) + zp) + zm), with
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into a fused
// multiply-add: the kernel equals the plain torch version bit for bit.
// (The TPU kernel held an x-slab and its two halo slabs in VMEM.)

#include <cuda_runtime.h>

namespace {

constexpr int kTz = 32;                  // z per tile: a warp's row
constexpr int kTy = 8;                   // y rows per tile: a warp each
constexpr int kXc = 4;                   // x planes per thread
constexpr int kThreads = kTz * kTy;
constexpr int kMaxGrid = 65535;          // gridDim.y / gridDim.z limit

__global__ void __launch_bounds__(kThreads)
stencil7_march(const float* __restrict__ u, float* __restrict__ out, int nx,
               int ny, int nz, float coef_c, float coef_n) {
  // s[q][y + 1][z + 1]: plane x0 + q of the tile with its y and z halo
  __shared__ float s[kXc][kTy + 2][kTz + 2];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int k = blockIdx.x * kTz + tz;
  const long long plane = (long long)ny * nz;
  const int ny_tiles = (ny - 1) / kTy + 1, nx_chunks = (nx - 1) / kXc + 1;
  // the z halo: lane 0 reads z0 - 1, lane 31 z0 + 32, in one load
  const int kh = tz == 0 ? k - 1 : (tz == kTz - 1 ? k + 1 : -1);
  const int hz = tz == 0 ? 0 : kTz + 1;
  const bool k_in = k < nz, kh_in = kh >= 0 && kh < nz;
  // the y halo: warp 0 reads row y0 - 1, the last warp row y0 + kTy
  const int dy = ty == 0 ? -1 : (ty == kTy - 1 ? 1 : 0);
  const int hy = ty == 0 ? 0 : kTy + 1;
  for (int xc = blockIdx.z; xc < nx_chunks; xc += gridDim.z) {
    for (int yt = blockIdx.y; yt < ny_tiles; yt += gridDim.y) {
      const int x0 = xc * kXc, j = yt * kTy + ty;
      const bool in = k_in && j < ny;
      const long long at = ((long long)x0 * ny + j) * nz + k;  // (x0, j, k)
      float col[kXc + 2];                  // planes x0 - 1 .. x0 + kXc
#pragma unroll
      for (int q = 0; q < kXc + 2; ++q) {
        const int x = x0 - 1 + q;
        col[q] = in && x >= 0 && x < nx ? __ldg(u + at + (q - 1) * plane)
                                        : 0.0f;
      }
      // the halo values, loaded before any is stored so that every load of
      // the thread is in flight at once
      const int jh = j + dy;
      const bool yh_in = dy != 0 && k_in && jh >= 0 && jh < ny;
      const bool zh_in = kh_in && j < ny;
      float yh[kXc], zh[kXc];
#pragma unroll
      for (int q = 0; q < kXc; ++q) {
        const bool x_in = x0 + q < nx;
        yh[q] = yh_in && x_in ? __ldg(u + at + q * plane + dy * nz) : 0.0f;
        zh[q] = zh_in && x_in ? __ldg(u + at + q * plane + (kh - k)) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kXc; ++q) {
        s[q][ty + 1][tz + 1] = col[q + 1];
        if (dy != 0) s[q][hy][tz + 1] = yh[q];
        if (tz == 0 || tz == kTz - 1) s[q][ty + 1][hz] = zh[q];
      }
      __syncthreads();
      if (in) {
#pragma unroll
        for (int q = 0; q < kXc; ++q) {
          if (x0 + q >= nx) continue;
          float sum = __fadd_rn(col[q], col[q + 2]);        // up + dn
          sum = __fadd_rn(sum, s[q][ty + 2][tz + 1]);       // + yp
          sum = __fadd_rn(sum, s[q][ty][tz + 1]);           // + ym
          sum = __fadd_rn(sum, s[q][ty + 1][tz + 2]);       // + zp
          sum = __fadd_rn(sum, s[q][ty + 1][tz]);           // + zm
          out[at + q * plane] =
              __fadd_rn(__fmul_rn(coef_c, col[q + 1]), __fmul_rn(coef_n, sum));
        }
      }
      __syncthreads();                     // the tile is reused
    }
  }
}

}  // namespace

// C interface (loaded with ctypes).  u, out: [nx, ny, nz] f32 contiguous
// device memory, not overlapping.  stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch.
extern "C" int stencil7_launch(const float* u, float* out, int nx, int ny,
                               int nz, float coef_c, float coef_n,
                               void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
  const int ny_tiles = (ny - 1) / kTy + 1, nx_chunks = (nx - 1) / kXc + 1;
  const dim3 grid((nz - 1) / kTz + 1,
                  ny_tiles < kMaxGrid ? ny_tiles : kMaxGrid,
                  nx_chunks < kMaxGrid ? nx_chunks : kMaxGrid);
  stencil7_march<<<grid, dim3(kTz, kTy), 0,
                   static_cast<cudaStream_t>(stream)>>>(u, out, nx, ny, nz,
                                                        coef_c, coef_n);
  return (int)cudaGetLastError();
}
