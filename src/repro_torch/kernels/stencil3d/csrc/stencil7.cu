// 7-point 3D stencil for Hopper (sm_90a): the BT/SP/LU right-hand side.
//
// Replaces the TPU kernel `stencil7_pallas`
// (src/repro/kernels/stencil3d/kernel.py, body `_stencil_kernel`):
// out = coef_c * u + coef_n * (sum of the 6 face neighbours) over an
// [nx, ny, nz] f32 grid, with zero Dirichlet boundaries (a neighbour outside
// the grid contributes 0).
//
// Design: one thread per output point, z fastest, so a warp reads 32
// neighbouring floats of each of the 7 input rows it needs; the neighbours
// come from device memory through L1/L2, where the rows that neighbouring
// warps share are reused.  (The TPU kernel held an x-slab and its two halo
// slabs in VMEM; a Hopper block has no such room and needs no explicit
// halo.)  The sum is taken in the reference's order,
// coef_c*u + coef_n*(((((up + dn) + yp) + ym) + zp) + zm), with
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into a fused
// multiply-add: the kernel equals the plain torch version bit for bit.
//
// Bound: each point is read once and written once: 8 * nx*ny*nz bytes,
// 0.63 us for the 64^3 grid of class A at an H100 SXM's published
// 3.35 TB/s (700 W limit).  The 8 f32 operations per point (6 adds, 2
// multiplies) take less at its 67 TFLOP/s, so bytes bound it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stencil7(const float* __restrict__ u, float* __restrict__ out, int nx, int ny,
         int nz, float coef_c, float coef_n) {
  const long long total = (long long)nx * ny * nz;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long plane = (long long)ny * nz;
  const int k = (int)(idx % nz);
  const long long r = idx / nz;
  const int j = (int)(r % ny);
  const int i = (int)(r / ny);
  const float c = u[idx];
  const float up = i > 0 ? u[idx - plane] : 0.0f;
  const float dn = i < nx - 1 ? u[idx + plane] : 0.0f;
  const float yp = j < ny - 1 ? u[idx + nz] : 0.0f;
  const float ym = j > 0 ? u[idx - nz] : 0.0f;
  const float zp = k < nz - 1 ? u[idx + 1] : 0.0f;
  const float zm = k > 0 ? u[idx - 1] : 0.0f;
  float s = __fadd_rn(up, dn);
  s = __fadd_rn(s, yp);
  s = __fadd_rn(s, ym);
  s = __fadd_rn(s, zp);
  s = __fadd_rn(s, zm);
  out[idx] = __fadd_rn(__fmul_rn(coef_c, c), __fmul_rn(coef_n, s));
}

}  // namespace

// C interface (loaded with ctypes).  u, out: [nx, ny, nz] f32 contiguous
// device memory, not overlapping.  stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch.
extern "C" int stencil7_launch(const float* u, float* out, int nx, int ny,
                               int nz, float coef_c, float coef_n,
                               void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nx * ny * nz;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stencil7<<<(unsigned)blocks, kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(u, out, nx, ny, nz, coef_c,
                                                  coef_n);
  return (int)cudaGetLastError();
}
