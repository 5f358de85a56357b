"""7-point stencil kernel: the CUDA wrapper.

``stencil7_cuda`` launches ``csrc/stencil7.cu`` on a CUDA tensor and
counts its launches; the plain version for CPU tensors is
``ref.stencil7_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


_launch = None


def _lib():
    global _launch
    if _launch is None:
        _launch = _build.function("stencil7", "stencil7_launch", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return _launch


def stencil7_cuda(u, *, coef_c: float = -6.0, coef_n: float = 1.0):
    """Launch the CUDA stencil.  u: [nx, ny, nz] f32 CUDA tensor.  Returns
    the stencil applied to u, on the caller's current stream (no
    synchronisation).  ``coef_c``/``coef_n`` are rounded to f32, as the
    plain version's scalar products round them.  Counts each call in
    ``stencil7_cuda.launches``."""
    if not u.is_cuda:
        raise ValueError("stencil7_cuda takes a CUDA tensor; use "
                         "stencil7_ref for CPU tensors")
    if u.dtype != torch.float32:
        raise TypeError(f"stencil7_cuda takes float32, got {u.dtype}")
    if u.dim() != 3 or min(u.shape) < 1:
        raise ValueError(f"u must be a non-empty [nx, ny, nz] grid, got "
                         f"{tuple(u.shape)}")
    if not u.is_contiguous():
        u = u.contiguous()
    out = torch.empty_like(u)
    nx, ny, nz = u.shape
    fn = _launch or _lib()
    err = _build.launch(u.get_device(), lambda stream: fn(
        u.data_ptr(), out.data_ptr(), nx, ny, nz, coef_c, coef_n, stream))
    if err != 0:
        raise RuntimeError(f"stencil7 kernel launch failed: CUDA error {err}")
    stencil7_cuda.launches += 1
    return out


stencil7_cuda.launches = 0
