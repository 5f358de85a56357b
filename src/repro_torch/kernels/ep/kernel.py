"""EP Gaussian-pair kernel: the CUDA wrapper.

``ep_pairs_cuda`` launches ``csrc/ep.cu`` on a CUDA tensor and counts its
launches; the plain version for CPU tensors is ``ref.ep_pairs_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ep.ref import N_ANNULI

#: threads per block and the most blocks one call uses (the kernel strides
#: over the pairs, and its partials are summed in one fixed-order pass)
THREADS = 256
MAX_BLOCKS = 1024


def _lib():
    return _build.function("ep", "ep_pairs_launch", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def ep_pairs_cuda(u):
    """Launch the CUDA EP kernel.  u: [2, n] f32 CUDA tensor, n >= 1.
    Returns (hist [10] f32, sums [2] f32) on the caller's current stream
    (no synchronisation).  Counts each call in ``ep_pairs_cuda.launches``."""
    if not u.is_cuda:
        raise ValueError("ep_pairs_cuda takes a CUDA tensor; use "
                         "ep_pairs_ref for CPU tensors")
    if u.dtype != torch.float32:
        raise TypeError(f"ep_pairs_cuda takes float32, got {u.dtype}")
    if u.dim() != 2 or u.shape[0] != 2 or u.shape[1] < 1:
        raise ValueError(f"u must be [2, n] with n >= 1, got "
                         f"{tuple(u.shape)}")
    u = u.contiguous()
    n = u.shape[1]
    blocks = min(MAX_BLOCKS, -(-n // THREADS))
    partial = torch.empty((blocks, N_ANNULI + 2), dtype=torch.float64,
                          device=u.device)
    hist = torch.empty(N_ANNULI, dtype=torch.float32, device=u.device)
    sums = torch.empty(2, dtype=torch.float32, device=u.device)
    launch = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = launch(u.data_ptr(), n, partial.data_ptr(), blocks,
                     hist.data_ptr(), sums.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ep kernel launch failed: CUDA error {err}")
    ep_pairs_cuda.launches += 1
    return hist, sums


ep_pairs_cuda.launches = 0
