"""EP Gaussian-pair kernel: the CUDA wrappers.

``ep_pass_cuda`` launches ``csrc/ep.cu`` over a whole draw pass
(``[nb, 2, n]`` uniforms) and adds each batch into f32 carries in batch
order; ``ep_pairs_cuda`` is the same launch for one ``[2, n]`` batch with
the carry taken as zero (the kernel reads no carry, so nothing is
zeroed).  Both take CUDA tensors only; the plain versions for CPU tensors
are ``ref.ep_pass_ref`` and ``ref.ep_pairs_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ep.ref import N_ANNULI

#: threads per block and the most blocks per batch (the kernel strides
#: over a batch's pairs, and its partials are summed in one fixed-order
#: pass)
THREADS = 256
MAX_BLOCKS = 512


def _pairs_per_thread(u):
    """Pairs a thread takes per step over u [nb, 2, n]: 8 (two 16-byte
    loads per row) when the call has 2^20 pairs or more, enough to fill the
    card at 8 a thread, and its rows allow 16-byte loads (n % 4 == 0, u
    16-byte aligned); else 1."""
    nb, n = u.shape[0], u.shape[2]
    wide = nb * n >= 1 << 20 and n % 4 == 0 and u.data_ptr() % 16 == 0
    return 8 if wide else 1


_launch = None


def _lib():
    global _launch
    if _launch is None:
        _launch = _build.function("ep", "ep_pairs_launch", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return _launch


def _launch_pass(u, hist, sums, zero_carry):
    """One call of the C entry over u [nb, 2, n], counted in
    ``ep_pass_cuda.launches`` (from either wrapper)."""
    if u.dtype != torch.float32:
        raise TypeError(f"the ep kernel takes float32, got {u.dtype}")
    if not u.is_contiguous():
        u = u.contiguous()
    nb, n = u.shape[0], u.shape[2]
    ppt = _pairs_per_thread(u)
    blocks = min(MAX_BLOCKS, -(-n // (THREADS * ppt)))
    partial = torch.empty((nb * blocks, N_ANNULI + 2), dtype=torch.float64,
                          device=u.device)
    fn = _launch or _lib()
    err = _build.launch(u.get_device(), lambda stream: fn(
        u.data_ptr(), nb, n, partial.data_ptr(), blocks, ppt,
        hist.data_ptr(), sums.data_ptr(), int(zero_carry), stream))
    if err != 0:
        raise RuntimeError(f"ep kernel launch failed: CUDA error {err}")
    ep_pass_cuda.launches += 1
    return hist, sums


def ep_pass_cuda(u, hist, sums):
    """Launch the CUDA EP kernel over a draw pass.  u: [nb, 2, n] f32 CUDA
    tensor, nb, n >= 1; hist [10] and sums [2]: f32 carries on the same
    device.  Adds the nb batches into the carries in place, batch by batch
    as the reference's f32 carry does, and returns them.  Runs on the
    caller's current stream (no synchronisation).  Counts each call of the
    C entry in ``ep_pass_cuda.launches``."""
    if not u.is_cuda:
        raise ValueError("ep_pass_cuda takes CUDA tensors; use ep_pass_ref "
                         "for CPU tensors")
    if u.dim() != 3 or u.shape[0] < 1 or u.shape[1] != 2 or u.shape[2] < 1:
        raise ValueError(f"u must be [nb, 2, n] with nb, n >= 1, got "
                         f"{tuple(u.shape)}")
    for name, t, size in (("hist", hist, N_ANNULI), ("sums", sums, 2)):
        if (not t.is_cuda or t.device != u.device or t.dtype != torch.float32
                or t.shape != (size,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{size}] float32 "
                             f"tensor on u's CUDA device")
    return _launch_pass(u, hist, sums, zero_carry=False)


ep_pass_cuda.launches = 0


def ep_pairs_cuda(u):
    """The CUDA EP kernel on one batch, from a zero carry.  u: [2, n] f32
    CUDA tensor, n >= 1.  Returns (hist [10] f32, sums [2] f32) on the
    caller's current stream; counted in ``ep_pass_cuda.launches``."""
    if not u.is_cuda:
        raise ValueError("ep_pairs_cuda takes CUDA tensors; use "
                         "ep_pairs_ref for CPU tensors")
    if u.dim() != 2 or u.shape[0] != 2 or u.shape[1] < 1:
        raise ValueError(f"u must be [2, n] with n >= 1, got "
                         f"{tuple(u.shape)}")
    hist = torch.empty(N_ANNULI, dtype=torch.float32, device=u.device)
    sums = torch.empty(2, dtype=torch.float32, device=u.device)
    return _launch_pass(u.unsqueeze(0), hist, sums, zero_carry=True)
