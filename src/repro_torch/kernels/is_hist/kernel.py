"""IS key-histogram kernel: the CUDA wrapper.

``key_histogram_cuda`` launches ``csrc/is_hist.cu`` on a CUDA tensor and
counts its launches; the plain version for CPU tensors is
``ref.key_histogram_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the largest bucket count the kernel keeps in shared memory (48 KB of
#: uint32 counts); above it the kernel adds straight into device memory
SMEM_BUCKETS = 48 * 1024 // 4


_launch = None


def _lib():
    global _launch
    if _launch is None:
        _launch = _build.function("is_hist", "key_histogram_launch", [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p])
    return _launch


def key_histogram_cuda(keys, *, n_buckets: int, bucket_shift: int):
    """Launch the CUDA histogram kernel.  keys: [n] int32 CUDA tensor;
    1 <= n_buckets < 2**31; 0 <= bucket_shift <= 31.  Returns
    [n_buckets] f32 on the caller's current stream (no synchronisation).
    Counts each call in ``key_histogram_cuda.launches``."""
    if not keys.is_cuda:
        raise ValueError("key_histogram_cuda takes a CUDA tensor; use "
                         "key_histogram_ref for CPU tensors")
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError(f"keys must be a 1-D int32 tensor, got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    if not 1 <= n_buckets < 2 ** 31:
        raise ValueError(f"n_buckets must be in [1, 2**31), got {n_buckets}")
    if not 0 <= bucket_shift <= 31:
        raise ValueError(f"bucket_shift must be in [0, 31], got "
                         f"{bucket_shift}")
    k = keys if keys.is_contiguous() else keys.contiguous()
    out = k.new_empty(n_buckets, dtype=torch.float32)
    fn = _launch or _lib()
    err = _build.launch(k.get_device(), lambda stream: fn(
        k.data_ptr(), k.shape[0], n_buckets, bucket_shift, out.data_ptr(),
        stream))
    if err != 0:
        raise RuntimeError(f"is_hist kernel launch failed: CUDA error {err}")
    key_histogram_cuda.launches += 1
    return out


key_histogram_cuda.launches = 0
