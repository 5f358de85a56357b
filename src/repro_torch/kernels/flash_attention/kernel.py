"""Flash attention kernel: the CUDA wrapper.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` on CUDA
tensors and counts its launches; the plain versions for CPU tensors are
in ``ref.py``.  The C entry picks the kernel from its arguments: bf16
inputs at head dims 64, 96 and 128 with 16-byte aligned rows go to the
tensor-core kernel, everything else to the f32-core one
(``flash_attention_cuda.last_route`` says which ran last).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 96, 128, 256)
#: the C entry's route codes
ROUTES = ("f32-core", "tensor-core")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    return _build.function("flash_attention", "flash_attention_launch", [
        p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll,
        i, ctypes.c_float, p, ctypes.POINTER(i)])


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors ({name} "
                             f"is on {t.device}); use the plain versions in "
                             f"ref.py for CPU tensors")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 "
                            f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous last "
                             f"dimension, got shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k, v must be [b, sk, kv, hd] with q's b and hd, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    kv, sk = k.shape[2], k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if min(b, sq, sk, kv) < 1 or h % kv:
        raise ValueError(f"need non-empty inputs and h % kv == 0, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch the CUDA kernel.  q: [b, sq, h, hd]; k, v: [b, sk, kv, hd];
    f32 or bf16 CUDA tensors with a contiguous last dimension, read in
    place through their other strides.  Causal is top-left: query i sees
    keys 0..i.  Returns [b, sq, h, hd] in q's dtype on the caller's
    current stream (no synchronisation).  Counts each call in
    ``flash_attention_cuda.launches`` and records the kernel that ran in
    ``flash_attention_cuda.last_route`` (one of ``ROUTES``)."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    launch = _lib()
    route = ctypes.c_int(-1)
    err = _build.launch(q.get_device(), lambda stream: launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, sq, sk, h, kv, hd, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], int(causal), hd ** -0.5, stream,
        ctypes.byref(route)))
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.last_route = ROUTES[route.value]
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.last_route = None
