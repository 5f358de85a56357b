"""Kth-free-time select: the CUDA kernel's wrapper and its plain torch twin.

The scheduler asks, for every system of every grid lane, when ``n_req``
of its nodes are simultaneously free: the ``n_req``-th smallest entry of
the node-free row.  Both versions map f32 times to order-preserving
uint32 keys, and the selected key is an element of the input, so both
are bit-exact against the sort oracle (``ref.py``).

``kth_free_cuda`` launches ``csrc/kth_free.cu`` and only takes CUDA
tensors: rows of up to 256 nodes go to a rank-by-comparison kernel (one
block per row), wider rows to a warp-per-row bit walk.
``radix_select_kth`` walks the 32 bits MSB -> LSB in plain torch ops,
counting at each bit the candidates whose bit is 0 and descending into
the half that holds rank k; it runs on CPU tensors and, on the card,
only when ``force="torch"`` asks for it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_M32 = 0xFFFFFFFF


def _f32_to_ordered_u32(x):
    """Order-preserving bijection f32 -> uint32 (held in int64): flip the
    sign bit of positives, every bit of negatives."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where(b >> 31 == 1, ~b & _M32, b | 0x80000000)


def _ordered_u32_to_f32(u):
    b = torch.where(u >> 31 == 1, u & 0x7FFFFFFF, ~u & _M32)
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def radix_select_kth(node_free, n_req):
    """Plain torch radix select.  node_free: [..., S, maxN] f32; n_req:
    [..., S] int.  Returns [..., S] f32: per row the n_req-th smallest
    value (1-indexed, clipped to [1, maxN])."""
    n = node_free.shape[-1]
    u = _f32_to_ordered_u32(node_free)
    k = n_req.to(torch.int64).clamp(1, n)
    active = torch.ones_like(u, dtype=torch.bool)
    val = torch.zeros_like(k)
    for i in range(32):
        shift = 31 - i
        bit = (u >> shift) & 1
        zeros = (active & (bit == 0)).sum(-1)
        go_one = k > zeros
        val = val | (go_one.to(torch.int64) << shift)
        active = active & (bit == go_one.to(torch.int64).unsqueeze(-1))
        k = torch.where(go_one, k - zeros, k)
    return _ordered_u32_to_f32(val)


_launch = None


def _lib():
    global _launch
    if _launch is None:
        _launch = _build.function("kth_free", "kth_free_launch", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    return _launch


def kth_free_cuda(node_free, n_req):
    """Launch the CUDA kth-free kernel.  node_free: [..., S, maxN] f32
    CUDA tensor; n_req: [..., S] int32 on the same device.  Returns
    [..., S] f32 on the caller's current stream (no synchronisation).
    Counts each launch in ``kth_free_cuda.launches``."""
    if not node_free.is_cuda:
        raise ValueError("kth_free_cuda takes CUDA tensors; use "
                         "radix_select_kth for CPU tensors")
    if node_free.dtype != torch.float32 or n_req.dtype != torch.int32:
        raise TypeError(f"kth_free_cuda takes float32 node_free and int32 "
                        f"n_req, got {node_free.dtype} and {n_req.dtype}")
    dev = node_free.get_device()
    if n_req.get_device() != dev:
        raise ValueError("node_free and n_req must share a device")
    if n_req.shape != node_free.shape[:-1]:
        raise ValueError(f"n_req shape {tuple(n_req.shape)} must be "
                         f"node_free's leading shape "
                         f"{tuple(node_free.shape[:-1])}")
    n = node_free.shape[-1]
    if n < 1:
        raise ValueError("node_free needs at least one node column")
    free = node_free if node_free.is_contiguous() else node_free.contiguous()
    nreq = n_req if n_req.is_contiguous() else n_req.contiguous()
    out = torch.empty_like(nreq, dtype=torch.float32)
    rows = out.numel()
    if rows == 0:
        return out
    fn = _launch or _lib()
    err = _build.launch(dev, lambda stream: fn(
        free.data_ptr(), nreq.data_ptr(), out.data_ptr(), rows, n, stream))
    if err != 0:
        raise RuntimeError(f"kth_free kernel launch failed: CUDA error "
                           f"{err}")
    kth_free_cuda.launches += 1
    return out


kth_free_cuda.launches = 0
