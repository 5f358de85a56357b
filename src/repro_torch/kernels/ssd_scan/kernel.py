"""SSD chunk-scan kernel: the CUDA wrapper.

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu`` on CUDA tensors and counts
its calls; the plain versions for CPU tensors are in ``ref.py``.  One call
is several kernel launches from one C entry and counts once: for f32
inputs three on the f32 cores (the chunks' own states, the scan over
chunks, the outputs), for bf16 inputs four on the tensor cores (C.B once
per group and chunk, then the same three).
``ssd_scan_cuda.last_route`` says which ran last.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the longest chunk the kernel takes (its per-chunk cumsum is one block)
MAX_CHUNK = 256
#: the C entry's route codes
ROUTES = ("f32-core", "tensor-core")
#: kernel launches per call, by route
LAUNCHES_PER_CALL = {"f32-core": 3, "tensor-core": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    i, p = ctypes.c_int, ctypes.c_void_p
    return _build.function("ssd_scan", "ssd_scan_launch", [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p,
        ctypes.POINTER(i)])


def _head_major(t, flat: bool):
    """``t`` as a head-major view ([b, h, l, ...]) from the flat layout
    ([bh, l, ...]: one batch of bh heads) or the model layout
    ([b, l, h, ...])."""
    return t[None] if flat else t.transpose(1, 2)


def _check(x, dt, dA, B, C, chunk):
    """Refuse what the kernel does not take; returns the inputs as
    head-major views."""
    for name, t in (("x", x), ("dt", dt), ("dA", dA), ("B", B), ("C", C)):
        if not t.is_cuda:
            raise ValueError(f"ssd_scan_cuda takes CUDA tensors ({name} is "
                             f"on {t.device}); use the plain versions in "
                             f"ref.py for CPU tensors")
        if t.device != x.device:
            raise ValueError("x, dt, dA, B and C must be on one device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan_cuda takes float32 or bfloat16 x, B, C of "
                        f"one dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or dA.dtype != torch.float32:
        raise TypeError(f"dt and dA must be float32, got {dt.dtype}, "
                        f"{dA.dtype}")
    if x.dim() not in (3, 4) or B.dim() != x.dim() or C.shape != B.shape:
        raise ValueError(f"x [bh, l, p] with B, C [bg, l, n], or x "
                         f"[b, l, h, p] with B, C [b, l, g, n]; got x "
                         f"{tuple(x.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if dt.shape != x.shape[:-1] or dA.shape != dt.shape:
        raise ValueError(f"dt and dA must be x's shape without its last "
                         f"dimension, got dt {tuple(dt.shape)}, dA "
                         f"{tuple(dA.shape)}, x {tuple(x.shape)}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension, got "
                             f"strides {t.stride()}")
    views = [_head_major(t, x.dim() == 3) for t in (x, dt, dA, B, C)]
    b, h, l, _ = views[0].shape
    bv = views[3]
    g = bv.shape[1]
    if bv.shape[0] != b or bv.shape[2] != l or g < 1 or h % g:
        raise ValueError(f"B, C must match x's batch and length, with "
                         f"heads a multiple of groups; got x "
                         f"{tuple(x.shape)}, B {tuple(B.shape)}")
    if min(x.shape) < 1 or b * h > 65535:
        raise ValueError(f"need non-empty inputs and at most 65,535 head "
                         f"rows, got x {tuple(x.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk:
        raise ValueError(f"chunk must divide l and lie in 1..{MAX_CHUNK}, "
                         f"got chunk {chunk}, l {l}")
    return views


def ssd_scan_cuda(x, dt, dA, B, C, *, chunk: int = 256):
    """Launch the CUDA kernel on the flat layout (x [bh, l, p], dt/dA
    [bh, l], B/C [bg, l, n], head row i reading B/C row i // (bh / bg)) or
    the model layout (x [b, l, h, p], dt/dA [b, l, h], B/C [b, l, g, n]).
    x, B, C: f32 or bf16 CUDA tensors of one dtype with a contiguous last
    dimension, read in place through their other strides; dt, dA: f32,
    any strides.  ``chunk`` is clipped to l.  Returns (y f32 in x's layout,
    final state f32 [bh, p, n] or [b, h, p, n]) on the caller's current
    stream (no synchronisation).  bf16 inputs take the tensor-core route
    (with scratch for C.B, [b, g, l / chunk, chunk, chunk] f32, and for the
    split entering states, [2, b h, l / chunk, p, n] bf16), f32 inputs the
    f32-core one.  Counts each call in
    ``ssd_scan_cuda.launches`` and records the route in
    ``ssd_scan_cuda.last_route``."""
    chunk = min(chunk, x.shape[1])
    xv, dtv, dAv, bv, cv = _check(x, dt, dA, B, C, chunk)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    yv = _head_major(y, x.dim() == 3)
    b, h, l, p = xv.shape
    g, n = bv.shape[1], bv.shape[3]
    nc = l // chunk
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = torch.empty((b * h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((b * h, nc), dtype=torch.float32, device=x.device)
    cb = prev = None
    if x.dtype == torch.bfloat16:
        cb = torch.empty((b, g, nc, chunk, chunk), dtype=torch.float32,
                         device=x.device)
        prev = torch.empty((2, b * h, nc, p, n), dtype=torch.bfloat16,
                           device=x.device)
    strides = (ctypes.c_longlong * 18)(*(
        s for t in (xv, dtv, dAv, bv, cv, yv) for s in t.stride()[:3]))
    launch = _lib()
    route = ctypes.c_int(-1)
    err = _build.launch(x.get_device(), lambda stream: launch(
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), states.data_ptr(),
        decay.data_ptr(), _DTYPES[x.dtype], b, h, g, l, p, n, chunk,
        strides, stream, None if cb is None else cb.data_ptr(),
        None if prev is None else prev.data_ptr(), ctypes.byref(route)))
    if err != 0:
        raise RuntimeError(f"ssd scan kernel launch failed: CUDA error {err}")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.last_route = ROUTES[route.value]
    return y, (state.reshape(b * h, p, n) if x.dim() == 3 else state)


ssd_scan_cuda.launches = 0
ssd_scan_cuda.last_route = None
