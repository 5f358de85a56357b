"""Dispatch for the SSD chunk-scan kernel (modes in
``repro_torch.kernels.modes``: ``cuda`` for CUDA tensors, ``torch`` for
CPU ones).

Two layouts: the reference's flat one (x [bh, l, p], dt/dA [bh, l], B/C
[bg, l, n]) and the model's (x [b, l, h, p], dt/dA [b, l, h], B/C
[b, l, g, n]), told apart by x's rank.  The ``torch`` mode runs
``ssd_scan_ref`` on the first and ``ssd_chunked_dA`` on the second.

Under autograd (grad enabled and an input requiring grad) the ``cuda``
mode runs through ``kernels.autograd.KernelGrad``: forward,
``ssd_scan_cuda`` (the tensor-core route for bf16, the f32-core one for
f32); backward, the gradient of the ``torch`` mode recomputed from the
saved inputs, for x, dt, dA, B and C.  The reference has no backward
kernel either: XLA differentiates its ``ssd_chunked``.  ``mamba_forward``
passes ``dA = dt * A``, so the gradient reaches ``A_log`` and ``dt_bias``
through autograd outside the kernel.  Without autograd (serving) the
kernel is called directly.
"""

from __future__ import annotations

from functools import partial

from repro_torch.kernels.autograd import KernelGrad, recording
from repro_torch.kernels.modes import pick_mode
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_dA, ssd_scan_ref


def _plain(x, dt, dA, B, C, *, chunk):
    if x.dim() == 4:
        return ssd_chunked_dA(x, dt, dA, B, C, chunk)
    return ssd_scan_ref(x, dt, dA, B, C, chunk=chunk)


def ssd_scan(x, dt, dA, B, C, *, chunk: int = 256, force: str | None = None):
    """Returns (y f32 in x's layout, final state f32 [bh, p, n] or
    [b, h, p, n]); ``chunk`` is clipped to l.  ``force``: None (by
    device) | 'cuda' | 'torch'."""
    chunk = min(chunk, x.shape[1])
    plain = partial(_plain, chunk=chunk)
    if pick_mode("ssd_scan", force, x) == "cuda":
        kernel = partial(ssd_scan_cuda, chunk=chunk)
        if recording(x, dt, dA, B, C):
            return KernelGrad.apply(kernel, plain, x, dt, dA, B, C)
        return kernel(x, dt, dA, B, C)
    return plain(x, dt, dA, B, C)
