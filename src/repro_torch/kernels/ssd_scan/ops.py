"""Dispatch for the SSD chunk-scan kernel (modes in
``repro_torch.kernels.modes``: ``cuda`` for CUDA tensors, ``torch`` for
CPU ones).

Two layouts: the reference's flat one (x [bh, l, p], dt/dA [bh, l], B/C
[bg, l, n]) and the model's (x [b, l, h, p], dt/dA [b, l, h], B/C
[b, l, g, n]), told apart by x's rank.  The ``torch`` mode runs
``ssd_scan_ref`` on the first and ``ssd_chunked_dA`` on the second.
"""

from __future__ import annotations

from repro_torch.kernels.modes import pick_mode
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_dA, ssd_scan_ref


def ssd_scan(x, dt, dA, B, C, *, chunk: int = 256, force: str | None = None):
    """Returns (y f32 in x's layout, final state f32 [bh, p, n] or
    [b, h, p, n]); ``chunk`` is clipped to l.  ``force``: None (by
    device) | 'cuda' | 'torch'."""
    chunk = min(chunk, x.shape[1])
    if pick_mode("ssd_scan", force, x) == "cuda":
        return ssd_scan_cuda(x, dt, dA, B, C, chunk=chunk)
    if x.dim() == 4:
        return ssd_chunked_dA(x, dt, dA, B, C, chunk)
    return ssd_scan_ref(x, dt, dA, B, C, chunk=chunk)
