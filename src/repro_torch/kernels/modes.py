"""The dispatch modes shared by the NPB kernels (ep, is_hist, stencil3d),
flash attention and the SSD scan.

  cuda   — the hand-written CUDA kernel (CUDA tensors only; raises on others)
  torch  — the plain torch version (any device)

``None`` picks ``cuda`` for a CUDA tensor and ``torch`` for a CPU one.
"""

from __future__ import annotations

MODES = ("cuda", "torch")


def pick_mode(kernel: str, force: str | None, x) -> str:
    """The mode to run ``kernel`` in for tensor ``x``; raises
    ``ValueError`` for a mode the port does not have (the reference's
    ``pallas``/``pallas_interpret`` among them)."""
    if force is not None and force not in MODES:
        raise ValueError(f"unknown {kernel} mode {force!r}; the port's modes "
                         f"are {MODES}")
    return force or ("cuda" if x.is_cuda else "torch")
