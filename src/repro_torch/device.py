"""Device resolution: CUDA by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  Raises ``RuntimeError`` when CUDA
    is requested (explicitly or by default) but absent: the port never
    drops to the CPU by itself, a caller who wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
