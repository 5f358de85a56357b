"""Dispatch for the kth-free-time placement kernel.

Modes (``force``):
  cuda   — the hand-written CUDA kernel (CUDA tensors only)
  torch  — the plain torch radix select (any device)
  sort   — the ``torch.sort`` oracle

Default: ``cuda`` for a CUDA tensor, ``torch`` for a CPU tensor.  All three
agree bit for bit.  The reference's ``pallas``/``pallas_interpret`` modes
have no counterpart here and raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.kth_free.kernel import (kth_free_cuda,
                                                 radix_select_kth)
from repro_torch.kernels.kth_free.ref import kth_free_ref

MODES = ("cuda", "torch", "sort")


def check_mode(force: str | None) -> None:
    """Raise ``ValueError`` for a placement mode the port does not have."""
    if force is not None and force not in MODES:
        raise ValueError(f"unknown kth_free mode {force!r}; the port's modes "
                         f"are {MODES}")


def kth_free_time(node_free, n_req, *, force: str | None = None):
    """node_free: [..., S, maxN] f32 per-node free times; n_req: [..., S]
    int.  Returns [..., S] f32: the earliest time n_req nodes of each
    system are free.  Any leading dimensions batch (grid lanes, EASY
    candidates)."""
    check_mode(force)
    mode = force or ("cuda" if node_free.is_cuda else "torch")
    if mode == "cuda":
        if n_req.dtype != torch.int32:
            n_req = n_req.to(torch.int32)
        return kth_free_cuda(node_free, n_req)
    if mode == "torch":
        return radix_select_kth(node_free, n_req)
    return kth_free_ref(node_free, n_req)


#: The reference's per-candidate batched entry: one more leading dimension
#: is just another batch dimension here.
kth_free_time_batched = kth_free_time
