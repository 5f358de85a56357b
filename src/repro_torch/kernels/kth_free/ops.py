"""Dispatch for the kth-free-time placement kernel.

Modes (``force``):
  cuda   — the hand-written CUDA kernel (CUDA tensors only)
  torch  — the plain torch radix select (any device)
  sort   — the ``torch.sort`` oracle

Default: ``cuda`` for a CUDA tensor; on a CPU tensor ``torch`` for
``kth_free_time`` and ``sort`` for the shared-table entries
(``kth_free_time_shared``, ``kth_free_time_rows``), as in the reference.
Every mode agrees bit for bit, since the answer is an element of the input.
The reference's ``pallas``/``pallas_interpret`` modes have no counterpart
here and raise.

Each call of a public entry counts once in the tracer (``utils/trace``),
in every mode: ``kth_free.calls`` 1 and ``kth_free.rows`` the output's
size, in the innermost open span, which names the call site.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.kth_free.kernel import (kth_free_cuda,
                                                 radix_select_kth)
from repro_torch.kernels.kth_free.ref import kth_free_ref
from repro_torch.utils import trace

MODES = ("cuda", "torch", "sort")


def check_mode(force: str | None) -> None:
    """Raise ``ValueError`` for a placement mode the port does not have."""
    if force is not None and force not in MODES:
        raise ValueError(f"unknown kth_free mode {force!r}; the port's modes "
                         f"are {MODES}")


def _counted(out):
    """``out`` of one public entry's call, counted in the tracer."""
    trace.count("kth_free.calls")
    trace.count("kth_free.rows", out.numel())
    return out


def kth_free_time(node_free, n_req, *, force: str | None = None):
    """node_free: [..., S, maxN] f32 per-node free times; n_req: [..., S]
    int.  Returns [..., S] f32: the earliest time n_req nodes of each
    system are free.  Any leading dimensions batch (grid lanes, EASY
    candidates)."""
    check_mode(force)
    return _counted(_kth_free_time(node_free, n_req, force))


def _kth_free_time(node_free, n_req, force):
    """``kth_free_time`` uncounted: the shared and rows entries select
    through it."""
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


def _sorted_kth(srt, n_req):
    """The ``n_req``-th smallest entry per row of already sorted rows
    ``srt`` [..., R, maxN]; ``n_req`` [..., R] (clipped to [1, maxN])."""
    idx = (n_req.to(torch.int64) - 1).clamp(0, srt.shape[-1] - 1)
    return srt.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def kth_free_time_shared(node_free, n_req, *, force: str | None = None):
    """Many requests against ONE node-free table per lane: node_free [...,
    S, maxN] f32, n_req [..., W, S] int -> [..., W, S] f32, the
    n_req[..., w, s]-th smallest entry of row s.

    ``sort`` sorts the table once and gathers every candidate's entry;
    ``cuda`` and ``torch`` broadcast the table to [..., W, S, maxN] (the
    kernel reads a contiguous copy) and select per candidate row."""
    check_mode(force)
    mode = force or ("cuda" if node_free.is_cuda else "sort")
    W = n_req.shape[-2]
    if mode == "sort":
        srt = torch.sort(node_free, dim=-1).values.unsqueeze(-3)
        return _counted(_sorted_kth(
            srt.expand(srt.shape[:-3] + (W,) + srt.shape[-2:]), n_req))
    free_b = node_free.unsqueeze(-3).expand(
        node_free.shape[:-2] + (W,) + node_free.shape[-2:])
    return _counted(_kth_free_time(free_b, n_req, mode))


def kth_free_time_rows(node_free, sels, n_req, *, force: str | None = None):
    """One request per slot against ONE node-free table per lane:
    node_free [..., S, maxN] f32, sels [..., W] int (each slot's system),
    n_req [..., W] int -> [..., W] f32, the n_req-th smallest entry of row
    ``sels``.  ``sort`` sorts the table once and gathers; ``cuda`` and
    ``torch`` select on the gathered [..., W, maxN] rows."""
    check_mode(force)
    mode = force or ("cuda" if node_free.is_cuda else "sort")
    idx = sels.to(torch.int64).unsqueeze(-1).expand(
        sels.shape + node_free.shape[-1:])
    if mode == "sort":
        return _counted(_sorted_kth(
            torch.sort(node_free, dim=-1).values.gather(-2, idx), n_req))
    return _counted(_kth_free_time(node_free.gather(-2, idx), n_req, mode))
