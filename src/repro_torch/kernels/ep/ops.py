"""Dispatch for the EP Gaussian-pair kernel (modes in
``repro_torch.kernels.modes``: ``cuda`` for a CUDA tensor, ``torch`` for
a CPU one).  The reference's ``block_n`` tile size changes nothing and
is not carried over."""

from __future__ import annotations

from repro_torch.kernels.ep.kernel import ep_pairs_cuda, ep_pass_cuda
from repro_torch.kernels.ep.ref import ep_pairs_ref, ep_pass_ref
from repro_torch.kernels.modes import pick_mode


def ep_pairs(u, *, force: str | None = None):
    """u: [2, n] f32 uniforms in (-1, 1).  Returns (hist [10], sums [2])."""
    if pick_mode("ep", force, u) == "cuda":
        return ep_pairs_cuda(u)
    return ep_pairs_ref(u)


def ep_pass(u, hist, sums, *, force: str | None = None):
    """u: [nb, 2, n] f32 uniforms, one draw pass.  Adds the nb batches
    into the f32 carries ``hist`` [10] and ``sums`` [2] in place, in batch
    order, and returns them."""
    if pick_mode("ep", force, u) == "cuda":
        return ep_pass_cuda(u, hist, sums)
    return ep_pass_ref(u, hist, sums)
