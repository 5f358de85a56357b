"""Dispatch for the 7-point stencil kernel (modes in
``repro_torch.kernels.modes``: ``cuda`` for a CUDA tensor, ``torch`` for
a CPU one).  The reference's ``bx`` tile size changes nothing and is not
carried over."""

from __future__ import annotations

from repro_torch.kernels.modes import pick_mode
from repro_torch.kernels.stencil3d.kernel import stencil7_cuda
from repro_torch.kernels.stencil3d.ref import stencil7_ref


def stencil7(u, *, coef_c: float = -6.0, coef_n: float = 1.0,
             force: str | None = None):
    """u: [nx, ny, nz] f32.  Returns coef_c*u + coef_n*(sum of the six
    neighbours), zero outside the grid."""
    fn = (stencil7_cuda if pick_mode("stencil7", force, u) == "cuda"
          else stencil7_ref)
    return fn(u, coef_c=coef_c, coef_n=coef_n)
