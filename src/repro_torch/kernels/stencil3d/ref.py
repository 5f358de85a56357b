"""Plain torch version of the 7-point stencil kernel.

``coef_c * u + coef_n * (((((up + dn) + yp) + ym) + zp) + zm)`` with zero
Dirichlet boundaries, in separate elementwise ops: the order of
``csrc/stencil7.cu``, so the two agree bit for bit.
"""

import torch


def _shifted(u, dim, step):
    """u moved by ``step`` (+1 or -1) along ``dim``: out[i] = u[i - step],
    zero where that falls outside the grid."""
    out = torch.zeros_like(u)
    n = u.shape[dim]
    if step > 0:
        out.narrow(dim, 1, n - 1).copy_(u.narrow(dim, 0, n - 1))
    else:
        out.narrow(dim, 0, n - 1).copy_(u.narrow(dim, 1, n - 1))
    return out


def stencil7_ref(u, *, coef_c: float = -6.0, coef_n: float = 1.0):
    """u: [nx, ny, nz] f32.  Returns the 7-point stencil applied to u."""
    up = _shifted(u, 0, 1)        # u[i - 1]
    dn = _shifted(u, 0, -1)       # u[i + 1]
    yp = _shifted(u, 1, -1)       # u[:, j + 1]
    ym = _shifted(u, 1, 1)        # u[:, j - 1]
    zp = _shifted(u, 2, -1)
    zm = _shifted(u, 2, 1)
    return coef_c * u + coef_n * (up + dn + yp + ym + zp + zm)
