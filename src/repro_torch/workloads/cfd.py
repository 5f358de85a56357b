"""BT / SP / LU analogues: ADI / SSOR iterations on a 3D grid.

As the reference's ``workloads/cfd.py``: per iteration the right-hand
side is the 7-point stencil (the ``stencil3d`` kernel), then
  BT/SP: ADI — tridiagonal solves along z, y and x (Thomas algorithm),
         two sweeps for BT, one for SP;
  LU   : SSOR relaxation (two stencil half-sweeps).
Verification: the solution stays finite and the residual decreases.

torch has no ``lax.scan``: ``thomas_tridiag`` is a Python loop of n
forward and n backward steps, each vectorised over all the other lines.
The initial grid comes from ``cfd_u0`` and the iterations from
``cfd_iterate``, so a caller can start from any grid.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.stencil3d import stencil7
from repro_torch.utils import prng

OMEGA = 0.8


def thomas_tridiag(a, b, c, d):
    """Solve tridiagonal systems along the LAST axis.
    a (sub), b (diag), c (super), d (rhs): broadcastable [..., n] f32."""
    a, b, c, d = (x.movedim(-1, 0) for x in torch.broadcast_tensors(a, b, c, d))
    n = d.shape[0]
    cp = torch.empty(d.shape, dtype=torch.float32, device=d.device)
    dp = torch.empty_like(cp)
    cp_prev = torch.zeros(d.shape[1:], dtype=torch.float32, device=d.device)
    dp_prev = cp_prev
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        cp_prev = c[i] / denom
        dp_prev = (d[i] - a[i] * dp_prev) / denom
        cp[i] = cp_prev
        dp[i] = dp_prev
    x = torch.empty_like(cp)
    carry = torch.zeros_like(cp_prev)
    for i in range(n - 1, -1, -1):
        carry = dp[i] - cp[i] * carry
        x[i] = carry
    return x.movedim(0, -1)


def _adi_sweep(u, rhs, diag: float):
    """One ADI iteration: tridiagonal solves along z, y, x (constant
    bands -0.25, diag, -0.25 over u's grid)."""
    a = torch.full((), -0.25, device=u.device).expand(u.shape)
    b = torch.full((), diag, device=u.device).expand(u.shape)
    u = thomas_tridiag(a, b, a, rhs)
    u = thomas_tridiag(a, b, a, u.movedim(1, -1)).movedim(-1, 1)
    u = thomas_tridiag(a, b, a, u.movedim(0, -1)).movedim(-1, 0)
    return u


def cfd_u0(nx: int = 32, seed: int = 0, device=None):
    """The initial grid: ``normal(key(seed), (nx, nx, nx))`` f32."""
    dev = resolve_device(device)
    return prng.normal(prng.key(seed, device=dev), (nx, nx, nx))


def cfd_iterate(u0, iters: int = 10, variant: str = "BT",
                force: str | None = None):
    """``iters`` iterations of ``variant`` (BT: 2-sweep ADI, SP: 1-sweep
    ADI, LU: SSOR) from ``u0``.  Returns {"u", "residuals" [iters]}."""
    if variant not in ("BT", "SP", "LU"):
        raise ValueError(f"unknown CFD variant {variant!r}")
    u, residuals = u0, []
    for _ in range(iters):
        if variant == "LU":
            rhs = stencil7(u, coef_c=-6.0, coef_n=1.0, force=force)
            u = u + OMEGA * 0.08 * rhs                      # lower sweep
            rhs = stencil7(u, coef_c=-6.0, coef_n=1.0, force=force)
            u = u + OMEGA * 0.08 * rhs                      # upper sweep
        else:
            rhs = stencil7(u, coef_c=-6.0, coef_n=1.0, force=force)
            v = u
            for _ in range(2 if variant == "BT" else 1):
                v = _adi_sweep(v, v - OMEGA * 0.1 * rhs, diag=1.5)
            u = v
        residuals.append(torch.sqrt(torch.mean(rhs * rhs)))
    return {"u": u, "residuals": torch.stack(residuals)}


def run_cfd(nx: int = 32, iters: int = 10, variant: str = "BT",
            seed: int = 0, force: str | None = None, device=None):
    """variant: BT (5-sweep ADI), SP (3-sweep ADI, lighter), LU (SSOR)."""
    return cfd_iterate(cfd_u0(nx, seed, device), iters, variant, force)


def verify_cfd(result) -> bool:
    r = result["residuals"]
    finite = bool(torch.isfinite(result["u"]).all())
    decreasing = float(r[-1]) < float(r[0])
    return finite and decreasing


def cfd_flops(nx: int, iters: int, variant: str) -> float:
    pts = nx ** 3
    stencil = 13.0 * pts                                  # 7-pt stencil flops
    thomas = 8.0 * pts                                    # per directional solve
    if variant == "BT":
        per_iter = stencil + 2 * 3 * thomas + 4 * pts
    elif variant == "SP":
        per_iter = stencil + 3 * thomas + 4 * pts
    else:  # LU
        per_iter = 2 * stencil + 4 * pts
    return per_iter * iters
