"""The paper's energy formalism, verbatim (eqs. in §Problem), on torch
tensors.

These functions operate on *measured/sampled* power traces (what SUPPZ's
monitoring provides on real hardware; what the simulator and the roofline
model synthesize). Like the reference under its default 32-bit types, they
compute in float32 whatever the input's width.
"""

from __future__ import annotations

import torch


def _asarray(x):
    """``torch.as_tensor`` narrowed as 32-bit array code narrows its inputs:
    float64 to float32, int64 to int32."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float64:
        return x.float()
    if x.dtype == torch.int64:
        return x.int()
    return x


def node_power(e_calc_sigma, e_disk, e_net):
    """W^j(t) = E_CALC,Σ^j(t) + E_disk^j(t) + E_net^j(t)   — paper eq. (1).
    Inputs are per-timepoint component powers (any matching shapes)."""
    return e_calc_sigma + e_disk + e_net


def average_power(w_jt, dt=1.0):
    """W̄ = ∫ Σ_j W^j(t) dt / T   — paper eq. (2).
    w_jt: [N_nodes, T_steps] power samples; dt: sample spacing (s).
    The trapezoid rule in the reference's order: 0.5 * Σ dt (y[i+1] + y[i])."""
    w_jt = _asarray(w_jt)
    y = w_jt.sum(dim=0, dtype=w_jt.dtype)
    if not y.is_floating_point():
        y = y.float()
    total = 0.5 * (dt * (y[1:] + y[:-1])).sum(-1)
    duration = (w_jt.shape[1] - 1) * dt
    # a tensor divisor: a Python scalar one may become a reciprocal multiply
    return total / total.new_tensor(max(duration, 1e-12))


def energy_coefficient(w_avg, p_mops):
    """C = W / P  [J/Mop]  — paper eq. (3); P in Mop/s (NPB's native unit)."""
    return _asarray(w_avg) / torch.clamp(_asarray(p_mops), min=1e-12)


def profile(k_percent, c):
    """A power-consumption profile is the pair (K, C) — paper §Problem."""
    return {"K": k_percent, "C": c}
