"""NPB EP analogue (runnable, scaled by ``m``: n_pairs = 2^m).

Uniform pairs -> Marsaglia polar -> Gaussian deviates -> annuli counts
and (sum X, sum Y), as the reference's ``workloads/ep.py``.  The uniforms
are the reference's threefry draws bit for bit: one ``fold_in(key, i)``
per batch of ``2**batch_pow`` pairs (so ``batch_pow`` changes the
result), drawn on the run's device, many batches per threefry pass.
Verification is NPB's statistical one: the acceptance ratio approaches
pi/4 and the mean deviate approaches 0.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ep import N_ANNULI, ep_pass
from repro_torch.utils import prng

FLOPS_PER_PAIR = 100.0   # transcendental-weighted (log, sqrt, div ~ dozens of flops)
#: pairs drawn per threefry pass (bounds the int64 temporaries to ~16 MB)
_DRAW_PAIRS = 1 << 20


def run_ep(m: int = 20, batch_pow: int = 16, seed: int = 0,
           force: str | None = None, device=None):
    """Returns dict(hist [10], sx, sy, n_pairs, accepted).  One kernel call
    per threefry pass of ``_DRAW_PAIRS`` pairs, which adds the pass's
    batches in order into the running hist and sums: f32, as the
    reference's carry (from m = 25 on the accepted count passes 2^24 and
    rounds)."""
    dev = resolve_device(device)
    n = 1 << m
    bn = 1 << min(batch_pow, m)
    n_batches = n // bn
    keys = prng.fold_in(prng.key(seed, device=dev),
                        torch.arange(n_batches, device=dev))
    hist = torch.zeros(N_ANNULI, dtype=torch.float32, device=dev)
    sums = torch.zeros(2, dtype=torch.float32, device=dev)
    per_draw = max(1, _DRAW_PAIRS // bn)
    for b0 in range(0, n_batches, per_draw):
        u = prng.uniform(keys[b0:b0 + per_draw], (2, bn), -1.0, 1.0)
        ep_pass(u, hist, sums, force=force)
    return {"hist": hist, "sx": sums[0], "sy": sums[1], "n_pairs": n,
            "accepted": hist.sum()}


def verify_ep(result) -> bool:
    """NPB-style statistical verification."""
    ratio = float(result["accepted"]) / result["n_pairs"]
    ok_ratio = abs(ratio - 3.141592653589793 / 4) < 0.01
    mean_x = float(result["sx"]) / max(float(result["accepted"]), 1.0)
    return bool(ok_ratio and abs(mean_x) < 0.02)


def ep_flops(m: int) -> float:
    return (1 << m) * FLOPS_PER_PAIR
