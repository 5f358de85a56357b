"""NPB IS analogue: bucket-histogram key ranking.

Ranks 2^n keys by bucket counting over ``iterations`` rounds, as the
reference's ``workloads/is_sort.py``: the histogram is the kernel, ranks
come from the exclusive prefix sum over buckets, and verification checks
that the ranks order the keys' buckets.  The keys are the reference's
threefry draws bit for bit (one ``fold_in(key, i)`` per round), drawn on
the run's device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.is_hist import key_histogram
from repro_torch.utils import prng

OPS_PER_KEY_PER_ITER = 45.0   # NPB IS ~int ops per key per ranking iteration


def run_is(n_pow: int = 16, bucket_pow: int = 10, iterations: int = 10,
           seed: int = 0, force: str | None = None, device=None):
    """One kernel call per round.  Returns the last round's keys and
    ranks and the f32 count of keys over all rounds.  The f32 prefix sum
    is exact while n stays below 2^24 (n_pow <= 23)."""
    dev = resolve_device(device)
    n, n_buckets = 1 << n_pow, 1 << bucket_pow
    key_max_pow = n_pow + 3                         # keys in [0, 8n)
    shift = key_max_pow - bucket_pow
    round_keys = prng.fold_in(prng.key(seed, device=dev),
                              torch.arange(iterations, device=dev))
    total = torch.zeros((), dtype=torch.float32, device=dev)
    keys = ranks = None
    for i in range(iterations):
        keys = prng.randint(round_keys[i], (n,), 0, 1 << key_max_pow)
        hist = key_histogram(keys, n_buckets=n_buckets, bucket_shift=shift,
                             force=force)
        starts = torch.cumsum(hist, 0) - hist       # exclusive prefix sum
        ranks = starts[(keys >> shift).long()]
        total = total + hist.sum()
    return {"keys": keys, "ranks": ranks, "total_counted": total,
            "n": n, "iterations": iterations}


def verify_is(result) -> bool:
    """Bucket-rank validity: sorting keys by rank must sort their buckets.
    Buckets are read at the run's default bucket_pow = 10, as the
    reference reads them."""
    keys, ranks = result["keys"], result["ranks"]
    order = torch.argsort(ranks, stable=True)
    shifted = keys[order]
    n = result["n"]
    ok_count = (float(result["total_counted"])
                == result["n"] * result["iterations"])
    diffs = torch.diff(shifted >> (int(math.log2(n)) + 3 - 10))
    return bool(ok_count and bool((diffs >= 0).all()))


def is_ops(n_pow: int, iterations: int = 10) -> float:
    return (1 << n_pow) * iterations * OPS_PER_KEY_PER_ITER
