"""Threefry-2x32 in torch, bit for bit with ``jax.random``.

The reference engine draws its fault factors and its ``random``-objective
picks from ``jax.random`` (threefry2x32, ``jax_threefry_partitionable``
on).  This module reproduces exactly the draws it makes:
``key(seed)``, ``split(key)``, ``fold_in(key, j)``, ``uniform(key, shape,
minval, maxval)``, ``randint(key, shape, lo, hi)`` and, within a stated
band, ``normal(key, shape)`` (the NPB workloads' draws).  Threefry is
counter based, so every draw of a whole ``[B, J]`` campaign is one
vectorized pass.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; all
uint32 arithmetic runs in int64 and is masked back to 32 bits.
"""

from __future__ import annotations

import torch


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block (20 rounds) on broadcastable int64 tensors
    of uint32 values; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for an int32 seed (or a tensor of them):
    the key words are ``(0, seed mod 2**32)``."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _counter_bits(k, shape):
    """Both output words of threefry at the flat counters ``0..n-1`` laid
    out in ``shape`` (the partitionable iota), for keys ``k [..., 2]``."""
    n = 1
    for d in shape:
        n *= d
    lo = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    pad = (1,) * len(shape)
    k0 = k[..., 0].reshape(k.shape[:-1] + pad)
    k1 = k[..., 1].reshape(k.shape[:-1] + pad)
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(k, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., 2] -> [..., num, 2]``."""
    y0, y1 = _counter_bits(k, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(k, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` broadcast over the key's leading
    dimensions and ``data``'s shape."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k, shape=()) -> torch.Tensor:
    """32 random bits per element: ``[..., 2] -> [..., *shape]`` int64."""
    y0, y1 = _counter_bits(k, tuple(shape))
    return y0 ^ y1


def uniform(k, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)``, float32 on
    [minval, maxval): ``max(minval, floats * (maxval - minval) + minval)``
    with the bounds and their difference rounded to float32 first.
    Bit-equal where that difference is a power of two, as it is for every
    caller (1, 2, and ``normal``'s span, which rounds to 2): the product is
    then exact, so the reference's fused multiply-add rounds as this
    multiply and add do."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    # bits < 2**31, so the int32 view is the float's bit pattern
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(k, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32:
    ``sqrt(2) * erfinv(uniform(k, shape, nextafter(-1, 0), 1))``.  The
    uniform draw is bit-equal; ``torch.erfinv`` differs from XLA's
    ``erf_inv`` in the last bits (a few 1e-6 relative, see PERF.md)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return torch.erfinv(u) * torch.tensor(2.0 ** 0.5, dtype=torch.float32)


def randint(k, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 bounds
    with ``minval < maxval`` (int32 result)."""
    k1, k2 = split(k).unbind(-2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = maxval - minval
    mult = (((2 ** 16 % span) ** 2) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return (minval + off % span).to(torch.int32)
