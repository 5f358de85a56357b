"""Threefry-2x32 counter-based draws in numpy uint32, as ``jax.random``
defines them with ``jax_threefry_partitionable`` on: ``key``, ``split``,
``fold_in`` and ``uniform``.  The fault model draws each job's straggler
and failure bits from ``uniform(fold_in(fault_key, job), (2,))``."""

from __future__ import annotations

import numpy as np

U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block on broadcastable uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, U32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + k0
        x1 = x1 + k1
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def key(seed) -> np.ndarray:
    """[..., 2] uint32 keys ``(0, seed mod 2**32)``."""
    s = (np.asarray(seed, np.int64) & 0xFFFFFFFF).astype(U32)
    return np.stack([np.zeros_like(s), s], -1)


def _counter_bits(k, n: int):
    lo = np.arange(n, dtype=U32)
    return threefry2x32(k[..., 0:1], k[..., 1:2], np.zeros_like(lo), lo)


def split(k, num: int = 2) -> np.ndarray:
    """[..., 2] -> [..., num, 2]."""
    y0, y1 = _counter_bits(k, num)
    return np.stack([y0, y1], -1)


def fold_in(k, data) -> np.ndarray:
    """Key ``k`` [..., 2] folded with ``data`` (broadcast)."""
    d = (np.asarray(data, np.int64) & 0xFFFFFFFF).astype(U32)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], np.zeros_like(d), d)
    return np.stack([y0, y1], -1)


def uniform(k, n: int) -> np.ndarray:
    """[..., 2] keys -> [..., n] float32 draws on [0, 1)."""
    y0, y1 = _counter_bits(k, n)
    bits = ((y0 ^ y1) >> U32(9)) | U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
