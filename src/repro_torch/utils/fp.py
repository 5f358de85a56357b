"""Fused multiply-add on float32 tensors.

The reference's compiled graphs contract ``a * b + c`` into one fused
multiply-add (one rounding) where XLA's CPU backend chooses to; the port
reproduces those sites exactly.  torch has no fused multiply-add op, so
``fma`` computes in float64: the product of two float32 values is exact
there, and the sum is rounded to odd before the final rounding to
float32, which makes that rounding correct (53 >= 24 + 2 bits).
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """``a * b + c`` with one rounding to float32 (broadcasting)."""
    a64, b64, c64 = (torch.as_tensor(x).to(torch.float64) for x in (a, b, c))
    p = a64 * b64                                  # exact
    s = p + c64
    # two-sum: e is the exact rounding error of s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    # round to odd: when inexact and s's last bit is even, step one ulp
    # toward the exact value (that neighbour is odd)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)
