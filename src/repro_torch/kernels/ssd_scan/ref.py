"""Plain torch versions of the SSD chunk-scan kernel.

``ssd_chunked_dA`` is the reference's chunked SSD scan
(``repro/kernels/ssd_scan/ref.py::_ssd_chunked_dA``, the body of
``repro/models/mamba.py::ssd_chunked`` with dA given) in the model layout;
``ssd_scan_ref`` is the reference's flat-layout oracle around it.  All
arithmetic is f32, as in the reference: the intra-chunk quadratic term
(``exp(cum_i - cum_j)`` taken where j <= i and 0 elsewhere), each chunk's
own state, the recurrence over chunks and the off-diagonal term.

One departure, in the gradient only: the reference takes
``where(j <= i, exp(cum_i - cum_j), 0)``, whose gradient is 0 * inf = NaN
wherever exp(cum_i - cum_j) overflows above the diagonal (cum falls by
more than 88 within a chunk: mamba2-780m's chunk of 256 at its initial
dt * A); the port masks the exponent first, exp(-inf) = 0.  The forward
is the same bit for bit; the gradient is the reference's wherever that
is finite (``tests/test_torch_train.py``).

They live here rather than in ``repro_torch.models.mamba`` (which builds
``ssd_chunked`` on ``ssd_chunked_dA``) so that the kernel package never
imports the models.
"""

from __future__ import annotations

import torch


def ssd_chunked_dA(x, dt, dA, B, C, chunk: int):
    """x [b, l, h, p]; dt, dA [b, l, h]; B, C [b, l, g, n] (head h reads
    group h // (H / g)); l % chunk == 0.  Returns (y [b, l, h, p] f32,
    final state [b, h, p, n] f32)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"l = {l} is not a multiple of chunk = {chunk}")
    nc, q = l // chunk, chunk
    rep = h // g
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    dAf = dA.float().reshape(b, nc, q, h)
    Bf = B.float().reshape(b, nc, q, g, n)
    Cf = C.float().reshape(b, nc, q, g, n)
    cum = torch.cumsum(dAf, dim=2)                              # [b,nc,q,h]

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, else 0; the
    # exponent is masked before exp, so the masked entries' gradient is 0
    # where exp(cum_i - cum_j) overflows (j > i) instead of 0 * inf
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [b,nc,i,j,h]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              float("-inf")))
    S = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)
    S = S.repeat_interleave(rep, dim=-1)                        # [b,nc,i,j,h]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", S * L * dtf[:, :, None], xf)

    # each chunk's own state: sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # [b,nc,q,h]
    Bh = Bf.repeat_interleave(rep, dim=3)                       # [b,nc,q,h,n]
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end * dtf, Bh,
                          xf)                                   # [b,nc,h,p,n]
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [b,nc,h]

    # the recurrence over chunks, keeping the state entering each chunk
    prev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prevs = torch.stack(entering, dim=1)                        # [b,nc,h,p,n]

    # off-diagonal: y_off[i] = exp(cum_i) * C_i . prev
    Ch = Cf.repeat_interleave(rep, dim=3)
    y_off = (torch.einsum("bcqhn,bchpn->bcqhp", Ch, prevs)
             * torch.exp(cum)[..., None])
    return (y_diag + y_off).reshape(b, l, h, p), prev


def ssd_scan_ref(x, dt, dA, B, C, *, chunk: int = 256):
    """The flat layout: x [bh, l, p]; dt, dA [bh, l]; B, C [bg, l, n] with
    bh = bg * rep (head row i reads B/C row i // rep).  Returns (y
    [bh, l, p] f32, state [bh, p, n] f32)."""
    bh, l, p = x.shape
    bg, _, n = B.shape
    rep = bh // bg
    y, st = ssd_chunked_dA(
        x.reshape(bg, rep, l, p).transpose(1, 2),
        dt.reshape(bg, rep, l).transpose(1, 2),
        dA.reshape(bg, rep, l).transpose(1, 2),
        B.reshape(bg, 1, l, n).transpose(1, 2),
        C.reshape(bg, 1, l, n).transpose(1, 2), chunk)
    return y.transpose(1, 2).reshape(bh, l, p), st.reshape(bh, p, n)
