"""Plain torch versions of the flash attention kernel.

``blocked_attention`` and ``blocked_attention_tri`` are the port of the
reference's jnp twins of its Pallas kernel (``repro/models/attention.py``):
the blocked online softmax, tile by tile, with f32 running max, sum and
accumulator, so the working set is one [b, h, block_q, block_k] score
tile and never the full [s, s] matrix.  ``plain_attention`` is the
plain-softmax version the reference keeps beside them, and
``attention_ref`` the oracle its kernel tests compare with.

They live here rather than in ``repro_torch.models.attention`` (which
re-exports them under the reference's names) so that the kernel package
never imports the models: the reference's ``ops.py`` imports its model
module, and the port keeps kernel and model imports free of cycles.

Layouts: q [b, sq, h, hd]; k, v [b, sk, kv, hd]; query head ``h`` reads
KV head ``h // (H / KV)``.  Outputs are in q's dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def plain_attention(q, k, v, *, causal: bool, q_positions=None,
                    k_positions=None):
    """q: [b,sq,h,hd]; k,v: [b,sk,kv,hd].  f32 softmax over the full
    [sq, sk] scores.  Returns [b,sq,h,hd]."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    rep = h // kv
    qr = q.reshape(b, sq, kv, rep, hd).float() * hd ** -0.5
    s = torch.einsum("bqgrd,bpgd->bgrqp", qr, k.float())
    if causal:
        qp = (torch.arange(sq, device=q.device) if q_positions is None
              else q_positions)
        kp = (torch.arange(sk, device=q.device) if k_positions is None
              else k_positions)
        s = torch.where(qp[:, None] >= kp[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqp,bpgd->bqgrd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def attention_ref(q, k, v, *, causal: bool = True):
    """The oracle: plain f32 softmax attention."""
    return plain_attention(q, k, v, causal=causal)


def _tile(state, qr, k_blk, v_blk, mask, shape):
    """One online-softmax step of a query tile against a key tile.
    state: (m [b,h,bq], l [b,h,bq], acc [b,h,bq,hd]); qr: the scaled f32
    query tile [b,bq,kv,rep,hd]; mask: [bq, bk] bool or None."""
    b, h, kv, rep, bq, bk, hd = shape
    m, l, acc = state
    s = torch.einsum("bqgrd,bpgd->bgrqp", qr, k_blk.float())
    s = s.reshape(b, h, bq, bk)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bgrqp,bpgd->bgrqd", p.reshape(b, kv, rep, bq, bk),
                      v_blk.float()).reshape(b, h, bq, hd)
    return m_new, l_new, acc * alpha[..., None] + pv


def _blocks(q, k, block_q, block_k):
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"blocked attention needs sq % block_q == sk % "
                         f"block_k == 0, got {(sq, block_q, sk, block_k)}")
    return (b, h, kv, h // kv, block_q, block_k, hd), sq // block_q, \
        sk // block_k


def _run(q, k, v, pairs, causal, shape):
    """Accumulate the (qi, [ki, ...]) tile pairs of ``pairs`` and write
    each finished query tile into the output [b, sq, h, hd]."""
    b, h, kv, rep, bq, bk, hd = shape
    out = torch.empty_like(q)
    scale = hd ** -0.5
    ar_q = torch.arange(bq, device=q.device)
    ar_k = torch.arange(bk, device=q.device)
    for qi, kis in pairs:
        qr = (q[:, qi * bq:(qi + 1) * bq].reshape(b, bq, kv, rep, hd).float()
              * scale)
        state = (torch.full((b, h, bq), NEG_INF, device=q.device),
                 torch.zeros((b, h, bq), device=q.device),
                 torch.zeros((b, h, bq, hd), device=q.device))
        for ki in kis:
            mask = None
            if causal:
                mask = ((qi * bq + ar_q)[:, None]
                        >= (ki * bk + ar_k)[None, :])
            state = _tile(state, qr, k[:, ki * bk:(ki + 1) * bk],
                          v[:, ki * bk:(ki + 1) * bk], mask, shape)
        _, l, acc = state
        o = acc / torch.clamp_min(l, 1e-30)[..., None]      # [b,h,bq,hd]
        out[:, qi * bq:(qi + 1) * bq] = o.transpose(1, 2).to(q.dtype)
    return out


def blocked_attention(q, k, v, *, causal: bool, block_q: int = 512,
                      block_k: int = 512):
    """Flash-style online-softmax attention on the rectangular schedule
    (every query tile against every key tile, masked when causal; both
    positions counted from 0).  Requires sq % block_q == sk % block_k == 0
    (after clipping the blocks to the lengths)."""
    shape, nq, nk = _blocks(q, k, block_q, block_k)
    return _run(q, k, v, [(qi, range(nk)) for qi in range(nq)], causal,
                shape)


def blocked_attention_tri(q, k, v, *, block_q: int = 512,
                          block_k: int = 512):
    """Causal blocked attention on the triangular schedule: only the
    nq (nq + 1) / 2 tile pairs (qi, ki <= qi) that are not wholly masked.
    Self-causal only (sq == sk), square blocks.  Equal bit for bit to the
    rectangular schedule: a wholly masked tile adds exp(-1e30 - m) = 0
    with alpha = 1, and comes after the others."""
    if q.shape[1] != k.shape[1]:
        raise ValueError("triangular schedule: self-causal only")
    shape, nq, _ = _blocks(q, k, block_q, block_k)
    if shape[4] != shape[5]:
        raise ValueError("triangular schedule assumes square blocks")
    return _run(q, k, v, [(qi, range(qi + 1)) for qi in range(nq)], True,
                shape)
