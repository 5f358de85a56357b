"""GQA attention: the blocked (flash) prefill path and the decode path
(``repro/models/attention.py``).

Implementations, numerically equivalent:
  - ``plain_attention``: einsum + causal mask, for short sequences.
  - ``blocked_attention`` / ``blocked_attention_tri``: the online-softmax
    twins of the flash kernel; they live in
    ``repro_torch.kernels.flash_attention.ref`` (so the kernel package
    never imports this module) and are re-exported here.
  - ``decode_attention``: one query token against a KV cache.

``attn_forward`` keeps the reference's dispatch rule: queries of at least
2,048 positions, a multiple of 512, against keys whose count is a
multiple of 512 go through ``kernels.flash_attention.ops.flash_attention``
(the CUDA kernel on the card, the blocked plain version on the CPU or with
``force="torch"``); others through ``plain_attention``.  The reference's
``attn_schedule`` is not needed: its two schedules give the same numbers,
and the dispatch picks the triangular one for causal self-attention (the
rectangular one for cross and encoder attention, ``causal=False``).
Cross-attention reads its keys and values from ``kv_x`` (the encoder's
output) in prefill, and from the precomputed memory in decode
(``attn_cross_decode``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, blocked_attention, blocked_attention_tri, plain_attention)
from repro_torch.models.layers import apply_rope, dense_init, dot, rope_angles

#: flash branch: tiles of the blocked plain version, and the rule
FLASH_BLOCK = 512
FLASH_MIN_SEQ = 2048


def init_attn(cfg: ModelConfig, gen, dtype, cross: bool = False):
    """Q/K/V/O projections (and QKV biases when ``cfg.qkv_bias``).  A
    cross-attention block (``cross``) has the same leaves, as in the
    reference."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim()
    p = {"wq": dense_init(gen, d, (h, hd), dtype),
         "wk": dense_init(gen, d, (kv, hd), dtype),
         "wv": dense_init(gen, d, (kv, hd), dtype),
         "wo": dense_init(gen, h * hd, (d,), dtype).reshape(h, hd, d)}
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n, hd), dtype=dtype, device=gen.device)
    return p


def _proj(x, w, bias):
    """x [b,s,d] @ w [d,n,hd] -> [b,s,n,hd] in x's dtype; with a bias the
    product is kept in f32 until the bias is added, as in the reference."""
    d, n, hd = w.shape
    if bias is None:
        y = dot(x, w.reshape(d, n * hd))
    else:
        y = (dot(x, w.reshape(d, n * hd), f32=True)
             + bias.float().reshape(n * hd)).to(x.dtype)
    return y.reshape(*x.shape[:-1], n, hd)


def _project_q(p, x, cfg):
    return _proj(x, p["wq"], p.get("bq"))


def _project_kv(p, x, cfg):
    return _proj(x, p["wk"], p.get("bk")), _proj(x, p["wv"], p.get("bv"))


def _out_proj(p, o, x_dtype):
    h, hd, d = p["wo"].shape
    return dot(o.reshape(*o.shape[:-2], h * hd), p["wo"].reshape(h * hd, d)
               ).to(x_dtype)


def decode_attention(q, cache_k, cache_v, *, length=None):
    """q: [b,1,h,hd]; cache: [b,S,kv,hd].  Attends over positions
    < length (length=None => the whole cache)."""
    b, _, h, hd = q.shape
    _, S, kv, _ = cache_k.shape
    qr = q.reshape(b, kv, h // kv, hd).float() * hd ** -0.5
    s = torch.einsum("bgrd,bpgd->bgrp", qr, cache_k.float())
    if length is not None:
        valid = torch.arange(S, device=q.device) < length
        s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrp,bpgd->bgrd", p, cache_v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


def uses_flash(cfg: ModelConfig, s: int, sk: int) -> bool:
    """The reference's rule for the flash branch of ``attn_forward``."""
    return (cfg.use_flash != "never" and s >= FLASH_MIN_SEQ
            and s % FLASH_BLOCK == 0 and sk % FLASH_BLOCK == 0)


def attn_forward(p, x, cfg: ModelConfig, *, causal=True, use_rope=True,
                 kv_x=None, return_kv=False, force=None):
    """Prefill self- (or cross-) attention.  x: [b, s, d]; kv_x: the
    source of K/V for cross-attention, or None (self).  ``force`` goes to
    the flash dispatch (None | 'cuda' | 'torch').  Returns [b, s, d] (and
    (k, v) [b, sk, kv, hd] if ``return_kv``)."""
    s = x.shape[1]
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x if kv_x is None else kv_x, cfg)
    if use_rope:
        pos = torch.arange(s, device=x.device)
        sin, cos = rope_angles(pos, cfg.resolved_head_dim(), cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    if uses_flash(cfg, s, k.shape[1]):
        o = ops.flash_attention(q, k, v, causal=causal, block_q=FLASH_BLOCK,
                                block_k=FLASH_BLOCK, force=force)
    else:
        o = plain_attention(q, k, v, causal=causal)
    out = _out_proj(p, o, x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def attn_decode(p, x, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                use_rope=True):
    """One-token decode.  x: [b,1,d]; cache_k/v: [b,S,kv,hd], written in
    place at ``pos`` (an int); attends over positions <= pos."""
    q = _project_q(p, x, cfg)
    k_new, v_new = _project_kv(p, x, cfg)
    if use_rope:
        posv = torch.arange(pos, pos + 1, device=x.device)
        sin, cos = rope_angles(posv, cfg.resolved_head_dim(), cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k_new = apply_rope(k_new, sin, cos)
    cache_k[:, pos] = k_new[:, 0]
    cache_v[:, pos] = v_new[:, 0]
    o = decode_attention(q, cache_k, cache_v, length=pos + 1)
    return _out_proj(p, o, x.dtype)


def attn_cross_decode(p, x, cfg: ModelConfig, mem_k, mem_v):
    """Cross-attention decode against the precomputed encoder K/V
    ``mem_k``, ``mem_v`` [b, S_enc, kv, hd] (no RoPE).  x: [b, 1, d]."""
    q = _project_q(p, x, cfg)
    o = decode_attention(q, mem_k, mem_v, length=None)
    return _out_proj(p, o, x.dtype)
