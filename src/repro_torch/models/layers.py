"""Shared building blocks of the LM stack: plain functions on dicts of
tensors, in the reference's layouts (``repro/models/layers.py``).

Numerics follow the reference: products that it takes with an f32 result
(``preferred_element_type``) and then uses in f32 are taken in f32 here
(the operands are widened first: a product of two bf16 values is exact in
f32, so this is the f32 accumulation the reference asks for); products
that it rounds straight back to the activation dtype run in that dtype.
Norms, RoPE and activations run in f32 and cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype):
    """Truncated-normal fan-in init: a standard normal truncated to
    (-2, 2), times ``in_dim ** -0.5``, drawn in f32 from ``gen`` on the
    generator's device and cast to ``dtype``.  Shape
    ``[in_dim, *out_shape]``."""
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * in_dim ** -0.5).to(dtype)


def dot(x, w, *, f32: bool = False):
    """``x @ w`` over x's last dimension.  ``f32=True`` gives the f32
    result of the widened operands (the reference's f32 product, kept in
    f32); otherwise the product is in x's dtype (the reference's f32
    product rounded once to x's dtype)."""
    if f32:
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w)


# ----------------------------------------------------------------- norms

def init_norm(cfg: ModelConfig, dtype, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------- RoPE

def rope_angles(positions, head_dim: int, theta: float):
    """positions: int tensor [...].  Returns (sin, cos) of shape
    [..., head_dim // 2], f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: [..., seq, heads, head_dim]; sin/cos: [seq, head_dim // 2]."""
    half = x.shape[-1] // 2
    s = sin[..., :, None, :]
    c = cos[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    o1 = xf1 * c - xf2 * s
    o2 = xf2 * c + xf1 * s
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ----------------------------------------------------------------- MLPs

def init_mlp(cfg: ModelConfig, gen, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, d, (f,), dtype),      # gate proj
                "wu": dense_init(gen, d, (f,), dtype),      # up proj
                "wo": dense_init(gen, f, (d,), dtype)}
    return {"wi": dense_init(gen, d, (f,), dtype),          # plain gelu MLP
            "bi": torch.zeros((f,), dtype=dtype, device=gen.device),
            "wo": dense_init(gen, f, (d,), dtype),
            "bo": torch.zeros((d,), dtype=dtype, device=gen.device)}


def apply_mlp(p, x, cfg: ModelConfig):
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = dot(x, p["wi"], f32=True)
        u = dot(x, p["wu"], f32=True)
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(
            g, approximate="tanh")
        return dot((act * u).to(x.dtype), p["wo"])
    h = dot(x, p["wi"], f32=True) + p["bi"].float()
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    return (dot(h, p["wo"], f32=True) + p["bo"].float()).to(x.dtype)


# ------------------------------------------------------------ embeddings

def init_embed(cfg: ModelConfig, gen, dtype):
    # table: [V, d]
    return {"table": dense_init(gen, cfg.d_model, (cfg.vocab_size,),
                                torch.float32).T.contiguous().to(dtype)}


def embed_tokens(p, tokens, cfg: ModelConfig):
    out = p["table"][tokens]
    scale = cfg.embed_scale()
    if scale is not None:
        # the scale rounded to the table's dtype first, as the reference
        # does; a 0-d CPU tensor enters a CUDA op as a scalar (no copy)
        out = out * torch.tensor(scale, dtype=out.dtype)
    return out


def lm_logits(embed_params, head_params, x, cfg: ModelConfig):
    """Final projection to the vocabulary, f32 logits.  Tied => reuse the
    embedding table."""
    table = embed_params["table"] if cfg.tie_embeddings else head_params["w"]
    return dot(x, table.T, f32=True)


def init_lm_head(cfg: ModelConfig, gen, dtype):
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, cfg.d_model, (cfg.vocab_size,),
                            dtype).T.contiguous()}                  # [V, d]
