"""Decoder-only LM serving: the dense, MoE, hybrid (Jamba), pure-SSM
(Mamba-2) and VLM families (``repro/models/transformer.py``).

Parameters are a dict of tensors in the reference's layouts, with the
layers as a list (``params["layers"][i]``) rather than stacked groups:
PyTorch runs eagerly, so ``backbone`` is a loop over layers and the
reference's ``scan_layers`` and ``remat`` have no meaning here (nor has
``sharding.annotate``, a no-op without a mesh).  Layer i takes the kind
of position ``i % group_size`` in the reference's group: an attention
layer (``attn``) or a Mamba-2 mixer (``mamba``), then, when ``d_ff > 0``,
``norm2`` and an MLP (``mlp``) or an MoE FFN (``moe``,
``cfg.layer_is_moe``).  A VLM batch may carry ``patch_embeds`` [b, P, d]
(the stub frontend's output), prepended to the token embeddings.

The decode cache holds each layer's kind: keys and values for the
attention layers only, conv buffers and SSD states for the Mamba-2
layers only, each stacked over the layers of its kind.
``train_loss`` and ``chunked_xent`` wait for the training slice (ROADMAP
Queue 1 item 14e).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as S
from repro_torch.models import moe as M


def group_size(cfg: ModelConfig) -> int:
    a = cfg.attn_layer_period if (cfg.ssm is not None
                                  and cfg.attn_layer_period > 1) else 1
    m = cfg.moe.layer_period if cfg.moe.n_experts else 1
    g = math.lcm(max(a, 1), m)
    assert cfg.n_layers % g == 0, (cfg.name, cfg.n_layers, g)
    return g


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // group_size(cfg)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer_kind(cfg: ModelConfig, i: int) -> str:
    return "attn" if cfg.layer_is_attn(i % group_size(cfg)) else "mamba"


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0


def _is_moe(cfg: ModelConfig, i: int) -> bool:
    return cfg.layer_is_moe(i % group_size(cfg))


def cache_slots(cfg: ModelConfig) -> list[int]:
    """Layer i's index among the layers of its kind: its row of the
    decode cache's ``k``/``v`` (attention) or ``conv``/``state``
    (Mamba-2) stack."""
    seen = {"attn": 0, "mamba": 0}
    slots = []
    for i in range(cfg.n_layers):
        kind = _layer_kind(cfg, i)
        slots.append(seen[kind])
        seen[kind] += 1
    return slots


# ------------------------------------------------------------------- init

def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from ``seed``, drawn on ``device`` (None: CUDA,
    raising without a card) by a ``torch.Generator`` there, in the
    config's dtype.  The draws are the reference's distributions, not its
    bits: weights carried across from the reference go through
    ``repro_torch.convert.params_from_reference``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = _dtype(cfg)
    params = {"embed": L.init_embed(cfg, gen, dtype),
              "head": L.init_lm_head(cfg, gen, dtype),
              "final_norm": L.init_norm(cfg, dtype, device),
              "layers": []}
    for i in range(cfg.n_layers):
        lp = {"norm1": L.init_norm(cfg, dtype, device)}
        if _layer_kind(cfg, i) == "attn":
            lp["attn"] = A.init_attn(cfg, gen, dtype)
        else:
            lp["mamba"] = S.init_mamba(cfg, gen, dtype)
        if _has_ffn(cfg):
            lp["norm2"] = L.init_norm(cfg, dtype, device)
            if _is_moe(cfg, i):
                lp["moe"] = M.init_moe(cfg, gen, dtype)
            else:
                lp["mlp"] = L.init_mlp(cfg, gen, dtype)
        params["layers"].append(lp)
    return params


# ---------------------------------------------------------------- forward

def _use_rope(cfg: ModelConfig) -> bool:
    return cfg.norm_type == "rmsnorm"


def _ffn(cfg, lp, x):
    """x plus the layer's MLP or MoE FFN (the MoE's aux loss is not used
    in serving)."""
    if not _has_ffn(cfg):
        return x
    h = L.apply_norm(lp["norm2"], x, cfg)
    if "moe" in lp:
        return x + M.apply_moe(lp["moe"], h, cfg)[0]
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def backbone(cfg: ModelConfig, params, x, *, force=None):
    """The layers over a [b, s, d] stream (before the final norm).
    ``force`` goes to the flash or SSD scan dispatch of every layer."""
    for lp in params["layers"]:
        h = L.apply_norm(lp["norm1"], x, cfg)
        if "attn" in lp:
            h = A.attn_forward(lp["attn"], h, cfg, use_rope=_use_rope(cfg),
                               force=force)
        else:
            h = S.mamba_forward(lp["mamba"], h, cfg, force=force)
        x = _ffn(cfg, lp, x + h)
    return x


def embed_inputs(cfg: ModelConfig, params, batch):
    """tokens [+ patch_embeds] -> [b, P + s, d]: a VLM batch's
    ``patch_embeds`` [b, P, d] (cast to the embeddings' dtype) go before
    the token embeddings."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------- serving

def prefill(cfg: ModelConfig, params, batch, *, force=None):
    """Prefill forward -> last-position logits [b, V] f32 (no cache, as
    the reference's).  ``batch``: ``tokens`` [b, s] (and ``patch_embeds``
    for a VLM).  ``force`` (None | 'cuda' | 'torch') picks how the flash
    branch or the SSD scan runs."""
    x = embed_inputs(cfg, params, batch)
    x = backbone(cfg, params, x, force=force)
    x = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
    return L.lm_logits(params["embed"], params["head"], x, cfg)[:, 0]


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    """Zero decode cache on ``device`` (None: CUDA, raising without a
    card), by layer kind: for the attention layers ``{"k": [La, b, S, kv,
    hd], "v": ...}`` in the config's dtype, for the Mamba-2 layers
    ``{"conv": [Lm, b, K-1, conv_dim]`` in the config's dtype, ``"state":
    [Lm, b, h, p, n]`` f32``}`` (``cache_slots`` maps a layer to its row);
    a family without one of the kinds has no such keys.  ``decode_step``
    writes it in place."""
    device = resolve_device(device)
    kinds = [_layer_kind(cfg, i) for i in range(cfg.n_layers)]
    n_attn, n_mamba = kinds.count("attn"), kinds.count("mamba")
    cache = {}
    if n_attn:
        shape = (n_attn, batch, max_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim())
        cache.update({name: torch.zeros(shape, dtype=_dtype(cfg),
                                        device=device)
                      for name in ("k", "v")})
    if n_mamba:
        (conv, conv_dt), (state, state_dt) = S.mamba_decode_cache_specs(
            cfg, batch)
        cache["conv"] = torch.zeros((n_mamba, *conv), dtype=conv_dt,
                                    device=device)
        cache["state"] = torch.zeros((n_mamba, *state), dtype=state_dt,
                                     device=device)
    return cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One decode step for all sequences at position ``pos`` (an int).
    tokens: [b, 1] int.  Writes the new keys and values (or conv buffers
    and SSD states) into ``cache`` in place.  Returns (logits [b, V] f32,
    cache)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    for lp, j in zip(params["layers"], cache_slots(cfg)):
        h = L.apply_norm(lp["norm1"], x, cfg)
        if "attn" in lp:
            h = A.attn_decode(lp["attn"], h, cfg, cache["k"][j],
                              cache["v"][j], pos, use_rope=_use_rope(cfg))
        else:
            h, conv, state = S.mamba_decode(lp["mamba"], h, cfg,
                                            cache["conv"][j],
                                            cache["state"][j])
            cache["conv"][j].copy_(conv)
            cache["state"][j].copy_(state)
        x = _ffn(cfg, lp, x + h)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], params["head"], x, cfg)[:, 0], cache
