"""Decoder-only LM serving: the dense and pure-SSM (Mamba-2) families
(``repro/models/transformer.py``).

Parameters are a dict of tensors in the reference's layouts, with the
layers as a list (``params["layers"][i]``) rather than stacked groups:
PyTorch runs eagerly, so ``backbone`` is a loop over layers and the
reference's ``scan_layers`` and ``remat`` have no meaning here (nor has
``sharding.annotate``, a no-op without a mesh).  A layer is an attention
layer (``attn``) or a Mamba-2 mixer (``mamba``), with ``norm2`` and an MLP
after it when ``d_ff > 0``.

The dense family and pure SSM are ported.  A config with MoE or hybrid
layers, an encoder-decoder or a VLM prefix raises
``NotImplementedError`` naming its ROADMAP item; ``train_loss`` and
``chunked_xent`` wait for the training slice (Queue 1 item 14e).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as S


def group_size(cfg: ModelConfig) -> int:
    a = cfg.attn_layer_period if (cfg.ssm is not None
                                  and cfg.attn_layer_period > 1) else 1
    m = cfg.moe.layer_period if cfg.moe.n_experts else 1
    g = math.lcm(max(a, 1), m)
    assert cfg.n_layers % g == 0, (cfg.name, cfg.n_layers, g)
    return g


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // group_size(cfg)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run
    yet, naming its ROADMAP item (Queue 1)."""
    if cfg.is_encoder_decoder:
        why = "the encoder-decoder waits for ROADMAP Queue 1 item 14d"
    elif cfg.ssm is not None and cfg.attn_layer_period > 0:
        why = "hybrid SSM/attention layers wait for ROADMAP Queue 1 item 14c"
    elif cfg.moe.n_experts:
        why = "MoE layers wait for ROADMAP Queue 1 item 14c"
    elif cfg.frontend != "none":
        why = "the VLM prefix waits for ROADMAP Queue 1 item 14d"
    else:
        return
    raise NotImplementedError(f"{cfg.name} ({cfg.family}): {why}; the port "
                              f"serves the dense and pure-SSM families only")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer_kind(cfg: ModelConfig, i: int) -> str:
    return "attn" if cfg.layer_is_attn(i % group_size(cfg)) else "mamba"


def _has_ffn(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0


# ------------------------------------------------------------------- init

def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from ``seed``, drawn on ``device`` (None: CUDA,
    raising without a card) by a ``torch.Generator`` there, in the
    config's dtype.  The draws are the reference's distributions, not its
    bits: weights carried across from the reference go through
    ``repro_torch.convert.params_from_reference``."""
    check_supported(cfg)
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
            lp["mlp"] = L.init_mlp(cfg, gen, dtype)
        params["layers"].append(lp)
    return params


# ---------------------------------------------------------------- forward

def _use_rope(cfg: ModelConfig) -> bool:
    return cfg.norm_type == "rmsnorm"


def _ffn(cfg, lp, x):
    if not _has_ffn(cfg):
        return x
    return x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg), cfg)


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
    """tokens -> [b, s, d] (the text path; the VLM prefix waits for
    ROADMAP Queue 1 item 14d)."""
    return L.embed_tokens(params["embed"], batch["tokens"], cfg)


# ---------------------------------------------------------------- serving

def prefill(cfg: ModelConfig, params, batch, *, force=None):
    """Prefill forward -> last-position logits [b, V] f32 (no cache, as
    the reference's).  ``force`` (None | 'cuda' | 'torch') picks how the
    flash branch or the SSD scan runs."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, batch)
    x = backbone(cfg, params, x, force=force)
    x = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
    return L.lm_logits(params["embed"], params["head"], x, cfg)[:, 0]


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    """Zero decode cache on ``device`` (None: CUDA, raising without a
    card): the KV cache ``{"k": [L, b, S, kv, hd], "v": ...}`` in the
    config's dtype for attention layers, or for Mamba-2 layers
    ``{"conv": [L, b, K-1, conv_dim]`` in the config's dtype, ``"state":
    [L, b, h, p, n]`` f32``}`` (``max_seq`` unused).  ``decode_step``
    writes it in place."""
    check_supported(cfg)
    device = resolve_device(device)
    if _layer_kind(cfg, 0) == "mamba":
        (conv, conv_dt), (state, state_dt) = S.mamba_decode_cache_specs(
            cfg, batch)
        return {"conv": torch.zeros((cfg.n_layers, *conv), dtype=conv_dt,
                                    device=device),
                "state": torch.zeros((cfg.n_layers, *state), dtype=state_dt,
                                     device=device)}
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    return {name: torch.zeros(shape, dtype=_dtype(cfg), device=device)
            for name in ("k", "v")}


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One decode step for all sequences at position ``pos`` (an int).
    tokens: [b, 1] int.  Writes the new keys and values (or conv buffers
    and SSD states) into ``cache`` in place.  Returns (logits [b, V] f32,
    cache)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(lp["norm1"], x, cfg)
        if "attn" in lp:
            h = A.attn_decode(lp["attn"], h, cfg, cache["k"][i],
                              cache["v"][i], pos, use_rope=_use_rope(cfg))
        else:
            h, conv, state = S.mamba_decode(lp["mamba"], h, cfg,
                                            cache["conv"][i],
                                            cache["state"][i])
            cache["conv"][i].copy_(conv)
            cache["state"][i].copy_(state)
        x = _ffn(cfg, lp, x + h)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], params["head"], x, cfg)[:, 0], cache
