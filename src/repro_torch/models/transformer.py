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

Training: ``train_loss`` is the mean next-token cross-entropy over the
mask (``chunked_xent``, chunk by chunk over the sequence so the [b, s, V]
f32 logits never exist at once) plus ``AUX_LOSS_COEF`` times the MoE
layers' load-balance loss, summed group by group in layer order as the
reference's scan does.  Remat: with ``cfg.remat_policy`` other than
"none" each layer runs under ``torch.utils.checkpoint.checkpoint``
(non-reentrant), the reference's ``jax.checkpoint`` of each group:
"nothing_saveable" keeps only the layer's input and recomputes the rest
in the backward; "dots" (``dots_with_no_batch_dims_saveable``) is the
selective checkpoint that keeps the outputs of ``aten.mm`` (the products
without batch dims) and recomputes everything else.  Remat changes
memory, never values.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as S
from repro_torch.models import moe as M
from repro_torch.sharding.ctx import dispatch_shards

AUX_LOSS_COEF = 0.01
XENT_CHUNK = 512


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
    config's dtype; on ``"meta"`` the tree's shapes and dtypes with no
    draw (``ModelApi.param_specs``).  The draws are the reference's
    distributions, not its bits: weights carried across from the
    reference go through ``repro_torch.convert.params_from_reference``."""
    device = resolve_device(device)
    gen = L.generator(device, seed)
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


def _ffn(cfg, lp, x, shards):
    """x plus the layer's MLP or MoE FFN, and the MoE's aux loss (None
    for a layer without one).  ``shards``: the MoE's dispatch shards."""
    if not _has_ffn(cfg):
        return x, None
    h = L.apply_norm(lp["norm2"], x, cfg)
    if "moe" in lp:
        out, aux = M.apply_moe(lp["moe"], h, cfg, shards)
        return x + out, aux
    return x + L.apply_mlp(lp["mlp"], h, cfg), None


def _layer(cfg, lp, x, force, shards):
    """One layer (mixer, then FFN): (x, aux or None)."""
    h = L.apply_norm(lp["norm1"], x, cfg)
    if "attn" in lp:
        h = A.attn_forward(lp["attn"], h, cfg, use_rope=_use_rope(cfg),
                           force=force)
    else:
        h = S.mamba_forward(lp["mamba"], h, cfg, force=force)
    return _ffn(cfg, lp, x + h, shards)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep products without batch dims (``aten.mm``),
    recompute the rest."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str):
    """``fn`` run under the checkpoint of remat ``policy`` ("none":
    ``fn`` itself)."""
    if policy == "none":
        return fn
    if policy == "nothing_saveable":
        return partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _save_dots))
    raise ValueError(f"unknown remat policy {policy!r}")


def backbone(cfg: ModelConfig, params, x, *, force=None, remat_layers=False):
    """The layers over a [b, s, d] stream (before the final norm).
    Returns (x, aux: the MoE layers' aux losses, an f32 scalar, summed
    within each group and then over the groups).  ``force`` goes to the
    flash or SSD scan dispatch of every layer; ``remat_layers`` runs each
    layer under the checkpoint of ``cfg.remat_policy``.  The MoE dispatch
    shards are read from the rules here, once, outside the checkpoint:
    its recompute may run on autograd's device thread, which does not see
    this thread's ``use_rules``."""
    shards = dispatch_shards()
    layer = partial(_layer, cfg)
    if remat_layers:
        layer = remat(layer, cfg.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    g = group_size(cfg)
    for i, lp in enumerate(params["layers"]):
        if i % g == 0:
            aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux_j = layer(lp, x, force, shards)
        if aux_j is not None:
            aux_g = aux_g + aux_j
        if i % g == g - 1:
            aux = aux + aux_g
    return x, aux


def embed_inputs(cfg: ModelConfig, params, batch):
    """tokens [+ patch_embeds] -> [b, P + s, d]: a VLM batch's
    ``patch_embeds`` [b, P, d] (cast to the embeddings' dtype) go before
    the token embeddings."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def chunked_xent(cfg: ModelConfig, params, x, labels, mask,
                 chunk=XENT_CHUNK):
    """Sequence-chunked softmax cross-entropy, chunk by chunk as the
    reference's scan: f32 logits of one chunk at a time, the max
    subtracted without its gradient, the gold logit gathered.  x:
    [b, s, d]; labels, mask: [b, s] (a single chunk if ``s % chunk``).
    Returns (sum_nll, sum_cnt), f32 scalars."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        xs = x[:, lo:lo + chunk]
        ls = labels[:, lo:lo + chunk].long()
        ms = mask[:, lo:lo + chunk].float()
        logits = L.lm_logits(params["embed"], params["head"], xs, cfg)
        lf = logits - logits.amax(-1, keepdim=True).detach()
        logz = torch.log(torch.exp(lf).sum(-1))
        gold = torch.gather(lf, -1, ls[..., None])[..., 0]
        nll = nll + ((logz - gold) * ms).sum()
        cnt = cnt + ms.sum()
    return nll, cnt


def train_loss(cfg: ModelConfig, params, batch, *, force=None):
    """``batch``: tokens, labels, mask [b, s] (and ``patch_embeds`` for a
    VLM, whose positions are sliced off before the loss).  Returns (loss
    + AUX_LOSS_COEF * aux, {"loss", "aux", "tokens"}), f32 scalars.
    ``force`` goes to the flash or SSD scan dispatch."""
    x = embed_inputs(cfg, params, batch)
    n_prefix = x.shape[1] - batch["tokens"].shape[1]
    x, aux = backbone(cfg, params, x, force=force,
                      remat_layers=cfg.remat_policy != "none")
    x = L.apply_norm(params["final_norm"], x, cfg)
    if n_prefix:
        x = x[:, n_prefix:]
    nll, cnt = chunked_xent(cfg, params, x, batch["labels"], batch["mask"])
    loss = nll / torch.clamp(cnt, min=1.0)
    return loss + AUX_LOSS_COEF * aux, {"loss": loss, "aux": aux,
                                        "tokens": cnt}


# ---------------------------------------------------------------- serving

def prefill(cfg: ModelConfig, params, batch, *, force=None):
    """Prefill forward -> last-position logits [b, V] f32 (no cache, as
    the reference's).  ``batch``: ``tokens`` [b, s] (and ``patch_embeds``
    for a VLM).  ``force`` (None | 'cuda' | 'torch') picks how the flash
    branch or the SSD scan runs."""
    x = embed_inputs(cfg, params, batch)
    x, _ = backbone(cfg, params, x, force=force)
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
        x, _ = _ffn(cfg, lp, x + h, dispatch_shards())
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], params["head"], x, cfg)[:, 0], cache
