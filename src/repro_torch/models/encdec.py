"""Encoder-decoder transformer, the Whisper-medium backbone
(``repro/models/encdec.py``).

The conv audio frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings [b, encoder_seq, d_model].  Whisper's
specifics: LayerNorm, GELU MLPs with biases, learned absolute positions
(``enc_pos``, ``dec_pos``), no RoPE, pre-LN blocks, the decoder's
embedding tied to its output.  Layers are lists (``enc_layers[i]``,
``dec_layers[i]``) where the reference stacks them.

Self-attention of the encoder and cross-attention take the rectangular
(non-causal) flash call when the reference's rule lets them (queries of
at least 2,048 positions, a multiple of 512, and keys a multiple of 512),
``plain_attention`` otherwise: whisper-medium's 1,500 frames never do.
The decoder's causal self-attention takes the triangular one.

Decode reads the cross-attention memory ``mem_k`` / ``mem_v`` from the
cache, as the reference's ``decode_step`` does; like the reference, the
API has no function that fills it (``init_decode_cache`` gives zeros).
A caller fills it from ``encode``'s output through each decoder layer's
``xattn`` K/V projection (``attention.attn_forward(..., kv_x=enc_out,
return_kv=True)``).

``train_loss`` runs ``encode``, ``decode_forward`` and
``transformer.chunked_xent`` (aux 0); with ``cfg.remat_policy`` other
than "none" each encoder and decoder layer runs under the checkpoint
(``transformer.remat``; the reference's ``jax.checkpoint`` of each
scanned layer saves nothing, so the port's is "nothing_saveable").
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

MAX_DEC_POSITIONS = 32_768


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init_layer(cfg: ModelConfig, gen, dtype, cross: bool):
    dev = gen.device
    lp = {"norm1": L.init_norm(cfg, dtype, dev),
          "attn": A.init_attn(cfg, gen, dtype),
          "norm_mlp": L.init_norm(cfg, dtype, dev),
          "mlp": L.init_mlp(cfg, gen, dtype)}
    if cross:
        lp["norm_x"] = L.init_norm(cfg, dtype, dev)
        lp["xattn"] = A.init_attn(cfg, gen, dtype, cross=True)
    return lp


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from ``seed`` on ``device`` (None: CUDA, raising
    without a card), the reference's distributions (positions: normal x
    0.02).  Weights carried across from the reference go through
    ``repro_torch.convert.params_from_reference``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = _dtype(cfg)

    def positions(n):
        return (torch.randn((n, cfg.d_model), generator=gen, device=device)
                * 0.02).to(dtype)
    return {
        "embed": L.init_embed(cfg, gen, dtype),
        "head": L.init_lm_head(cfg, gen, dtype),
        "enc_pos": positions(cfg.encoder_seq),
        "dec_pos": positions(MAX_DEC_POSITIONS),
        "enc_final_norm": L.init_norm(cfg, dtype, device),
        "dec_final_norm": L.init_norm(cfg, dtype, device),
        "enc_layers": [_init_layer(cfg, gen, dtype, cross=False)
                       for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [_init_layer(cfg, gen, dtype, cross=True)
                       for _ in range(cfg.n_layers)],
    }


def _enc_layer(cfg, lp, x, force):
    h = L.apply_norm(lp["norm1"], x, cfg)
    x = x + A.attn_forward(lp["attn"], h, cfg, causal=False, use_rope=False,
                           force=force)
    h = L.apply_norm(lp["norm_mlp"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def _dec_layer(cfg, lp, x, enc_out, force):
    h = L.apply_norm(lp["norm1"], x, cfg)
    x = x + A.attn_forward(lp["attn"], h, cfg, causal=True, use_rope=False,
                           force=force)
    h = L.apply_norm(lp["norm_x"], x, cfg)
    x = x + A.attn_forward(lp["xattn"], h, cfg, causal=False,
                           use_rope=False, kv_x=enc_out, force=force)
    h = L.apply_norm(lp["norm_mlp"], x, cfg)
    return x + L.apply_mlp(lp["mlp"], h, cfg)


def _policy(remat_layers: bool) -> str:
    return "nothing_saveable" if remat_layers else "none"


def encode(cfg: ModelConfig, params, frame_embeds, *, force=None,
           remat_layers=False):
    """frame_embeds [b, encoder_seq, d] -> the encoder's normed output
    [b, encoder_seq, d] in the config's dtype."""
    x = frame_embeds.to(_dtype(cfg)) + params["enc_pos"]
    layer = T.remat(_enc_layer, _policy(remat_layers))
    for lp in params["enc_layers"]:
        x = layer(cfg, lp, x, force)
    return L.apply_norm(params["enc_final_norm"], x, cfg)


def decode_forward(cfg: ModelConfig, params, tokens, enc_out, *,
                   force=None, remat_layers=False):
    """The decoder over tokens [b, s] against ``enc_out``: the normed
    stream [b, s, d]."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = x + params["dec_pos"][:tokens.shape[1]]
    layer = T.remat(_dec_layer, _policy(remat_layers))
    for lp in params["dec_layers"]:
        x = layer(cfg, lp, x, enc_out, force)
    return L.apply_norm(params["dec_final_norm"], x, cfg)


def train_loss(cfg: ModelConfig, params, batch, *, force=None):
    """``batch``: frame_embeds [b, F, d], tokens, labels, mask [b, s].
    Returns (loss, {"loss", "aux": 0, "tokens"}), f32 scalars."""
    remat_layers = cfg.remat_policy != "none"
    enc_out = encode(cfg, params, batch["frame_embeds"], force=force,
                     remat_layers=remat_layers)
    x = decode_forward(cfg, params, batch["tokens"], enc_out, force=force,
                       remat_layers=remat_layers)
    nll, cnt = T.chunked_xent(cfg, params, x, batch["labels"],
                              batch["mask"])
    loss = nll / torch.clamp(cnt, min=1.0)
    return loss, {"loss": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=x.device),
                  "tokens": cnt}


def prefill(cfg: ModelConfig, params, batch, *, force=None):
    """``batch``: ``frame_embeds`` [b, encoder_seq, d], ``tokens`` [b, s].
    Returns the last position's logits [b, V] f32.  ``force`` (None |
    'cuda' | 'torch') picks how the flash branch runs."""
    enc_out = encode(cfg, params, batch["frame_embeds"], force=force)
    x = decode_forward(cfg, params, batch["tokens"], enc_out, force=force)
    return L.lm_logits(params["embed"], params["head"], x[:, -1:], cfg)[:, 0]


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    """Zero cache on ``device`` (None: CUDA, raising without a card), in
    the config's dtype: ``self_k`` / ``self_v`` [L, b, max_seq, kv, hd] and
    the cross-attention memory ``mem_k`` / ``mem_v`` [L, b, encoder_seq,
    kv, hd]."""
    device = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    shapes = {"self": (cfg.n_layers, batch, max_seq, kv, hd),
              "mem": (cfg.n_layers, batch, cfg.encoder_seq, kv, hd)}
    return {f"{part}_{t}": torch.zeros(shape, dtype=_dtype(cfg),
                                       device=device)
            for part, shape in shapes.items() for t in ("k", "v")}


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One decoder token step at position ``pos`` (an int).  tokens:
    [b, 1].  Writes the self-attention keys and values into ``cache`` in
    place and reads ``mem_k`` / ``mem_v``.  Returns (logits [b, V] f32,
    cache)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = x + params["dec_pos"][pos:pos + 1]
    for i, lp in enumerate(params["dec_layers"]):
        h = L.apply_norm(lp["norm1"], x, cfg)
        x = x + A.attn_decode(lp["attn"], h, cfg, cache["self_k"][i],
                              cache["self_v"][i], pos, use_rope=False)
        h = L.apply_norm(lp["norm_x"], x, cfg)
        x = x + A.attn_cross_decode(lp["xattn"], h, cfg, cache["mem_k"][i],
                                    cache["mem_v"][i])
        h = L.apply_norm(lp["norm_mlp"], x, cfg)
        x = x + L.apply_mlp(lp["mlp"], h, cfg)
    x = L.apply_norm(params["dec_final_norm"], x, cfg)
    return L.lm_logits(params["embed"], params["head"], x, cfg)[:, 0], cache
