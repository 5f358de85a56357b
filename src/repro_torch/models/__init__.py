"""Model API of the port's LM stack: every family of the registry (dense,
MoE, hybrid, pure SSM, VLM and the encoder-decoder), for serving and
training.

``build_model(cfg, device=None)`` returns a ``ModelApi`` whose functions
run on the CUDA device unless ``device="cpu"`` is passed: ``None`` means
CUDA and raises without a card, never falling back to the CPU.  The
reference's ``ShapeDtypeStruct`` stand-ins (``param_specs``,
``decode_cache_specs``, ``input_specs``) are tensors on the ``meta``
device: a shape and a dtype with no storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T

META = torch.device("meta")


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable           # (seed=0) -> params
    train_loss: Callable            # (params, batch, force=None) -> (loss, metrics)
    prefill: Callable               # (params, batch, force=None) -> logits [b, V]
    decode_step: Callable           # (params, cache, tokens, pos) -> (logits, cache)
    init_decode_cache: Callable     # (batch, max_seq) -> cache
    param_specs: Callable           # () -> params as meta tensors
    decode_cache_specs: Callable    # (batch, max_seq) -> cache as meta tensors

    def input_specs(self, shape: ShapeConfig,
                    batch_override: int | None = None) -> dict:
        """Meta-tensor stand-ins for every model input of this shape cell
        (global logical shapes; the launcher attaches shardings)."""
        cfg = self.cfg
        b = batch_override or shape.global_batch
        s = shape.seq_len
        dt = getattr(torch, cfg.dtype)

        def sds(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device=META)
        if shape.kind == "decode":       # one new token against the cache
            return {"cache": self.decode_cache_specs(b, s),
                    "tokens": sds((b, 1)), "pos": sds(())}
        names = (("tokens", "labels", "mask") if shape.kind == "train"
                 else ("tokens",))
        batch = {n: sds((b, s)) for n in names}
        if cfg.is_encoder_decoder:
            batch["frame_embeds"] = sds((b, cfg.encoder_seq, cfg.d_model),
                                        dt)
        if cfg.frontend == "vision":
            batch["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model), dt)
        return {"batch": batch}


    def stacked_name(self, name: str) -> str:
        """The reference's leaf that the port's leaf ``name`` is a slice
        of: ``layers/<i>/...`` of ``groups/pos<i % group_size>/...`` and
        ``enc_layers/<i>/...`` / ``dec_layers/<i>/...`` of
        ``enc_layers/...`` / ``dec_layers/...`` (stacked on a leading
        layer dim); any other leaf is its own."""
        parts = name.split("/")
        if parts[0] == "layers":
            j = int(parts[1]) % T.group_size(self.cfg)
            return "/".join(["groups", f"pos{j}", *parts[2:]])
        if parts[0] in ("enc_layers", "dec_layers"):
            return "/".join([parts[0], *parts[2:]])
        return name


def build_model(cfg: ModelConfig, device=None) -> ModelApi:
    """The API of ``cfg`` on ``device`` (None: CUDA): the
    encoder-decoder (``models.encdec``, a batch of ``frame_embeds`` and
    ``tokens``) or a decoder-only family (``models.transformer``).
    ``train_loss``'s metrics are ``loss``, ``aux`` and ``tokens``."""
    dev = resolve_device(device)
    m = E if cfg.is_encoder_decoder else T
    return ModelApi(
        cfg=cfg, device=dev,
        init_params=lambda seed=0: m.init_params(cfg, seed, dev),
        train_loss=lambda p, b, force=None: m.train_loss(cfg, p, b,
                                                         force=force),
        prefill=lambda p, b, force=None: m.prefill(cfg, p, b, force=force),
        decode_step=lambda p, c, t, pos: m.decode_step(cfg, p, c, t, pos),
        init_decode_cache=lambda b, s: m.init_decode_cache(cfg, b, s, dev),
        param_specs=lambda: m.init_params(cfg, 0, META),
        decode_cache_specs=lambda b, s: m.init_decode_cache(cfg, b, s, META),
    )
