"""Model API of the port's LM stack: every family of the registry (dense,
MoE, hybrid, pure SSM, VLM and the encoder-decoder), for serving and
training.

``build_model(cfg, device=None)`` returns a ``ModelApi`` whose functions
run on the CUDA device unless ``device="cpu"`` is passed: ``None`` means
CUDA and raises without a card, never falling back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable           # (seed=0) -> params
    train_loss: Callable            # (params, batch, force=None) -> (loss, metrics)
    prefill: Callable               # (params, batch, force=None) -> logits [b, V]
    decode_step: Callable           # (params, cache, tokens, pos) -> (logits, cache)
    init_decode_cache: Callable     # (batch, max_seq) -> cache


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
    )
