"""Model API of the port's LM stack (dense-decoder and pure-SSM serving).

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
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable           # (seed=0) -> params
    prefill: Callable               # (params, batch, force=None) -> logits [b, V]
    decode_step: Callable           # (params, cache, tokens, pos) -> (logits, cache)
    init_decode_cache: Callable     # (batch, max_seq) -> cache


def build_model(cfg: ModelConfig, device=None) -> ModelApi:
    """The serving API of ``cfg`` on ``device`` (None: CUDA): the dense
    family and pure SSM (Mamba-2).  Raises ``NotImplementedError`` for a
    family the port does not serve yet (MoE, hybrid, encoder-decoder,
    VLM)."""
    T.check_supported(cfg)
    dev = resolve_device(device)
    return ModelApi(
        cfg=cfg, device=dev,
        init_params=lambda seed=0: T.init_params(cfg, seed, dev),
        prefill=lambda p, b, force=None: T.prefill(cfg, p, b, force=force),
        decode_step=lambda p, c, t, pos: T.decode_step(cfg, p, c, t, pos),
        init_decode_cache=lambda b, s: T.init_decode_cache(cfg, b, s, dev),
    )
