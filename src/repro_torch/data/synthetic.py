"""Deterministic synthetic token pipeline (``repro/data/synthetic.py``).

Batches are a pure function of (seed, step), so a restarted run resumes
the exact stream with no iterator state to persist.  Documents are
Zipf-ish token sequences packed with EOS delimiters, and the loss mask
ignores padding.  ``host_batch`` is numpy and draws exactly what the
reference draws, in the same order, so its batches equal the
reference's bit for bit; ``device_batch`` and ``SyntheticStream`` put
them on a torch device (None: CUDA, raising without a card), or, with
``shardings`` (a dict of ``NamedSharding`` like the batch), lay each leaf
out on its mesh (``sharding.layout.put``: each shard's rows on its
shard's device, the per-host loading of the reference's
``make_array_from_callback``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.sharding.layout import put

EOS = 1
PAD = 0


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    mean_doc_len: int = 512
    zipf_a: float = 1.2           # token distribution skew


def _doc_lengths(rng: np.random.Generator, total: int, mean_len: int):
    lens = []
    left = total
    while left > 0:
        n = int(np.clip(rng.geometric(1.0 / mean_len), 8, left))
        lens.append(n)
        left -= n
    return lens


def host_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               dcfg: DataConfig = DataConfig()) -> dict:
    """One packed global batch as numpy arrays (a pure function of step):
    ``tokens``, ``labels``, ``mask`` [b, s] int32, and ``frame_embeds``
    [b, encoder_seq, d] (encoder-decoder) or ``patch_embeds`` [b, P, d]
    (VLM) f32."""
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    b, s = shape.global_batch, shape.seq_len
    tokens = np.empty((b, s), np.int32)
    for i in range(b):
        row = []
        for n in _doc_lengths(rng, s, dcfg.mean_doc_len):
            doc = rng.zipf(dcfg.zipf_a, size=n - 1).astype(np.int64)
            doc = (doc % (cfg.vocab_size - 2)) + 2      # reserve PAD/EOS
            row.extend(doc.tolist())
            row.append(EOS)
        tokens[i] = np.asarray(row[:s], np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = EOS
    mask = (tokens != PAD).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels, "mask": mask}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return batch


def device_batch(cfg, shape, step, device=None,
                 dcfg: DataConfig = DataConfig(), shardings=None) -> dict:
    """``host_batch`` as tensors on ``device`` (None: CUDA, raising
    without a card), each with its numpy dtype; with ``shardings`` each
    leaf a ``ShardedTensor`` on the mesh's devices (``device`` unused)."""
    hb = host_batch(cfg, shape, step, dcfg)
    if shardings is not None:
        return {k: put(v, shardings[k]) for k, v in hb.items()}
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}


class SyntheticStream:
    """Step-indexed iterator facade (resume = construct with
    ``start_step``)."""

    def __init__(self, cfg, shape, start_step: int = 0,
                 dcfg: DataConfig = DataConfig(), device=None,
                 shardings=None):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        self.step = start_step
        self.shardings = shardings
        self.device = None if shardings is not None else resolve_device(
            device)

    def __iter__(self):
        return self

    def __next__(self):
        b = device_batch(self.cfg, self.shape, self.step, self.device,
                         self.dcfg, self.shardings)
        self.step += 1
        return b
