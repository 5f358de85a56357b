"""Serving launcher: a greedy batched decode loop (``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --reduced --device cpu

``--arch`` takes every registry id (dense, MoE, hybrid, SSM, VLM and the
encoder-decoder).  As in the reference's launcher, whisper-medium decodes
against its zero cross-attention memory and phi-3-vision decodes text
tokens only (no image prefix).  Runs on the CUDA device by default (``--device cuda``) and raises without
one.  Weights come from the port's own seeded init
(``api.init_params(0)``), not the reference's draws.  The first token of
each sequence is ``jax.random.randint(key(0), (batch, 1), 2, vocab)``,
reproduced bit for bit by ``repro_torch.utils.prng.randint``; the later
ones are the argmax of the logits.  The first decode step is the warm-up,
and the remaining ``--tokens - 1`` are timed.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_reduce
from repro_torch.models import build_model
from repro_torch.utils import prng


def greedy_decode(api, params, cache, logits, start: int, stop: int):
    """Decode positions ``start..stop-1``, each from the argmax of the
    previous logits.  Returns the last logits."""
    for pos in range(start, stop):
        tok = torch.argmax(logits, -1)[:, None]
        logits, cache = api.decode_step(params, cache, tok, pos)
    return logits


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_reduce(cfg)
    api = build_model(cfg, device=args.device)
    params = api.init_params(0)
    cache = api.init_decode_cache(args.batch, args.max_seq)

    tok = prng.randint(prng.key(0, device=api.device), (args.batch, 1), 2,
                       cfg.vocab_size)
    logits, cache = api.decode_step(params, cache, tok, 0)   # warm-up
    on_card = api.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(api.device)
    t0 = time.perf_counter()
    logits = greedy_decode(api, params, cache, logits, 1, args.tokens)
    if on_card:
        torch.cuda.synchronize(api.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    n_dev = torch.cuda.device_count() if on_card else 1
    steps = args.tokens - 1
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''}: "
          f"{args.batch * steps / dt:.1f} tok/s "
          f"(batch {args.batch}, {args.tokens} steps, {n_dev} device(s))")
    return {"cfg": cfg, "logits": logits, "seconds": dt, "steps": steps,
            "tokens_per_s": args.batch * steps / dt,
            "ms_per_step": dt / steps * 1e3 if steps else None}


if __name__ == "__main__":
    main()
