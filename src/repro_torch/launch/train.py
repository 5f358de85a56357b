"""Training launcher (``repro/launch/train.py``): the fault-tolerant loop
on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        tinyllama-1.1b --reduced --steps 20 --device cpu

Runs on the CUDA device by default (``--device cuda``) and raises
without one.  ``--reduced`` is the smoke-size config (``smoke_reduce``)
at seq 64 and batch 4 (``--seq`` / ``--batch`` override them), with one
microbatch; otherwise the shape is ``--shape`` (train_4k: 4,096 x 256)
and the config's microbatches.  Weights come from the port's seeded
init.  Checkpoints go to ``--ckpt-dir`` (default: ``ecosched_train``
under the temporary directory), and a rerun resumes from its latest.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_reduce
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import LoopConfig, run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config")
    ap.add_argument("--batch", type=int, default=0, help="override batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "ecosched_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke_reduce(cfg)
    shape = SHAPES[args.shape]
    if args.reduced:
        shape = ShapeConfig("reduced", seq_len=args.seq or 64,
                            global_batch=args.batch or 4, kind="train")
    elif args.batch or args.seq:
        shape = ShapeConfig("custom", seq_len=args.seq or shape.seq_len,
                            global_batch=args.batch or shape.global_batch,
                            kind="train")

    mb = args.microbatches or (1 if args.reduced else cfg.microbatches)
    api = build_model(cfg, device=args.device)
    ocfg = AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 20, 2),
                       total_steps=args.steps)
    lcfg = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, microbatches=mb)
    n_dev = torch.cuda.device_count() if api.device.type == "cuda" else 1
    print(f"training {cfg.name}{' (reduced)' if args.reduced else ''} "
          f"seq={shape.seq_len} batch={shape.global_batch} mb={mb} "
          f"on {n_dev} device(s)")
    res = run_training(api, shape, ocfg, lcfg,
                       metrics_path=args.metrics or None)
    losses = (f"{res.losses[0]:.3f} -> {res.losses[-1]:.3f}" if res.losses
              else "none (no step left to run)")
    print(f"done: steps={res.final_step} resumed_from={res.resumed_from} "
          f"loss {losses} stragglers={len(res.straggler_events)}")
    return res


if __name__ == "__main__":
    main()
