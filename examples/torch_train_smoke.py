"""End-to-end training on the PyTorch port: a reduced registry LM trained
with the full stack (packed synthetic data, AdamW with warmup + cosine,
gradient accumulation, atomic asynchronous checkpoints, resume, straggler
detection).  The port of ``examples/train_smoke.py``.

    PYTHONPATH=src python examples/torch_train_smoke.py --arch qwen2-1.5b --steps 30
    PYTHONPATH=src python examples/torch_train_smoke.py --device cpu

The run crashes on purpose at ``--crash-at`` (default: two thirds of the
steps; 0 for none) and resumes from its last checkpoint (every 10 steps,
or every third of a shorter run), as a killed and rerun job would.  It
asserts that the loss falls and that the resumed run started from that
checkpoint.  Checkpoints and ``metrics.jsonl`` go to ``--ckpt-dir``
(default: a fresh temporary directory, removed at the end).  Runs on the
CUDA device unless ``--device`` says otherwise, and raises without one.
"""

import argparse
import json
import os
import shutil
import tempfile

from repro_torch.configs import ARCH_IDS, get_config, smoke_reduce
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import LoopConfig, run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    crash_at = (args.steps * 2 // 3 if args.crash_at is None
                else args.crash_at) or None
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="ecosched_train_")

    cfg = smoke_reduce(get_config(args.arch))
    api = build_model(cfg, device=args.device)
    shape = ShapeConfig("smoke", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    ocfg = AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=args.steps)
    lcfg = LoopConfig(steps=args.steps, ckpt_dir=ckpt_dir,
                      ckpt_every=min(10, max(1, args.steps // 3)),
                      microbatches=args.microbatches, log_every=5)
    metrics = os.path.join(ckpt_dir, "metrics.jsonl")
    try:
        if crash_at is not None:
            try:
                run_training(api, shape, ocfg, lcfg, crash_at_step=crash_at,
                             metrics_path=metrics)
            except RuntimeError as e:
                print(f"{e}; resuming from the last checkpoint")
        res = run_training(api, shape, ocfg, lcfg, metrics_path=metrics)
        with open(metrics) as f:
            first = json.loads(f.readline())["loss"]      # step 0
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"\narch={cfg.name} (reduced) steps={res.final_step} "
          f"resumed_from={res.resumed_from} on {api.device}")
    print(f"loss: {first:.3f} -> {res.losses[-1]:.3f}")
    times = sorted(res.step_times)
    print(f"median step time: {times[len(times) // 2]:.2f}s; "
          f"straggler events: {len(res.straggler_events)}")
    assert res.losses[-1] < first, "training must reduce loss"
    if crash_at is not None:
        want = crash_at // lcfg.ckpt_every * lcfg.ckpt_every or None
        assert res.resumed_from == want, (res.resumed_from, want)
    return res


if __name__ == "__main__":
    main()
