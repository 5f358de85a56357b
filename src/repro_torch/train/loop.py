"""Fault-tolerant training loop (``repro/train/loop.py``).

  - checkpoint / restart: params and optimizer state through
    ``CheckpointManager`` (atomic, asynchronous saves; every tensor copied
    to the host before ``save`` returns); a resumed run restores the
    latest step and rebuilds the data stream from it (batches are a pure
    function of the step);
  - straggler detection: each step's wall time against the median of the
    last 50; a step over ``straggler_factor`` times it is logged;
  - crash injection (``crash_at_step``) for the fault-tolerance tests;
  - a JSONL metrics file every ``log_every`` steps.

A step's wall time ends at ``float(loss)``, which waits for the step: on
the card that is one device-to-host copy a step.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import ModelApi
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step


@dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    keep_n: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    microbatches: int = 1
    seed: int = 0


@dataclass
class LoopResult:
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    straggler_events: list = field(default_factory=list)
    final_step: int = 0
    resumed_from: int | None = None


def run_training(api: ModelApi, shape, ocfg: AdamWConfig, lcfg: LoopConfig,
                 crash_at_step: int | None = None,
                 metrics_path: str | None = None) -> LoopResult:
    """Single-process training on ``api.device`` with checkpoint /
    resume.  Returns a ``LoopResult``."""
    cfg = api.cfg
    mgr = CheckpointManager(lcfg.ckpt_dir, keep_n=lcfg.keep_n)
    res = LoopResult()

    params = api.init_params(lcfg.seed)
    opt_state = adamw_init(params)
    start_step = 0
    restored, ck_step, _meta = mgr.restore({"params": params,
                                            "opt": opt_state})
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        start_step = ck_step
        res.resumed_from = ck_step

    step_fn = make_train_step(api, ocfg, lcfg.microbatches)
    stream = SyntheticStream(cfg, shape, start_step=start_step,
                             dcfg=DataConfig(seed=lcfg.seed),
                             device=api.device)
    mfile = open(metrics_path, "a") if metrics_path else None

    try:
        for step in range(start_step, lcfg.steps):
            if crash_at_step is not None and step == crash_at_step:
                mgr.wait()
                raise RuntimeError(f"injected crash at step {step}")
            batch = next(stream)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])      # waits for the step
            dt = time.perf_counter() - t0
            res.losses.append(loss)
            res.step_times.append(dt)
            if len(res.step_times) >= 5:
                med = statistics.median(res.step_times[-50:])
                if dt > lcfg.straggler_factor * med:
                    res.straggler_events.append(
                        {"step": step, "dt": dt, "median": med})
            if mfile and step % lcfg.log_every == 0:
                mfile.write(json.dumps({"step": step, "loss": loss, "dt": dt,
                                        "lr": float(metrics["lr"])}) + "\n")
                mfile.flush()
            if (step + 1) % lcfg.ckpt_every == 0 or step + 1 == lcfg.steps:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         metadata={"loss": loss, "arch": cfg.name})
            res.final_step = step + 1
        mgr.wait()
    finally:
        if mfile:
            mfile.close()
    assert np.isfinite(res.losses[-1]) if res.losses else True
    return res
