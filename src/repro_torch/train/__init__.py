"""Training (``repro/train``): the step factories, the fault-tolerant
loop and the hierarchical data-parallel step over a ``('pod', 'data')``
mesh with compressed cross-pod gradients (``train/dp.py``)."""

from repro_torch.train.dp import init_dp_state, make_dp_train_step
from repro_torch.train.loop import LoopConfig, LoopResult, run_training
from repro_torch.train.step import (make_decode_step, make_eval_step,
                                    make_prefill_step, make_train_step)

__all__ = ["LoopConfig", "LoopResult", "run_training", "make_train_step",
           "make_eval_step", "make_prefill_step", "make_decode_step",
           "make_dp_train_step", "init_dp_state"]
