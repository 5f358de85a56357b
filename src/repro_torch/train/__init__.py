"""Training (``repro/train``): the step factories and the fault-tolerant
loop.

The reference's data-parallel training (``train/dp.py``: ``shard_map``
over a ``('pod', 'data')`` mesh with compressed gradient all-reduce)
goes with the sharding slice (ROADMAP Queue 1 item 14f).
"""

from repro_torch.train.loop import LoopConfig, LoopResult, run_training
from repro_torch.train.step import (make_decode_step, make_eval_step,
                                    make_prefill_step, make_train_step)

__all__ = ["LoopConfig", "LoopResult", "run_training", "make_train_step",
           "make_eval_step", "make_prefill_step", "make_decode_step"]
