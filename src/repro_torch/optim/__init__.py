"""The optimizer (``repro/optim``): AdamW with f32 masters.

The reference's gradient compression (``optim/compression.py``:
``compressed_psum`` over a ``('pod', 'data')`` mesh and its int8
quantizers) and ``adamw_init_specs`` (the dry-run's shapes) go with the
sharding slice (ROADMAP Queue 1 item 14f).
"""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    lr_schedule,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "lr_schedule"]
