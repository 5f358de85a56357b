"""The optimizer (``repro/optim``): AdamW with f32 masters, and int8
error-feedback compression of the cross-pod gradient reduction."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_init_specs,
    adamw_update,
    global_norm,
    lr_schedule,
)
from repro_torch.optim.compression import (
    compress_with_feedback,
    compressed_psum,
    dequantize_int8,
    init_error_state,
    quantize_int8,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_init_specs", "adamw_update",
           "global_norm", "lr_schedule", "compress_with_feedback",
           "compressed_psum", "dequantize_int8", "init_error_state",
           "quantize_int8"]
