from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    shape_applicable,
    smoke_reduce,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape, all_cells
