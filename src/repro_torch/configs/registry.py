"""--arch <id> registry mapping architecture ids to ModelConfigs."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable, smoke_reduce

_ARCH_MODULES = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "moonshot-v1-16b-a3b":   "repro_torch.configs.moonshot_v1_16b_a3b",
    "jamba-v0.1-52b":        "repro_torch.configs.jamba_v0_1_52b",
    "gemma-7b":              "repro_torch.configs.gemma_7b",
    "qwen2-1.5b":            "repro_torch.configs.qwen2_1_5b",
    "internlm2-20b":         "repro_torch.configs.internlm2_20b",
    "tinyllama-1.1b":        "repro_torch.configs.tinyllama_1_1b",
    "mamba2-780m":           "repro_torch.configs.mamba2_780m",
    "whisper-medium":        "repro_torch.configs.whisper_medium",
    "phi-3-vision-4.2b":     "repro_torch.configs.phi_3_vision_4_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells(include_skipped: bool = True):
    """Yield (arch_id, shape_name, applicable, reason) for the 40-cell matrix."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, reason = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch, sname, ok, reason
