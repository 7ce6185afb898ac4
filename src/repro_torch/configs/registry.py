"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import Callable

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "whisper-base": "repro_torch.configs.whisper_base",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).smoke_config()


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is part of the dry-run grid; reason if not.

    Skips are documented in DESIGN.md §Arch-applicability.
    """
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return False, "enc-dec decoder max context << 500k by construction"
        if not cfg.supports_long_context:
            return False, "pure full-attention stack; no sub-quadratic variant"
    return True, ""
