from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import (
    ARCH_IDS,
    applicable,
    get_config,
    get_shape,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "applicable", "get_config", "get_shape", "get_smoke_config",
]
