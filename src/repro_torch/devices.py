"""Device resolution for the port's public entry points.

Every entry point that creates tensors (``init_params``,
``init_paged_cache``, the serving engine, the serve CLI) runs on the
card unless the caller asks for another device.  There is no silent
fall-back: without CUDA the default raises, and the CPU is used only
when the caller passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` for a CUDA device on a host without CUDA.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and CUDA is not "
            "available here; pass device='cpu' to run on the CPU")
    return dev


def tensor_device(tree) -> Optional[torch.device]:
    """Device of the first tensor in a nested dict (None if empty)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for sub in tree.values():
            dev = tensor_device(sub)
            if dev is not None:
                return dev
    return None
