"""Weight bridge: the JAX package's parameter tree, as numpy, into torch.

The port keeps the reference parameter layout (same dict keys, stacked
layer axis first, einsum-shaped weights), so the bridge is a plain tree
map.  The caller converts the JAX tree with
``jax.tree.map(np.asarray, params)``; this module never imports JAX.

bfloat16 leaves arrive as numpy arrays of the ``ml_dtypes`` bfloat16
type, which ``torch.from_numpy`` rejects.  They cross as their raw 16-bit
patterns (a ``uint16`` view) and are reinterpreted as ``torch.bfloat16``
on the torch side — bit for bit, never through a float cast.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.layers import FLOAT32_LEAVES


def array_to_tensor(arr: np.ndarray) -> torch.Tensor:
    """One numpy leaf -> a CPU tensor holding the same bits (a copy when
    the array is read-only, as arrays viewed from JAX are)."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:       # (ascontiguousarray makes 0-d 1-d)
        arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; bfloat16 comes back as its ``uint16`` bit
    pattern (view it as ``ml_dtypes.bfloat16`` on the JAX side)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_to_numpy(tree):
    """A tree of tensors (nested dicts, lists and tuples) as numpy arrays:
    the inverse of ``params_from_numpy``.  bfloat16 leaves come back as
    their ``uint16`` bit patterns (``tensor_to_array``); Python ints
    stay as they are."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, int):
        return tree
    return tensor_to_array(tree)


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """Map a numpy tree (nested dicts, lists and tuples) onto torch
    tensors on ``device`` (default ``cuda``): parameter trees, superblock
    trunks included, optimizer states (an int32 ``step`` scalar keeps its
    shape ``()``, 8-bit moments are {"q" int8, "scale"} dict leaves),
    early-exit heads (a list of head dicts beside a tuple of ints) and the
    shared-context space (its ints cross as ints; the caller drops the
    JAX PRNG key it holds under ``_key`` and gives the port a
    ``torch.Generator`` there).  Python ints pass through unchanged.
    ``dtype`` recasts floating leaves, except those the reference keeps
    in float32 (``models.layers.FLOAT32_LEAVES``: norm scales and biases,
    ``A_log``, ``D``, ``dt_bias``, the scale beside int8 values); integer
    leaves keep their type."""
    dev = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, int):
            return node
        t = array_to_tensor(np.asarray(node))
        if dtype is not None and t.is_floating_point() \
                and key not in FLOAT32_LEAVES:
            t = t.to(dtype)
        return t.to(dev)

    return walk(tree)
