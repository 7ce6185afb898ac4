"""Checkpointing: tree <-> .npz with path-keyed arrays + JSON metadata
(PyTorch port of ``repro.training.checkpoint``; the same format).

Works for any params / optimizer-state tree (nested dicts, lists or
tuples with tensor leaves).  Keys are the "/"-joined paths in sorted
key order; bfloat16 leaves are saved as float32 and flagged
"bfloat16" in ``<path>.meta.json``.  A checkpoint written by either
package restores in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.devices import tensor_device

SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix.rstrip(SEP)] = tree
    return out


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    meta = {"leaves": {}, "user": metadata or {}}
    for k, v in _flatten(tree).items():
        t = torch.as_tensor(v).detach().cpu()
        if t.dtype == torch.bfloat16:
            meta["leaves"][k] = "bfloat16"
            t = t.float()
        arrays[k] = t.numpy()
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes must match), each
    leaf on the device of ``like``'s leaf (CPU for non-tensor leaves)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        data = {k: z[k] for k in z.files}
    meta_path = (path[:-4] if path.endswith(".npz") else path) + ".meta.json"
    bf16 = set()
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            bf16 = {k for k, v in json.load(f)["leaves"].items()
                    if v == "bfloat16"}

    out = {}
    for k, ref in _flatten(like).items():
        arr = data[k]
        if arr.shape != tuple(np.shape(ref)):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{arr.shape} vs {tuple(np.shape(ref))}")
        t = torch.from_numpy(np.array(arr))        # (0-d stays 0-d)
        if k in bf16:
            t = t.to(torch.bfloat16)
        out[k] = t.to(tensor_device(ref) or "cpu")
    return _unflatten_like(like, out)


def _unflatten_like(like: Any, flat: dict, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], flat, f"{prefix}{k}{SEP}")
                for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten_like(v, flat, f"{prefix}{i}{SEP}")
                for i, v in enumerate(like)]
        return type(like)(vals)
    return flat[prefix.rstrip(SEP)]
