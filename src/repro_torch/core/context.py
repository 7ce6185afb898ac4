"""Shared context between sensing devices (paper §Shared context;
PyTorch port of ``repro.core.context``).

* shared context space — implicit context sharing: each sensor embeds
  its observations into a COMMON subspace via a per-device projection;
  downstream tasks consume fused embeddings ("embedding subsets of
  available sensors into a common subspace").
* multi-view fusion — several devices observing the same event fuse
  their embeddings to improve a shared task (smart speaker + camera).
* multi-task heads — different tasks share one DNN backend instead of
  replicating it per device.

The params keep the reference layout.  Where JAX keeps a PRNG key under
``_key`` for later heads, the port keeps the ``torch.Generator`` the
space was made from; a tree bridged from JAX drops the key and takes a
generator in its place.  The numbers it draws are not JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L


def init_context_space(generator: Optional[torch.Generator],
                       sensor_dims: Dict[str, int], shared_dim: int,
                       num_classes: int, hidden: int = 64,
                       device: DeviceLike = None):
    """Projections (one per sensor, sorted by name) and the shared trunk
    from ``generator`` (default: seed 0 on ``device``, default ``cuda``),
    float32 on ``device``; no task head yet (``add_task_head``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    proj = {name: L._dense_init(generator, (dim, shared_dim), device=dev)
            for name, dim in sorted(sensor_dims.items())}
    return {
        "proj": proj,
        "trunk_w": L._dense_init(generator, (shared_dim, hidden), device=dev),
        "heads": {},
        "_key": generator,
        "shared_dim": shared_dim,
        "hidden": hidden,
    }


def add_task_head(params, task: str, num_classes: int):
    """A new head drawn from the space's generator, on the trunk's
    device (in place; returns ``params``)."""
    params["heads"][task] = L._dense_init(
        params["_key"], (params["hidden"], num_classes),
        device=params["trunk_w"].device)
    return params


def embed_views(params, views: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Project each sensor's features into the shared subspace and fuse
    (mean over available views — robust to partial availability)."""
    embs = [views[name] @ params["proj"][name]
            for name in sorted(views) if name in params["proj"]]
    if not embs:
        raise ValueError("no recognised sensor views")
    return torch.mean(torch.stack(embs), dim=0)


def task_logits(params, task: str, fused: torch.Tensor) -> torch.Tensor:
    h = torch.relu(fused @ params["trunk_w"])
    return h @ params["heads"][task]


def multiview_logits(params, task: str,
                     views: Dict[str, torch.Tensor]) -> torch.Tensor:
    return task_logits(params, task, embed_views(params, views))


def context_loss(params, task: str, views: Dict[str, torch.Tensor],
                 labels: torch.Tensor) -> torch.Tensor:
    logits = multiview_logits(params, task, views)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
