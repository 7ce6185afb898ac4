"""Sharding rules: params / batches / caches -> partition specs (PyTorch
port of ``repro.launch.sharding``).

Rule engine over leaf *names* with dims-addressed-from-the-right (so the
same rule covers scan-stacked and unstacked params).  Every candidate
axis assignment is divisibility-checked against the mesh — non-divisible
dims fall back down the candidate list, ending at replication.  This is
what lets ONE rule set cover all 10 architectures on the (16,16) and
(2,16,16) production meshes.

``fsdp=True`` additionally shards a second dim of every large tensor
over the data axis (ZeRO-3-style), the lever that fits the 1T-param MoE.

A spec (``P``) is a per-dimension tuple of mesh-axis names (an axis, a
tuple of axes, or None), as JAX's ``PartitionSpec``.  Trees are nested
dicts / lists / tuples; a leaf's path is its tuple of dict keys and
sequence indices (``torch.utils._pytree``'s key entries), and its name
is the last dict key.  ``named`` turns a spec tree into DTensor
placements on a ``DeviceMesh`` (``Shard(dim)`` / ``Replicate()`` per
mesh axis) and ``place`` lays a tensor tree out by them.  Any object
with ``.shape`` serves as a leaf shape (a tensor, a meta tensor, a
``models.model.TensorSpec``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._pytree import MappingKey, tree_map, tree_map_with_path

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes


class P(tuple):
    """A partition spec: one entry per tensor dim (a one-axis tuple
    entry is that axis, as in JAX)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


def is_shaped(x) -> bool:
    """A leaf of a shape tree (``is_leaf`` for the tree maps): anything
    with ``.shape``, so a ``TensorSpec`` (a ``NamedTuple``) is not walked
    into."""
    return hasattr(x, "shape")


def data_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _axsize(mesh, ax) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _assign(shape, mesh, candidates) -> P:
    """candidates: list of (dim_from_right, axis). First divisible wins
    per axis; one dim gets at most one axis."""
    spec = [None] * len(shape)
    used_dims = set()
    used_axes = set()
    for dim_r, ax in candidates:
        dim = len(shape) + dim_r if dim_r < 0 else dim_r
        if dim < 0 or dim >= len(shape) or dim in used_dims:
            continue
        key = ax if isinstance(ax, tuple) else (ax,)
        if any(a in used_axes for a in key):
            continue
        if shape[dim] % _axsize(mesh, ax) == 0 and shape[dim] > 0:
            spec[dim] = ax
            used_dims.add(dim)
            used_axes.update(key)
    return P(*spec)


# rule table: leaf name -> (primary candidates, fsdp extra candidates)
# dims are from-the-right so scan-stacking prefixes don't matter.
# CAREFUL: expert tensors (E, d, f) share leaf names with dense MLPs
# (d, f) — disambiguated by rank in the rule fn (a -3 rule applied to a
# scan-stacked dense (L, d, f) would shard the LAYER dim, which gathers
# the whole stack every step).
_PARAM_RULES = {
    # attention
    "wq": ([(-2, "model"), (-3, "model")], [(-3, "data")]),
    "wk": ([(-2, "model"), (-1, "model"), (-3, "model")], [(-3, "data")]),
    "wv": ([(-2, "model"), (-1, "model"), (-3, "model")], [(-3, "data")]),
    "wo": ([(-3, "model"), (-1, "model")], [(-1, "data")]),
    # dense MLPs (2D unstacked)
    "w_gate": ([(-1, "model")], [(-2, "data")]),
    "w_up": ([(-1, "model")], [(-2, "data")]),
    "w_down": ([(-2, "model")], [(-1, "data")]),
    "router": ([(-1, "model")], []),
    # whisper mlp
    "w_in": ([(-1, "model")], [(-2, "data")]),
    "w_out": ([(-2, "model")], [(-1, "data")]),
    # ssm
    "in_proj": ([(-2, "model")], [(-1, "data")]),
    "out_proj": ([(-2, "model")], [(-1, "data")]),
    # embeddings
    "table": ([(-2, "model"), (-1, "model")], [(-1, "data"), (-2, "data")]),
    "w": ([(-1, "model"), (-2, "model")], [(-2, "data")]),  # unembed
    "w1": ([(-1, "model")], []),                            # vlm projector
    "w2": ([(-1, "model")], []),
    "pos_table": ([], []),
}

# routed-expert tensors: (layers?, E, d, f) — expert-parallel over model,
# fsdp shards the ffn dim over data (the 1T-MoE memory lever)
_EXPERT_RULES = {
    "w_gate": ([(-3, "model"), (-1, "model")], [(-1, "data")]),
    "w_up": ([(-3, "model"), (-1, "model")], [(-1, "data")]),
    "w_down": ([(-3, "model"), (-2, "model")], [(-2, "data")]),
}


def _dict_keys(path) -> list:
    return [e.key for e in path if isinstance(e, MappingKey)]


def _leaf_name(path) -> str:
    keys = _dict_keys(path)
    return keys[-1] if keys else ""


def param_pspecs(cfg: ModelConfig, mesh, params_shape: Any,
                 *, fsdp: bool = False, smart: bool = False) -> Any:
    """Spec tree matching ``params_shape`` (a tree of shaped leaves).

    ``smart=True`` enables the beyond-baseline rules: attention
    projections are kept OFF the model axis when the head counts don't
    divide it (indivisible-head sharding leaves q/k sharded on head_dim,
    which all-reduces an S x S score tile per attention block — the phi3
    prefill pathology).  FSDP then carries the memory.
    """
    msize = axis_sizes(mesh)["model"]
    heads_div = cfg.num_heads > 0 and cfg.num_heads % msize == 0
    kv_div = cfg.num_kv_heads > 0 and cfg.num_kv_heads % msize == 0
    da = data_axes(mesh)
    dax = da[0] if len(da) == 1 else tuple(da)  # multi-pod: ('pod','data')

    def rule(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return P()
        if name in _EXPERT_RULES and len(shape) >= 4 \
                and "moe" in _dict_keys(path):
            prim, extra = _EXPERT_RULES[name]
        else:
            prim, extra = _PARAM_RULES.get(name, ([], []))
        if smart:
            if name in ("wq", "wo") and not heads_div:
                prim = []
            if name in ("wk", "wv") and not kv_div:
                prim = []
        extra = [(d, dax if ax == "data" else ax) for d, ax in extra]
        cands = list(prim) + (list(extra) if fsdp else [])
        return _assign(shape, mesh, cands)

    return tree_map_with_path(rule, params_shape, is_leaf=is_shaped)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and "q" in x


def opt_pspecs(param_specs: Any, opt_shape: Any, mesh) -> Any:
    """Optimizer state specs: moments MIRROR their parameter's spec.

    int8 moments are shape-preserving (optimizer._q8_encode): q carries
    the parameter spec (last axis kept only while the padded size stays
    divisible); scale drops the last axis (it is per-BLOCK, tiny).
    Mirroring matters: any mismatch reshards the decoded float32 moments
    every step.
    """
    def for_moment(pspec, leaf):
        if _is_q8(leaf):
            q_shape = tuple(leaf["q"].shape)
            entries = list(pspec) + [None] * (len(q_shape) - len(pspec))
            q_spec = []
            for dim, ax in enumerate(entries):
                ok = (ax is not None
                      and q_shape[dim] % _axsize(mesh, ax) == 0)
                q_spec.append(ax if ok else None)
            s_spec = q_spec[:-1] + [None, None]
            return {"q": P(*q_spec), "scale": P(*s_spec)}
        return pspec

    return {
        "step": P(),
        "m": tree_map(for_moment, param_specs, opt_shape["m"]),
        "v": tree_map(for_moment, param_specs, opt_shape["v"]),
    }


def batch_pspecs(cfg: ModelConfig, mesh, batch_shape: Any) -> Any:
    da = data_axes(mesh)
    ax = da if len(da) == 1 else tuple(da)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if shape[0] % _axsize(mesh, ax if isinstance(ax, tuple)
                              else ax[0]) == 0:
            first = ax if isinstance(ax, str) else tuple(ax)
            return P(first, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return tree_map_with_path(rule, batch_shape, is_leaf=is_shaped)


def cache_pspecs(cfg: ModelConfig, mesh, cache_shape: Any,
                 batch: int, *, smart: bool = False) -> Any:
    """KV/SSM cache specs.  Batch over data when divisible; batch=1
    long-context decode shards the TIME axis over data instead and
    heads/channels over model.

    ``smart=True``: when kv heads don't divide the model axis, shard the
    cache on TIME over model instead of head_dim — head_dim-sharded
    caches gather each layer's whole cache at every decode step (the
    internvl2 decode pathology); time-sharded caches only move a
    (B, H, 1, T) score strip.
    """
    da = data_axes(mesh)
    dax = da[0] if len(da) == 1 else tuple(da)
    d_n = _axsize(mesh, dax)
    m_n = _axsize(mesh, "model")
    batch_ok = batch % d_n == 0
    kv_div = cfg.num_kv_heads > 0 and cfg.num_kv_heads % m_n == 0

    def rule(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        cands = []
        if name in ("k", "v", "cross_k", "cross_v"):
            # (..., B, T, K, hd)
            kv_c = ([(-2, "model")] if kv_div or not smart
                    else [(-2, "model"), (-3, "model")])
            tail = [(-1, "model")] if not smart else []
            if batch_ok:
                cands = [(-4, dax)] + kv_c + tail
            else:
                cands = [(-3, dax)] + kv_c + tail
        elif name == "slots":
            # (..., B, T)
            cands = [(-2, dax)] if batch_ok else [(-1, dax)]
        elif name == "conv":
            # (..., B, w-1, ch)
            cands = ([(-3, dax), (-1, "model")] if batch_ok
                     else [(-1, "model")])
        elif name == "ssm":
            # (..., B, h, p, n)
            cands = ([(-4, dax), (-3, "model")] if batch_ok
                     else [(-3, "model")])
        return _assign(shape, mesh, cands)

    return tree_map_with_path(rule, cache_shape, is_leaf=is_shaped)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` and its DTensor placements (one per
    mesh dim): the counterpart of JAX's ``NamedSharding``."""
    mesh: Any
    spec: P
    placements: tuple


def placements(mesh, spec: P) -> tuple:
    """``Shard(dim)`` on each mesh dim an entry of ``spec`` names (a
    tuple entry shards its dim over those mesh dims, major first, as
    JAX lays it out), ``Replicate()`` on the others.  A mesh dim of size
    1 holds the whole tensor either way and gets ``Replicate()``, so the
    one-device mesh runs every op on whole tensors with no
    redistribution."""
    names = list(mesh.mesh_dim_names)
    sizes = mesh.mesh.shape
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            i = names.index(a)
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def named(mesh, spec_tree: Any) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s, placements(mesh, s)),
                    spec_tree)


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """Lay each tensor of ``tree`` out on ``mesh`` by its spec in ``specs``
    (a spec tree or a ``named`` tree) as a DTensor: this rank's shard of
    the tensor it holds, with no collective (``src_data_rank=None``:
    every rank holds the whole tensor, as one process does).  A DTensor
    already on those placements is kept; one on others is
    redistributed.  Leaf tensors keep ``requires_grad``."""
    def one(t, s):
        if not isinstance(t, torch.Tensor):
            return t
        pl = s.placements if isinstance(s, NamedSharding) \
            else placements(mesh, s)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else t.redistribute(
                mesh, pl)
        out = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
        return out.requires_grad_(t.requires_grad)

    return tree_map(one, tree, specs)


def place(tree: Any, mesh, specs: Any) -> Any:
    """``distribute`` on a mesh of more than one device.  A one-device
    mesh holds every tensor whole, so its tensors stay plain and a step
    runs as the direct call does, without DTensor's per-op dispatch."""
    if mesh.size() == 1:
        return tree
    return distribute(tree, mesh, specs)


def gather(tree: Any) -> Any:
    """Each DTensor of ``tree`` as the whole tensor on this rank."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
