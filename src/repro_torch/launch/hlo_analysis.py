"""Per-chip cost counting of a step as it runs (the port's counterpart of
``repro.launch.hlo_analysis``).

PyTorch has no HLO module to walk.  ``Trace`` is a ``TorchDispatchMode``
that sees every aten op the step executes, forward and backward, and
counts the same three things the JAX walk reads from the partitioned
module:

  * FLOPs — dot products (``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` and
    the other products ``torch.utils.flop_counter`` has formulas for):
    2 * output elements * contraction length.
  * bytes — operand + result bytes of every op that touches memory
    (each op streams its operands and writes its result); views and
    allocations cost nothing, and a window write (``copy_``,
    ``index_put_``, ``scatter_``, ...) reads its operands and writes its
    source once more, not the whole destination.
  * collective bytes — result sizes of the functional collectives
    (``torch.ops._c10d_functional.*``) by kind.

Counts are PER CHIP.  On DTensors the mode lets the DTensor dispatch
run (it returns ``NotImplemented`` for an op with DTensor arguments) and
counts the local ops each rank executes on its shards and the
collectives of its redistributions, not the global op; the global-shape
ops DTensor runs to propagate shapes are muted.  Eager mode runs each
loop trip itself, so nothing is scaled by trip counts.

``Trace`` also keeps the bytes of the tensors the step made that are
still alive, tracked by storage, and their peak (``peak_bytes``): under
``FakeTensorMode`` that is the dry-run's per-chip temporary memory.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

# ops that move no bytes: metadata, aliasing and allocation
_FREE = {
    _aten.detach, _aten.alias, _aten._unsafe_view, _aten.lift_fresh,
    _aten.empty, _aten.empty_like, _aten.empty_strided,
    _aten.new_empty, _aten.new_empty_strided, _aten._local_scalar_dense,
    _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset, _aten.is_same_size,
}
# writes of a window into a destination: the destination is not streamed
_WINDOW_WRITES = {
    _aten.copy_, _aten.index_put_, _aten._index_put_impl_,
    _aten.index_copy_, _aten.scatter_, _aten.masked_scatter_,
    _aten.slice_scatter, _aten.select_scatter,
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")
_COLLECTIVE_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("broadcast", "broadcast"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def shape_bytes(x: Any) -> int:
    """Bytes of a tensor, a ``TensorSpec`` (shape, dtype) or any tree of
    them (a scalar counts one element)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return math.prod(x.shape) * x.dtype.itemsize
    if isinstance(x, dict):
        return sum(shape_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(shape_bytes(v) for v in x)
    return 0


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_counts: dict = field(default_factory=dict)

    def add(self, other: "Costs"):
        self.flops += other.flops
        self.bytes += other.bytes
        self.coll_bytes += other.coll_bytes
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    if name.startswith("wait"):
        return None
    for stem, kind in _COLLECTIVE_KINDS:
        if stem in name:
            return kind
    return None


def _dot_flops(func, args, kwargs, out) -> float:
    fn = flop_registry.get(func.overloadpacket)
    return float(fn(*args, **kwargs, out_val=out)) if fn else 0.0


def _op_bytes(func, args, kwargs, out) -> int:
    packet = func.overloadpacket
    if packet in _FREE or func.is_view:
        return 0
    ins = _tensors((args, kwargs))
    if packet in _WINDOW_WRITES and ins:
        src = ins[1:]                      # the destination is ins[0]
        return shape_bytes(src) + (shape_bytes(src[-1]) if src else 0)
    return shape_bytes(ins) + shape_bytes(_tensors(out))


class Trace(TorchDispatchMode):
    """Counts the ops run while it is active (``with Trace() as tr``).

    ``costs`` holds the per-chip totals; ``rows`` the same per (op,
    output shape) with the number of calls; ``live_bytes`` /
    ``peak_bytes`` the tensors made in the trace that are still alive and
    their peak; ``arg_bytes`` is for the caller to set (the step's
    per-chip argument bytes)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.rows: dict = {}
        self.arg_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}              # storage key -> bytes
        self._muted = 0
        self._patched = None

    # DTensor runs every op once more on global-shape fake tensors to
    # propagate shapes; those calls are not the chip's work
    def __enter__(self):
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        trace = self

        def muted(prop, op_schema):
            trace._muted += 1
            try:
                return orig(prop, op_schema)
            finally:
                trace._muted -= 1

        self._patched = orig
        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._patched
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count the local ops instead
        out = func(*args, **kwargs)
        if self._muted or func.namespace == "prim":
            return out
        c = Costs(flops=_dot_flops(func, args, kwargs, out),
                  bytes=_op_bytes(func, args, kwargs, out))
        kind = _collective_kind(func)
        if kind is not None:
            c.coll_bytes = shape_bytes(_tensors(out))
            c.coll_counts[kind] = 1
        self.costs.add(c)
        outs = _tensors(out)
        key = (str(func), tuple(tuple(t.shape) for t in outs))
        row = self.rows.setdefault(key, [0, Costs()])
        row[0] += 1
        row[1].add(c)
        self._track(args, kwargs, outs)
        return out

    def _track(self, args, kwargs, outs):
        """Count each storage an op makes until it is freed.  A storage's
        Python object lives exactly as long as its C++ storage (PyTorch
        preserves it), so its finalizer fires when the last tensor on it
        (a view, a tensor autograd saved) lets go."""
        inputs = {_storage_key(t) for t in _tensors((args, kwargs))}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._live:
                continue                   # in place, or a view
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key)

    def _release(self, key):
        n = self._live.pop(key, None)
        if n is not None:
            self.live_bytes -= n


def trace(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the ``Trace`` of that call)."""
    with Trace() as tr:
        out = fn(*args, **kwargs)
    return out, tr


def analyze_hlo(traced: Trace) -> Costs:
    """Per-chip costs of one execution of the traced step."""
    return traced.costs


def breakdown(traced: Trace, top: int = 15) -> dict:
    """Top (op, output shape) rows by bytes / flops / collective bytes,
    with the number of calls each row sums."""
    rows = [{"op": op, "shape": str(shape)[:60], "calls": n,
             "bytes": c.bytes, "flops": c.flops, "coll_bytes": c.coll_bytes}
            for (op, shape), (n, c) in traced.rows.items()]
    return {
        "by_bytes": sorted(rows, key=lambda r: -r["bytes"])[:top],
        "by_flops": sorted(rows, key=lambda r: -r["flops"])[:top],
        "by_coll": sorted([r for r in rows if r["coll_bytes"]],
                          key=lambda r: -r["coll_bytes"])[:top],
    }
