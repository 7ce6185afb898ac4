"""Step builders + input_specs for the dry-run and the launchers (PyTorch
port of ``repro.launch.specs``).

``input_specs`` returns ``models.model.TensorSpec`` stand-ins for every
model input (shapes and dtypes only: the cache's come from its
initializer on the meta device, which allocates nothing).
``build_train`` / ``build_serve`` / ``build_prefill`` return a ``Built``:
a step function, the ``TensorSpec`` trees of its arguments, and the
``NamedSharding`` trees its inputs and outputs are laid out by.  The
step places its inputs on the mesh by the sharding rules (DTensors;
plain tensors a step makes inside are taken as replicated), runs the
model's own function on them and lays its outputs out by the out
shardings.  Running it under ``FakeTensorMode`` on the production mesh
is the dry-run; feeding real tensors on ``mesh.make_local_mesh()`` is
the launcher.  On a one-device mesh ``sharding.place`` leaves tensors
plain (every placement there is ``Replicate()``), so the launcher's step
is the model's own function, bit for bit and at its speed.

JAX donates the train state and the decode cache to their steps; here
the train step returns a new state and the decode step updates the
cache in place and returns it (the caller keeps what is returned).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_map

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.sharding import P
from repro_torch.models import model as M
from repro_torch.models.model import TensorSpec
from repro_torch.training import trainer as tr


def shapes(tree: Any) -> Any:
    """``TensorSpec`` of every tensor of ``tree`` (others kept)."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def allocate(spec_tree: Any, device) -> Any:
    """Uninitialized tensors of a ``TensorSpec`` tree on ``device`` (under
    ``FakeTensorMode``: fake tensors, no memory)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device)
                    if isinstance(s, TensorSpec) else s, spec_tree,
                    is_leaf=sh.is_shaped)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """``TensorSpec`` of every model input of this (arch, shape)."""
    if shape.kind == "decode":
        B = shape.global_batch
        cache = shapes(M.init_cache(cfg, B, shape.seq_len, "meta"))
        return {
            "cache": cache,
            "tokens": TensorSpec((B, 1), torch.int32),
            "pos": TensorSpec((B,), torch.int32),
        }
    return M.batch_shapes(cfg, shape)


def _params_shape(cfg: ModelConfig) -> Any:
    return shapes(M.init_params(cfg, None, "meta"))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

@dataclass
class Built:
    fn: Any                 # the step: places its inputs, runs, lays out
    args: tuple             # TensorSpec trees of fn's arguments
    in_shardings: Any
    out_shardings: Any


def build_train(cfg: ModelConfig, shape: InputShape, mesh,
                tcfg: Optional[tr.TrainConfig] = None, *,
                fsdp: bool = False, smart: bool = False) -> Built:
    tcfg = tcfg or tr.TrainConfig()
    state_shape = shapes(tr.init_train_state(cfg, tcfg, None, "meta"))
    pspec = sh.param_pspecs(cfg, mesh, state_shape["params"], fsdp=fsdp,
                            smart=smart)
    ospec = sh.opt_pspecs(pspec, state_shape["opt"], mesh)
    state_spec = {"params": pspec, "opt": ospec}

    batch_shape = M.batch_shapes(cfg, shape)
    bspec = sh.batch_pspecs(cfg, mesh, batch_shape)

    step = tr.make_train_step(cfg, tcfg)
    in_sh = (sh.named(mesh, state_spec), sh.named(mesh, bspec))
    out_sh = (sh.named(mesh, state_spec), None)

    def train_step(state, batch):
        state = sh.place(state, mesh, in_sh[0])
        batch = sh.place(batch, mesh, in_sh[1])
        with implicit_replication():
            state, metrics = step(state, batch)
        return sh.place(state, mesh, out_sh[0]), sh.gather(metrics)

    return Built(train_step, (state_shape, batch_shape), in_sh, out_sh)


# ---------------------------------------------------------------------------
# serve: decode + prefill
# ---------------------------------------------------------------------------

def _logits_sharding(cfg: ModelConfig, mesh, B: int):
    da = sh.data_axes(mesh)
    dax = da[0] if len(da) == 1 else tuple(da)
    bdiv = B % sh._axsize(mesh, dax) == 0
    vdiv = cfg.vocab_size % sh._axsize(mesh, "model") == 0
    return dax, bdiv, sh.named(mesh, P(dax if bdiv else None, None,
                                       "model" if vdiv else None))


def build_serve(cfg: ModelConfig, shape: InputShape, mesh, *,
                fsdp: bool = False, smart: bool = False) -> Built:
    """serve_step: ONE new token against a seq_len cache."""
    assert shape.kind == "decode"
    B = shape.global_batch
    specs = input_specs(cfg, shape)
    params_shape = _params_shape(cfg)
    pspec = sh.param_pspecs(cfg, mesh, params_shape, smart=smart)
    cspec = sh.cache_pspecs(cfg, mesh, specs["cache"], B, smart=smart)
    dax, bdiv, logits_sh = _logits_sharding(cfg, mesh, B)
    tok_spec = P(dax, None) if bdiv else P(None, None)
    pos_spec = P(dax) if bdiv else P(None)

    in_sh = (sh.named(mesh, pspec), sh.named(mesh, cspec),
             sh.named(mesh, tok_spec), sh.named(mesh, pos_spec))
    out_sh = (logits_sh, sh.named(mesh, cspec))

    def serve_step(params, cache, tokens, pos):
        params, cache, tokens, pos = (
            sh.place(x, mesh, s)
            for x, s in zip((params, cache, tokens, pos), in_sh))
        with implicit_replication():
            logits, cache = M.decode_step(cfg, params, cache, tokens, pos)
        return (sh.place(logits, mesh, out_sh[0]),
                sh.place(cache, mesh, out_sh[1]))

    args = (params_shape, specs["cache"], specs["tokens"], specs["pos"])
    return Built(serve_step, args, in_sh, out_sh)


def build_prefill(cfg: ModelConfig, shape: InputShape, mesh, *,
                  fsdp: bool = False, smart: bool = False) -> Built:
    """prefill step: run the whole prompt, emit last logits + full cache."""
    assert shape.kind == "prefill"
    B, S = shape.global_batch, shape.seq_len
    params_shape = _params_shape(cfg)
    pspec = sh.param_pspecs(cfg, mesh, params_shape, fsdp=fsdp, smart=smart)
    batch_shape = M.batch_shapes(cfg, shape)
    batch_shape.pop("targets", None)
    bspec = sh.batch_pspecs(cfg, mesh, batch_shape)
    cache_shape = shapes(M.init_cache(cfg, B, S, "meta"))
    cspec = sh.cache_pspecs(cfg, mesh, cache_shape, B, smart=smart)
    _, _, logits_sh = _logits_sharding(cfg, mesh, B)

    in_sh = (sh.named(mesh, pspec), sh.named(mesh, bspec))
    out_sh = (logits_sh, sh.named(mesh, cspec))

    def prefill_step(params, batch):
        params = sh.place(params, mesh, in_sh[0])
        batch = sh.place(batch, mesh, in_sh[1])
        with implicit_replication():
            logits, cache = M.prefill(cfg, params, batch, S)
        return (sh.place(logits, mesh, out_sh[0]),
                sh.place(cache, mesh, out_sh[1]))

    return Built(prefill_step, (params_shape, batch_shape), in_sh, out_sh)


def _maybe_enable_seq_parallel_attn(cfg: ModelConfig, shape: InputShape,
                                    mesh) -> None:
    """When query heads can't shard over `model`, shard the query
    SEQUENCE over it inside blockwise attention (layers.py knob;
    process-scoped, stays set while the step runs)."""
    from repro_torch.models import layers as L
    msize = sh.axis_sizes(mesh)["model"]
    heads_div = cfg.num_heads > 0 and cfg.num_heads % msize == 0
    if heads_div or cfg.num_heads == 0 or shape.kind == "decode":
        return
    per = shape.seq_len // msize
    if shape.seq_len % msize or per < L.BLOCKWISE_CHUNK \
            or per % L.BLOCKWISE_CHUNK:
        return
    spec = P(None, "model", None, None, None, None)
    L.SEQ_PARALLEL_ATTN = (msize, sh.named(mesh, spec))


def build(cfg: ModelConfig, shape: InputShape, mesh, *,
          tcfg: Optional[tr.TrainConfig] = None, fsdp: bool = False,
          smart: bool = False) -> Built:
    if smart:
        _maybe_enable_seq_parallel_attn(cfg, shape, mesh)
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, tcfg, fsdp=fsdp, smart=smart)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, fsdp=fsdp, smart=smart)
    return build_serve(cfg, shape, mesh, fsdp=fsdp, smart=smart)
