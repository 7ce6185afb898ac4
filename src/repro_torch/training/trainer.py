"""Training loop: train_step factory with grad accumulation + remat
(PyTorch port of ``repro.training.trainer``).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  Parameters are leaf tensors with ``requires_grad``; the
gradients come from ``torch.autograd.grad`` of ``model.loss_fn`` (no
``.grad`` fields are kept), remat is ``torch.utils.checkpoint``
(``transformer._maybe_remat``), and the AdamW update runs under
``torch.no_grad()`` into new parameter tensors, as the JAX step returns
new arrays.  Neither kernel of the forward has a backward:
``TrainConfig(use_flash=True)`` (or ``use_kernel=True`` on the ssm
family) raises ``NotImplementedError`` at the first step, as
``jax.grad`` through a Pallas call raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt

Params = Any


@dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = opt.OptimizerConfig()
    microbatches: int = 1          # grad accumulation steps
    remat: Optional[str] = "nothing_saveable"  # JAX checkpoint policy name
    use_flash: bool = False
    use_kernel: bool = False
    accum_dtype: str = "float32"   # grad-accumulator dtype


def _with_grad(params: Params) -> Params:
    """Mark every floating leaf as a leaf that requires grad (in place:
    the trainer's parameters are always leaves)."""
    for p in opt.tree_leaves(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    return params


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> dict:
    """{"params", "opt"}: ``model.init_params`` (seed 0 on ``device``,
    default ``cuda``, unless ``generator`` says otherwise) and a fresh
    optimizer state."""
    params = _with_grad(M.init_params(cfg, generator, device))
    return {"params": params,
            "opt": opt.init_opt_state(tcfg.optimizer, params)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(state, batch) -> (state, metrics).  batch leaves: (B, ...)."""

    def grads_of(params, batch):
        leaves = opt.tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = M.loss_fn(cfg, params, batch,
                                      use_flash=tcfg.use_flash,
                                      use_kernel=tcfg.use_kernel,
                                      remat=tcfg.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def accumulated(params, batch):
        n = tcfg.microbatches
        adt = getattr(torch, tcfg.accum_dtype)
        acc = [torch.zeros_like(p, dtype=adt)    # DTensors stay DTensors
               for p in opt.tree_leaves(params)]
        lsum = None
        for i in range(n):
            mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(adt))
            del grads
            lsum = loss if lsum is None else lsum + loss
        return lsum / n, metrics, [a / n for a in acc]

    def train_step(state, batch):
        params = _with_grad(state["params"])
        fn = grads_of if tcfg.microbatches <= 1 else accumulated
        loss, metrics, grads = fn(params, batch)
        with torch.no_grad():
            new_params, new_opt, opt_metrics = opt.adamw_update(
                tcfg.optimizer, opt.tree_unflatten(params, grads),
                state["opt"], params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": _with_grad(new_params), "opt": new_opt}, metrics

    return train_step


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, data_iter,
               num_steps: int, *, generator=None, state=None,
               log_every: int = 10, callback=None,
               device: DeviceLike = None):
    """Eager single-device loop (examples/tests).  Returns (state,
    history of logged metrics)."""
    if state is None:
        state = init_train_state(cfg, tcfg, generator, device)
    step_fn = make_train_step(cfg, tcfg)
    history = []
    for i in range(num_steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if callback:
                callback(i, m)
    return state, history
