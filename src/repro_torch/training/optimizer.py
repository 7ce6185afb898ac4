"""Optimizers: AdamW with optional 8-bit (block-quantized) moments
(PyTorch port of ``repro.training.optimizer``).

Functional, like the JAX module: ``adamw_update`` returns new parameter
and state trees and leaves its inputs as they were; run it under
``torch.no_grad()`` (the trainer does).  Trees are nested dicts of
tensors, walked in sorted key order (the JAX tree order), so the global
norm sums its leaves in the same order.  The 8-bit moment store
quarters optimizer memory; its bytes and scales equal the JAX
package's for the same float32 moments (both round half to even).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

Params = Any
BLOCK = 256  # quantization block size for 8-bit moments


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"  # "float32" | "int8"


def lr_schedule(cfg: OptimizerConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio; ``step`` an integer
    tensor, the result a float32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * frac


# ---------------------------------------------------------------------------
# trees (nested dicts; {"q", "scale"} dicts are 8-bit moment leaves)
# ---------------------------------------------------------------------------

def _is_q8(node) -> bool:
    return isinstance(node, dict) and "q" in node


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted key order (the JAX order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _moment_leaves(params, moments) -> list:
    """The moment tree's leaves matched to ``params``' leaves: a tensor
    or a {"q", "scale"} dict each."""
    if isinstance(params, dict):
        return [m for k in sorted(params)
                for m in _moment_leaves(params[k], moments[k])]
    return [moments]


# ---------------------------------------------------------------------------
# 8-bit block quantization for moment tensors
# ---------------------------------------------------------------------------

def _q8_encode(x: torch.Tensor) -> dict:
    """Shape-preserving block quantization along the last axis: ``q``
    keeps the parameter's shape (the last axis padded to a BLOCK
    multiple), ``scale`` is one float32 per BLOCK of the last axis
    (shape (*lead, nblocks, 1)), ``q = clip(round(x / scale))`` with
    ``scale = max|block| / 127 + 1e-12`` — the JAX function's bytes."""
    *lead, last = x.shape
    pad = (-last) % BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*lead, (last + pad) // BLOCK, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(*lead, last + pad), "scale": scale.float()}


def _q8_decode(enc: dict, shape) -> torch.Tensor:
    *lead, last = shape
    padded = enc["q"].shape[-1]
    blocks = enc["q"].reshape(*lead, padded // BLOCK, BLOCK)
    out = (blocks.float() * enc["scale"]).reshape(*lead, padded)
    return out[..., :last]


def _moment_init(p, dtype: str):
    if dtype == "int8":
        return _q8_encode(torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device))
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _moment_read(m, dtype: str, like, *, sqrt_domain: bool = False):
    if dtype == "int8":
        x = _q8_decode(m, like.shape)
        return torch.square(x) if sqrt_domain else x
    return m


def _moment_write(x, dtype: str, *, sqrt_domain: bool = False):
    """sqrt_domain: the SECOND moment is stored as sqrt(v) — linear int8
    quantization of v crushes small entries within a block to zero and
    1/sqrt(v) explodes; in the sqrt domain the 127 levels track the
    float32 trajectory."""
    if dtype == "int8":
        return _q8_encode(torch.sqrt(x) if sqrt_domain else x)
    return x


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(cfg: OptimizerConfig, params: Params) -> dict:
    """{"step": int32 scalar, "m", "v"}: float32 moments shaped like the
    parameters, or {"q", "scale"} leaves with ``moments_dtype="int8"``,
    on the parameters' device."""
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": _map(lambda p: _moment_init(p, cfg.moments_dtype), params),
        "v": _map(lambda p: _moment_init(p, cfg.moments_dtype), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(cfg: OptimizerConfig, grads: Params, opt_state,
                 params: Params):
    """Returns (new_params, new_opt_state, metrics {"grad_norm", "lr"});
    new tensors throughout, the inputs untouched."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if cfg.grad_clip else torch.ones((), device=gnorm.device))

    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    dt = cfg.moments_dtype

    def upd(p, g, m, v):
        g = g.float() * clip
        m_f = _moment_read(m, dt, g)
        v_f = _moment_read(v, dt, g, sqrt_domain=True)
        m_f = b1 * m_f + (1.0 - b1) * g
        v_f = b2 * v_f + (1.0 - b2) * torch.square(g)
        mhat = m_f / bc1
        vhat = v_f / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        new_p = p32 - lr * (delta + cfg.weight_decay * p32)
        return (new_p.to(p.dtype), _moment_write(m_f, dt),
                _moment_write(v_f, dt, sqrt_domain=True))

    flat_p = tree_leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), _moment_leaves(params, opt_state["m"]),
        _moment_leaves(params, opt_state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    new_state = {"step": step, "m": new_m, "v": new_v}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}


def sgd_update(params: Params, grads: Params, lr: float):
    """Plain SGD (the federated local steps' update)."""
    flat = [(p.float() - lr * g.float()).to(p.dtype)
            for p, g in zip(tree_leaves(params), tree_leaves(grads))]
    return tree_unflatten(params, flat)
