"""Split computing (SPINN-style [24]): partition a DNN between a weak
device and the EdgeAI-Hub, shipping QUANTIZED activations at the cut
(PyTorch port of ``repro.core.split``).

Two halves run as real programs on sliced layer stacks (the plain
attention path: no kernel, as the JAX halves run without flash); the
wire payload is int8/int4-quantized activations priced through the
multi-channel network model.  ``choose_split`` is the orchestrator-side
optimizer: argmin over cut points of device-time + transfer + hub-time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import MultiChannelLink
from repro_torch.core.perf_model import DeviceSpec, TaskCost, estimate
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# ---------------------------------------------------------------------------
# activation quantization for the wire
# ---------------------------------------------------------------------------

def quantize_activations(x: torch.Tensor, bits: int = 8):
    """Per-token symmetric quantization. Returns (q int8, scale float32
    (..., 1)); ``torch.round`` rounds half to even as JAX does, so equal
    inputs give equal bytes."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / qmax + 1e-12
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale


def dequantize_activations(q: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def wire_bytes(x_shape: tuple, bits: int) -> float:
    n = math.prod(x_shape)
    scales = n / x_shape[-1] * 4  # f32 scale per token
    return n * bits / 8 + scales


# ---------------------------------------------------------------------------
# split execution (dense trunks; cut at layer granularity)
# ---------------------------------------------------------------------------

def _slice_layers(trunk, lo: int, hi: int):
    """Layers [lo, hi) of every leaf of a stacked trunk (views)."""
    return {k: (_slice_layers(v, lo, hi) if isinstance(v, dict) else v[lo:hi])
            for k, v in trunk.items()}


def _positions(x):
    B, S, _ = x.shape
    return torch.broadcast_to(
        torch.arange(S, dtype=torch.int32, device=x.device), (B, S))


def head_forward(cfg: ModelConfig, params, tokens, split: int):
    """Device-side: embed + layers [0, split). Returns activations."""
    if cfg.pattern_period > 1:
        raise NotImplementedError(
            "split computing cuts uniform stacks; pattern archs cut at "
            "super-block granularity via split=k*period (not needed here)")
    x = L.embed(cfg, params["embed"], tokens)
    head = {"layers": _slice_layers(params["trunk"]["layers"], 0, split)}
    if split > 0:
        x = T.trunk_fwd(cfg.replace(num_layers=split), head, x,
                        _positions(x))
    return x


def tail_forward(cfg: ModelConfig, params, x, split: int):
    """Hub-side: layers [split, L) + norm + unembed."""
    n = cfg.num_layers
    tail = {"layers": _slice_layers(params["trunk"]["layers"], split, n)}
    if split < n:
        x = T.trunk_fwd(cfg.replace(num_layers=n - split), tail, x,
                        _positions(x))
    _, norm = L.make_norm(cfg)
    x = norm(params["final_norm"], x)
    return L.unembed(cfg, params["embed"], params["unembed"], x)


def split_forward(cfg: ModelConfig, params, tokens, split: int,
                  *, bits: int = 8):
    """End-to-end split inference with a quantized wire transfer.

    Returns (logits, payload_bytes).  split=0 => full offload,
    split=num_layers => fully on-device (no transfer of activations,
    but logits still come back).
    """
    x = head_forward(cfg, params, tokens, split)
    if 0 < split < cfg.num_layers:
        q, s = quantize_activations(x.float(), bits)
        payload = wire_bytes(tuple(x.shape), bits)
        x = dequantize_activations(q, s, cfg.activation_dtype)
    else:
        payload = 0.0
    logits = tail_forward(cfg, params, x, split)
    return logits, payload


# ---------------------------------------------------------------------------
# orchestrator-side split optimizer
# ---------------------------------------------------------------------------

@dataclass
class SplitDecision:
    split: int
    device_s: float
    transfer_s: float
    hub_s: float
    total_s: float
    payload_bytes: float


def _per_layer_flops(cfg: ModelConfig, n_tokens: int) -> float:
    d = cfg.d_model
    attn = 2 * n_tokens * (d * cfg.num_heads * cfg.head_dim * 2
                           + d * cfg.num_kv_heads * cfg.head_dim * 2)
    mlp = 2 * n_tokens * 3 * d * cfg.d_ff
    return attn + mlp


def choose_split(cfg: ModelConfig, device: DeviceSpec, hub: DeviceSpec,
                 link: MultiChannelLink, batch: int, seq: int,
                 *, bits: int = 8, head_bits: int = 8) -> SplitDecision:
    """Latency-optimal cut point for one inference batch."""
    n_tok = batch * seq
    lflops = _per_layer_flops(cfg, n_tok)
    lbytes_dev = _per_layer_weight_bytes(cfg, head_bits)
    act_bytes = wire_bytes((batch, seq, cfg.d_model), bits)
    emb_flops = 2.0 * n_tok * cfg.d_model   # lookup-ish, negligible
    unemb_flops = 2.0 * n_tok * cfg.d_model * cfg.vocab_size

    best: Optional[SplitDecision] = None
    for k in range(cfg.num_layers + 1):
        dev_cost = TaskCost(flops=emb_flops + k * lflops,
                            weight_bytes=k * lbytes_dev,
                            activation_bytes=n_tok * cfg.d_model * 2)
        hub_cost = TaskCost(
            flops=(cfg.num_layers - k) * lflops + unemb_flops,
            weight_bytes=(cfg.num_layers - k)
            * _per_layer_weight_bytes(cfg, 16) + cfg.vocab_size * cfg.d_model * 2,
            activation_bytes=n_tok * cfg.d_model * 2)
        dev_t = estimate(dev_cost, device).latency_s
        hub_t = estimate(hub_cost, hub).latency_s if k < cfg.num_layers \
            else 0.0
        if 0 < k < cfg.num_layers:
            tr = link.send(act_bytes).latency_s
            payload = act_bytes
        elif k == 0:
            tr = link.send(n_tok * 4).latency_s        # raw tokens up
            payload = n_tok * 4
        else:
            tr = link.send(batch * 8).latency_s        # predictions back
            payload = batch * 8
        total = dev_t + tr + hub_t
        cand = SplitDecision(k, dev_t, tr, hub_t, total, payload)
        if best is None or cand.total_s < best.total_s:
            best = cand
    return best


def _per_layer_weight_bytes(cfg: ModelConfig, bits: int) -> float:
    d = cfg.d_model
    attn = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
        + cfg.num_heads * cfg.head_dim * d
    return (attn + 3 * d * cfg.d_ff) * bits / 8
