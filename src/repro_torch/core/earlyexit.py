"""Early-exit networks (paper Sustainability pillar; HAPI [25]/SPINN [24];
PyTorch port of ``repro.core.earlyexit``).

Attach lightweight exit heads to intermediate layers of a dense trunk;
at serve time a confidence threshold preempts computation on easy
inputs.  Exits are evaluated on the whole batch and the *batch exit
mask* decides skipping, as in the reference: savings are realized at
batch granularity (all-exited => remaining layers skipped, read on the
host before every layer: one device sync a layer) and measured in
expected-FLOPs for per-sample accounting.  The layers run the plain
attention path (no kernel), as the reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_exit_heads(cfg: ModelConfig, exit_layers: Sequence[int],
                    device=None):
    """One head (a norm; the unembedding is tied to the trunk's) per exit
    point.  The JAX function takes a PRNG key it never draws from: a
    fresh norm is deterministic, so none is taken here."""
    norm_init, _ = L.make_norm(cfg)
    heads = [{"ln": norm_init(cfg.d_model, device=device)}
             for _ in exit_layers]
    return {"exits": heads, "exit_layers": tuple(exit_layers)}


def _exit_logits(cfg, params, head, x):
    _, norm = L.make_norm(cfg)
    h = norm(head["ln"], x)
    return L.unembed(cfg, params["embed"], params["unembed"], h)


def _embed(cfg, params, tokens):
    x = L.embed(cfg, params["embed"], tokens)
    B, S, _ = x.shape
    positions = torch.broadcast_to(
        torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
    return x, positions


def _block(cfg, params, i, x, positions):
    return T.block_fwd(cfg, T._layer(params["trunk"]["layers"], i), x,
                       positions, is_global=True)


def forward_with_exits(cfg: ModelConfig, params, heads, tokens):
    """All exit logits (training mode). Returns list[(layer, logits)]."""
    if cfg.pattern_period > 1:
        raise NotImplementedError("early exits target uniform dense stacks")
    x, positions = _embed(cfg, params, tokens)
    exit_at = dict(zip(heads["exit_layers"], range(len(heads["exits"]))))
    outs = []
    for i in range(cfg.num_layers):
        x = _block(cfg, params, i, x, positions)
        if i in exit_at:
            outs.append((i, _exit_logits(cfg, params,
                                         heads["exits"][exit_at[i]], x)))
    _, norm = L.make_norm(cfg)
    xf = norm(params["final_norm"], x)
    outs.append((cfg.num_layers - 1,
                 L.unembed(cfg, params["embed"], params["unembed"], xf)))
    return outs


def exit_loss(cfg: ModelConfig, params, heads, batch,
              weights: Optional[Sequence[float]] = None):
    """Weighted sum of per-exit cross-entropies (joint training)."""
    outs = forward_with_exits(cfg, params, heads, batch["tokens"])
    targets = batch["targets"].long()
    if weights is None:
        weights = [1.0] * len(outs)
    total = 0.0
    for w, (_, logits) in zip(weights, outs):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])
        total = total + w * torch.mean(nll)
    return total / sum(weights)


@dataclass
class ExitReport:
    predictions: torch.Tensor      # (B, S) int32
    exit_layer: torch.Tensor       # (B,) int32 layer index each example left at
    expected_layers: float         # mean layers executed per example
    flops_saved_frac: float        # vs. always running the full stack


def serve_early_exit(cfg: ModelConfig, params, heads, tokens,
                     threshold: float = 0.7,
                     conf_reduce: str = "mean") -> ExitReport:
    """Confidence-gated inference.

    conf_reduce: per-example confidence over token positions — "mean"
    (LM-style; first tokens of a sequence are inherently unpredictable)
    or "min" (strictest, classification-style).
    """
    x, positions = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    dev = x.device
    exit_at = dict(zip(heads["exit_layers"], range(len(heads["exits"]))))

    exited = torch.zeros((B,), dtype=torch.bool, device=dev)
    exit_layer = torch.full((B,), cfg.num_layers - 1, dtype=torch.int32,
                            device=dev)
    preds = torch.zeros((B, S), dtype=torch.int32, device=dev)

    for i in range(cfg.num_layers):
        if bool(exited.all()):
            break  # batch-granular compute skip
        x = _block(cfg, params, i, x, positions)
        if i in exit_at:
            logits = _exit_logits(cfg, params,
                                  heads["exits"][exit_at[i]], x)
            probs = torch.softmax(logits.float(), dim=-1)
            tok_conf = torch.amax(probs, dim=-1)
            conf = (torch.amin(tok_conf, dim=-1) if conf_reduce == "min"
                    else torch.mean(tok_conf, dim=-1))
            newly = (~exited) & (conf >= threshold)
            preds = torch.where(newly[:, None],
                                torch.argmax(logits, -1).to(torch.int32),
                                preds)
            exit_layer = exit_layer.masked_fill(newly, i)
            exited = exited | newly

    _, norm = L.make_norm(cfg)
    logits = L.unembed(cfg, params["embed"], params["unembed"],
                       norm(params["final_norm"], x))
    preds = torch.where(exited[:, None],
                        preds, torch.argmax(logits, -1).to(torch.int32))

    expected = float(torch.mean((exit_layer + 1).float()))
    saved = 1.0 - expected / cfg.num_layers
    return ExitReport(preds, exit_layer, expected, saved)
