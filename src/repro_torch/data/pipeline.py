"""Synthetic data pipeline (PyTorch port of ``repro.data.pipeline``):
deterministic, shardable, learnable.

Tokens follow a fixed random bigram chain, giving cross-entropy strictly
below ln(V) once a model learns the transitions.  They are drawn with
numpy exactly as the JAX package draws them, so both packages see
identical batches for the same ``DataConfig``; only the final tensors
differ in framework.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import model as M


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    branching: int = 4   # out-degree of the bigram chain (entropy = ln b)
    shard_index: int = 0
    num_shards: int = 1


def _bigram_table(cfg: DataConfig, vocab: int) -> np.ndarray:
    """vocab x branching successor table (deterministic in seed)."""
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(0, vocab, size=(vocab, cfg.branching))


def synthetic_tokens(dcfg: DataConfig, vocab: int, batch: int, seq: int,
                     step: int) -> np.ndarray:
    """(batch, seq+1) int32 bigram-chain tokens for a global step."""
    table = _bigram_table(dcfg, vocab)
    rng = np.random.default_rng(
        (dcfg.seed, step, dcfg.shard_index, 0xEDE_A1))
    out = np.empty((batch, seq + 1), np.int32)
    out[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.integers(0, dcfg.branching, size=(batch, seq))
    for t in range(seq):
        out[:, t + 1] = table[out[:, t], choices[:, t]]
    return out


def data_iterator(cfg: ModelConfig, shape: InputShape,
                  dcfg: Optional[DataConfig] = None,
                  device: DeviceLike = None) -> Iterator[dict]:
    """Yields model batches ``{"tokens", "targets"}`` (int32 on
    ``device``, default ``cuda``), this shard's rows of each global
    step, plus the stub frontends' embeddings where the family takes
    them (``image_embeds`` / ``audio_embeds``): ``0.1 * randn`` from a
    torch generator seeded as the JAX package seeds its key
    (``(seed * 1000003 + step) % 2**31``), so the numbers are not
    JAX's."""
    dcfg = dcfg or DataConfig()
    dev = resolve_device(device)
    shapes = M.batch_shapes(cfg, shape)
    local_b = shape.global_batch // dcfg.num_shards
    step = 0
    while True:
        toks = synthetic_tokens(dcfg, cfg.vocab_size, local_b,
                                shapes["tokens"].shape[1], step)
        t = torch.from_numpy(toks).to(dev)
        batch = {"tokens": t[:, :-1], "targets": t[:, 1:]}
        for name in ("image_embeds", "audio_embeds"):
            if name in shapes:
                spec = shapes[name]
                gen = torch.Generator(device=dev).manual_seed(
                    (dcfg.seed * 1000003 + step) % (2 ** 31))
                batch[name] = 0.1 * torch.randn(
                    (local_b,) + tuple(spec.shape[1:]), generator=gen,
                    dtype=spec.dtype, device=dev)
        yield batch
        step += 1
