"""Early-exit heads (PyTorch port of ``repro.core.earlyexit``; this slice
holds only ``init_exit_heads``, the one function the speculative
self-draft needs)."""
from __future__ import annotations

from typing import Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_exit_heads(cfg: ModelConfig, exit_layers: Sequence[int],
                    device=None):
    """One head (a norm; the unembedding is tied to the trunk's) per exit
    point.  The JAX function takes a PRNG key it never draws from: a
    fresh norm is deterministic, so none is taken here."""
    norm_init, _ = L.make_norm(cfg)
    heads = [{"ln": norm_init(cfg.d_model, device=device)}
             for _ in exit_layers]
    return {"exits": heads, "exit_layers": tuple(exit_layers)}
