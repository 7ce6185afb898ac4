"""InternVL2-style VLM backbone (PyTorch port of ``repro.models.vlm``):
a stub vision frontend and the dense language trunk.

The InternViT encoder is a stub, as in JAX: requests carry precomputed
patch embeddings (B, num_image_tokens, image_embed_dim).  This module
owns the MLP projector (rmsnorm, tanh GELU, two matmuls) and hands the
language trunk to ``models.transformer``, with the projected image
tokens at positions [0, num_image_tokens) before the text.  Every cache
entry point updates the cache's tensors in place, as the trunk's do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = dict


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """The trunk's parameters (``transformer.init_params``) and the
    ``projector`` (``w1`` (image_embed_dim, d), ``w2`` (d, d), ``ln``),
    in ``cfg.weight_dtype`` on ``device`` (default ``cuda``), drawn from
    ``generator`` (default: seed 0 on ``device``); not the JAX package's
    numbers — bridge JAX weights for parity."""
    dev = resolve_device(device)
    if generator is None:
        generator = L.default_generator(dev)
    p = T.init_params(cfg, generator, dev)
    kw = dict(dtype=cfg.weight_dtype, device=dev)
    p["projector"] = {
        "w1": L._dense_init(generator, (cfg.image_embed_dim, cfg.d_model),
                            **kw),
        "w2": L._dense_init(generator, (cfg.d_model, cfg.d_model), **kw),
        "ln": L.init_rmsnorm(cfg.image_embed_dim, device=dev),
    }
    return p


def project(cfg: ModelConfig, p: Params, image_embeds):
    """(B, N_img, image_embed_dim) -> (B, N_img, d_model)."""
    x = image_embeds.to(cfg.activation_dtype)
    x = L.rmsnorm(p["projector"]["ln"], x, cfg.norm_eps)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(torch.matmul(x, p["projector"]["w1"].to(x.dtype)),
               approximate="tanh")
    return torch.matmul(h, p["projector"]["w2"].to(x.dtype))


def forward(cfg: ModelConfig, params: Params, tokens, image_embeds, *,
            use_flash=False, remat: Optional[str] = None):
    """tokens: (B, S_text); the projected image tokens go first.  Returns
    logits over the whole (image + text) sequence."""
    return T.forward(cfg, params, tokens,
                     prefix_embeds=project(cfg, params, image_embeds),
                     use_flash=use_flash, remat=remat)


init_cache = T.init_cache
decode_step = T.decode_step
init_paged_cache = T.init_paged_cache      # the trunk owns every KV layer
decode_step_paged = T.decode_step_paged
extend_paged = T.extend_paged  # text-token extend; the image is KV only
extend = T.extend
paged_layers = T.paged_layers


def prefill(cfg: ModelConfig, params: Params, tokens, max_len, *,
            image_embeds=None, use_flash=False, true_len=None):
    """``true_len`` counts TEXT tokens; ``transformer.prefill`` offsets
    it by the image prefix."""
    return T.prefill(cfg, params, tokens, max_len,
                     prefix_embeds=project(cfg, params, image_embeds),
                     use_flash=use_flash, true_len=true_len)


def prefill_paged(cfg: ModelConfig, params: Params, tokens, max_len,
                  cache, *, slots, write_tables=None, ctx_tables=None,
                  ctx_len=None, true_len=None, image_embeds=None,
                  use_flash=False):
    """Paged admission prefill (``transformer.prefill_paged``).  Cold
    rows project the image and put it before the text.  A radix-hit row
    is a pure-text suffix: its matched chain always covers the image
    positions (the engine keys them under the image digest and treats a
    shorter match as a miss), so ``image_embeds`` is ignored and the
    image K/V is read from the pages."""
    if ctx_tables is not None:
        return T.prefill_paged(
            cfg, params, tokens, max_len, cache, slots=slots,
            write_tables=write_tables, ctx_tables=ctx_tables,
            ctx_len=ctx_len, true_len=true_len, use_flash=use_flash)
    return T.prefill_paged(
        cfg, params, tokens, max_len, cache, slots=slots,
        write_tables=write_tables, true_len=true_len,
        prefix_embeds=project(cfg, params, image_embeds),
        use_flash=use_flash)
