"""Unified model API (PyTorch port of ``repro.models.model``).

The same entry points, dispatched on ``cfg.family``; the port has the
dense family (``models.transformer``), the ssm family (``models.ssm``)
and the hybrid family (``models.hybrid``: mamba blocks and one shared
attention block), and every other family raises
``NotImplementedError`` naming its ROADMAP item:

    init_params(cfg, generator, device)           -> params
    forward(cfg, params, tokens, use_kernel=...)  -> logits (B, S, V)
    apply(cfg, params, batch, use_flash=...,
          use_kernel=..., remat=...)              -> (logits, aux loss)
    loss_fn(cfg, params, batch, **opts)           -> (loss, metrics)
    init_cache(cfg, b, max_len, device)           -> cache (dense strips)
    prefill(cfg, params, batch, max_len,
            true_len=...)                         -> (logits, cache)
    decode_step(cfg, params, cache, toks, pos)    -> (logits, cache)
    init_paged_cache(cfg, b, max_len, nB, bs)     -> cache (paged pool)
    prefill_paged(cfg, params, batch, max_len,
                  cache, slots=..., write_tables=..., true_len=...,
                  use_kernel=...)                 -> (logits, cache)
    decode_step_paged(cfg, params, cache,
                      toks, pos, block_tables)    -> (logits, cache)
    extend_paged(cfg, params, cache, toks[B,S],
                 pos, block_tables)               -> (logits[B,S,V], cache)
    extend(cfg, params, cache, toks[B,S], pos)    -> (logits[B,S,V], cache)
    extendable / spec_decodable / prefix_sharable -> bool
    make_batch(cfg, shape, generator, device)     -> random batch

The JAX entry points return new caches; these update the cache's
tensors in place and return the same cache (``prefill`` makes a new
one, as in JAX).  ``batch`` is a dict of ``tokens`` / ``targets`` (and
an optional ``loss_mask``); the vlm and encdec families' embedding
inputs come with their slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import hybrid, ssm, transformer

_FAMILIES = {"dense": transformer, "ssm": ssm, "hybrid": hybrid}
_FAMILY_ITEMS = {"moe": "A.9.1", "vlm": "A.9.2", "encdec": "A.9.3"}


def family_module(cfg: ModelConfig):
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    item = _FAMILY_ITEMS.get(cfg.family)
    if item is None:
        raise ValueError(cfg.family)
    raise NotImplementedError(
        f"the {cfg.family} family is not ported to repro_torch yet "
        f"(ROADMAP {item})")


def init_params(cfg: ModelConfig, generator=None, device: DeviceLike = None):
    return family_module(cfg).init_params(cfg, generator, device)


def specialize(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt static config knobs to an input shape (the enc-dec position
    table must cover the decoder length)."""
    if cfg.family == "encdec" and cfg.max_target_positions < shape.seq_len:
        cfg = cfg.replace(max_target_positions=shape.seq_len)
    return cfg


def apply(cfg: ModelConfig, params, batch: dict, *, use_flash: bool = False,
          use_kernel: bool = False, remat: Optional[str] = None):
    """Full-sequence logits (B, S, V) and a scalar aux loss (0 where n/a,
    float32).  ``use_flash`` sends the attention of the dense and hybrid
    families through ``kernels.ops.flash_attention`` and ``use_kernel``
    the ssm and hybrid families' scan through ``kernels.ops.ssd_scan``
    (neither kernel has a backward); ``remat`` is the JAX checkpoint
    policy name (``transformer._maybe_remat``)."""
    tokens = batch["tokens"]
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.family == "ssm":
        return ssm.forward(cfg, params, tokens, use_kernel=use_kernel,
                           remat=remat), zero
    if cfg.family == "hybrid":
        return hybrid.forward(cfg, params, tokens, use_flash=use_flash,
                              use_kernel=use_kernel, remat=remat), zero
    return family_module(cfg).forward(cfg, params, tokens,
                                      use_flash=use_flash, remat=remat), zero


def loss_fn(cfg: ModelConfig, params, batch: dict, **opts):
    """Mean next-token cross-entropy of ``batch["targets"]`` under
    ``apply(**opts)``: float32 log-softmax, masked by ``loss_mask`` when
    the batch has one.  Returns (loss, {"ce", "aux"})."""
    logits, aux = apply(cfg, params, batch, **opts)
    targets = batch["targets"]
    logits = logits[:, -targets.shape[1]:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    del logits
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = float(nll.numel())
    ce = torch.sum(nll) / denom
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the JAX
    ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def batch_shapes(cfg: ModelConfig, shape: InputShape) -> dict:
    """``TensorSpec`` of every model input of a train/prefill batch."""
    if cfg.family in ("vlm", "encdec"):
        family_module(cfg)
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": TensorSpec((B, S), torch.int32),
            "targets": TensorSpec((B, S), torch.int32)}


def count_params(params) -> int:
    """Number of scalars in a parameter tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def forward(cfg: ModelConfig, params, tokens, *, use_kernel: bool = False):
    """Full-sequence logits: ``apply``'s, without the aux loss."""
    return apply(cfg, params, {"tokens": tokens}, use_kernel=use_kernel)[0]


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: DeviceLike = None):
    """Dense decode cache: one ``max_len`` strip per row and layer (the
    speculative draft's cache), on ``device`` (default ``cuda``)."""
    return family_module(cfg).init_cache(cfg, batch_size, max_len, device)


def prefill(cfg: ModelConfig, params, batch: dict, max_len: int, *,
            use_flash: bool = False, use_kernel: bool = False,
            true_len=None):
    """Run the prompt and build a dense decode cache of its rows.
    ``true_len`` (int | (B,) int32): the true token count of each
    right-padded row; logits come from each row's true last token and
    pad positions stay out of the decode state, so padded prefill
    decodes exactly like an unpadded one.  ``use_kernel`` sends the ssm
    and hybrid families' scan through ``kernels.ops.ssd_scan``;
    ``use_flash`` is the attention families' switch (the hybrid's shared
    block included)."""
    if cfg.family == "ssm":
        return ssm.prefill(cfg, params, batch["tokens"], max_len,
                           use_kernel=use_kernel, true_len=true_len)
    if cfg.family == "hybrid":
        return hybrid.prefill(cfg, params, batch["tokens"], max_len,
                              use_flash=use_flash, use_kernel=use_kernel,
                              true_len=true_len)
    return family_module(cfg).prefill(cfg, params, batch["tokens"], max_len,
                                      use_flash=use_flash,
                                      true_len=true_len)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """One decode token per row against the dense cache (updated in
    place); pos: (B,) int32 or a scalar write position."""
    return family_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def init_paged_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                     num_blocks: int, block_size: int, kv_dtype=None,
                     device: DeviceLike = None):
    """Decode cache with attention KV in a shared page pool of
    ``num_blocks`` x ``block_size`` tokens (no batch axis on pool
    leaves), on ``device`` (default ``cuda``).  ``kv_dtype="int8"``
    stores the pool quantized with per-(page, offset, kv-head) float32
    scales in ``k_scale``/``v_scale`` leaves
    (``layers.init_kv_pages(quant=True)``); every paged read path
    dequantizes.  ``None`` keeps the pool in the activation dtype."""
    return family_module(cfg).init_paged_cache(
        cfg, batch_size, max_len, num_blocks, block_size,
        kv_dtype=kv_dtype, device=device)


def decode_step_paged(cfg: ModelConfig, params, cache, tokens, pos,
                      block_tables, use_pallas: bool = False):
    """One decode token per row through ``block_tables`` (B, n_blk) int32
    (-1 = unallocated), cache updated in place.  ``use_pallas=True``
    reads the pages through the hand-written ``paged_attention`` kernel
    (CUDA tensors) or its plain version (CPU tensors) instead of the
    gather."""
    return family_module(cfg).decode_step_paged(cfg, params, cache, tokens,
                                                pos, block_tables,
                                                use_pallas)


def extend_paged(cfg: ModelConfig, params, cache, tokens, pos,
                 block_tables, valid_len=None, use_pallas: bool = False):
    """Score S tokens against the paged cache in one call (chunked
    catch-up prefill), cache updated in place.  Context read masked
    strictly below ``pos``; K/V for rows ``i < valid_len`` written at
    ``pos + i``.  On an int8 pool ``use_pallas=True`` reads the pages
    through the hand-written ``paged_extend_attention`` kernel (CUDA
    tensors) or its plain version (CPU tensors) instead of the gather;
    a float pool ignores it, as in JAX."""
    return family_module(cfg).extend_paged(cfg, params, cache, tokens,
                                           pos, block_tables, valid_len,
                                           use_pallas=use_pallas)


def prefill_paged(cfg: ModelConfig, params, batch: dict, max_len, cache, *,
                  slots, write_tables=None, ctx_tables=None, ctx_len=None,
                  true_len=None, use_flash: bool = False,
                  use_kernel: bool = False):
    """Admission prefill fused with cache insertion: prompt K/V is
    written directly into the page pool through ``write_tables``; the
    ssm and hybrid families (no pages) write each row's states and rings
    at ``slots`` and run their scan through ``kernels.ops.ssd_scan`` with
    ``use_kernel`` (the ssm family ignores ``use_flash``).  With
    ``ctx_tables`` / ``ctx_len`` the rows are radix-cache-hit suffixes
    that read the shared prefix's pages (only where
    ``prefix_sharable(cfg)``; ``ctx_len`` is token-granular and both
    tables are then the row's full block table); ``write_tables=None``
    is the dense engine's admission into ``max_len`` strips.  Returns
    (last-true-token logits, cache)."""
    if cfg.family == "ssm":
        return ssm.prefill_paged(
            cfg, params, batch["tokens"], max_len, cache, slots=slots,
            write_tables=write_tables, ctx_tables=ctx_tables,
            ctx_len=ctx_len, true_len=true_len, use_kernel=use_kernel)
    if cfg.family == "hybrid":
        return hybrid.prefill_paged(
            cfg, params, batch["tokens"], max_len, cache, slots=slots,
            write_tables=write_tables, ctx_tables=ctx_tables,
            ctx_len=ctx_len, true_len=true_len, use_flash=use_flash,
            use_kernel=use_kernel)
    return family_module(cfg).prefill_paged(
        cfg, params, batch["tokens"], max_len, cache, slots=slots,
        write_tables=write_tables, ctx_tables=ctx_tables, ctx_len=ctx_len,
        true_len=true_len, use_flash=use_flash)


def extend(cfg: ModelConfig, params, cache, tokens, pos, valid_len=None):
    """Dense twin of ``extend_paged``: the same multi-token scoring
    against the dense strips and rings of ``init_cache`` (updated in
    place), which keeps the ``ServeConfig.paged=False`` engine wave for
    wave the paged one.  The recurrent families (ssm, hybrid) are not
    ``extendable`` and raise, as in JAX."""
    if not extendable(cfg):
        raise NotImplementedError(
            f"{cfg.family} has no multi-token extend: its recurrent state "
            "cannot be advanced S tokens and rolled back (gate callers on "
            "model.extendable)")
    return family_module(cfg).extend(cfg, params, cache, tokens, pos,
                                     valid_len)


def make_batch(cfg: ModelConfig, shape: InputShape, generator=None,
               device: DeviceLike = None) -> dict:
    """A random batch of ``batch_shapes(cfg, shape)`` on ``device``
    (default ``cuda``): token ids uniform over the vocabulary, floating
    inputs ``0.1 * randn``, drawn in order from ``generator`` (default:
    seed 0 on the device).  The numbers are not the JAX package's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, spec in batch_shapes(cfg, shape).items():
        if spec.dtype.is_floating_point:
            out[name] = 0.1 * torch.randn(spec.shape, generator=generator,
                                          dtype=spec.dtype, device=dev)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, dtype=spec.dtype,
                                      device=dev)
    return out


def extendable(cfg: ModelConfig) -> bool:
    """Does the family implement multi-token ``extend_paged``?"""
    return cfg.family in ("dense", "moe", "vlm", "encdec")


def spec_decodable(cfg: ModelConfig) -> bool:
    """Can this config serve as a speculative-decoding verify model?"""
    if cfg.family in ("dense", "vlm"):
        return cfg.pattern_period <= 1
    return cfg.family in ("moe", "encdec")


def prefix_sharable(cfg: ModelConfig) -> bool:
    """Can finished chains be shared through the radix prefix cache?"""
    if cfg.family in ("dense", "vlm"):
        return cfg.pattern_period <= 1
    return cfg.family in ("moe", "encdec")
