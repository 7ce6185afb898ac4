"""Unified model API (PyTorch port of ``repro.models.model``).

The same entry points, dispatched on ``cfg.family``; the port has the
dense family (``models.transformer``) and the ssm family
(``models.ssm``), and every other family raises
``NotImplementedError`` naming its ROADMAP item:

    init_params(cfg, generator, device)           -> params
    forward(cfg, params, tokens, use_kernel=...)  -> logits (B, S, V)
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
    extendable / spec_decodable / prefix_sharable -> bool

The JAX entry points return new caches; these update the cache's
tensors in place and return the same cache (``prefill`` makes a new
one, as in JAX).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike
from repro_torch.models import ssm, transformer

_FAMILIES = {"dense": transformer, "ssm": ssm}
_FAMILY_ITEMS = {"moe": "A.9.1", "vlm": "A.9.2", "encdec": "A.9.3",
                 "hybrid": "A.9.5"}


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


def forward(cfg: ModelConfig, params, tokens, *, use_kernel: bool = False):
    """Full-sequence logits.  ``use_kernel`` sends the ssm family's scan
    through ``kernels.ops.ssd_scan`` (as JAX ``apply(use_kernel=)``);
    the dense family ignores it."""
    if cfg.family == "ssm":
        return ssm.forward(cfg, params, tokens, use_kernel=use_kernel)
    return family_module(cfg).forward(cfg, params, tokens)


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
    family's scan through ``kernels.ops.ssd_scan``; ``use_flash`` is the
    attention families' switch."""
    if cfg.family == "ssm":
        return ssm.prefill(cfg, params, batch["tokens"], max_len,
                           use_kernel=use_kernel, true_len=true_len)
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
    ssm family (no pages) writes each row's state at ``slots`` and runs
    its scan through ``kernels.ops.ssd_scan`` with ``use_kernel``.
    Returns (last-true-token logits, cache)."""
    if cfg.family == "ssm":
        return ssm.prefill_paged(
            cfg, params, batch["tokens"], max_len, cache, slots=slots,
            write_tables=write_tables, ctx_tables=ctx_tables,
            ctx_len=ctx_len, true_len=true_len, use_kernel=use_kernel)
    return family_module(cfg).prefill_paged(
        cfg, params, batch["tokens"], max_len, cache, slots=slots,
        write_tables=write_tables, ctx_tables=ctx_tables, ctx_len=ctx_len,
        true_len=true_len, use_flash=use_flash)


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
