"""Zamba2-style hybrid trunk (PyTorch port of ``repro.models.hybrid``):
Mamba2 blocks and one SHARED attention(+MLP) block. [arXiv:2411.15242]

The attention block's weights are shared by all of its periodic
applications (every ``hybrid_attn_period``-th position); every other
position is a Mamba2 block (``models.ssm``).  81 layers at period 6 give
13 super-blocks of 5 mamba blocks and one shared-attention application,
then 3 remainder mamba blocks (``rem_mamba``).

Training and prefill attend full-causal, as the model is trained
(``use_flash`` sends that attention through ``kernels.ops.flash_attention``,
``use_kernel`` the mamba blocks' scan through ``kernels.ops.ssd_scan``);
serving decode reads a sliding-window ring of ``W = min(max_len,
local_window)`` entries per application and row, masked on
``local_window``.  Decode state is O(1) per row whatever the prompt
length: the SSM recurrences and the rings, so there is nothing to page
and the engine serves this family pool-free, as it does ssm.

Parameters keep the JAX layout (``mamba`` stacked (nb, period - 1),
``shared_attn`` unstacked, ``rem_mamba`` (rem,)); the ``lax.scan`` over
super-blocks becomes a loop over layer views (``walk``).  ``decode_step``
and ``prefill_paged`` update the cache's tensors IN PLACE and return
that same cache; ``prefill`` makes a new one, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Params = dict


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference layout, stored in
    ``cfg.weight_dtype`` on ``device`` (default ``cuda``), drawn from
    ``generator`` (default: seed 0 on ``device``); not the JAX package's
    numbers — bridge JAX weights for parity."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    nb, rem = _superblocks(cfg)
    kw = dict(dtype=cfg.weight_dtype, device=dev)
    p = {
        "embed": L.init_embedding(cfg, generator, **kw),
        "unembed": L.init_unembed(cfg, generator, **kw),
        "mamba": S.init_mamba_block(cfg, generator,
                                    stack=(nb, cfg.hybrid_attn_period - 1),
                                    **kw),
        "shared_attn": T.init_block(cfg, generator, **kw),  # ONE set
        "final_norm": L.init_rmsnorm(cfg.d_model, device=dev),
    }
    if rem:
        p["rem_mamba"] = S.init_mamba_block(cfg, generator, stack=(rem,),
                                            **kw)
    return p


def _superblocks(cfg: ModelConfig) -> tuple[int, int]:
    period = cfg.hybrid_attn_period
    return cfg.num_layers // period, cfg.num_layers % period


def walk(cfg: ModelConfig, params: Params, cache: Optional[Params] = None):
    """(layer params, layer cache, is_attn) views of every block in the
    JAX order: each super-block's ``period - 1`` mamba blocks, then the
    shared attention block on that super-block's ring, then the
    ``rem_mamba`` blocks.  The layer cache is a mamba block's state dict
    or the application's ring (batch axis first); None without a
    cache."""
    nb, rem = _superblocks(cfg)

    def at(key, i):
        return None if cache is None else T._layer(cache[key], i)
    for i in range(nb):
        mp, mc = T._layer(params["mamba"], i), at("mamba", i)
        for j in range(cfg.hybrid_attn_period - 1):
            yield (T._layer(mp, j), None if mc is None else T._layer(mc, j),
                   False)
        yield params["shared_attn"], at("attn", i), True
    for i in range(rem):
        yield T._layer(params["rem_mamba"], i), at("rem_mamba", i), False


def _positions(x):
    B, Sq, _ = x.shape
    return torch.broadcast_to(
        torch.arange(Sq, dtype=torch.int32, device=x.device), (B, Sq))


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Params, tokens, *, use_flash=False,
            use_kernel=False, remat: Optional[str] = None):
    """Full-sequence logits (B, S, V). tokens: (B, S).  ``remat``: the
    JAX checkpoint policy name of each block
    (``transformer._maybe_remat``)."""
    x = L.embed(cfg, params["embed"], tokens)
    positions = _positions(x)
    mamba = T._maybe_remat(
        lambda h, lp: S.block_fwd(cfg, lp, h, use_kernel=use_kernel)[0],
        remat)
    attn = T._maybe_remat(
        lambda h, lp: T.block_fwd(cfg, lp, h, positions, is_global=True,
                                  use_flash=use_flash), remat)
    for lp, _, is_attn in walk(cfg, params):
        x = (attn if is_attn else mamba)(x, lp)
    return S._logits(cfg, params, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """The decode cache on ``device`` (default ``cuda``; ``"meta"`` gives
    shapes only): mamba states stacked (nb, period - 1) (``rem_mamba``
    (rem,)) and one ring of ``W = min(max_len, local_window)`` entries
    per super-block and row."""
    nb, rem = _superblocks(cfg)
    dev = resolve_device(device)
    W = min(max_len, cfg.local_window)
    c = {
        "mamba": S.init_state(cfg, batch,
                              stack=(nb, cfg.hybrid_attn_period - 1),
                              device=dev),
        "attn": L.init_kv_cache(cfg, batch, W, stack=(nb,), device=dev),
    }
    if rem:
        c["rem_mamba"] = S.init_state(cfg, batch, stack=(rem,), device=dev)
    return c


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens,
                pos):
    """One token per row: mamba blocks step their recurrences, the shared
    block writes its ring at ``pos % W`` and attends the window.  The
    cache's tensors are updated in place.  Returns (logits (B, 1, V),
    cache)."""
    x = L.embed(cfg, params["embed"], tokens)
    for lp, c, is_attn in walk(cfg, params, cache):
        if is_attn:
            x, _ = T.block_decode(cfg, lp, x, c, pos, is_global=False)
            continue
        x, new = S.block_decode(cfg, lp, x, c)
        c["conv"].copy_(new["conv"])
        c["ssm"].copy_(new["ssm"])
    return S._logits(cfg, params, x), cache


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_blocks: int, block_size: int, kv_dtype=None,
                     device: DeviceLike = None) -> Params:
    """The shared block decodes on a ``local_window`` ring and SSM state
    is O(1): nothing uses ``max_len`` strips, so there are no pages to
    carve out — the paged cache IS the dense cache, with no pool leaf,
    and the engine runs this family without a pool (``kv_dtype`` is
    accepted and ignored: no pages, nothing to quantize)."""
    del num_blocks, block_size, kv_dtype
    return init_cache(cfg, batch, max_len, device)


def decode_step_paged(cfg: ModelConfig, params: Params, cache: Params,
                      tokens, pos, block_tables, use_pallas: bool = False):
    del block_tables, use_pallas  # rings + SSM state only; nothing paged
    return decode_step(cfg, params, cache, tokens, pos)


def extend_paged(cfg: ModelConfig, params: Params, cache: Params, tokens,
                 pos, block_tables, valid_len=None,
                 use_pallas: bool = False):
    """Hybrid decode state = SSM recurrences + shared-attention rings:
    both advance irreversibly (the recurrence cannot roll back, ring
    writes evict window context), so neither speculative verify nor
    multi-token catch-up is offered — see ``model.spec_decodable``."""
    raise NotImplementedError(
        "hybrid has no multi-token extend: recurrent state cannot "
        "roll back")


extend = extend_paged  # the dense twin is gated identically


def prefill(cfg: ModelConfig, params: Params, tokens, max_len, *,
            use_flash=False, use_kernel=False, true_len=None):
    """Run the prompt; returns (last-true-token logits (B, 1, V), a new
    cache of B rows).  The shared block attends full-causal
    (``use_flash``: through ``kernels.ops.flash_attention``) and each
    application's ring is filled from its K/V (``transformer._fill_local``);
    the mamba blocks' final states land in the cache (``use_kernel``: the
    scan through ``kernels.ops.ssd_scan``).  ``true_len`` (int | (B,)
    int32) marks right-padded rows: pad positions leave the states
    untouched and stay out of the rings."""
    x = L.embed(cfg, params["embed"], tokens)
    n = T.broadcast_true_len(true_len, x.shape[0], x.device)
    positions = _positions(x)
    cache = init_cache(cfg, x.shape[0], max_len, x.device)
    for lp, c, is_attn in walk(cfg, params, cache):
        if is_attn:
            x, (k, v) = T.block_prefill(cfg, lp, x, positions,
                                        is_global=True, use_flash=use_flash)
            T._fill_local(c, k, v, n)
            continue
        x, new = S.block_fwd(cfg, lp, x, use_kernel=use_kernel, true_len=n)
        c["conv"].copy_(new["conv"])
        c["ssm"].copy_(new["ssm"])
    x = x[:, -1:] if n is None else T.gather_last(x, n)
    return S._logits(cfg, params, x), cache


def prefill_paged(cfg: ModelConfig, params: Params, tokens, max_len,
                  cache, *, slots, write_tables=None, ctx_tables=None,
                  ctx_len=None, true_len=None, use_flash=False,
                  use_kernel=False):
    """Admission prefill fused with state insertion: each row's mamba
    states and rings land in the engine cache at ``slots`` (in place).
    Nothing here is paged or shareable — a ring holds only the last W
    tokens and the recurrence is not reconstructible from pages — so
    context is rejected."""
    if write_tables is not None or ctx_tables is not None:
        raise ValueError("hybrid has no paged KV and no shareable prefix")
    logits, st = prefill(cfg, params, tokens, max_len, use_flash=use_flash,
                         use_kernel=use_kernel, true_len=true_len)
    slots = torch.as_tensor(slots, dtype=torch.int32, device=logits.device)
    T.scatter_cache_rows(cache["mamba"], st["mamba"], slots, 2)
    T.scatter_cache_rows(cache["attn"], st["attn"], slots, 1)
    if "rem_mamba" in st:
        T.scatter_cache_rows(cache["rem_mamba"], st["rem_mamba"], slots, 1)
    return logits, cache
