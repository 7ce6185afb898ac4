"""Dense decoder-only transformer trunk (PyTorch port of
``repro.models.transformer``).

Layers are stacked along a leading axis exactly like the JAX trunk, and
the ``lax.scan`` over them becomes a Python loop over layer slices (views,
no copies).  Architectures with a local:global attention pattern
(gemma2/3, ``pattern_period > 1``) stack *super-blocks* as in JAX:
``pattern_period - 1`` local (sliding-window) layers followed by one
global layer, then the remainder local layers; ``init_params``,
``trunk_fwd`` and ``forward`` (training and evaluation) take them.
Caches are updated IN PLACE: every ``*_paged`` function writes into the
pool tensors it was given, and ``decode_step`` into the dense strips and
rings of ``init_cache``; each returns that same cache.  On a pattern
config the local layers keep a dense ring of ``W = min(local_window,
max_len)`` entries per row, the global layers a ``max_len`` strip
(``init_cache``) or the shared page pool (``init_paged_cache``); every
cache entry point walks the layers with ``walk`` in the JAX order.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, gen, stack=(), dtype=torch.float32,
               device=None) -> Params:
    norm_init, _ = L.make_norm(cfg)
    kw = dict(dtype=dtype, device=device)
    p = {
        "attn": L.init_attention(cfg, gen, stack, **kw),
        "mlp": L.init_mlp(cfg, gen, stack=stack, **kw),
        "ln1": norm_init(cfg.d_model, stack, device),
        "ln2": norm_init(cfg.d_model, stack, device),
    }
    if cfg.sandwich_norms:
        p["ln1_post"] = norm_init(cfg.d_model, stack, device)
        p["ln2_post"] = norm_init(cfg.d_model, stack, device)
    return p


def init_trunk(cfg: ModelConfig, gen, dtype=torch.float32,
               device=None) -> Params:
    """The stacked trunk: ``{"layers"}`` (nb,) for a uniform config;
    ``{"super": {"local" (nb, period-1), "global" (nb,)}}`` plus
    ``"rem_local"`` (rem,) for a local:global pattern."""
    nb, rem = cfg.pattern_blocks()
    kw = dict(dtype=dtype, device=device)
    if cfg.pattern_period <= 1:
        return {"layers": init_block(cfg, gen, stack=(nb,), **kw)}
    p = {"super": {
        "local": init_block(cfg, gen, stack=(nb, cfg.pattern_period - 1),
                            **kw),
        "global": init_block(cfg, gen, stack=(nb,), **kw)}}
    if rem:
        p["rem_local"] = init_block(cfg, gen, stack=(rem,), **kw)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference layout (same keys, shapes and
    init scheme as the JAX ``init_params``), stored in
    ``cfg.weight_dtype`` on ``device`` (default ``cuda``).  The numbers
    come from ``generator`` (default: seed 0 on ``device``); they are not
    the JAX package's numbers — bridge JAX weights for parity."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    norm_init, _ = L.make_norm(cfg)
    kw = dict(dtype=cfg.weight_dtype, device=dev)
    return {
        "embed": L.init_embedding(cfg, generator, **kw),
        "unembed": L.init_unembed(cfg, generator, **kw),
        "trunk": init_trunk(cfg, generator, **kw),
        "final_norm": norm_init(cfg.d_model, device=dev),
    }


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter / pool tree (views)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _uniform_layers(cfg: ModelConfig, trunk: Params):
    """Per-layer views of a uniform stacked trunk, the first
    ``cfg.num_layers`` of them (a tree holding more stacked layers is
    sliced, as in JAX)."""
    return [_layer(trunk["layers"], i) for i in range(cfg.num_layers)]


def walk(cfg: ModelConfig, trunk: Params, cache: Params):
    """(layer params, layer cache, is_global) views of every layer in the
    JAX order: the uniform stack's first ``cfg.num_layers`` layers; on a
    pattern config each super-block's ``pattern_period - 1`` local
    layers, then its global layer, then the ``rem_local`` layers.  The
    layer cache is that layer's ring or strip (batch axis first) or, on
    a paged global layer, its page pool."""
    if cfg.pattern_period <= 1:
        for i in range(cfg.num_layers):
            yield (_layer(trunk["layers"], i), _layer(cache["layers"], i),
                   True)
        return
    nb, rem = cfg.pattern_blocks()
    for i in range(nb):
        sp, sc = _layer(trunk["super"], i), _layer(cache["super"], i)
        for j in range(cfg.pattern_period - 1):
            yield _layer(sp["local"], j), _layer(sc["local"], j), False
        yield sp["global"], sc["global"], True
    for i in range(rem):
        yield (_layer(trunk["rem_local"], i), _layer(cache["rem_local"], i),
               False)


def paged_layers(cfg: ModelConfig, params: Params, cache: Params):
    """(layer params, layer pool) view pairs of the paged (global)
    layers, first layer first: one ``block_*_paged`` call per pair (every
    layer of a uniform trunk)."""
    return [(lp, c) for lp, c, is_global in walk(cfg, params["trunk"], cache)
            if is_global]


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _block(cfg: ModelConfig, p: Params, x, attend):
    """Pre-norm residual block around ``attend(h) -> (a, aux)``."""
    _, norm = L.make_norm(cfg)
    h = norm(p["ln1"], x)
    a, aux = attend(h)
    if cfg.sandwich_norms:
        a = norm(p["ln1_post"], a)
    x = x + a
    h = norm(p["ln2"], x)
    m = L.mlp(p["mlp"], h)
    if cfg.sandwich_norms:
        m = norm(p["ln2_post"], m)
    return x + m, aux


def block_fwd(cfg: ModelConfig, p: Params, x, positions, *, is_global,
              use_flash=False):
    out, _ = _block(cfg, p, x, lambda h: (L.attention_fwd(
        cfg, p["attn"], h, positions, is_global=is_global,
        use_flash=use_flash)[0], None))
    return out


def block_prefill(cfg: ModelConfig, p: Params, x, positions, *, is_global,
                  use_flash=False):
    """Like ``block_fwd`` but also returns (k, v) for cache construction."""
    def attend(h):
        o, k, v = L.attention_fwd(cfg, p["attn"], h, positions,
                                  is_global=is_global, use_flash=use_flash)
        return o, (k, v)
    return _block(cfg, p, x, attend)


def block_decode(cfg: ModelConfig, p: Params, x, cache, pos, *, is_global):
    """A layer's decode step against its dense cache (in place)."""
    return _block(cfg, p, x, lambda h: L.attention_decode(
        cfg, p["attn"], h, cache, pos, is_global=is_global))


def block_extend(cfg: ModelConfig, p: Params, x, cache, pos, *, is_global,
                 valid_len=None):
    """``block_decode`` for S tokens against a dense ring or strip cache
    (``layers.attention_extend``, in place)."""
    return _block(cfg, p, x, lambda h: L.attention_extend(
        cfg, p["attn"], h, cache, pos, is_global=is_global,
        valid_len=valid_len))


def block_decode_paged(cfg: ModelConfig, p: Params, x, cache, pos,
                       block_tables, use_pallas: bool = False):
    """A GLOBAL layer's decode step whose KV lives in the paged pool
    (``layers.attention_decode_paged``, in place)."""
    return _block(cfg, p, x, lambda h: L.attention_decode_paged(
        cfg, p["attn"], h, cache, pos, block_tables, use_pallas=use_pallas))


def block_extend_paged(cfg: ModelConfig, p: Params, x, pos, cache,
                       block_tables, valid_len=None, *,
                       use_pallas: bool = False):
    """``block_decode_paged`` for S tokens at once (chunked catch-up)."""
    return _block(cfg, p, x, lambda h: L.attention_extend_paged(
        cfg, p["attn"], h, pos, cache, block_tables, valid_len,
        use_pallas=use_pallas))


def block_prefill_paged(cfg: ModelConfig, p: Params, x, positions, pages,
                        write_tables, ctx_tables=None, ctx_len=None, *,
                        use_flash=False):
    """A GLOBAL layer's prefill writing K/V straight into its page pool
    (``layers.attention_prefill_paged``, in place)."""
    return _block(cfg, p, x, lambda h: L.attention_prefill_paged(
        cfg, p["attn"], h, positions, pages, write_tables, ctx_tables,
        ctx_len, use_flash=use_flash))


# ---------------------------------------------------------------------------
# full-sequence forward (train / evaluation without cache)
# ---------------------------------------------------------------------------

def _maybe_remat(fn, policy: Optional[str]):
    """``fn`` recomputed in the backward pass under ``policy``, the JAX
    ``TrainConfig.remat`` name: ``None`` / ``"none"`` keep every
    activation; ``"full"`` and ``"nothing_saveable"`` save only the
    block's inputs and recompute the rest (``torch.utils.checkpoint``,
    non-reentrant).  Any other JAX checkpoint policy raises rather than
    silently saving something else."""
    if not policy or policy == "none":
        return fn
    if policy not in ("full", "nothing_saveable"):
        raise NotImplementedError(
            f"remat policy {policy!r} is not ported to repro_torch (it "
            f"takes None, 'none', 'full' and 'nothing_saveable')")

    def recomputed(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return recomputed


def trunk_fwd(cfg: ModelConfig, trunk: Params, x, positions, *,
              use_flash=False, remat: Optional[str] = None):
    """The trunk over x (B, S, d) in the JAX layer order: each
    super-block's locals, then its global, then ``rem_local``."""
    def body(h, lp, is_global):
        return block_fwd(cfg, lp, h, positions, is_global=is_global,
                         use_flash=use_flash)

    if cfg.pattern_period <= 1:
        step = _maybe_remat(lambda h, lp: body(h, lp, True), remat)
        for lp in _uniform_layers(cfg, trunk):
            x = step(x, lp)
        return x

    local = _maybe_remat(lambda h, lp: body(h, lp, False), remat)

    def super_body(h, sp):
        for j in range(cfg.pattern_period - 1):
            h = local(h, _layer(sp["local"], j))
        return body(h, sp["global"], True)

    superblock = _maybe_remat(super_body, remat)
    nb, rem = cfg.pattern_blocks()
    for i in range(nb):
        x = superblock(x, _layer(trunk["super"], i))
    for i in range(rem):
        x = local(x, _layer(trunk["rem_local"], i))
    return x


def forward(cfg: ModelConfig, params: Params, tokens, *, use_flash=False,
            remat: Optional[str] = None):
    """Full-sequence logits (B, S, V). tokens: (B, S)."""
    x = L.embed(cfg, params["embed"], tokens)
    B, S, _ = x.shape
    positions = torch.broadcast_to(
        torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
    x = trunk_fwd(cfg, params["trunk"], x, positions, use_flash=use_flash,
                  remat=remat)
    return _logits(cfg, params, x)


def _logits(cfg: ModelConfig, params: Params, x):
    _, norm = L.make_norm(cfg)
    x = norm(params["final_norm"], x)
    return L.unembed(cfg, params["embed"], params["unembed"], x)


# ---------------------------------------------------------------------------
# dense cache + decode
# ---------------------------------------------------------------------------

def _cache(cfg: ModelConfig, batch: int, max_len: int, global_leaves,
           dtype=None, device=None) -> Params:
    """The cache tree around ``global_leaves`` (the global layers'
    stacked strips or pool): ``{"layers"}`` on a uniform config; on a
    pattern config ``{"super": {"local", "global"}}`` plus
    ``"rem_local"``, the local layers' rings of ``W = min(local_window,
    max_len)`` entries per row, in ``dtype`` (default the activation
    dtype, also under an int8 pool: rings are per-slot state, not pool
    capacity)."""
    if cfg.pattern_period <= 1:
        return {"layers": global_leaves}
    nb, rem = cfg.pattern_blocks()
    W = min(cfg.local_window, max_len)
    c = {"super": {
        "local": L.init_kv_cache(cfg, batch, W,
                                 stack=(nb, cfg.pattern_period - 1),
                                 dtype=dtype, device=device),
        "global": global_leaves}}
    if rem:
        c["rem_local"] = L.init_kv_cache(cfg, batch, W, stack=(rem,),
                                         dtype=dtype, device=device)
    return c


def _n_global(cfg: ModelConfig) -> int:
    return (cfg.num_layers if cfg.pattern_period <= 1
            else cfg.pattern_blocks()[0])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """Dense decode cache on ``device`` (default ``cuda``; ``"meta"``
    gives shapes only): one ``max_len`` strip per row and global layer
    (``{"layers": {"k", "v", "slots"}}`` stacked over the layers on a
    uniform config) and, on a pattern config, one ring per row and
    local layer (``_cache``)."""
    dev = resolve_device(device)
    return _cache(cfg, batch, max_len, L.init_kv_cache(
        cfg, batch, max_len, stack=(_n_global(cfg),), device=dev),
        device=dev)


def trunk_decode(cfg: ModelConfig, trunk: Params, cache: Params, x, pos):
    """x: (B, 1, d); pos: (B,) int32 write positions.  Returns (x,
    cache), the cache updated in place."""
    for lp, c, is_global in walk(cfg, trunk, cache):
        x, _ = block_decode(cfg, lp, x, c, pos, is_global=is_global)
    return x, cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens,
                pos):
    """One decode token per row against the dense cache (updated in
    place).  tokens: (B, 1) int32; pos: (B,) int32 (or a scalar) write
    positions.  Returns (logits (B, 1, V), cache)."""
    x = L.embed(cfg, params["embed"], tokens)
    x, cache = trunk_decode(cfg, params["trunk"], cache, x, pos)
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# paged cache + decode / extend
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_blocks: int, block_size: int, kv_dtype=None,
                     device: DeviceLike = None) -> Params:
    """Like ``init_cache``, but the global layers share a page pool (no
    batch axis) of shape (n_global, num_blocks, block_size, K, hd) in the
    activation dtype, on ``device`` (default ``cuda``);
    ``kv_dtype="int8"`` makes the pool int8 with float32
    ``k_scale``/``v_scale`` leaves (n_global, num_blocks, block_size, K)
    beside it.  Local ring layers stay dense at W per row."""
    dev = resolve_device(device)
    return _cache(cfg, batch, max_len, L.init_kv_pages(
        cfg, num_blocks, block_size, stack=(_n_global(cfg),),
        quant=kv_dtype == "int8", device=dev), device=dev)


def decode_step_paged(cfg: ModelConfig, params: Params, cache: Params,
                      tokens, pos, block_tables, use_pallas: bool = False):
    """One decode token per row against the paged cache (updated in
    place): global layers read and write their pages through
    ``block_tables`` (B, n_blk) int32, local layers their rings.
    tokens: (B, 1) int32; pos: (B,) int32 write positions.  Returns
    (logits (B, 1, V), cache)."""
    x = L.embed(cfg, params["embed"], tokens)
    for lp, c, is_global in walk(cfg, params["trunk"], cache):
        if is_global:
            x, _ = block_decode_paged(cfg, lp, x, c, pos, block_tables,
                                      use_pallas)
        else:
            x, _ = block_decode(cfg, lp, x, c, pos, is_global=False)
    return _logits(cfg, params, x), cache


def extend_paged(cfg: ModelConfig, params: Params, cache: Params, tokens,
                 pos, block_tables, valid_len=None,
                 use_pallas: bool = False):
    """Score S tokens against the paged cache in one call (updated in
    place).  tokens: (B, S) int32 at absolute positions ``pos + i``.
    Global layers extend through their pages
    (``layers.attention_extend_paged``), local layers through their
    rings with the same pre-write causal-suffix semantics
    (``layers.attention_extend``; requires S <= W).  Returns (logits
    (B, S, V), cache) — row i is the next-token distribution after
    consuming ``tokens[:, :i+1]``; rows ``i >= valid_len`` are padding
    (garbage logits, writes dropped)."""
    x = L.embed(cfg, params["embed"], tokens)
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                             device=x.device),
                             (x.shape[0],))
    for lp, c, is_global in walk(cfg, params["trunk"], cache):
        if is_global:
            x, _ = block_extend_paged(cfg, lp, x, pos, c, block_tables,
                                      valid_len, use_pallas=use_pallas)
        else:
            x, _ = block_extend(cfg, lp, x, c, pos, is_global=False,
                                valid_len=valid_len)
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# prefill: admission writes straight into the engine cache
# ---------------------------------------------------------------------------

def broadcast_true_len(true_len, batch: int, device=None):
    """``true_len`` (int | (B,) int32 | None) -> (B,) int32 | None."""
    if true_len is None:
        return None
    return torch.broadcast_to(torch.as_tensor(true_len, dtype=torch.int32,
                                              device=device), (batch,))


def gather_last(x, n):
    """x: (B, S, d); n: (B,) true lengths -> (B, 1, d) at index n-1."""
    idx = torch.clamp(n - 1, min=0).long()[:, None, None]
    return torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))


def _fill_global(cache: Params, k, v, n=None) -> None:
    """Fill one layer's dense cache (strips of ``max_len``) from prefill
    K/V (B, S, K, hd) in place: k/v at [0, S), and ``slots`` marking
    positions below ``n`` (the true lengths; all S without it) valid and
    the right-padding -1, so pad K/V is never attended and is
    overwritten in sequence order by later decodes."""
    B, S = k.shape[0], k.shape[1]
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    max_len = cache["slots"].shape[1]
    pos = torch.arange(max_len, dtype=torch.int32, device=k.device)
    limit = (torch.full((B,), S, dtype=torch.int32, device=k.device)
             if n is None else n)
    cache["slots"].copy_(torch.where(pos[None, :] < limit[:, None],
                                     pos[None, :], -1))


def _fill_local(cache: Params, k, v, n=None) -> None:
    """Fill one layer's ring of W entries (an empty ``init_kv_cache``
    ring) from prefill K/V (B, S, K, hd) in place.  With ``n`` (the
    true lengths) ring slot j holds the largest position p <= n-1 with
    p % W == j, so right-padding never evicts true context; without it
    the ring holds the last min(S, W) positions."""
    B, S = k.shape[0], k.shape[1]
    W = cache["k"].shape[1]
    if n is not None:
        j = torch.arange(W, dtype=torch.int32, device=k.device)
        p = j[None, :] + ((n[:, None] - 1 - j[None, :]) // W) * W  # (B, W)
        valid = (p >= 0) & (p < n[:, None])
        idx = torch.clamp(p, 0, S - 1).long()[..., None, None].expand(
            B, W, *k.shape[2:])
        for key, src in (("k", k), ("v", v)):
            cache[key].copy_(torch.where(valid[..., None, None],
                                         torch.gather(src, 1, idx), 0))
        cache["slots"].copy_(torch.where(valid, p, -1))
    elif S >= W:
        pos = torch.arange(S - W, S, dtype=torch.int32, device=k.device)
        at = (pos % W).long()
        cache["k"][:, at] = k[:, S - W:].to(cache["k"].dtype)
        cache["v"][:, at] = v[:, S - W:].to(cache["v"].dtype)
        cache["slots"][:, at] = pos
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["slots"][:, :S] = torch.arange(S, dtype=torch.int32,
                                             device=k.device)


def prefill(cfg: ModelConfig, params: Params, tokens, max_len, *,
            prefix_embeds=None, use_flash=False, true_len=None):
    """Run the prompt and return (last-token logits (B, 1, V), a dense
    cache of B rows sized ``max_len``: strips and rings).  ``true_len``
    (int | (B,) int32) marks right-padded rows: logits come from each
    row's true last token and pad positions stay out of the cache, so a
    padded prefill decodes exactly like an unpadded one.  VLM prefix
    embeddings belong to the vlm slice."""
    if prefix_embeds is not None:
        raise L._not_ported("prefix embeddings", "A.9.2 (vlm family)")
    x = L.embed(cfg, params["embed"], tokens)
    B, S, _ = x.shape
    n = broadcast_true_len(true_len, B, x.device)
    positions = torch.broadcast_to(
        torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
    cache = _cache(cfg, B, max_len, L.init_kv_cache(
        cfg, B, max_len, stack=(_n_global(cfg),), dtype=x.dtype,
        device=x.device), dtype=x.dtype, device=x.device)
    for lp, c, is_global in walk(cfg, params["trunk"], cache):
        x, (k, v) = block_prefill(cfg, lp, x, positions, is_global=is_global,
                                  use_flash=use_flash)
        (_fill_global if is_global else _fill_local)(c, k, v, n)
    x = x[:, -1:] if n is None else gather_last(x, n)
    return _logits(cfg, params, x), cache


def scatter_cache_rows(full, rows, slots, axis: int):
    """Scatter an ``m``-row cache subtree into the batched engine cache
    at ``slots`` IN PLACE (every leaf shares the batch ``axis``);
    returns ``full``."""
    for key, leaf in full.items():
        if isinstance(leaf, dict):
            scatter_cache_rows(leaf, rows[key], slots, axis)
        else:
            L.scatter_rows(leaf, rows[key], slots, axis)
    return full


def prefill_paged(cfg: ModelConfig, params: Params, tokens, max_len,
                  cache, *, slots, write_tables=None, ctx_tables=None,
                  ctx_len=None, true_len=None, prefix_embeds=None,
                  use_flash=False):
    """Admission prefill fused with cache insertion: runs ``m`` prompt
    rows and writes their decode state DIRECTLY into the engine's cache,
    in place: global-layer K/V into the shared page pool through
    ``write_tables`` (m, n_wblk), local-layer rings into their rows at
    ``slots`` (m,).  ``true_len`` (m,) marks the right-padded bucket:
    logits come from each row's true last token.  The prefix-cache hit
    path (``ctx_tables``), VLM prefix embeddings and the dense
    ``write_tables=None`` engine are later slices.  Returns
    (last-true-token logits (m, 1, V), cache)."""
    if ctx_tables is not None:
        raise L._not_ported("prefix-cache hit prefill", "A.5 (prefix cache)")
    if write_tables is None:
        raise L._not_ported("dense-strip admission (paged=False)",
                            "A.4 (dense twin)")
    if prefix_embeds is not None:
        raise L._not_ported("prefix embeddings", "A.9.2 (vlm family)")
    x = L.embed(cfg, params["embed"], tokens)
    B, S, _ = x.shape
    n = broadcast_true_len(true_len, B, x.device)
    positions = torch.broadcast_to(
        torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
    W = min(cfg.local_window, max_len)
    for lp, c, is_global in walk(cfg, params["trunk"], cache):
        if is_global:
            x, _ = block_prefill_paged(cfg, lp, x, positions, c,
                                       write_tables, use_flash=use_flash)
            continue
        x, (k, v) = block_prefill(cfg, lp, x, positions, is_global=False,
                                  use_flash=use_flash)
        rows = L.init_kv_cache(cfg, B, W, dtype=k.dtype, device=x.device)
        _fill_local(rows, k, v, n)
        scatter_cache_rows(c, rows, slots, 0)
    x = x[:, -1:] if n is None else gather_last(x, n)
    return _logits(cfg, params, x), cache
