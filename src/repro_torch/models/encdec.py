"""Whisper-style encoder-decoder backbone (PyTorch port of
``repro.models.encdec``).

The mel-spectrogram and conv feature extractor are a stub, as in JAX:
requests carry precomputed frame embeddings (B, encoder_seq, d_model).
This module is the transformer that consumes them: a non-causal encoder
(layernorm, sinusoidal positions, GELU MLPs) and a causal decoder with a
learned position table, whose blocks run self attention, cross attention
over the encoder output and a GELU MLP.

Caches: the decoder's self-attention K/V lives in ``max_len`` strips
(``init_cache``) or the shared page pool (``init_paged_cache``); the
cross K/V, encoder-length and written once at prefill, stays dense per
slot in both (``cross_k`` / ``cross_v`` (L, B, encoder_seq, K, hd)).  The
``lax.scan`` over the stacked layers becomes a loop over layer views,
and every cache entry point updates the cache's tensors in place
(``prefill`` makes a new cache, as in JAX).  A decoder position past the
table's end reads its last row, as a JAX gather clamps.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_enc_block(cfg: ModelConfig, gen, stack=(), **kw):
    dev = kw.get("device")
    return {
        "attn": L.init_attention(cfg, gen, stack, **kw),
        "mlp": L.init_gelu_mlp(cfg, gen, stack, **kw),
        "ln1": L.init_layernorm(cfg.d_model, stack, dev),
        "ln2": L.init_layernorm(cfg.d_model, stack, dev),
    }


def _init_dec_block(cfg: ModelConfig, gen, stack=(), **kw):
    dev = kw.get("device")
    return {
        "self_attn": L.init_attention(cfg, gen, stack, **kw),
        "cross_attn": L.init_attention(cfg, gen, stack, **kw),
        "mlp": L.init_gelu_mlp(cfg, gen, stack, **kw),
        "ln1": L.init_layernorm(cfg.d_model, stack, dev),
        "ln2": L.init_layernorm(cfg.d_model, stack, dev),
        "ln3": L.init_layernorm(cfg.d_model, stack, dev),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference layout (``embed``,
    ``pos_table``, ``encoder`` (encoder_layers,) and ``decoder``
    (num_layers,) stacks, ``enc_ln``, ``dec_ln``), in
    ``cfg.weight_dtype`` on ``device`` (default ``cuda``), drawn from
    ``generator`` (default: seed 0 on ``device``); not the JAX package's
    numbers — bridge JAX weights for parity."""
    dev = resolve_device(device)
    if generator is None:
        generator = L.default_generator(dev)
    kw = dict(dtype=cfg.weight_dtype, device=dev)
    pos = torch.empty((cfg.max_target_positions, cfg.d_model),
                      dtype=torch.float32, device=dev)
    if not pos.is_meta:
        pos.normal_(generator=generator).mul_(0.02)
    return {
        "embed": L.init_embedding(cfg, generator, **kw),
        "pos_table": pos.to(cfg.weight_dtype),
        "encoder": _init_enc_block(cfg, generator,
                                   stack=(cfg.encoder_layers,), **kw),
        "decoder": _init_dec_block(cfg, generator, stack=(cfg.num_layers,),
                                   **kw),
        "enc_ln": L.init_layernorm(cfg.d_model, device=dev),
        "dec_ln": L.init_layernorm(cfg.d_model, device=dev),
    }


def _decoder_layers(cfg: ModelConfig, params: Params):
    return [T._layer(params["decoder"], i) for i in range(cfg.num_layers)]


def _ln(cfg: ModelConfig, p, x):
    return L.layernorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: Params, audio_embeds):
    """audio_embeds: (B, T_enc, d) stub frontend output."""
    B, Te, d = audio_embeds.shape
    x = audio_embeds.to(cfg.activation_dtype)
    x = x + L.sinusoidal_positions(Te, d, x.device).to(x.dtype)[None]
    positions = torch.broadcast_to(
        torch.arange(Te, dtype=torch.int32, device=x.device), (B, Te))
    for i in range(cfg.encoder_layers):
        lp = T._layer(params["encoder"], i)
        a, _, _ = L.attention_fwd(cfg, lp["attn"], _ln(cfg, lp["ln1"], x),
                                  positions, is_global=True, causal=False)
        x = x + a
        x = x + L.gelu_mlp(lp["mlp"], _ln(cfg, lp["ln2"], x))
    return _ln(cfg, params["enc_ln"], x)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dec_block_fwd(cfg: ModelConfig, lp, h, positions, enc_out,
                   use_flash=False):
    """Returns (h, (k, v, cross k, cross v))."""
    a, k, v = L.attention_fwd(cfg, lp["self_attn"], _ln(cfg, lp["ln1"], h),
                              positions, is_global=True, use_flash=use_flash)
    h = h + a
    c, ck, cv = L.attention_fwd(cfg, lp["cross_attn"],
                                _ln(cfg, lp["ln2"], h), positions,
                                is_global=True, kv_x=enc_out)
    h = h + c
    h = h + L.gelu_mlp(lp["mlp"], _ln(cfg, lp["ln3"], h))
    return h, (k, v, ck, cv)


def _embed(cfg: ModelConfig, params: Params, tokens, positions):
    """Token embeddings plus the learned position rows (B, S, d);
    positions (B, S) are clamped to the table, as a JAX gather clamps."""
    x = L.embed(cfg, params["embed"], tokens)
    table = params["pos_table"]
    idx = torch.clamp(positions.long(), 0, table.shape[0] - 1)
    return x + L.take_rows(table, idx).to(x.dtype)


def _positions(pos, B: int, S: int, device):
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                             device=device), (B,))
    return pos, pos[:, None] + torch.arange(S, dtype=torch.int32,
                                            device=device)[None, :]


def _logits(cfg: ModelConfig, params: Params, x):
    return L.unembed(cfg, params["embed"], {},
                     _ln(cfg, params["dec_ln"], x))


def forward(cfg: ModelConfig, params: Params, tokens, audio_embeds, *,
            use_flash=False, remat: Optional[str] = None):
    """Teacher-forced decoder logits (B, S, V). tokens: (B, S)."""
    enc_out = encode(cfg, params, audio_embeds)
    B, S = tokens.shape
    _, positions = _positions(0, B, S, tokens.device)
    x = _embed(cfg, params, tokens, positions)
    body = T._maybe_remat(lambda h, lp: _dec_block_fwd(
        cfg, lp, h, positions, enc_out, use_flash=use_flash)[0], remat)
    for lp in _decoder_layers(cfg, params):
        x = body(x, lp)
    return _logits(cfg, params, x)


def _cross_kv(cfg: ModelConfig, batch: int, dtype=None, device=None):
    shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim)
    dtype = dtype or cfg.activation_dtype
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """Dense decode cache on ``device`` (default ``cuda``; ``"meta"``
    gives shapes only): self-attention strips of ``max_len`` per row and
    decoder layer, and the dense cross K/V."""
    dev = resolve_device(device)
    return {"self": L.init_kv_cache(cfg, batch, max_len,
                                    stack=(cfg.num_layers,), device=dev),
            **_cross_kv(cfg, batch, device=dev)}


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_blocks: int, block_size: int, kv_dtype=None,
                     device: DeviceLike = None) -> Params:
    """The decoder's self-attention K/V in the shared page pool (int8
    with float32 scales under ``kv_dtype="int8"``); the cross K/V stays
    dense per slot in the activation dtype: it is encoder-length,
    written once at prefill and never grows, so only the self pool
    quantizes."""
    del max_len
    dev = resolve_device(device)
    return {"self": L.init_kv_pages(cfg, num_blocks, block_size,
                                    stack=(cfg.num_layers,),
                                    quant=kv_dtype == "int8", device=dev),
            **_cross_kv(cfg, batch, device=dev)}


def _walk(cfg: ModelConfig, params: Params, cache: Params):
    """(layer params, self cache, cross k, cross v) views per decoder
    layer."""
    for i, lp in enumerate(_decoder_layers(cfg, params)):
        yield (lp, T._layer(cache["self"], i), cache["cross_k"][i],
               cache["cross_v"][i])


def paged_layers(cfg: ModelConfig, params: Params, cache: Params):
    """(decoder layer params, layer pool) view pairs of a paged cache,
    first layer first: the self attention of every decoder layer is
    paged."""
    return [(lp, sc) for lp, sc, _, _ in _walk(cfg, params, cache)]


def _decode(cfg: ModelConfig, params: Params, cache: Params, tokens, pos,
            self_attend):
    """One decode token per row; ``self_attend(lp, h, layer cache)`` is
    the self-attention read (a strip or the pool)."""
    B = tokens.shape[0]
    pos, positions = _positions(pos, B, 1, tokens.device)
    x = _embed(cfg, params, tokens, positions)
    for lp, sc, ck, cv in _walk(cfg, params, cache):
        a, _ = self_attend(lp, _ln(cfg, lp["ln1"], x), sc, pos)
        x = x + a
        c, _ = L.attention_decode(cfg, lp["cross_attn"],
                                  _ln(cfg, lp["ln2"], x), sc, pos,
                                  is_global=True,
                                  cross_kv=(ck.to(x.dtype), cv.to(x.dtype)))
        x = x + c
        x = x + L.gelu_mlp(lp["mlp"], _ln(cfg, lp["ln3"], x))
    return _logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens,
                pos):
    """tokens: (B, 1); pos: (B,) int32 or a scalar.  Cross K/V were
    written at prefill.  Returns (logits (B, 1, V), cache)."""
    return _decode(cfg, params, cache, tokens, pos,
                   lambda lp, h, sc, p: L.attention_decode(
                       cfg, lp["self_attn"], h, sc, p, is_global=True))


def decode_step_paged(cfg: ModelConfig, params: Params, cache: Params,
                      tokens, pos, block_tables, use_pallas: bool = False):
    """Paged twin of ``decode_step``: self-attention K/V through
    ``block_tables``, read by the ``paged_attention`` kernel (its plain
    version on CPU tensors) with ``use_pallas``."""
    return _decode(cfg, params, cache, tokens, pos,
                   lambda lp, h, sc, p: L.attention_decode_paged(
                       cfg, lp["self_attn"], h, sc, p, block_tables,
                       use_pallas=use_pallas))


def _cross_extend(cfg: ModelConfig, lp, h, ck, cv):
    """Cross attention for S decoder queries against the slot's cross
    K/V: the multi-query twin of ``attention_decode``'s ``cross_kv``
    branch (no cache update, every entry attended)."""
    B, S, _ = h.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    q = L.weight_einsum("bsd,dhq->bshq", h, lp["wq"])
    if cfg.use_qk_norm:
        q = L.rmsnorm(lp["q_norm"], q, cfg.norm_eps)
    out = L.attention_weights_and_out(
        q.reshape(B, S, K, H // K, hd), ck.to(h.dtype), cv.to(h.dtype),
        None, scale=scale, softcap=cfg.attn_logit_softcap)
    return L.weight_einsum("bshq,hqd->bsd", out.reshape(B, S, H, hd),
                           lp["wo"])


def _extend(cfg: ModelConfig, params: Params, cache: Params, tokens, pos,
            self_attend):
    B, S = tokens.shape
    pos, positions = _positions(pos, B, S, tokens.device)
    x = _embed(cfg, params, tokens, positions)
    for lp, sc, ck, cv in _walk(cfg, params, cache):
        a, _ = self_attend(lp, _ln(cfg, lp["ln1"], x), sc, pos)
        x = x + a
        x = x + _cross_extend(cfg, lp["cross_attn"], _ln(cfg, lp["ln2"], x),
                              ck, cv)
        x = x + L.gelu_mlp(lp["mlp"], _ln(cfg, lp["ln3"], x))
    return _logits(cfg, params, x), cache


def extend_paged(cfg: ModelConfig, params: Params, cache: Params, tokens,
                 pos, block_tables, valid_len=None,
                 use_pallas: bool = False):
    """Score S decoder tokens against the paged self-attention cache in
    one call (``transformer.extend_paged``'s row semantics); the cross
    K/V is read as written at prefill."""
    return _extend(cfg, params, cache, tokens, pos,
                   lambda lp, h, sc, p: L.attention_extend_paged(
                       cfg, lp["self_attn"], h, p, sc, block_tables,
                       valid_len, use_pallas=use_pallas))


def extend(cfg: ModelConfig, params: Params, cache: Params, tokens, pos,
           valid_len=None):
    """Dense twin of ``extend_paged`` against the self-attention
    strips."""
    return _extend(cfg, params, cache, tokens, pos,
                   lambda lp, h, sc, p: L.attention_extend(
                       cfg, lp["self_attn"], h, sc, p, is_global=True,
                       valid_len=valid_len))


def prefill(cfg: ModelConfig, params: Params, tokens, max_len, *,
            audio_embeds=None, use_flash=False, true_len=None):
    """Encode the audio, run the prompt tokens and build a dense decode
    cache of B rows sized ``max_len``.  Returns (last-true-token logits
    (B, 1, V), cache)."""
    enc_out = encode(cfg, params, audio_embeds)
    B, S = tokens.shape
    n = T.broadcast_true_len(true_len, B, tokens.device)
    _, positions = _positions(0, B, S, tokens.device)
    x = _embed(cfg, params, tokens, positions)
    self_cache = L.on_mesh_of(L.init_kv_cache(
        cfg, B, max_len, stack=(cfg.num_layers,), dtype=x.dtype,
        device=x.device), x)
    cks, cvs = [], []
    for i, lp in enumerate(_decoder_layers(cfg, params)):
        x, (k, v, ck, cv) = _dec_block_fwd(cfg, lp, x, positions, enc_out,
                                           use_flash=use_flash)
        T._fill_global(T._layer(self_cache, i), k, v, n)
        cks.append(ck)
        cvs.append(cv)
    cache = {"self": self_cache, "cross_k": torch.stack(cks),
             "cross_v": torch.stack(cvs)}
    x = x[:, -1:] if n is None else T.gather_last(x, n)
    return _logits(cfg, params, x), cache


def prefill_paged(cfg: ModelConfig, params: Params, tokens, max_len,
                  cache, *, slots, write_tables=None, ctx_tables=None,
                  ctx_len=None, true_len=None, audio_embeds=None,
                  use_flash=False):
    """Admission prefill writing straight into the engine cache, in
    place: decoder self-attention K/V into pages through
    ``write_tables`` (or, with ``write_tables=None``, dense strips at
    ``slots``) and the cross K/V into its dense rows at ``slots``.

    A prefix-cache hit (``ctx_tables`` / ``ctx_len``) is sound because a
    suffix prefill rebuilds the FULL cross K/V from ``audio_embeds``
    whichever decoder tokens it runs, and the self-attention prefix K/V
    comes from the pages; the engine keys chains under the audio digest,
    so only requests with identical audio share.  Returns
    (last-true-token logits (m, 1, V), cache)."""
    enc_out = encode(cfg, params, audio_embeds)
    B, S = tokens.shape
    n = T.broadcast_true_len(true_len, B, tokens.device)
    off = (0 if ctx_len is None
           else torch.as_tensor(ctx_len, dtype=torch.int32,
                                device=tokens.device))
    _, positions = _positions(off, B, S, tokens.device)
    x = _embed(cfg, params, tokens, positions)
    paged = write_tables is not None
    for lp, sc, ck_all, cv_all in _walk(cfg, params, cache):
        if paged:
            a, _ = L.attention_prefill_paged(
                cfg, lp["self_attn"], _ln(cfg, lp["ln1"], x), positions, sc,
                write_tables, ctx_tables, ctx_len, use_flash=use_flash)
            x = x + a
            c, ck, cv = L.attention_fwd(
                cfg, lp["cross_attn"], _ln(cfg, lp["ln2"], x), positions,
                is_global=True, kv_x=enc_out)
            x = x + c
            x = x + L.gelu_mlp(lp["mlp"], _ln(cfg, lp["ln3"], x))
        else:
            x, (k, v, ck, cv) = _dec_block_fwd(cfg, lp, x, positions,
                                               enc_out, use_flash=use_flash)
            rows = L.init_kv_cache(cfg, B, max_len, dtype=k.dtype,
                                   device=x.device)
            T._fill_global(rows, k, v, n)
            T.scatter_cache_rows(sc, rows, slots, 0)
        L.scatter_rows(ck_all, ck, slots, 0)
        L.scatter_rows(cv_all, cv, slots, 0)
    x = x[:, -1:] if n is None else T.gather_last(x, n)
    return _logits(cfg, params, x), cache
