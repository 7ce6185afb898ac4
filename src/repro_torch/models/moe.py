"""Mixture-of-Experts trunk (PyTorch port of ``repro.models.moe``:
kimi-k2, granite-moe).

GShard/Switch capacity dispatch, as in JAX: each expert takes at most
``capacity(cfg, N)`` (token, choice) pairs of a call's N tokens, granted
in stable-sort order of the expert ids flattened row-major over (token,
choice), so earlier rows win; the excess is dropped (its expert output
is zero).  Dispatch and combine are gathers against an (E, c, d) expert
buffer built from a small integer scatter.  A token's output therefore
depends on every other row of its call: the serving engine feeds the
same rows as the JAX engine (idle slots' stale tokens included), so the
same tokens drop.

``_route`` holds the discrete decisions (top-k experts, position within
the expert, kept or dropped) apart from the expert compute, so tests
and the chip smoke hold them exactly.  Where JAX clamps an out-of-range
index or drops an out-of-range write, this module says so explicitly:
torch indexing raises on the sentinel expert ``E`` that pad tokens go
to.  The router, its softmax and top-k run in float32; the expert
einsums are batched matmuls (``torch.bmm``) in the activation dtype, as
JAX computes them outside any Pallas kernel.

Parameters keep the JAX layout (``moe_layers`` stacked (n_moe,), and
``dense_layers`` (first_dense_layers,) built by ``transformer.init_block``
where the config has them), so JAX weights bridge over by a tree map.
The ``lax.scan`` over each stack becomes a loop over layer views
(``walk``: dense layers first).  Every cache entry point updates the
cache's tensors IN PLACE and returns that same cache; ``prefill`` makes
a new one, as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = dict


# ---------------------------------------------------------------------------
# router + expert FFN
# ---------------------------------------------------------------------------

def init_moe_mlp(cfg: ModelConfig, gen, stack=(), dtype=torch.float32,
                 device=None) -> Params:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": L._dense_init(gen, (d, E), stack, **kw),
        "w_gate": L._dense_init(gen, (E, d, f), stack, in_axis_size=d, **kw),
        "w_up": L._dense_init(gen, (E, d, f), stack, in_axis_size=d, **kw),
        "w_down": L._dense_init(gen, (E, f, d), stack, in_axis_size=f, **kw),
    }
    if cfg.num_shared_experts:
        p["shared"] = L.init_mlp(
            cfg, gen, d_ff=cfg.moe_d_ff * cfg.num_shared_experts,
            stack=stack, **kw)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Expert capacity of a call over ``n_tokens`` static tokens (the JAX
    float expression, in its order)."""
    c = math.ceil(n_tokens * cfg.num_experts_per_tok * cfg.capacity_factor
                  / cfg.num_experts)
    return max(c, 1)


def moe_mlp(cfg: ModelConfig, p: Params, x, token_mask=None):
    """x: (B, S, d) -> (out (B, S, d), aux loss scalar float32).
    ``token_mask``: optional (B, S) bool, False marking padding tokens
    kept out of expert capacity (``_moe_tokens``).

    ``cfg.moe_rowwise``: each row is dispatched on its own, with capacity
    ``capacity(cfg, S)``, and the aux loss is the mean of the rows'
    (the JAX ``vmap`` over the batch, here a loop).  Otherwise all
    ``B * S`` tokens share one capacity, flattened row-major."""
    B, S, d = x.shape
    if token_mask is not None:
        token_mask = token_mask.reshape(B, S)
    if cfg.moe_rowwise:
        outs, auxes = [], []
        for b in range(B):
            o, a = _moe_tokens(cfg, p, x[b],
                               None if token_mask is None else token_mask[b])
            outs.append(o)
            auxes.append(a)
        return torch.stack(outs), torch.mean(torch.stack(auxes))
    flat_mask = None if token_mask is None else token_mask.reshape(B * S)
    if not isinstance(x, DTensor):
        out, aux = _moe_tokens(cfg, p, x.reshape(B * S, d), flat_mask)
        return out.reshape(B, S, d), aux
    # the token flatten merges (B, S): a sequence shard is gathered
    # first (the tokens' gradient comes back in their layout:
    # ``_moe_tokens``)
    xf = L._merge_ready(x, 0, 2).reshape(B * S, d)
    mesh, rows = xf.device_mesh, xf.placements
    out, aux = _moe_tokens(cfg, p, xf, flat_mask)
    # the combine's gather over all tokens leaves partial sums on the row
    # axes, which the next op would reduce-scatter wherever its rule
    # lands; they are reduced onto the tokens' own rows here, and the
    # output's gradient comes back ready for the flatten
    out = out.redistribute(mesh, rows).reshape(B, S, d)
    return L.grad_relaid(out, lambda g: L._merge_ready(g, 0, 2)), aux


def _route(cfg: ModelConfig, router, xf, token_mask=None):
    """The discrete half of ``_moe_tokens`` over a flat token set xf
    (N, d): returns ``(gate, eidx, pos, valid, probs)``.

    ``probs`` (N, E) float32 router softmax; ``gate`` (N, k) float32 top-k
    probabilities renormalised to sum 1 (0 on pad rows); ``eidx`` (N, k)
    int64 expert ids, in descending probability and, among equal ones,
    ascending id (``lax.top_k``'s order), with pad rows sent to the
    sentinel ``E``; ``pos`` (N, k) the pair's place within its expert,
    counted in the stable-sort order of the flat (N*k,) ids (row-major
    over (token, choice)); ``valid = pos < capacity(cfg, N)``.  A
    sentinel pair's ``valid`` means nothing: it is never dispatched."""
    N = xf.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    c = capacity(cfg, N)
    logits = torch.matmul(xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                     # (N, E)
    # a stable descending sort keeps equal probabilities in id order
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = srt.values[:, :k], srt.indices[:, :k]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    if token_mask is not None:
        eidx = torch.where(token_mask[:, None], eidx, E)
        gate = gate * token_mask[:, None].to(gate.dtype)

    pos = _places(eidx.reshape(-1)).reshape(N, k)
    return gate, eidx, pos, pos < c, probs


def _places(ef):
    """(M,) expert ids -> each one's place among the pairs of its expert,
    counted in the stable-sort order of ``ef``.

    On DTensors every rank counts the ids whole (an explicit local map):
    the sort runs over all tokens in any layout, and DTensor has no rule
    for the segment scan's ``ne`` and ``cummax`` in every torch version."""
    if isinstance(ef, DTensor):
        mesh, whole = ef.device_mesh, [Replicate()] * ef.device_mesh.ndim
        pos = _places(ef.redistribute(mesh, whole).to_local())
        return DTensor.from_local(pos, mesh, whole, run_check=False
                                  ).redistribute(mesh, ef.placements)
    order = torch.argsort(ef, stable=True)
    es = ef[order]
    idx = torch.arange(ef.shape[0], device=ef.device)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=ef.device), es[1:] != es[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return torch.empty_like(idx).scatter(0, order, idx - seg_start)


def _aux_loss(cfg: ModelConfig, probs, eidx):
    """Switch load balancing, ``E * <f_e> . <p_e>`` over all N rows, pads
    included: ``me`` the mean router probability, ``ce`` the mean count
    of each expert among a row's k choices (the sentinel counts for no
    expert: the JAX ``one_hot`` of ``E`` is a zero row)."""
    E = cfg.num_experts
    me = torch.mean(probs, dim=0)
    one_hot = F.one_hot(eidx, E + 1)[..., :E].float()          # (N, k, E)
    ce = torch.mean(torch.sum(one_hot, dim=1), dim=0)
    return E * torch.sum(me * ce)


def _inverse(eidx, pos, valid, E: int, c: int, N: int):
    """(E, c) map expert slot -> token row, ``N`` where empty: pair
    (t, j) is written at ``[eidx, pos]`` only where ``eidx < E`` and
    ``pos < c`` (the JAX scatter's ``mode="drop"``).  Dropped pairs go
    to a spare cell past the map, which is cut off."""
    k = eidx.shape[1]
    tok = torch.arange(N, device=eidx.device)[:, None].expand(N, k)
    keep = (eidx < E) & valid
    cell = torch.where(keep, eidx * c + pos, E * c)
    inv = torch.full((E * c + 1,), N, dtype=torch.int64, device=eidx.device)
    inv = inv.scatter(0, cell.reshape(-1), tok.reshape(-1))
    return inv[:E * c].reshape(E, c)


def _expert_weight(leaf, dtype):
    """An (E, in, out) expert weight in ``dtype``; an int8 dict
    ({"q", "scale"}, ``layers.quantize_matmul_params``: scale (E, out))
    is dequantized densely, as in JAX: the E-stacked product has no 2D
    matmul form for ``quant_matmul``."""
    if isinstance(leaf, dict):
        return (leaf["q"].float()
                * leaf["scale"][..., None, :].float()).to(dtype)
    return leaf.to(dtype)


def _moe_tokens(cfg: ModelConfig, p: Params, xf, token_mask=None):
    """Capacity-based top-k dispatch over a flat token set xf (N, d);
    returns (out (N, d), aux).  ``token_mask``: optional (N,) bool, False
    rows (padding) routed to the sentinel expert ``E`` so that they never
    take real capacity; their output is the shared expert's alone."""
    N, d = xf.shape
    E = cfg.num_experts
    c = capacity(cfg, N)
    # autograd sums the gradients of xf's three uses (the router, the
    # dispatch, the shared expert); on DTensors they come back in
    # different layouts, whose sum DTensor has no rule for in every
    # torch version, so each is laid out as xf first
    x_route, x_dispatch, x_shared = (_grad_laid_as(xf) for _ in range(3))
    gate, eidx, pos, valid, probs = _route(cfg, p["router"], x_route,
                                          token_mask)
    aux = _aux_loss(cfg, probs, eidx)

    inv = _inverse(eidx, pos, valid, E, c, N)
    x_pad = torch.cat([x_dispatch, torch.zeros((1, d), dtype=xf.dtype,
                                       device=xf.device)])
    xs = L.take_rows(x_pad, inv)                               # (E, c, d)
    wg = _expert_weight(p["w_gate"], xf.dtype)
    wu = _expert_weight(p["w_up"], xf.dtype)
    wd = _expert_weight(p["w_down"], xf.dtype)
    h = F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu)          # (E, c, f)
    ys = torch.bmm(h, wd)                                      # (E, c, d)

    # combine: each token's k expert outputs, a dropped pair reading the
    # zero row at c; the sentinel id is clamped to E - 1 as JAX's gather
    # clamps it, and its gate of 0 zeroes that finite row.  Both lookups
    # are ``take_rows`` of a 2-D table (a local map on DTensors)
    ys_pad = torch.cat([ys, torch.zeros((E, 1, d), dtype=ys.dtype,
                                        device=ys.device)], dim=1)
    slot = torch.where(valid, pos, c)
    y_tok = L.take_rows(ys_pad.reshape(E * (c + 1), d),
                        torch.clamp(eidx, max=E - 1) * (c + 1) + slot)
    out = torch.sum(y_tok * gate.to(y_tok.dtype)[..., None], dim=1)

    if cfg.num_shared_experts:
        # the tokens stay rows: on DTensors (1, N, d) would put their
        # shard on a dim the projections' flatten gathers
        out = out + L.mlp(p["shared"], x_shared[:, None]).reshape(N, d)
    return out, aux


def _grad_laid_as(t):
    """``t``, whose gradient comes back laid out as ``t`` is (partial
    sums reduced); a plain ``t`` as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in t.placements]
    return L.grad_relaid(t, lambda g: g.redistribute(mesh, pl))


# ---------------------------------------------------------------------------
# blocks & trunk
# ---------------------------------------------------------------------------

def init_moe_block(cfg: ModelConfig, gen, stack=(), dtype=torch.float32,
                   device=None) -> Params:
    norm_init, _ = L.make_norm(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "attn": L.init_attention(cfg, gen, stack, **kw),
        "moe": init_moe_mlp(cfg, gen, stack, **kw),
        "ln1": norm_init(cfg.d_model, stack, device),
        "ln2": norm_init(cfg.d_model, stack, device),
    }


def _n_moe(cfg: ModelConfig) -> int:
    return cfg.num_layers - cfg.first_dense_layers


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference layout, stored in
    ``cfg.weight_dtype`` on ``device`` (default ``cuda``), drawn from
    ``generator`` (default: seed 0 on ``device``); not the JAX package's
    numbers — bridge JAX weights for parity."""
    dev = resolve_device(device)
    if generator is None:
        generator = L.default_generator(dev)
    if generator is not None and generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    norm_init, _ = L.make_norm(cfg)
    kw = dict(dtype=cfg.weight_dtype, device=dev)
    p = {
        "embed": L.init_embedding(cfg, generator, **kw),
        "unembed": L.init_unembed(cfg, generator, **kw),
        "moe_layers": init_moe_block(cfg, generator, stack=(_n_moe(cfg),),
                                     **kw),
        "final_norm": norm_init(cfg.d_model, device=dev),
    }
    if cfg.first_dense_layers:
        p["dense_layers"] = T.init_block(
            cfg, generator, stack=(cfg.first_dense_layers,), **kw)
    return p


def walk(cfg: ModelConfig, params: Params, cache: Optional[Params] = None):
    """(layer params, layer cache, is_moe) views of every layer in the JAX
    order: the ``dense_layers`` stack first, then ``moe_layers``.  The
    layer cache is that layer's strip (batch axis first) or page pool;
    None without a cache."""
    for key, n, is_moe in (("dense_layers", cfg.first_dense_layers, False),
                           ("moe_layers", _n_moe(cfg), True)):
        for i in range(n):
            yield (T._layer(params[key], i),
                   None if cache is None else T._layer(cache[key], i),
                   is_moe)


def paged_layers(cfg: ModelConfig, params: Params, cache: Params):
    """(layer params, layer pool) view pairs of every layer of a paged
    cache, dense layers first: one block call per pair (every MoE
    attention layer is global, so every layer is paged).  A pair's
    params hold ``"moe"`` on an MoE layer and ``"mlp"`` on a dense one."""
    return [(lp, c) for lp, c, _ in walk(cfg, params, cache)]


def moe_block_fwd(cfg: ModelConfig, p: Params, x, positions, *,
                  use_flash=False, token_mask=None):
    """Returns (x, aux, (k, v))."""
    _, norm = L.make_norm(cfg)
    h = norm(p["ln1"], x)
    a, k, v = L.attention_fwd(cfg, p["attn"], h, positions, is_global=True,
                              use_flash=use_flash)
    x = x + a
    h = norm(p["ln2"], x)
    m, aux = moe_mlp(cfg, p["moe"], h, token_mask=token_mask)
    return x + m, aux, (k, v)


def _moe_residual(cfg: ModelConfig, p: Params, x, a, token_mask=None):
    """The block's second half after attention output ``a``."""
    _, norm = L.make_norm(cfg)
    x = x + a
    m, _ = moe_mlp(cfg, p["moe"], norm(p["ln2"], x), token_mask=token_mask)
    return x + m


def moe_block_decode(cfg: ModelConfig, p: Params, x, cache, pos):
    """One token per row against the layer's dense strip (in place)."""
    _, norm = L.make_norm(cfg)
    a, cache = L.attention_decode(cfg, p["attn"], norm(p["ln1"], x), cache,
                                  pos, is_global=True)
    return _moe_residual(cfg, p, x, a), cache


def moe_block_decode_paged(cfg: ModelConfig, p: Params, x, cache, pos,
                           block_tables, use_pallas: bool = False):
    """One token per row against the layer's page pool (in place); every
    row of x competes for expert capacity, as in JAX (no token mask)."""
    _, norm = L.make_norm(cfg)
    a, cache = L.attention_decode_paged(cfg, p["attn"], norm(p["ln1"], x),
                                        cache, pos, block_tables,
                                        use_pallas=use_pallas)
    return _moe_residual(cfg, p, x, a), cache


def _extend_token_mask(x, valid_len):
    """(B, S) mask of the real extend rows: host-side padding must not
    take expert capacity from real tokens.  The capacity bound still
    comes from the static B * S (as in JAX)."""
    if valid_len is None:
        return None
    S = x.shape[1]
    return (torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
            < valid_len[:, None])


def moe_block_extend_paged(cfg: ModelConfig, p: Params, x, pos, cache,
                           block_tables, valid_len=None, *,
                           use_pallas: bool = False):
    """``moe_block_decode_paged`` for S tokens at once (speculative
    verify / chunked catch-up)."""
    _, norm = L.make_norm(cfg)
    a, cache = L.attention_extend_paged(cfg, p["attn"], norm(p["ln1"], x),
                                        pos, cache, block_tables, valid_len,
                                        use_pallas=use_pallas)
    return _moe_residual(cfg, p, x, a,
                         _extend_token_mask(x, valid_len)), cache


def moe_block_prefill_paged(cfg: ModelConfig, p: Params, x, positions,
                            pages, write_tables, ctx_tables=None,
                            ctx_len=None, *, use_flash=False,
                            token_mask=None):
    """``moe_block_fwd`` writing attention K/V straight into its page
    pool (in place), and reading a shared-prefix chain on a radix-cache
    hit."""
    _, norm = L.make_norm(cfg)
    a, pages = L.attention_prefill_paged(
        cfg, p["attn"], norm(p["ln1"], x), positions, pages, write_tables,
        ctx_tables, ctx_len, use_flash=use_flash)
    return _moe_residual(cfg, p, x, a, token_mask), pages


def _positions(x):
    B, S, _ = x.shape
    return torch.broadcast_to(
        torch.arange(S, dtype=torch.int32, device=x.device), (B, S))


def forward(cfg: ModelConfig, params: Params, tokens, *, use_flash=False,
            remat: Optional[str] = None):
    """Returns (logits (B, S, V), aux loss: the mean over MoE layers).
    ``remat``: the JAX checkpoint policy name of each layer
    (``transformer._maybe_remat``)."""
    x = L.embed(cfg, params["embed"], tokens)
    positions = _positions(x)
    dense = T._maybe_remat(lambda h, lp: T.block_fwd(
        cfg, lp, h, positions, is_global=True, use_flash=use_flash), remat)
    moe = T._maybe_remat(lambda h, lp: moe_block_fwd(
        cfg, lp, h, positions, use_flash=use_flash)[:2], remat)
    auxes = []
    for lp, _, is_moe in walk(cfg, params):
        if is_moe:
            x, aux = moe(x, lp)
            auxes.append(aux)
        else:
            x = dense(x, lp)
    return T._logits(cfg, params, x), torch.mean(torch.stack(auxes))


def _stacked(cfg: ModelConfig, make) -> Params:
    """``{"moe_layers": make(n_moe)}`` plus ``dense_layers`` where the
    config has them."""
    c = {"moe_layers": make(_n_moe(cfg))}
    if cfg.first_dense_layers:
        c["dense_layers"] = make(cfg.first_dense_layers)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """Dense decode cache on ``device`` (default ``cuda``; ``"meta"``
    gives shapes only): one ``max_len`` strip per row and layer."""
    dev = resolve_device(device)
    return _stacked(cfg, lambda n: L.init_kv_cache(
        cfg, batch, max_len, stack=(n,), device=dev))


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens,
                pos):
    """One decode token per row against the dense cache (in place).
    Returns (logits (B, 1, V), cache)."""
    x = L.embed(cfg, params["embed"], tokens)
    for lp, c, is_moe in walk(cfg, params, cache):
        if is_moe:
            x, _ = moe_block_decode(cfg, lp, x, c, pos)
        else:
            x, _ = T.block_decode(cfg, lp, x, c, pos, is_global=True)
    return T._logits(cfg, params, x), cache


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_blocks: int, block_size: int, kv_dtype=None,
                     device: DeviceLike = None) -> Params:
    """All MoE attention layers are global: every layer's K/V lives in
    the shared page pool (n, num_blocks, block_size, K, hd) on ``device``
    (default ``cuda``); ``kv_dtype="int8"`` makes it int8 with float32
    scale leaves."""
    del batch, max_len
    dev = resolve_device(device)
    return _stacked(cfg, lambda n: L.init_kv_pages(
        cfg, num_blocks, block_size, stack=(n,), quant=kv_dtype == "int8",
        device=dev))


def decode_step_paged(cfg: ModelConfig, params: Params, cache: Params,
                      tokens, pos, block_tables, use_pallas: bool = False):
    """One decode token per row through ``block_tables`` (in place);
    ``use_pallas`` reads the pages through the hand-written
    ``paged_attention`` kernel.  Returns (logits (B, 1, V), cache)."""
    x = L.embed(cfg, params["embed"], tokens)
    for lp, c, is_moe in walk(cfg, params, cache):
        if is_moe:
            x, _ = moe_block_decode_paged(cfg, lp, x, c, pos, block_tables,
                                          use_pallas)
        else:
            x, _ = T.block_decode_paged(cfg, lp, x, c, pos, block_tables,
                                        use_pallas)
    return T._logits(cfg, params, x), cache


def _broadcast_pos(pos, x):
    return torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                              device=x.device),
                              (x.shape[0],))


def extend_paged(cfg: ModelConfig, params: Params, cache: Params, tokens,
                 pos, block_tables, valid_len=None,
                 use_pallas: bool = False):
    """Score S tokens against the paged cache in one call (in place); see
    ``transformer.extend_paged`` for the row semantics and the
    ``valid_len`` write-drop contract.  Rows ``i >= valid_len`` take no
    expert capacity."""
    x = L.embed(cfg, params["embed"], tokens)
    pos = _broadcast_pos(pos, x)
    for lp, c, is_moe in walk(cfg, params, cache):
        if is_moe:
            x, _ = moe_block_extend_paged(cfg, lp, x, pos, c, block_tables,
                                          valid_len, use_pallas=use_pallas)
        else:
            x, _ = T.block_extend_paged(cfg, lp, x, pos, c, block_tables,
                                        valid_len, use_pallas=use_pallas)
    return T._logits(cfg, params, x), cache


def extend(cfg: ModelConfig, params: Params, cache: Params, tokens, pos,
           valid_len=None):
    """Dense twin of ``extend_paged`` (strip caches, same row and write
    semantics, in place)."""
    x = L.embed(cfg, params["embed"], tokens)
    pos = _broadcast_pos(pos, x)
    _, norm = L.make_norm(cfg)
    for lp, c, is_moe in walk(cfg, params, cache):
        if not is_moe:
            x, _ = T.block_extend(cfg, lp, x, c, pos, is_global=True,
                                  valid_len=valid_len)
            continue
        a, _ = L.attention_extend(cfg, lp["attn"], norm(lp["ln1"], x), c,
                                  pos, is_global=True, valid_len=valid_len)
        x = _moe_residual(cfg, lp, x, a, _extend_token_mask(x, valid_len))
    return T._logits(cfg, params, x), cache


def _token_mask(n, x):
    """(B, S) True below each row's true length ``n`` (None without)."""
    if n is None:
        return None
    S = x.shape[1]
    return torch.arange(S, dtype=torch.int32, device=x.device)[None, :] \
        < n[:, None]


def prefill(cfg: ModelConfig, params: Params, tokens, max_len, *,
            use_flash=False, true_len=None):
    """Run the prompt; returns (last-true-token logits (B, 1, V), a new
    dense cache of B rows sized ``max_len``).  ``true_len`` marks
    right-padded rows: pad tokens stay out of the cache and out of
    expert capacity."""
    x = L.embed(cfg, params["embed"], tokens)
    B = x.shape[0]
    n = T.broadcast_true_len(true_len, B, x.device)
    mask = _token_mask(n, x)
    positions = _positions(x)
    cache = L.on_mesh_of(_stacked(cfg, lambda m: L.init_kv_cache(
        cfg, B, max_len, stack=(m,), dtype=x.dtype, device=x.device)), x)
    for lp, c, is_moe in walk(cfg, params, cache):
        if is_moe:
            x, _, (k, v) = moe_block_fwd(cfg, lp, x, positions,
                                         use_flash=use_flash,
                                         token_mask=mask)
        else:
            x, (k, v) = T.block_prefill(cfg, lp, x, positions,
                                        is_global=True, use_flash=use_flash)
        T._fill_global(c, k, v, n)
    x = x[:, -1:] if n is None else T.gather_last(x, n)
    return T._logits(cfg, params, x), cache


def prefill_paged(cfg: ModelConfig, params: Params, tokens, max_len,
                  cache, *, slots, write_tables=None, ctx_tables=None,
                  ctx_len=None, true_len=None, use_flash=False):
    """Admission prefill writing K/V straight into the engine cache, in
    place: every layer's into the page pool through ``write_tables``
    (all MoE attention is global, so radix prefix-cache context is
    supported), or with ``write_tables=None`` into ``max_len`` strips
    scattered at ``slots`` (the dense engine).  See
    ``transformer.prefill_paged``.

    MoE caveat: expert capacity comes from the static suffix token count
    (rows x bucket), so under capacity pressure a hit-admitted suffix can
    drop other tokens than the same tokens inside a cold full-prompt
    prefill, as in JAX; with capacity ample enough that nothing drops,
    hits equal cold runs as in every other family."""
    x = L.embed(cfg, params["embed"], tokens)
    B, S, _ = x.shape
    n = T.broadcast_true_len(true_len, B, x.device)
    mask = _token_mask(n, x)
    off = (torch.zeros((B,), dtype=torch.int32, device=x.device)
           if ctx_len is None
           else torch.as_tensor(ctx_len, dtype=torch.int32, device=x.device))
    positions = off[:, None] + torch.arange(S, dtype=torch.int32,
                                            device=x.device)[None, :]
    paged = write_tables is not None
    for lp, c, is_moe in walk(cfg, params, cache):
        if paged and is_moe:
            x, _ = moe_block_prefill_paged(
                cfg, lp, x, positions, c, write_tables, ctx_tables, ctx_len,
                use_flash=use_flash, token_mask=mask)
            continue
        if paged:
            x, _ = T.block_prefill_paged(cfg, lp, x, positions, c,
                                         write_tables, ctx_tables, ctx_len,
                                         use_flash=use_flash)
            continue
        if is_moe:
            x, _, (k, v) = moe_block_fwd(cfg, lp, x, positions,
                                         use_flash=use_flash,
                                         token_mask=mask)
        else:
            x, (k, v) = T.block_prefill(cfg, lp, x, positions,
                                        is_global=True, use_flash=use_flash)
        rows = L.init_kv_cache(cfg, B, max_len, dtype=k.dtype,
                               device=x.device)
        T._fill_global(rows, k, v, n)
        T.scatter_cache_rows(c, rows, slots, 0)
    x = x[:, -1:] if n is None else T.gather_last(x, n)
    return T._logits(cfg, params, x), cache
