"""Mamba2 (SSD, state-space duality) trunk (PyTorch port of
``repro.models.ssm``). [arXiv:2405.21060]

Prefill uses the chunked SSD algorithm: a quadratic attention-like
intra-chunk term plus an inter-chunk state recurrence, O(L * Q) in all;
with ``use_kernel=True`` the scan runs through ``kernels.ops.ssd_scan``
(the hand-written Hopper kernel on CUDA tensors, its plain version on
CPU tensors).  Decode carries (conv_state, ssm_state): O(1) per token
and no KV cache, so the engine serves this family without a page pool.

Parameters keep the JAX layout (``in_proj`` (d, 2di+2n+h), ``conv_w``
(w, ch), ..., stacked layer axis first), and the ``lax.scan`` over
layers becomes a loop over layer slices (views).  ``decode_step`` and
``prefill_paged`` update the cache's tensors IN PLACE and return that
same cache; ``prefill`` makes a new one, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_layer, _maybe_remat,
                                            broadcast_true_len, gather_last,
                                            scatter_cache_rows)

Params = dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_mamba_block(cfg: ModelConfig, gen, stack=(), dtype=torch.float32,
                     device=None) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, w = cfg.ssm_heads, cfg.ssm_conv_width
    conv_ch = di + 2 * n
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": L._dense_init(gen, (d, 2 * di + 2 * n + h), stack, **kw),
        "conv_w": L._dense_init(gen, (w, conv_ch), stack, in_axis_size=w,
                                **kw),
        "conv_b": L._zeros((conv_ch,), stack, **kw),
        # float32 whatever ``dtype`` says (L.FLOAT32_LEAVES)
        "A_log": L._zeros((h,), stack, device=device),  # A = -exp(0) = -1
        "D": L._ones((h,), stack, device=device),
        "dt_bias": L._zeros((h,), stack, device=device),
        "gate_norm": L.init_rmsnorm(di, stack, device),
        "out_proj": L._dense_init(gen, (di, d), stack, in_axis_size=di, **kw),
        "ln": L.init_rmsnorm(d, stack, device),
    }


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
    kw = dict(dtype=cfg.weight_dtype, device=dev)
    return {
        "embed": L.init_embedding(cfg, generator, **kw),
        "unembed": L.init_unembed(cfg, generator, **kw),
        "layers": init_mamba_block(cfg, generator, stack=(cfg.num_layers,),
                                   **kw),
        "final_norm": L.init_rmsnorm(cfg.d_model, device=dev),
    }


def _layers(cfg: ModelConfig, tree: Params):
    """Per-layer views of a stacked tree, the first ``cfg.num_layers``."""
    return [_layer(tree, i) for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None, use_kernel: bool = False):
    """Chunked SSD scan.

    x: (b, l, h, p); dt: (b, l, h) (post-softplus); A: (h,) negative;
    B, C: (b, l, n) (single group).  h0: optional initial state (b,h,p,n).
    Returns (y (b, l, h, p) in x's dtype, h_final (b, h, p, n) float32).
    ``use_kernel`` sends the scan through ``kernels.ops.ssd_scan`` with
    this ``chunk``.
    """
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0)
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l)
    orig_l = l
    if l % Q:
        # pad the tail: dt=0 => decay exp(0)=1 and zero state contribution
        pad = Q - l % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        l = l + pad
    nc = l // Q

    xc = x.reshape(b, nc, Q, h, p)
    dtc = dt.reshape(b, nc, Q, h).float()
    Bc = B.reshape(b, nc, Q, n).float()
    Cc = C.reshape(b, nc, Q, n).float()

    dA = dtc * A.float()                               # (b, nc, Q, h)
    cums = torch.cumsum(dA, dim=2)                     # inclusive

    # ---- intra-chunk (attention-like) term
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]   # (b,nc,Q,Q,h) i,j
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lmat = torch.where(mask[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    xdt = xc.float() * dtc[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * Lmat,
                           xdt)

    # ---- chunk-final states
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)      # (b,nc,Q,h)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc,
                          xdt * decay_to_end[..., None])

    # ---- inter-chunk recurrence (the lax.scan over chunks)
    chunk_decay = torch.exp(cums[:, :, -1, :])               # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    prev = []
    for c in range(nc):
        prev.append(carry)                                  # pre-chunk state
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                         # (b,nc,h,p,n)

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, prev) \
        * torch.exp(cums)[..., None]
    y = (y_intra + y_inter).reshape(b, l, h, p)[:, :orig_l]
    return y.to(x.dtype), carry


def _causal_conv(xBC, conv_w, conv_b, conv_state=None, true_len=None):
    """Depthwise causal conv via shifted adds.

    xBC: (b, l, ch); conv_w: (w, ch).  conv_state: (b, w-1, ch) history
    prepended (decode/chunked-prefill continuity) or zeros.
    ``true_len``: optional (b,) — with right-padded input the returned
    state window ends at each row's true boundary (positions
    [n-w+1, n)), not at the pad tail.
    Returns (out (b, l, ch), new_state (b, w-1, ch)).
    """
    b, l, ch = xBC.shape
    w = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((b, w - 1, ch), dtype=xBC.dtype,
                                 device=xBC.device)
    full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    out = torch.zeros((b, l, ch), dtype=xBC.dtype, device=xBC.device)
    for i in range(w):
        out = out + full[:, i:i + l] * conv_w[i].to(xBC.dtype)
    out = out + conv_b.to(xBC.dtype)
    if w <= 1:
        return out, conv_state
    if true_len is None:
        return out, full[:, -(w - 1):]
    # position p lives at full[:, p + w - 1]; window [n-w+1, n) starts
    # at full index n, and negative positions land in the zero prefix
    idx = true_len.long()[:, None] + torch.arange(w - 1, device=xBC.device)
    new_state = torch.gather(full, 1, idx[..., None].expand(-1, -1, ch))
    return out, new_state


def _split_in_proj(cfg: ModelConfig, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xBC, dt


def mamba_mix(cfg: ModelConfig, p: Params, x, state=None, *,
              use_kernel: bool = False, true_len=None):
    """Sequence-mode mamba2 mixer. x: (b, l, d).

    state: optional dict(conv=(b,w-1,ch), ssm=(b,h,pd,n)) for continuation.
    ``true_len``: optional (b,) int32 — positions >= true_len are
    right-padding: their dt is forced to 0, which makes them exact
    no-ops on the recurrence (decay exp(0·A)=1, zero state update), and
    the conv state is taken at the true boundary.  x, B and C reach the
    scan as strided views into the conv output (no copy).
    Returns (out (b,l,d), new_state dict).
    """
    b, l, d = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xBC, dt = _split_in_proj(cfg, zxbcdt)

    conv_in = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_in,
                                 true_len=true_len)
    xBC = F.silu(xBC)
    xin = xBC[..., :di].reshape(b, l, h, pd)
    B = xBC[..., di:di + n]
    C = xBC[..., di + n:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    if true_len is not None:
        tmask = torch.arange(l, device=x.device)[None, :] < true_len[:, None]
        dt = torch.where(tmask[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"].float())
    h0 = None if state is None else state["ssm"]
    y, h_final = ssd_chunked(xin, dt, A, B, C, cfg.ssm_chunk, h0=h0,
                             use_kernel=use_kernel)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xin
    y = y.reshape(b, l, di)
    y = L.rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    return out, {"conv": new_conv, "ssm": h_final}


def mamba_mix_decode(cfg: ModelConfig, p: Params, x, state):
    """Single-step mixer. x: (b, 1, d); state dict as above."""
    b, _, d = x.shape
    di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xBC, dt = _split_in_proj(cfg, zxbcdt)
    xBC = xBC[:, 0]                                    # (b, ch)

    conv_state = state["conv"]                         # (b, w-1, ch)
    full = torch.cat([conv_state.to(xBC.dtype), xBC[:, None]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", full, p["conv_w"].to(xBC.dtype)) \
        + p["conv_b"].to(xBC.dtype)
    new_conv = full[:, 1:]
    xBC = F.silu(conv_out)
    xin = xBC[..., :di].reshape(b, h, pd)
    B = xBC[..., di:di + n].float()
    C = xBC[..., di + n:].float()

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())    # (b, h)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)                              # (b, h)
    hs = state["ssm"].float()                          # (b, h, pd, n)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xin.float(), B)
    hs = hs * a[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", hs, C)
    y = y + p["D"].float()[None, :, None] * xin.float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = L.rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    return out, {"conv": new_conv, "ssm": hs}


# ---------------------------------------------------------------------------
# blocks & trunk
# ---------------------------------------------------------------------------

def block_fwd(cfg: ModelConfig, p: Params, x, state=None, *,
              use_kernel=False, true_len=None):
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    o, new_state = mamba_mix(cfg, p, h, state, use_kernel=use_kernel,
                             true_len=true_len)
    return x + o, new_state


def block_decode(cfg: ModelConfig, p: Params, x, state):
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    o, new_state = mamba_mix_decode(cfg, p, h, state)
    return x + o, new_state


def init_state(cfg: ModelConfig, batch: int, stack=(),
               device: DeviceLike = None) -> Params:
    """Zero decode state: conv history (b, w-1, ch) in the activation
    dtype and the SSM state (b, h, pd, n) in float32, after ``stack``."""
    ch = cfg.d_inner + 2 * cfg.ssm_state
    dev = resolve_device(device)
    return {
        "conv": L._zeros((batch, cfg.ssm_conv_width - 1, ch), stack,
                         cfg.activation_dtype, dev),
        "ssm": L._zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), stack, torch.float32, dev),
    }


def _logits(cfg: ModelConfig, params: Params, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(cfg, params["embed"], params["unembed"], x)


def forward(cfg: ModelConfig, params: Params, tokens, *, use_kernel=False,
            remat: Optional[str] = None):
    """Full-sequence logits (B, S, V). tokens: (B, S).  ``remat``: the
    JAX checkpoint policy name of each block
    (``transformer._maybe_remat``)."""
    x = L.embed(cfg, params["embed"], tokens)
    body = _maybe_remat(
        lambda h, lp: block_fwd(cfg, lp, h, use_kernel=use_kernel)[0], remat)
    for lp in _layers(cfg, params["layers"]):
        x = body(x, lp)
    return _logits(cfg, params, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """The decode cache: O(1) state per row and layer, whatever
    ``max_len`` (the SSM's whole point), on ``device`` (default
    ``cuda``; ``"meta"`` gives shapes only)."""
    del max_len
    return {"layers": init_state(cfg, batch, stack=(cfg.num_layers,),
                                 device=device)}


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     num_blocks: int, block_size: int, kv_dtype=None,
                     device: DeviceLike = None) -> Params:
    """SSM state is O(1): there are no KV pages to allocate; the paged
    cache is the dense one and has no pool leaf, so the engine runs
    this family without a pool (``kv_dtype`` is accepted and ignored:
    no pages, nothing to quantize)."""
    del num_blocks, block_size, kv_dtype
    return init_cache(cfg, batch, max_len, device)


def decode_step(cfg: ModelConfig, params: Params, cache: Params, tokens,
                pos):
    """One token per row; the state is positionless (``pos`` unused).
    The cache's tensors are updated in place.  Returns (logits (B, 1,
    V), cache)."""
    del pos
    x = L.embed(cfg, params["embed"], tokens)
    for lp, st in zip(_layers(cfg, params["layers"]),
                      _layers(cfg, cache["layers"])):
        x, new = block_decode(cfg, lp, x, st)
        st["conv"].copy_(new["conv"])
        st["ssm"].copy_(new["ssm"])
    return _logits(cfg, params, x), cache


def decode_step_paged(cfg: ModelConfig, params: Params, cache: Params,
                      tokens, pos, block_tables, use_pallas: bool = False):
    del block_tables, use_pallas  # no attention, nothing paged
    return decode_step(cfg, params, cache, tokens, pos)


def extend_paged(cfg: ModelConfig, params: Params, cache: Params, tokens,
                 pos, block_tables, valid_len=None,
                 use_pallas: bool = False):
    """SSM decode state is an O(1) recurrence: scoring S tokens advances
    it irreversibly, and a rejected speculation could not roll back by
    position masking the way paged KV does.  Gated out of the
    speculative path via ``model.spec_decodable`` / ``model.extendable``
    — catch-up prefill for this family stays one token per step."""
    raise NotImplementedError(
        "ssm has no multi-token extend: recurrent state cannot roll back")


extend = extend_paged  # the dense twin is gated identically


def prefill(cfg: ModelConfig, params: Params, tokens, max_len, *,
            use_kernel=False, true_len=None):
    """Run the prompt; returns (last-true-token logits (B, 1, V), a new
    cache of B rows holding each layer's final state).  ``true_len``
    (int | (B,) int32) marks right-padded rows: pad positions leave the
    state untouched.  ``use_kernel`` sends each layer's scan through
    ``kernels.ops.ssd_scan``."""
    del max_len
    x = L.embed(cfg, params["embed"], tokens)
    n = broadcast_true_len(true_len, x.shape[0], x.device)
    cache = init_cache(cfg, x.shape[0], 0, x.device)
    for lp, st in zip(_layers(cfg, params["layers"]),
                      _layers(cfg, cache["layers"])):
        x, new = block_fwd(cfg, lp, x, use_kernel=use_kernel, true_len=n)
        st["conv"].copy_(new["conv"])
        st["ssm"].copy_(new["ssm"])
    x = x[:, -1:] if n is None else gather_last(x, n)
    return _logits(cfg, params, x), cache


def prefill_paged(cfg: ModelConfig, params: Params, tokens, max_len,
                  cache, *, slots, write_tables=None, ctx_tables=None,
                  ctx_len=None, true_len=None, use_kernel=False):
    """Admission prefill fused with state insertion: the O(1) SSM state
    rows land directly in the engine cache at ``slots`` (in place).
    There are no KV pages and no shareable prefix state (the recurrence
    is not reconstructible from pages), so context is rejected."""
    if write_tables is not None or ctx_tables is not None:
        raise ValueError("ssm has no paged KV and no shareable prefix")
    logits, states = prefill(cfg, params, tokens, max_len,
                             use_kernel=use_kernel, true_len=true_len)
    slots = torch.as_tensor(slots, dtype=torch.int32, device=logits.device)
    scatter_cache_rows(cache["layers"], states["layers"], slots, 1)
    return logits, cache
