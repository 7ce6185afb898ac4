"""Shared neural-net building blocks (PyTorch port of
``repro.models.layers``, the dense-path subset).

Conventions
-----------
* Parameters are nested dicts of tensors in the reference layout:
  einsum-shaped weights (``wq`` (d, H, hd), ``wo`` (H, hd, d)) with any
  stacked layer axis first, so JAX parameters bridge over by a plain
  tree map (``repro_torch.bridge``).
* Activations run in ``cfg.activation_dtype``; attention scores,
  softmax and norms accumulate in float32.
* Attention is GQA throughout: H query heads grouped over K kv heads.
* The JAX functions are pure and return new pools.  Here the paged KV
  pool is updated IN PLACE: every ``scatter_*`` and paged attention
  function writes into the pool tensors it was given (masked
  ``index_put_``; dropped writes touch nothing) and returns that same
  dict.
* Paged pools come in the activation dtype or as int8 with one float32
  scale per (page, offset, kv head) head_dim vector (``quantize_kv``).
* Projection weights may be int8 with one float32 scale per output
  channel (``quantize_matmul_params``): ``weight_einsum`` sends them to
  the hand-written ``quant_matmul`` kernel on a CUDA tensor, to its
  plain version on a CPU tensor.
* The dense decode cache (``init_kv_cache`` / ``attention_decode`` /
  ``attention_extend``) covers global strips and local ring windows and
  is updated IN PLACE like the pool.
* Not ported yet, raising ``NotImplementedError``: cross-attention
  decode, the long-sequence (blockwise) prefill branch and the encdec
  family's ``gelu_mlp`` / ``sinusoidal_positions``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.unported import not_ported

NEG_INF = -2.0e38


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# initializers (numbers from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def _dense_init(gen, shape, stack=(), in_axis_size=None, dtype=torch.float32,
                device=None):
    """Truncated-normal fan-in init (cut at +-2 standard deviations), with
    optional stacking prefix.  Drawn in float32 one stacked slice at a
    time, then stored in ``dtype``."""
    full = tuple(stack) + tuple(shape)
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(full, dtype=dtype, device=device)
    for part in (out.view(-1, *shape) if stack else out[None]):
        tmp = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(tmp.mul_(std))
    return out


def _zeros(shape, stack=(), dtype=torch.float32, device=None):
    return torch.zeros(tuple(stack) + tuple(shape), dtype=dtype, device=device)


def _ones(shape, stack=(), dtype=torch.float32, device=None):
    return torch.ones(tuple(stack) + tuple(shape), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# int8 quantization of KV pages
# ---------------------------------------------------------------------------

KV_QMAX = 127.0


def quantize_kv(x, eps: float = 1e-8):
    """Symmetric int8 quantization of a K/V tensor along ``head_dim``.

    x: (..., hd).  Returns (q int8 (..., hd), scale float32 (...)): one
    scale per head_dim vector, ``scale = max|x| / 127 + eps``,
    ``q = clamp(round(x / scale), -127, 127)``.  ``torch.round`` rounds
    half to even like ``jnp.round``, so the same float32 input gives the
    JAX function's bytes and scales exactly.  A row's scale depends on
    that row alone: committed page rows are never re-quantized.
    """
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / KV_QMAX + eps
    q = torch.clamp(torch.round(xf / scale[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of ``quantize_kv``: q (..., hd) int8, scale (...)."""
    return (q.float() * scale[..., None].float()).to(dtype)


# ---------------------------------------------------------------------------
# int8 projection weights
# ---------------------------------------------------------------------------

# weight name -> (contraction dims, output dims), counted from the end
# of the leaf shape (any leading dims are stacked-layer axes)
QUANT_WEIGHT_DIMS = {
    "wq": (1, 2), "wk": (1, 2), "wv": (1, 2), "wo": (2, 1),
    "w_gate": (1, 1), "w_up": (1, 1), "w_down": (1, 1),
    "w_in": (1, 1), "w_out": (1, 1),
}


def quantize_weight(w, n_in: int, n_out: int):
    """Per-output-channel symmetric int8 quantization of one projection
    weight: the trailing ``n_in`` + ``n_out`` dims are the matmul dims,
    anything before is a stack prefix, kept on BOTH leaves so a layer
    slice of the stack is a quantized layer.  ``scale = max|w| / 127 +
    1e-12`` over the contracted dims, ``q = clamp(round(w / scale))``:
    the JAX function's bytes and scales on the same float32 input."""
    in_axes = tuple(range(w.dim() - n_in - n_out, w.dim() - n_out))
    wf = w.float()
    scale = torch.amax(torch.abs(wf), dim=in_axes, keepdim=True) / KV_QMAX \
        + 1e-12
    q = torch.clamp(torch.round(wf / scale), -KV_QMAX, KV_QMAX)
    return {"q": q.to(torch.int8), "scale": scale.squeeze(in_axes)}


def quantize_matmul_params(params):
    """Copy of ``params`` with every attention/MLP projection weight
    replaced by its int8 quantization ({"q", "scale"} dict leaves, which
    ``weight_einsum`` dispatches on).  Norms, embeddings and biases stay
    full precision and are shared with ``params``, not copied.  Used to
    quantize a resident draft model's weights."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for name, sub in node.items():
            dims = QUANT_WEIGHT_DIMS.get(name)
            if (dims is not None and not isinstance(sub, dict)
                    and sub.dim() >= sum(dims)):
                out[name] = quantize_weight(sub, *dims)
            else:
                out[name] = walk(sub)
        return out
    return walk(params)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _n_contracted(eq: str) -> int:
    x_spec, w_spec = eq.split("->")[0].split(",")
    return sum(1 for c in w_spec if c in x_spec)


def weight_einsum(eq, x, w):
    """``einsum(eq, x, w.to(x.dtype))`` for this module's projection
    equations, which contract x's trailing dims against w's leading dims
    in order and append w's remaining dims (as the JAX function
    assumes): one matmul over the flattened dims, without einsum's
    per-call planning on the host.

    ``w`` may be an int8-quantized weight ({"q", "scale"}, see
    ``quantize_weight``): x flattens to (M, kd) and q to (kd, nd), where
    kd is the product of q's first ``n`` dims (those that appear in x's
    spec) and nd of the rest, and the product runs through
    ``kernels.ops.quant_matmul`` with ``out_dtype = x.dtype``: the
    hand-written kernel on a CUDA tensor (x rounded to bfloat16, float32
    accumulation), the plain float32 dequant product on a CPU tensor
    (the JAX function's branch off the TPU)."""
    n = _n_contracted(eq)
    lead = x.shape[:x.dim() - n]
    if isinstance(w, dict):
        from repro_torch.kernels import ops as kernel_ops
        q, scale = w["q"], w["scale"]
        kd = math.prod(q.shape[:n])
        nd = math.prod(q.shape[n:])
        out = kernel_ops.quant_matmul(
            x.reshape(-1, kd).contiguous(), q.reshape(kd, nd),
            scale.reshape(nd).float(), out_dtype=x.dtype)
        return out.reshape(*lead, *q.shape[n:])
    kd = math.prod(w.shape[:n])
    out = torch.matmul(x.reshape(*lead, kd), w.to(x.dtype).reshape(kd, -1))
    return out.reshape(*lead, *w.shape[n:])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

# Leaves the reference keeps and reads in float32 whatever the weights'
# type: norm scales and biases, the ssm's A_log, D and dt_bias, and the
# float32 scale beside int8 values ({"q", "scale"} weights and moments).
# ``init_*`` make them float32 and ``bridge.params_from_numpy`` does not
# recast them.
FLOAT32_LEAVES = frozenset({"scale", "bias", "A_log", "D", "dt_bias"})


def init_rmsnorm(d: int, stack=(), device=None):
    """A zero scale (gemma's ``1 + scale``), float32 whatever the
    weights' type (``FLOAT32_LEAVES``)."""
    return {"scale": _zeros((d,), stack, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dtype)


def init_layernorm(d: int, stack=(), device=None):
    """Unit scale and zero bias, float32 whatever the weights' type."""
    return {"scale": _ones((d,), stack, device=device),
            "bias": _zeros((d,), stack, device=device)}


def layernorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def make_norm(cfg: ModelConfig):
    if cfg.use_layernorm:
        return (lambda d, stack=(), device=None:
                init_layernorm(d, stack, device),
                lambda p, x: layernorm(p, x, cfg.norm_eps))
    return (lambda d, stack=(), device=None: init_rmsnorm(d, stack, device),
            lambda p, x: rmsnorm(p, x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


@functools.lru_cache(maxsize=None)
def _cached_rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return rope_freqs(head_dim, theta, device)


def _rope_angles(positions, head_dim: int, theta: float):
    """(sin, cos), each (..., S, 1, hd//2), broadcasting over heads.  The
    frequencies are computed once per (head_dim, theta, device)."""
    freqs = _cached_rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd//2)
    angles = angles[..., None, :]  # (..., S, 1, hd//2) to broadcast over heads
    return torch.sin(angles), torch.cos(angles)


def _rotate(x, sin, cos):
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    return _rotate(x, *_rope_angles(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen, stack=(), dtype=torch.float32,
                   device=None):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": _dense_init(gen, (d, H, hd), stack, in_axis_size=d, **kw),
        "wk": _dense_init(gen, (d, K, hd), stack, in_axis_size=d, **kw),
        "wv": _dense_init(gen, (d, K, hd), stack, in_axis_size=d, **kw),
        "wo": _dense_init(gen, (H, hd, d), stack, in_axis_size=H * hd, **kw),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = init_rmsnorm(hd, stack, device)
        p["k_norm"] = init_rmsnorm(hd, stack, device)
    return p


def _softcap(x, cap: float):
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


def attention_weights_and_out(q, k, v, mask, *, scale, softcap=0.0):
    """GQA attention core.

    q: (B, S, K, G, hd)   k, v: (B, T, K, hd)   mask: broadcast (B,1,1,S,T)
    returns (B, S, K, G, hd).  Scores are float32 products of the
    activation-dtype inputs (the JAX ``preferred_element_type``); both
    contractions are batched matmuls over (B, K) with the G query heads
    of a group stacked along the rows.
    """
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    qr = q.permute(0, 2, 3, 1, 4).reshape(B, K, G * S, hd).float()
    scores = torch.matmul(qr, k.permute(0, 2, 3, 1).float())
    scores = _softcap(scores.view(B, K, G, S, T) * scale, softcap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.view(B, K, G * S, T), v.permute(0, 2, 1, 3))
    return out.view(B, K, G, S, hd).permute(0, 3, 1, 2, 4)


def causal_mask(s: int, t: int, q_offset=0, device=None) -> torch.Tensor:
    """(S, T) causal mask; q position i attends kv positions <= i+q_offset."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    return kpos <= qpos


def window_mask(s: int, t: int, window: int, q_offset=0,
                device=None) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    return (kpos <= qpos) & (kpos > qpos - window)


def _project_seq(cfg: ModelConfig, params, x, positions, *,
                 is_global: bool):
    """Shared q/k/v projection + qk-norm + RoPE for the full-sequence
    paths (``attention_fwd`` and the paged extend).  The JAX function's
    cross-attention source ``kv_x`` belongs to the enc-dec slice."""
    q = weight_einsum("bsd,dhq->bshq", x, params["wq"])
    k = weight_einsum("btd,dkq->btkq", x, params["wk"])
    v = weight_einsum("btd,dkq->btkq", x, params["wv"])

    if cfg.use_qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)

    if not cfg.use_abs_pos:
        theta = (cfg.rope_theta_global
                 if (is_global and cfg.rope_theta_global) else cfg.rope_theta)
        sin, cos = _rope_angles(positions, q.shape[-1], theta)  # q and k
        q, k = _rotate(q, sin, cos), _rotate(k, sin, cos)
    return q, k, v


BLOCKWISE_THRESHOLD = 8192
BLOCKWISE_CHUNK = 1024


def attention_fwd(cfg: ModelConfig, params, x, positions, *,
                  is_global: bool, use_flash: bool = False):
    """Full-sequence causal self-attention (training / prefill).

    x: (B, S, d).  ``use_flash`` sends the attention through
    ``kernels.ops.flash_attention`` (the hand-written kernel on CUDA
    tensors, its plain version on CPU tensors; neither has a backward).
    Otherwise local (sliding-window) layers take the chunked O(S*W) path
    when S > 2W and S % W == 0, and the rest the plain masked softmax.
    Returns (out (B,S,d), k, v) — k/v returned for cache construction.
    The JAX function's blockwise branch (S >= 8192) raises
    ``NotImplementedError`` here; its cross-attention / non-causal
    arguments belong to the enc-dec slice.
    """
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5

    q, k, v = _project_seq(cfg, params, x, positions, is_global=is_global)

    T = k.shape[1]
    qg = q.reshape(B, S, K, G, hd)

    window = 0 if is_global else cfg.local_window
    if use_flash:
        from repro_torch.kernels import ops as kernel_ops
        out = kernel_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
            window=window, softcap=cfg.attn_logit_softcap,
        ).reshape(B, S, K, G, hd)
    elif window and S > 2 * window and S % window == 0:
        out = _chunked_local_attention(qg, k, v, window, scale,
                                       cfg.attn_logit_softcap)
    elif S >= BLOCKWISE_THRESHOLD and S % BLOCKWISE_CHUNK == 0 \
            and T % BLOCKWISE_CHUNK == 0:
        raise _not_ported("blockwise long-sequence prefill",
                          "A.2 (_blockwise_causal_attention)")
    else:
        m = (window_mask(S, T, window, device=x.device) if window
             else causal_mask(S, T, device=x.device))
        out = attention_weights_and_out(qg, k, v, m[None, None, None],
                                        scale=scale,
                                        softcap=cfg.attn_logit_softcap)

    out = out.reshape(B, S, H, hd)
    o = weight_einsum("bshq,hqd->bsd", out, params["wo"])
    return o, k, v


def _chunked_local_attention(qg, k, v, window, scale, softcap):
    """Sliding-window attention in O(S * 2W): each chunk of W queries
    against its own chunk and the previous one (zeros before chunk 0).

    qg: (B, S, K, G, hd) with S % window == 0; k, v: (B, S, K, hd).
    Scores are float32 products, probabilities are cast to v's dtype
    before the second product, as in ``attention_weights_and_out``.
    """
    B, S, K, G, hd = qg.shape
    W = window
    C = S // W
    kc = k.reshape(B, C, W, K, hd)
    vc = v.reshape(B, C, W, K, hd)
    k2 = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]],
                              dim=1), kc], dim=2)      # (B, C, 2W, K, hd)
    v2 = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]],
                              dim=1), vc], dim=2)

    qpos = torch.arange(W, device=qg.device)[:, None] + W  # in the 2W frame
    kpos = torch.arange(2 * W, device=qg.device)[None, :]
    m = (kpos <= qpos) & (kpos > qpos - W)                 # (W, 2W)
    first = m & (kpos >= W)                 # chunk 0 has no previous chunk
    mask = torch.cat([first[None], m.expand(C - 1, W, 2 * W)], dim=0)

    # (B, C, K, G*W, hd) @ (B, C, K, hd, 2W): the G heads of a group
    # stacked along the rows
    qr = qg.reshape(B, C, W, K, G, hd).permute(0, 1, 3, 4, 2, 5) \
        .reshape(B, C, K, G * W, hd).float()
    scores = torch.matmul(qr, k2.permute(0, 1, 3, 4, 2).float())
    scores = _softcap(scores.view(B, C, K, G, W, 2 * W) * scale, softcap)
    scores = torch.where(mask[None, :, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.view(B, C, K, G * W, 2 * W),
                       v2.permute(0, 1, 3, 2, 4))   # (B, C, K, G*W, hd)
    return out.view(B, C, K, G, W, hd).permute(0, 1, 4, 2, 3, 5) \
        .reshape(B, S, K, G, hd)


def _decode_project(cfg: ModelConfig, params, x, pos, *, is_global: bool):
    """Shared q/k/v projection + RoPE for the single-token decode paths.

    x: (B, 1, d); pos: (B,) int32.  Returns (q (B,1,H,hd),
    knew (B,1,K,hd), vnew (B,1,K,hd)).
    """
    q = weight_einsum("bsd,dhq->bshq", x, params["wq"])
    if cfg.use_qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)

    knew = weight_einsum("bsd,dkq->bskq", x, params["wk"])
    vnew = weight_einsum("bsd,dkq->bskq", x, params["wv"])
    if cfg.use_qk_norm:
        knew = rmsnorm(params["k_norm"], knew, cfg.norm_eps)

    if not cfg.use_abs_pos:
        theta = (cfg.rope_theta_global
                 if (is_global and cfg.rope_theta_global) else cfg.rope_theta)
        posb = pos[:, None]
        sin, cos = _rope_angles(posb, q.shape[-1], theta)       # q and k
        q, knew = _rotate(q, sin, cos), _rotate(knew, sin, cos)
    return q, knew, vnew


# ---------------------------------------------------------------------------
# dense decode caches (global strips and local rings)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, length: int, stack=(),
                  dtype=None, device=None):
    """Empty dense cache with a stacking prefix: ``k``/``v`` (stack...,
    batch, length, K, hd) in ``dtype`` (default the activation dtype)
    and ``slots`` (stack..., batch, length) int32, -1 = empty; ``slots``
    holds the position each strip or ring entry was written for."""
    dtype = dtype or cfg.activation_dtype
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": _zeros((batch, length, K, hd), stack, dtype, device),
        "v": _zeros((batch, length, K, hd), stack, dtype, device),
        "slots": torch.full(tuple(stack) + (batch, length), -1,
                            dtype=torch.int32, device=device),
    }


def attention_decode(cfg: ModelConfig, params, x, cache, pos, *,
                     is_global: bool, cross_kv=None):
    """Single-token decode against a dense cache: a global strip or a
    local ring window.

    x: (B, 1, d); pos: (B,) int32 per-row write positions (a scalar is
    broadcast); cache: this layer's dict(k=(B, T, K, hd), v=..., slots=
    (B, T)), T the strip length (global) or the window W (local ring).
    The new token's K/V and position are written IN PLACE at ``pos % T``
    (== pos on a global strip), then the row attends every entry whose
    slot lies in [0, pos] and, on a local layer, above ``pos -
    local_window``.  A row that writes past its frontier (the draft's
    parked writes) only ever overwrites entries above that frontier on
    a strip.  Enc-dec cross attention is a later slice.  Returns (out
    (B, 1, d), cache).
    """
    if cross_kv is not None:
        raise _not_ported("cross-attention decode", "A.9.3 (encdec family)")
    B, S, d = x.shape
    assert S == 1
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                             device=x.device), (B,))
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5

    q, knew, vnew = _decode_project(cfg, params, x, pos, is_global=is_global)

    kc, vc, slots = cache["k"], cache["v"], cache["slots"]
    T = kc.shape[1]
    rows = torch.arange(B, device=x.device)
    at = (pos % T).long()
    kc[rows, at] = knew[:, 0].to(kc.dtype)
    vc[rows, at] = vnew[:, 0].to(vc.dtype)
    slots[rows, at] = pos

    window = 0 if is_global else cfg.local_window
    valid = (slots >= 0) & (slots <= pos[:, None])
    if window:
        valid &= slots > (pos[:, None] - window)
    mask = valid[:, None, None, None, :]          # (B,1,1,1,T)
    qg = q.reshape(B, 1, K, G, hd)
    out = attention_weights_and_out(qg, kc.to(x.dtype), vc.to(x.dtype),
                                    mask, scale=scale,
                                    softcap=cfg.attn_logit_softcap)
    o = weight_einsum("bshq,hqd->bsd", out.reshape(B, 1, H, hd),
                      params["wo"])
    return o, cache


def attention_extend(cfg: ModelConfig, params, x, cache, pos, *,
                     is_global: bool, valid_len=None):
    """Multi-token decode against a dense cache (global strip or local
    ring): the non-paged leg of ``extend_paged`` for a trunk that mixes
    paged global layers with dense ring layers.

    x: (B, S, d) at absolute positions ``pos + i``.  The old entries are
    read PRE-write, masked strictly below ``pos`` (and, on a local
    layer, above each query's ``position - local_window``), and the S
    new tokens attend each other as a causal, windowed suffix: the
    sequential decode's semantics, since decode would evict ring entry
    ``(pos + j) % W`` only at step ``j``, after steps ``i < j`` read it
    (requires S <= W).  Then K/V and positions of rows ``i < valid_len``
    are written IN PLACE at ``(pos + i) % T``; pad rows write nothing,
    so they never evict live ring context.  Returns (out (B, S, d),
    cache).
    """
    B, S, d = x.shape
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                             device=x.device), (B,))
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    rel = torch.arange(S, dtype=torch.int32, device=x.device)
    positions = pos[:, None] + rel[None, :]

    q, knew, vnew = _project_seq(cfg, params, x, positions,
                                 is_global=is_global)

    kc, vc, slots = cache["k"], cache["v"], cache["slots"]
    T = kc.shape[1]
    window = 0 if is_global else cfg.local_window
    old_ok = (slots[:, None, :] >= 0) & (slots[:, None, :] < pos[:, None, None])
    new_ok = rel[None, :] <= rel[:, None]                          # (S, S)
    if window:
        old_ok = old_ok & (slots[:, None, :]
                           > (positions[:, :, None] - window))
        new_ok &= (rel[:, None] - rel[None, :]) < window
    mask = torch.cat([torch.broadcast_to(old_ok, (B, S, T)),
                      torch.broadcast_to(new_ok, (B, S, S))], dim=-1)
    k_all = torch.cat([kc.to(x.dtype), knew], dim=1)   # cat = a copy
    v_all = torch.cat([vc.to(x.dtype), vnew], dim=1)
    qg = q.reshape(B, S, K, G, hd)
    out = attention_weights_and_out(qg, k_all, v_all, mask[:, None, None],
                                    scale=scale,
                                    softcap=cfg.attn_logit_softcap)
    o = weight_einsum("bshq,hqd->bsd", out.reshape(B, S, H, hd),
                      params["wo"])

    keep = (rel[None, :] < valid_len[:, None] if valid_len is not None
            else torch.ones((B, S), dtype=torch.bool, device=x.device))
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
    _masked_put(((kc, knew.reshape(B * S, K, hd)),
                 (vc, vnew.reshape(B * S, K, hd)),
                 (slots, positions.reshape(-1))),
                (rows.reshape(-1), (positions % T).long().reshape(-1)),
                keep.reshape(-1))
    return o, cache


def scatter_rows(full, rows, slots, axis: int):
    """Write ``m`` single-request rows into a batched cache leaf IN PLACE:
    ``full`` has the slot axis at ``axis``, ``rows`` the same leaf with
    ``m`` entries there; ``slots`` (m,) distinct slot indices.  Returns
    ``full``."""
    idx = (slice(None),) * axis + (slots.long(),)
    full[idx] = rows.to(full.dtype)
    return full


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------

def init_kv_pages(cfg: ModelConfig, num_blocks: int, block_size: int,
                  stack=(), dtype=None, quant: bool = False, device=None):
    """Paged KV pool for GLOBAL attention layers: physical pages of
    ``block_size`` tokens shared by every slot, no batch axis (ownership
    lives in the engine's block tables).  ``quant=True`` stores K/V as
    int8 with one float32 scale per (page, offset, kv head) in
    ``k_scale``/``v_scale`` leaves of shape (nB, bs, K): the pool
    layout, so every page-granular operation covers them unchanged."""
    dtype = dtype or cfg.activation_dtype
    K, hd = cfg.num_kv_heads, cfg.head_dim
    if quant:
        return {
            "k": _zeros((num_blocks, block_size, K, hd), stack, torch.int8,
                        device),
            "v": _zeros((num_blocks, block_size, K, hd), stack, torch.int8,
                        device),
            "k_scale": _zeros((num_blocks, block_size, K), stack,
                              torch.float32, device),
            "v_scale": _zeros((num_blocks, block_size, K), stack,
                              torch.float32, device),
        }
    return {
        "k": _zeros((num_blocks, block_size, K, hd), stack, dtype, device),
        "v": _zeros((num_blocks, block_size, K, hd), stack, dtype, device),
    }


def kv_pages_quantized(pages) -> bool:
    """Is this pool dict the int8 layout (scale leaves present)?"""
    return "k_scale" in pages


def _masked_put(pairs, index, keep) -> None:
    """For each ``(dst, values)`` of ``pairs``:
    ``dst[index[0][i], index[1][i], ...] = values[i]`` for the rows with
    ``keep[i]``; other rows write nothing — the in-place counterpart of
    JAX's ``.at[idx].set(..., mode="drop")``.

    Without a host sync: a dropped row is redirected to the first kept
    row's target with that row's value (a duplicate write of identical
    bytes, so the outcome is the same whichever write lands), and when
    no row is kept every row rewrites the current contents of the first
    row's target.  Index tensors must already lie in range for every
    row (callers clip dropped rows' indices)."""
    n = keep.shape[0]
    first = torch.argmax(keep.to(torch.int32))
    src = torch.where(keep, torch.arange(n, device=keep.device), first)
    idx = tuple(i[src] for i in index)
    any_kept = keep[first]
    for dst, values in pairs:
        vals = values[src].to(dst.dtype)
        vals = torch.where(any_kept.reshape((1,) * vals.dim()), vals,
                           dst[idx])
        dst.index_put_(idx, vals)


def scatter_kv_pages(pages, k, v, write_tables):
    """Write a per-row K/V strip straight into the shared page pool, in
    place.

    pages: dict(k=(nB, bs, K, hd), v=...); k, v: (B, T, K, hd);
    write_tables: (B, n_wblk) int32 physical page per covered logical
    block (-1 = unallocated -> write dropped).  T is right-padded up to
    ``n_wblk * bs`` — pad K/V lands beyond each row's true length and is
    positionally masked at read time.  An int8 pool stores
    ``quantize_kv`` of the strip: bytes and scales go to the same pages
    under the same keep mask.  Returns ``pages``.
    """
    nB, bs = pages["k"].shape[0], pages["k"].shape[1]
    B, T = k.shape[0], k.shape[1]
    n_wblk = write_tables.shape[1]
    pad = n_wblk * bs - T
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kb = k.reshape(B * n_wblk, bs, *k.shape[2:])
    vb = v.reshape(B * n_wblk, bs, *v.shape[2:])
    tgt = write_tables.reshape(-1).long()
    keep = tgt >= 0
    tgt = torch.clamp(tgt, 0, nB - 1)
    if kv_pages_quantized(pages):
        kq, ks = quantize_kv(kb)
        vq, vs = quantize_kv(vb)
        pairs = ((pages["k"], kq), (pages["v"], vq),
                 (pages["k_scale"], ks), (pages["v_scale"], vs))
    else:
        pairs = ((pages["k"], kb), (pages["v"], vb))
    _masked_put(pairs, (tgt,), keep)
    return pages


def gather_kv_pages(pages, ctx_tables):
    """Materialise the logical K/V view of a chain of pages.

    ctx_tables: (B, n_cblk) int32 physical pages (-1 rows gather page 0,
    which the caller masks).  Returns (k, v) each (B, n_cblk * bs, K, hd),
    dequantized to float32 from an int8 pool.
    """
    nB = pages["k"].shape[0]
    B = ctx_tables.shape[0]
    bt = torch.clamp(ctx_tables.long(), 0, nB - 1)
    kg = pages["k"][bt].reshape(B, -1, *pages["k"].shape[2:])
    vg = pages["v"][bt].reshape(B, -1, *pages["v"].shape[2:])
    if kv_pages_quantized(pages):
        ks = pages["k_scale"][bt].reshape(B, -1, *pages["k_scale"].shape[2:])
        vs = pages["v_scale"][bt].reshape(B, -1, *pages["v_scale"].shape[2:])
        return dequantize_kv(kg, ks), dequantize_kv(vg, vs)
    return kg, vg


def attention_prefill_paged(cfg: ModelConfig, params, x, positions, pages,
                            write_tables, ctx_tables=None, ctx_len=None, *,
                            use_flash: bool = False):
    """Prefill attention for a GLOBAL layer that writes K/V straight into
    the paged pool (in place) and, on a prefix-cache hit, attends the
    shared prefix's pages instead of recomputing them.

    x: (B, S, d) suffix activations; positions: (B, S) ABSOLUTE
    positions (``ctx_len + arange(S)`` on a hit).

    Cold rows (``ctx_tables=None``): ``write_tables`` (B, n_wblk) holds
    the physical pages covering the span from logical block 0, and the
    compute is ``attention_fwd``, so paged admission is the same math as
    a plain prefill.

    Hit rows: the match is token-granular, so the suffix may start
    mid-page (the engine has already forked that page private).
    ``ctx_tables`` and ``write_tables`` are then both the row's full
    block table: the context is the gathered view of it masked to
    positions ``< ctx_len`` per row (dequantized from an int8 pool), the
    suffix attends itself causally, and its K/V is scattered token by
    token at ``ctx_len + i`` through the same table.  On an int8 pool
    the suffix attends its own int8 round trip and writes those ints.
    As in JAX, the hit prefill reads through the gather, not a kernel.
    Returns (out (B, S, d), pages).
    """
    if ctx_tables is None:
        o, k, v = attention_fwd(cfg, params, x, positions, is_global=True,
                                use_flash=use_flash)
        return o, scatter_kv_pages(pages, k, v, write_tables)

    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    ctx_len = torch.as_tensor(ctx_len, dtype=torch.int32, device=x.device)
    q, k, v = _project_seq(cfg, params, x, positions, is_global=True)
    quant = kv_pages_quantized(pages)
    if quant:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k = dequantize_kv(kq, ks, k.dtype)
        v = dequantize_kv(vq, vs, v.dtype)
    ck, cv = gather_kv_pages(pages, ctx_tables)       # gather = a copy
    Tc = ck.shape[1]
    ctx_ok = (torch.arange(Tc, dtype=torch.int32, device=x.device)[None, :]
              < ctx_len[:, None])
    mask = torch.cat(
        [torch.broadcast_to(ctx_ok[:, None, :], (B, S, Tc)),
         torch.broadcast_to(causal_mask(S, S, device=x.device), (B, S, S))],
        dim=-1)
    k_all = torch.cat([ck.to(x.dtype), k], dim=1)
    v_all = torch.cat([cv.to(x.dtype), v], dim=1)
    qg = q.reshape(B, S, K, G, hd)
    out = attention_weights_and_out(qg, k_all, v_all, mask[:, None, None],
                                    scale=scale,
                                    softcap=cfg.attn_logit_softcap)
    o = weight_einsum("bshq,hqd->bsd", out.reshape(B, S, H, hd),
                      params["wo"])
    if quant:
        _scatter_tokens_quant(pages, kq, ks, vq, vs, write_tables, ctx_len)
    else:
        scatter_kv_tokens(pages, k, v, write_tables, ctx_len)
    return o, pages


def attention_decode_paged(cfg: ModelConfig, params, x, cache, pos,
                           block_tables, *, use_pallas: bool = False):
    """Single-token decode against a paged KV pool (GLOBAL layers).

    x: (B, 1, d); pos: (B,) int32 write positions; cache: this layer's
    pool dict(k=(num_blocks, bs, K, hd), v=...); block_tables: (B, n_blk)
    int32, -1 = unallocated.

    The new token's K/V is written IN PLACE into page ``block_tables[b,
    pos//bs]`` at offset ``pos % bs``; rows whose entry is -1 (inactive
    or stalled slots) drop the write.  ``use_pallas=True`` reads the
    pages through the hand-written ``paged_attention`` kernel on a CUDA
    tensor (its plain version on a CPU tensor, ``kernels.ops``);
    otherwise the logical view is gathered and read with a masked
    softmax.  On an int8 pool the new token is quantized and its bytes
    and scales written in place first; the kernel fuses the dequant
    into its read, the gather path dequantizes the gathered view.
    Returns (out (B, 1, d), cache).
    """
    B, S, d = x.shape
    assert S == 1
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                             device=x.device), (B,))
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5

    q, knew, vnew = _decode_project(cfg, params, x, pos, is_global=True)

    kc, vc = cache["k"], cache["v"]
    nB, bs = kc.shape[0], kc.shape[1]
    blk, off = (pos // bs).long(), (pos % bs).long()
    phys = block_tables[torch.arange(B, device=x.device), blk].long()
    keep = phys >= 0
    wphys = torch.clamp(phys, 0, nB - 1)
    quant = kv_pages_quantized(cache)
    if quant:
        kcs, vcs = cache["k_scale"], cache["v_scale"]
        kq1, ks1 = quantize_kv(knew[:, 0])
        vq1, vs1 = quantize_kv(vnew[:, 0])
        pairs = ((kc, kq1), (vc, vq1), (kcs, ks1), (vcs, vs1))
    else:
        pairs = ((kc, knew[:, 0]), (vc, vnew[:, 0]))
    _masked_put(pairs, (wphys, off), keep)

    if use_pallas:
        from repro_torch.kernels import ops as kernel_ops
        out = kernel_ops.paged_attention(
            q[:, 0].contiguous(), kc, vc, block_tables, pos + 1,
            scale=scale, softcap=cfg.attn_logit_softcap,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        o = weight_einsum("bshq,hqd->bsd", out[:, None].to(x.dtype),
                          params["wo"])
        return o, cache

    # gather the logical view: (B, n_blk*bs, K, hd)
    bt = torch.clamp(block_tables.long(), 0, nB - 1)
    kg = kc[bt].reshape(B, -1, K, hd)
    vg = vc[bt].reshape(B, -1, K, hd)
    if quant:
        kg = dequantize_kv(kg, kcs[bt].reshape(B, -1, K))
        vg = dequantize_kv(vg, vcs[bt].reshape(B, -1, K))
    t = torch.arange(block_tables.shape[1] * bs, dtype=torch.int32,
                     device=x.device)
    allocated = torch.repeat_interleave(block_tables >= 0, bs, dim=1)
    valid = allocated & (t[None, :] <= pos[:, None])
    mask = valid[:, None, None, None, :]          # (B,1,1,1,L)

    qg = q.reshape(B, 1, K, G, hd)
    out = attention_weights_and_out(qg, kg.to(x.dtype), vg.to(x.dtype),
                                    mask, scale=scale,
                                    softcap=cfg.attn_logit_softcap)
    o = weight_einsum("bshq,hqd->bsd", out.reshape(B, 1, H, hd),
                      params["wo"])
    return o, cache


def _token_write_targets(pages, B, S, block_tables, pos, valid_len):
    """(tgt, off) page/offset pairs for an S-token scatter, each (B, S);
    dropped writes (unallocated / out-of-span / pad rows) map tgt to the
    out-of-range page index ``nB``, as in the JAX function."""
    nB, bs = pages["k"].shape[0], pages["k"].shape[1]
    n_blk = block_tables.shape[1]
    dev = block_tables.device
    p = pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    blk = torch.clamp(p // bs, 0, n_blk - 1)
    off = p % bs
    phys = torch.gather(block_tables, 1, blk.long())              # (B, S)
    ok = (phys >= 0) & (p < n_blk * bs)
    if valid_len is not None:
        ok &= (torch.arange(S, dtype=torch.int32, device=dev)[None, :]
               < valid_len[:, None])
    return torch.where(ok, phys, nB), off


def scatter_kv_tokens(pages, k, v, block_tables, pos, valid_len=None):
    """Write ``S`` consecutive tokens' K/V into the page pool IN PLACE at
    absolute positions ``pos + i`` through each row's block table.

    pages: dict(k=(nB, bs, K, hd), v=...); k, v: (B, S, K, hd);
    block_tables: (B, n_blk) int32 (-1 = unallocated -> write dropped);
    pos: (B,) int32 first write position; valid_len: optional (B,) int32
    — rows ``i >= valid_len`` are host-side padding whose writes are
    dropped.  Writes past the table's logical span (``n_blk * bs``) are
    dropped.  An int8 pool stores ``quantize_kv`` of k and v.  Returns
    ``pages``.
    """
    if kv_pages_quantized(pages):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return _scatter_tokens_quant(pages, kq, ks, vq, vs, block_tables,
                                     pos, valid_len)
    return _scatter_tokens(pages, ((pages["k"], k), (pages["v"], v)),
                           block_tables, pos, valid_len)


def _scatter_tokens(pages, pairs, block_tables, pos, valid_len):
    """Masked in-place write of per-token leaves: each ``(dst, values)``
    with values (B, S, ...) lands at the targets of ``pos + i``."""
    nB = pages["k"].shape[0]
    B, S = pairs[0][1].shape[0], pairs[0][1].shape[1]
    tgt, off = _token_write_targets(pages, B, S, block_tables, pos,
                                    valid_len)
    tgt, off = tgt.reshape(-1).long(), off.reshape(-1).long()
    keep = tgt < nB
    tgt = torch.clamp(tgt, 0, nB - 1)
    _masked_put(tuple((dst, vals.reshape(B * S, *vals.shape[2:]))
                      for dst, vals in pairs), (tgt, off), keep)
    return pages


def _scatter_tokens_quant(pages, kq, ks, vq, vs, block_tables, pos,
                          valid_len=None):
    """Token scatter of PRE-quantized K/V and their scales, in place.
    Callers that already round-tripped the suffix for attention pass the
    same ints here: re-quantizing the dequantized values would drift
    (the eps of the scale would apply twice)."""
    return _scatter_tokens(pages, ((pages["k"], kq), (pages["v"], vq),
                                   (pages["k_scale"], ks),
                                   (pages["v_scale"], vs)),
                           block_tables, pos, valid_len)


def attention_extend_paged(cfg: ModelConfig, params, x, pos, pages,
                           block_tables, valid_len=None, *,
                           use_pallas: bool = False):
    """Multi-token decode against the paged pool: score ``S``
    teacher-forced tokens in ONE call (chunked catch-up prefill).

    x: (B, S, d) at absolute positions ``pos + i``; block_tables: (B,
    n_blk) the slot's FULL table.  The context is the PRE-WRITE view of
    the pages masked strictly below ``pos``, and the S new tokens attend
    each other causally as a suffix.  K/V for rows ``i < valid_len`` is
    then written into the pages IN PLACE at ``pos + i``.  The pre-write
    view holds by order: the gather copies the context, or the kernel
    is launched on the stream, before the scatter.

    On an int8 pool the suffix attends its own int8 round trip, the
    values every later read of those pages sees, and the same ints are
    then written (``_scatter_tokens_quant``).  There ``use_pallas=True``
    reads the pages through the hand-written ``paged_extend_attention``
    kernel on a CUDA tensor (its plain version on a CPU tensor,
    ``kernels.ops``), which fuses the dequant.  On a float pool the JAX
    function ignores ``use_pallas`` and so does this one.  Returns
    (out (B, S, d), pages).
    """
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                             device=x.device), (B,))
    positions = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                            device=x.device)[None, :]

    q, k, v = _project_seq(cfg, params, x, positions, is_global=True)

    quant = kv_pages_quantized(pages)
    if quant:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        k = dequantize_kv(kq, ks, k.dtype)
        v = dequantize_kv(vq, vs, v.dtype)

    if quant and use_pallas:
        from repro_torch.kernels import ops as kernel_ops
        # launched before the scatter below: it reads the pre-write pages
        out = kernel_ops.paged_extend_attention(
            q.contiguous(), pages["k"], pages["v"], k.contiguous(),
            v.contiguous(), block_tables, pos, scale=scale,
            softcap=cfg.attn_logit_softcap, k_scale=pages["k_scale"],
            v_scale=pages["v_scale"])
        _scatter_tokens_quant(pages, kq, ks, vq, vs, block_tables, pos,
                              valid_len)
        o = weight_einsum("bshq,hqd->bsd", out.to(x.dtype), params["wo"])
        return o, pages

    ck, cv = gather_kv_pages(pages, block_tables)     # gather = a copy
    if quant:
        _scatter_tokens_quant(pages, kq, ks, vq, vs, block_tables, pos,
                              valid_len)
    else:
        scatter_kv_tokens(pages, k, v, block_tables, pos, valid_len)

    bs = pages["k"].shape[1]
    L = block_tables.shape[1] * bs
    t = torch.arange(L, dtype=torch.int32, device=x.device)
    allocated = torch.repeat_interleave(block_tables >= 0, bs, dim=1)
    ctx_ok = allocated & (t[None, :] < pos[:, None])               # (B, L)
    mask = torch.cat(
        [torch.broadcast_to(ctx_ok[:, None, :], (B, S, L)),
         torch.broadcast_to(causal_mask(S, S, device=x.device), (B, S, S))],
        dim=-1)
    k_all = torch.cat([ck.to(x.dtype), k], dim=1)
    v_all = torch.cat([cv.to(x.dtype), v], dim=1)
    qg = q.reshape(B, S, K, G, hd)
    out = attention_weights_and_out(qg, k_all, v_all, mask[:, None, None],
                                    scale=scale,
                                    softcap=cfg.attn_logit_softcap)
    o = weight_einsum("bshq,hqd->bsd", out.reshape(B, S, H, hd),
                      params["wo"])
    return o, pages


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen, d_ff=None, stack=(), dtype=torch.float32,
             device=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": _dense_init(gen, (d, f), stack, **kw),
        "w_up": _dense_init(gen, (d, f), stack, **kw),
        "w_down": _dense_init(gen, (f, d), stack, in_axis_size=f, **kw),
    }


def mlp(params, x, activation="silu"):
    # jax.nn.gelu defaults to the tanh approximation
    act = ((lambda t: F.gelu(t, approximate="tanh")) if activation == "gelu"
           else F.silu)
    h = act(weight_einsum("bsd,df->bsf", x, params["w_gate"])) \
        * weight_einsum("bsd,df->bsf", x, params["w_up"])
    return weight_einsum("bsf,fd->bsd", h, params["w_down"])


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(cfg: ModelConfig, gen, dtype=torch.float32, device=None):
    std = cfg.d_model ** -0.5  # keeps tied-unembed logits O(1)
    table = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                        device=device)
    rows = max(1, (1 << 26) // max(cfg.d_model, 1))   # ~256 MB f32 chunks
    for part in torch.split(table, rows):
        tmp = torch.empty(part.shape, dtype=torch.float32, device=device)
        part.copy_(tmp.normal_(generator=gen).mul_(std))
    return {"table": table}


def embed(cfg: ModelConfig, params, tokens):
    # gather first, then cast: the same values as casting the table
    x = params["table"][tokens.long()].to(cfg.activation_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, emb_params, head_params, x):
    if cfg.tie_embeddings:
        logits = torch.matmul(x, emb_params["table"].to(x.dtype).t())
    else:
        logits = torch.matmul(x, head_params["w"].to(x.dtype))
    return _softcap(logits.float(), cfg.final_logit_softcap)


def init_unembed(cfg: ModelConfig, gen, dtype=torch.float32, device=None):
    if cfg.tie_embeddings:
        return {}
    return {"w": _dense_init(gen, (cfg.d_model, cfg.vocab_size),
                             dtype=dtype, device=device)}


# the encdec family's pieces (A.9.3)
gelu_mlp = not_ported("repro.models.layers.gelu_mlp", "A.9.3 (encdec family)")
init_gelu_mlp = not_ported("repro.models.layers.init_gelu_mlp",
                           "A.9.3 (encdec family)")
sinusoidal_positions = not_ported("repro.models.layers.sinusoidal_positions",
                                  "A.9.3 (encdec family)")
