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
* Cross attention (the encdec family's decoder reading the encoder
  output) and the encoder's non-causal self-attention run through
  ``attention_weights_and_out`` with no mask, as JAX computes them
  outside any Pallas kernel.
* Long causal sequences (S >= 8192, S and T multiples of 1024) take the
  blockwise online-softmax walk of ``_blockwise_causal_attention``, as
  in JAX, split over query shards when the launch layer sets
  ``SEQ_PARALLEL_ATTN``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# initializers (numbers from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def default_generator(device: torch.device):
    """Seed 0 on ``device``, or None on the meta device: there the
    initializers only shape their tensors and draw nothing (the
    counterpart of ``jax.eval_shape`` of an init)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(0)


def _dense_init(gen, shape, stack=(), in_axis_size=None, dtype=torch.float32,
                device=None):
    """Truncated-normal fan-in init (cut at +-2 standard deviations), with
    optional stacking prefix.  Drawn in float32 one stacked slice at a
    time, then stored in ``dtype``."""
    full = tuple(stack) + tuple(shape)
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(full, dtype=dtype, device=device)
    if out.is_meta:
        return out
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
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        # matmul folds x's leading dims into one and the weight's
        # contracted and output dims into one each, and its backward
        # folds the gradient's leading dims
        x = _merge_ready(_merge_ready(x, 0, len(lead)), len(lead), x.dim())
        w = _merge_ready(_merge_ready(w, 0, n), n, w.dim())
        out = torch.matmul(x.reshape(*lead, kd),
                           w.to(x.dtype).reshape(kd, -1))
        out = reduced_onto_tokens(out).reshape(*lead, *w.shape[n:])
        return grad_relaid(out, lambda g: _merge_ready(g, 0, len(lead)))
    out = torch.matmul(x.reshape(*lead, kd), w.to(x.dtype).reshape(kd, -1))
    return out.reshape(*lead, *w.shape[n:])


# DTensor layouts.  A step of ``launch.specs`` on a mesh of more than one
# device runs these functions on DTensors; where DTensor's rules do not
# follow a reshape or a walk, the helpers below redistribute explicitly.
# Each call site takes them only after one ``isinstance(..., DTensor)``
# check, so plain tensors (the one-device mesh, the engines) run as
# before.

def _relaid(t, fn):
    """``t`` with the placement p of each mesh dim i replaced by
    ``fn(i, p)``: a redistribute where one changes."""
    if not isinstance(t, DTensor):
        return t
    pl = [fn(i, p) for i, p in enumerate(t.placements)]
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def reduced_onto_tokens(t):
    """``t`` with its partial sums reduce-scattered onto its rows (dim 0)
    where they divide further, else onto the sequence (dim 1).  A
    product whose contracted dim is sharded leaves ``Partial``
    placements, and the next pointwise op would have DTensor pick a dim
    for them: the rows where they take them (what XLA does too), but
    otherwise the sequence, which the attention products, the scan's
    products and the token flattens then fold into a strided shard.
    Placed here, on every torch, the walks and flattens downstream take
    the sequence shard explicitly (``_shardwise``, ``_merge_ready``,
    ``grad_relaid``).  Partial sums that fit neither (a decode's few
    rows of one token) stay partial, for DTensor's own route."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    pl = list(t.placements)
    for i, p in enumerate(pl):
        if not isinstance(p, Partial):
            continue
        for dim in range(min(2, t.dim() - 1)):
            split = math.prod(mesh.size(j) for j, q in enumerate(pl)
                              if isinstance(q, Shard) and q.dim == dim)
            if t.shape[dim] % (split * mesh.size(i)) == 0:
                pl[i] = Shard(dim)
                break
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


class _GradRelaid(torch.autograd.Function):
    """The identity, whose backward lays the gradient out by ``relay``
    (a redistribute): the reshapes' backwards fold and split gradients
    in whatever layout the ops downstream left them, and DTensor's
    rules refuse some (a strided shard, a nested row shard split)."""

    @staticmethod
    def forward(ctx, t, relay):
        ctx.relay = relay
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.relay(g), None


def grad_relaid(t, relay):
    """``t``, its gradient laid out by ``relay`` on the way back."""
    return _GradRelaid.apply(t, relay) if t.requires_grad else t


def _split_ready(t, dim: int, lead: int):
    """``t`` ready for dim ``dim`` to split into (lead, rest): a shard of
    that dim over a mesh dim that ``lead`` does not divide (H query heads
    over 16 devices, grouped as K = 8 kv heads) is gathered first."""
    return _relaid(t, lambda i, p: Replicate() if isinstance(p, Shard)
                   and p.dim == dim and lead % t.device_mesh.size(i) else p)


def _shardwise(walk, keep_seq: bool = False):
    """``walk(qg, k, v, ...)``, an attention walk over qg (B, S, K, G, hd)
    and k, v (B, T, K, hd) that returns qg's shape, run rank by rank on
    DTensors: an explicit local map.  Rows (dim 0) and kv heads (dim 2,
    where K divides the mesh dim) keep their shards, since attention is
    independent per row and per kv head; with ``keep_seq`` (a walk whose
    mask holds the positions) so does the query sequence, against k and
    v held whole along it.  Any other layout is gathered and partial
    sums reduced.  Each rank walks its local tensors and the output
    comes back with qg's placements; a tensor among the other positional
    arguments (a mask (B or 1, 1, 1, S, T)) is laid out by qg's rows and
    sequence.  Where k and v are held whole along a mesh dim that splits
    the queries, their gradients come back as the ranks' partial sums.
    (DTensor's view rules do not follow the walks' chunk-by-chunk
    slicing and head regrouping on a split dim.)  Plain tensors go
    straight to ``walk``."""
    @functools.wraps(walk)
    def run(qg, k, v, *args, **kw):
        if not isinstance(qg, DTensor):
            return walk(qg, k, v, *args, **kw)
        mesh, (B, S, K) = qg.device_mesh, qg.shape[:3]
        pl = [p if type(p) is Shard and (
            p.dim == 0 or (p.dim == 2 and K % mesh.size(i) == 0)
            or (p.dim == 1 and keep_seq))
            else Replicate() for i, p in enumerate(qg.placements)]
        seq = [type(p) is Shard and p.dim == 1 for p in pl]
        kv_pl = [Replicate() if s else p for s, p in zip(seq, pl)]
        kv_grad = [Partial() if s else p for s, p in zip(seq, pl)]
        local = [_local_as(qg, mesh, pl)] + [
            _local_as(t, mesh, kv_pl, kv_grad) for t in (k, v)]
        args = [_local_as(a, mesh, [
            Shard(0) if type(p) is Shard and p.dim == 0 and a.shape[0] == B
            else Shard(a.dim() - 2) if s and a.shape[-2] == S
            else Replicate() for s, p in zip(seq, pl)])
            if isinstance(a, torch.Tensor) else a for a in args]
        out = walk(*local, *args, **kw).contiguous()
        return DTensor.from_local(out, mesh, pl, run_check=False,
                                  shape=qg.shape,
                                  stride=_contiguous_stride(qg.shape))
    return run


def _local_as(t, mesh, placements, grad_placements=None):
    """This rank's part of ``t`` laid out by ``placements`` (a plain
    ``t`` is taken as the whole tensor, held on every rank); its
    gradient comes back with ``grad_placements`` (default: those)."""
    if isinstance(t, DTensor):
        t = grad_relaid(t, _true_strides)
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)
    return distribute_tensor(t, mesh, placements,
                             src_data_rank=None).to_local()


def _true_strides(g):
    """``g`` with strides its local part has: a local map's backward
    hands back the local gradient in whatever strides the walk left (a
    transposed product's) under the forward's strides, and DTensor's
    views of it (the reshapes' backwards upstream) go by the latter.  On
    a mesh of one device the local part is the tensor and no collective
    or chunk rebuilds it upstream, so ``g`` reports the local strides,
    those the same ops give a plain tensor (the products upstream see
    the plain path's layouts); on larger meshes the redistributes
    upstream make local parts whose strides DTensor's spec does not
    follow, so a non-contiguous one is made contiguous, which DTensor's
    views take."""
    loc = g.to_local()
    if g.device_mesh.size() == 1:
        if loc.stride() == g.stride():
            return g
        stride = loc.stride()
    elif loc.is_contiguous():
        return g
    else:
        loc, stride = loc.contiguous(), g.stride()
    return DTensor.from_local(loc, g.device_mesh, g.placements,
                              run_check=False, shape=g.shape, stride=stride)


def _contiguous_stride(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()


def _merge_ready(t, start: int, stop: int):
    """``t`` ready for dims [start, stop) to merge into one: a shard of a
    dim of the group other than its first, or of a first dim that is
    already a strided shard, would come out of the merge strided, which
    DTensor's product rules do not take; partial sums would be
    re-sharded strided.  Each is gathered (reduced) first."""
    return _relaid(t, lambda i, p: Replicate() if isinstance(p, Partial)
                   or isinstance(p, Shard) and (
                       start < p.dim < stop
                       or (p.dim == start and type(p) is not Shard))
                   else p)


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


def _mean_last(t):
    """The mean over the last dim, kept.  On a DTensor sharded there the
    sum's partial sums are all-reduced explicitly before the division: a
    partial mean meeting the next pointwise op would be reduce-scattered
    onto the sequence, and DTensor's backward cannot turn the gradient's
    partial sum into a partial mean."""
    if isinstance(t, DTensor) and any(isinstance(p, Shard)
                                      and p.dim == t.dim() - 1
                                      for p in t.placements):
        total = _relaid(torch.sum(t, dim=-1, keepdim=True),
                        lambda i, p: Replicate() if isinstance(p, Partial)
                        else p)
        return total / t.shape[-1]
    return torch.mean(t, dim=-1, keepdim=True)


def rmsnorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = _mean_last(torch.square(x))
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dtype)


def init_layernorm(d: int, stack=(), device=None):
    """Unit scale and zero bias, float32 whatever the weights' type."""
    return {"scale": _ones((d,), stack, device=device),
            "bias": _zeros((d,), stack, device=device)}


def layernorm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    mu = _mean_last(x)
    var = _mean_last(torch.square(x - mu))
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


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embedding table (n, d), float32."""
    half = d // 2
    log_timescale = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(n, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


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
    or None (every key, the JAX all-ones mask of cross and non-causal
    attention); returns (B, S, K, G, hd).  Scores are float32 products
    of the activation-dtype inputs (the JAX ``preferred_element_type``);
    both contractions are batched matmuls over (B, K) with the G query
    heads of a group stacked along the rows.

    On DTensors the full-sequence reads run rank by rank (``_shardwise``,
    the query sequence's shard kept): folding (B, K) or (G, S) into one
    dim makes a strided shard of a row, kv-head or sequence shard, which
    DTensor's product and cast rules refuse, and partial sums do not
    survive the softmax.  A one-token read keeps DTensor's own route
    (a head_dim shard of the cache, where the kv heads do not divide the
    model axis, gives partial scores, as XLA splits it; a cache whose
    time axis is split reduces the softmax over the time shards) unless
    its rows and kv heads are both sharded.
    """
    if isinstance(q, DTensor):
        dims = {p.dim for t in (q, k) if isinstance(t, DTensor)
                for p in t.placements if isinstance(p, Shard)}
        if q.shape[1] > 1 or {0, 2} <= dims:
            return _attention_by_rank(q, k, v, mask, scale=scale,
                                      softcap=softcap)
    return _attention_core(q, k, v, mask, scale=scale, softcap=softcap)


def _attention_core(q, k, v, mask, *, scale, softcap):
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    qr = q.permute(0, 2, 3, 1, 4).reshape(B, K, G * S, hd).float()
    scores = torch.matmul(qr, k.permute(0, 2, 3, 1).float())
    scores = _softcap(scores.view(B, K, G, S, T) * scale, softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.view(B, K, G * S, T), v.permute(0, 2, 1, 3))
    return out.view(B, K, G, S, hd).permute(0, 3, 1, 2, 4)


_attention_by_rank = _shardwise(_attention_core, keep_seq=True)


def _merged_heads(out):
    """(B, S, K, G, hd) -> (B, S, H, hd) for the output projection.  On
    DTensors the merge's input is readied for it, and the gradient, which
    the projection's backward hands back sharded as the heads of ``wo``
    are, comes back ready for the split into (K, G)."""
    B, S, K, G, hd = out.shape
    if not isinstance(out, DTensor):
        return out.reshape(B, S, K * G, hd)
    merged = _merge_ready(out, 2, 4).reshape(B, S, K * G, hd)
    return grad_relaid(merged, lambda g: _split_ready(g, 2, K))


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
                 is_global: bool, kv_x=None):
    """Shared q/k/v projection + qk-norm + RoPE for the full-sequence
    paths (``attention_fwd`` and the paged extend).  ``kv_x`` (B, T, d)
    is a cross-attention source: k and v are projected from it and
    nothing is rotated."""
    q = weight_einsum("bsd,dhq->bshq", x, params["wq"])
    src = x if kv_x is None else kv_x
    k = weight_einsum("btd,dkq->btkq", src, params["wk"])
    v = weight_einsum("btd,dkq->btkq", src, params["wv"])

    if cfg.use_qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)

    if not cfg.use_abs_pos and kv_x is None:
        theta = (cfg.rope_theta_global
                 if (is_global and cfg.rope_theta_global) else cfg.rope_theta)
        sin, cos = _rope_angles(positions, q.shape[-1], theta)  # q and k
        q, k = _rotate(q, sin, cos), _rotate(k, sin, cos)
    return q, k, v


BLOCKWISE_THRESHOLD = 8192
BLOCKWISE_CHUNK = 1024

# Sequence-parallel blockwise attention (process-scoped, set by
# ``launch.specs``): (n_shards, layout) or None, ``layout`` a
# ``launch.sharding.NamedSharding`` of the (B, shard, S/shard, K, G, hd)
# query layout, or None.  Used when query heads cannot shard over the
# model axis: each model shard computes its 1/n slice of the query
# sequence against the whole K/V — no redundant FLOPs and 1/n of the
# score traffic per chip.
SEQ_PARALLEL_ATTN = None


def attention_fwd(cfg: ModelConfig, params, x, positions, *,
                  is_global: bool, kv_x=None, causal: bool = True,
                  use_flash: bool = False):
    """Full-sequence attention (training / prefill).

    x: (B, S, d).  ``kv_x`` (B, T, d) is a cross-attention source, and
    ``causal=False`` lets every query see every key (the encoder); both
    take the unmasked softmax, whatever ``use_flash`` says, as in JAX.
    Otherwise ``use_flash`` sends the causal attention through
    ``kernels.ops.flash_attention`` (the hand-written kernel on CUDA
    tensors, its plain version on CPU tensors; neither has a backward).
    Otherwise local (sliding-window) layers take the chunked O(S*W) path
    when S > 2W and S % W == 0, and the rest the plain masked softmax.
    Causal global attention with S >= 8192 and S, T multiples of
    ``BLOCKWISE_CHUNK`` takes ``_blockwise_causal_attention``.
    Returns (out (B,S,d), k, v) — k/v returned for cache construction.
    """
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5

    q, k, v = _project_seq(cfg, params, x, positions, is_global=is_global,
                           kv_x=kv_x)

    T = k.shape[1]
    if isinstance(q, DTensor):
        q = _split_ready(q, 2, K)
    qg = q.reshape(B, S, K, G, hd)

    window = 0 if is_global else cfg.local_window
    if kv_x is not None or not causal:
        out = attention_weights_and_out(qg, k, v, None, scale=scale,
                                        softcap=cfg.attn_logit_softcap)
    elif use_flash:
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
        out = _blockwise_causal_attention(qg, k, v, scale,
                                          cfg.attn_logit_softcap,
                                          chunk=BLOCKWISE_CHUNK)
    else:
        m = (window_mask(S, T, window, device=x.device) if window
             else causal_mask(S, T, device=x.device))
        out = attention_weights_and_out(qg, k, v, m[None, None, None],
                                        scale=scale,
                                        softcap=cfg.attn_logit_softcap)

    o = weight_einsum("bshq,hqd->bsd", _merged_heads(out), params["wo"])
    return o, k, v


@_shardwise
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


def _blockwise_causal_attention(qg, k, v, scale, softcap,
                                chunk: int = BLOCKWISE_CHUNK):
    """Memory-efficient causal attention over (q, kv) chunk pairs with a
    running (max, denominator, accumulator): the flash algorithm in plain
    PyTorch, O(S * chunk) live scores instead of O(S * T).

    qg: (B, S, K, G, hd); k, v: (B, T, K, hd).  With
    ``SEQ_PARALLEL_ATTN = (n, layout)`` set, S % n == 0 and the shard
    length ``per = S // n`` a multiple of ``chunk``, the queries split
    into n shards of ``per`` (``_seq_parallel_attention``); otherwise
    the whole sequence takes one walk, as in JAX."""
    sp = SEQ_PARALLEL_ATTN
    if sp is not None:
        n_sh, layout = sp
        S = qg.shape[1]
        per = S // n_sh
        if S % n_sh == 0 and per % chunk == 0 and per >= chunk:
            return _seq_parallel_attention(qg, k, v, scale, softcap, chunk,
                                           n_sh, layout)
    return _blockwise_inner(qg, k, v, scale, softcap, chunk)


def _seq_parallel_attention(qg, k, v, scale, softcap, chunk, n_sh, layout):
    """The walk of ``_blockwise_inner`` on each of ``n_sh`` query shards,
    shard s at ``q_offset = s * per`` against the whole of k, v.

    Plain tensors walk the shards in turn.  A DTensor (a step of
    ``launch.specs`` on a mesh) is laid out by ``layout``'s placements
    first, the shard axis over the model axis, and each rank walks the
    shards it holds against k, v gathered whole (the explicit
    redistribute JAX's ``with_sharding_constraint`` implies); the output
    keeps that layout.  Each query chunk walks the same kv chunks in the
    same order as the unsplit walk, so the bits are the same."""
    B, S, K, G, hd = qg.shape
    per = S // n_sh
    qs = qg.reshape(B, n_sh, per, K, G, hd)
    if not isinstance(qs, DTensor) or layout is None:
        outs = [_blockwise_inner(qs[:, s], k, v, scale, softcap, chunk,
                                 q_offset=s * per) for s in range(n_sh)]
        return torch.stack(outs, dim=1).reshape(B, S, K, G, hd)

    mesh, placements = layout.mesh, layout.placements
    whole = [Replicate()] * mesh.ndim
    kl, vl = _local_as(k, mesh, whole), _local_as(v, mesh, whole)
    ql = qs.redistribute(mesh, placements).to_local()
    first = _shard_offset(n_sh, 1, mesh, placements)
    outs = [_blockwise_inner(ql[:, j], kl, vl, scale, softcap, chunk,
                             q_offset=(first + j) * per)
            for j in range(ql.shape[1])]
    out = DTensor.from_local(torch.stack(outs, dim=1), mesh, placements,
                             run_check=False, shape=qs.shape,
                             stride=_contiguous_stride(qs.shape))
    return out.reshape(B, S, K, G, hd)


@_shardwise
def _blockwise_inner(qg, k, v, scale, softcap, chunk, q_offset=0):
    """The walk of ``_blockwise_causal_attention`` for queries at
    positions ``q_offset + i`` (a shard of a longer sequence) against
    every key of k, v.  S and T are multiples of ``chunk``.

    For each query chunk the kv chunks are walked in order, carrying
    m (running max), l (denominator) and a float32 accumulator:
    scores are float32 products of float32 operands, times ``scale``,
    softcapped, ``NEG_INF`` where ``kpos > qpos``; ``p = exp(s - m_new)``
    (0 where masked), ``alpha = exp(m - m_new)``, and p is rounded to v's
    dtype before the float32 p.v product, as JAX casts it before its
    float32-accumulated einsum.  The output is ``acc / max(l, 1e-30)``
    in qg's dtype.

    Unlike JAX, kv chunks wholly above the diagonal are skipped, and the
    mask is applied only to the chunks it cuts.  Skipping changes no bit:
    kv chunk 0 is always walked first and holds a visible key for every
    query (positions start at 0), so m is finite after it; a wholly
    masked chunk then has max ``NEG_INF`` < m, so m_new = m, alpha =
    exp(0) = 1 and p = 0, and l and acc come out exactly as they went in.
    That halves the work of a causal walk.  Where every key of a chunk
    is visible the mask selects every score, so leaving it out changes
    nothing either.
    """
    B, S, K, G, hd = qg.shape
    T = k.shape[1]
    nq, nk = S // chunk, T // chunk
    kt = k.permute(0, 2, 3, 1).float()           # (B, K, hd, T)
    vt = v.permute(0, 2, 1, 3).float()           # (B, K, T, hd)
    rel = torch.arange(chunk, device=qg.device)
    outs = []
    for qi in range(nq):
        q0 = q_offset + qi * chunk               # the chunk's first query
        # (B, K, G*chunk, hd): the G heads of a group stacked on the rows
        q = qg[:, qi * chunk:(qi + 1) * chunk].permute(0, 2, 3, 1, 4) \
            .reshape(B, K, G * chunk, hd).float()
        m = torch.full((B, K, G, chunk), NEG_INF, dtype=torch.float32,
                       device=qg.device)
        l = torch.zeros((B, K, G, chunk), dtype=torch.float32,
                        device=qg.device)
        acc = torch.zeros((B, K, G, chunk, hd), dtype=torch.float32,
                          device=qg.device)
        for kj in range(nk):
            k0 = kj * chunk
            if k0 > q0 + chunk - 1:              # wholly above the diagonal
                break
            s = torch.matmul(q, kt[..., k0:k0 + chunk]) \
                .view(B, K, G, chunk, chunk) * scale
            s = _softcap(s, softcap)
            vis = None
            if k0 + chunk - 1 > q0:              # the diagonal cuts it
                vis = (k0 + rel)[None, :] <= (q0 + rel)[:, None]
                s = torch.where(vis, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if vis is not None:
                p = torch.where(vis, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).float()
                              .view(B, K, G * chunk, chunk),
                              vt[:, :, k0:k0 + chunk])
            acc = acc * alpha[..., None] + pv.view(B, K, G, chunk, hd)
            m = m_new
        out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(qg.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, chunk, K, G, hd)
    return torch.cat(outs, dim=1)


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


def on_mesh_of(tree, ref):
    """``tree``'s tensors as replicated DTensors over the same storage on
    ``ref``'s mesh when ``ref`` is a DTensor (a cache a prefill makes
    inside a step of ``launch.specs`` joins the mesh its activations run
    on, so the in-place fills can write DTensors into it); otherwise
    ``tree`` as it is."""
    if not isinstance(ref, DTensor):
        return tree
    mesh = ref.device_mesh
    whole = [Replicate()] * mesh.ndim

    def wrap(t):
        if isinstance(t, dict):
            return {k: wrap(v) for k, v in t.items()}
        return DTensor.from_local(t, mesh, whole, run_check=False)
    return wrap(tree)


def _shard_offset(length: int, dim: int, mesh, placements) -> int:
    """Where this rank's part of tensor dim ``dim`` (``length`` long)
    starts, for DTensor's split: each mesh dim sharding it, in order,
    cuts what is left into ``torch.chunk`` pieces (from the mesh's own
    coordinates, so no tensor op runs: none is data-dependent under
    ``FakeTensorMode``)."""
    coord = mesh.get_coordinate()
    start = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            piece = -(-length // mesh.size(i))
            start += coord[i] * piece
            length = max(0, min(piece, length - coord[i] * piece))
    return start


def row_write(dst, at, val) -> None:
    """``dst[b, at[b]] = val[b]`` for every row b, in place, of a DTensor
    dst (B, T, ...) (a step of ``launch.specs`` on a mesh); at (B,)
    int64, val (B, ...).

    It is written shard by shard, an explicit local map: DTensor has no
    sharding rule for ``index_put_`` in every torch version, and none
    keeps a sharded destination in place.  ``at`` and ``val`` are laid
    out as ``dst``'s rows and trailing dims are, each rank writes the
    rows it holds, and where T is split a rank writes only the positions
    that fall in its part (a masked write of what was there
    elsewhere)."""
    mesh, pl = dst.device_mesh, dst.placements

    def local(t, placements):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements).to_local()
        return distribute_tensor(t, mesh, placements,
                                 src_data_rank=None).to_local()
    # val's dims are dst's without T (dim 1); at's one dim is dst's rows
    val = local(val, [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
                      and p.dim != 1 else Replicate() for p in pl])
    at = local(at, [Shard(0) if isinstance(p, Shard) and p.dim == 0
                    else Replicate() for p in pl])
    mine = dst.to_local()
    rows = torch.arange(mine.shape[0], device=mine.device)
    T = mine.shape[1]
    if T == dst.shape[1]:
        mine[rows, at] = val
        return
    li = at - _shard_offset(dst.shape[1], 1, mesh, pl)
    ok = ((li >= 0) & (li < T)).view(-1, *([1] * (val.dim() - 1)))
    li = li.clamp(0, T - 1)
    mine[rows, li] = torch.where(ok, val, mine[rows, li])


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
    a strip.  ``cross_kv`` = (k, v), each (B, T, K, hd), is the encdec
    decoder's cross attention: the query attends all T entries, nothing
    is rotated or written, and the cache comes back untouched.  Returns
    (out (B, 1, d), cache).
    """
    B, S, d = x.shape
    assert S == 1
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    if cross_kv is not None:
        q = weight_einsum("bsd,dhq->bshq", x, params["wq"])
        if cfg.use_qk_norm:
            q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k, v = cross_kv
        if isinstance(q, DTensor):
            q = _split_ready(q, 2, K)
        out = attention_weights_and_out(q.reshape(B, 1, K, G, hd), k, v,
                                        None, scale=scale,
                                        softcap=cfg.attn_logit_softcap)
        o = weight_einsum("bshq,hqd->bsd", _merged_heads(out),
                          params["wo"])
        return o, cache
    pos = torch.broadcast_to(torch.as_tensor(pos, dtype=torch.int32,
                                             device=x.device), (B,))

    q, knew, vnew = _decode_project(cfg, params, x, pos, is_global=is_global)

    kc, vc, slots = cache["k"], cache["v"], cache["slots"]
    T = kc.shape[1]
    at = (pos % T).long()
    if isinstance(kc, DTensor):
        row_write(kc, at, knew[:, 0].to(kc.dtype))
        row_write(vc, at, vnew[:, 0].to(vc.dtype))
        row_write(slots, at, pos)
    else:
        rows = torch.arange(B, device=x.device)
        kc[rows, at] = knew[:, 0].to(kc.dtype)
        vc[rows, at] = vnew[:, 0].to(vc.dtype)
        slots[rows, at] = pos

    window = 0 if is_global else cfg.local_window
    valid = (slots >= 0) & (slots <= pos[:, None])
    if window:
        valid &= slots > (pos[:, None] - window)
    mask = valid[:, None, None, None, :]          # (B,1,1,1,T)
    if isinstance(q, DTensor):
        q = _split_ready(q, 2, K)
    qg = q.reshape(B, 1, K, G, hd)
    out = attention_weights_and_out(qg, kc.to(x.dtype), vc.to(x.dtype),
                                    mask, scale=scale,
                                    softcap=cfg.attn_logit_softcap)
    o = weight_einsum("bshq,hqd->bsd", _merged_heads(out), params["wo"])
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


def init_gelu_mlp(cfg: ModelConfig, gen, stack=(), dtype=torch.float32,
                  device=None):
    """Whisper-style 2-matrix GELU MLP with biases (zero at init)."""
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "w_in": _dense_init(gen, (d, f), stack, **kw),
        "b_in": _zeros((f,), stack, **kw),
        "w_out": _dense_init(gen, (f, d), stack, in_axis_size=f, **kw),
        "b_out": _zeros((d,), stack, **kw),
    }


def gelu_mlp(params, x):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(weight_einsum("bsd,df->bsf", x, params["w_in"])
               + params["b_in"].to(x.dtype), approximate="tanh")
    return weight_einsum("bsf,fd->bsd", h, params["w_out"]) \
        + params["b_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(cfg: ModelConfig, gen, dtype=torch.float32, device=None):
    std = cfg.d_model ** -0.5  # keeps tied-unembed logits O(1)
    table = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                        device=device)
    if table.is_meta:
        return {"table": table}
    rows = max(1, (1 << 26) // max(cfg.d_model, 1))   # ~256 MB f32 chunks
    for part in torch.split(table, rows):
        tmp = torch.empty(part.shape, dtype=torch.float32, device=device)
        part.copy_(tmp.normal_(generator=gen).mul_(std))
    return {"table": table}


def take_rows(table, idx):
    """``table[idx]``: rows of a 2-D table at integer ids of any shape.
    On DTensors rank by rank (an explicit local map): on each mesh dim
    the ids keep their shard and the table is held whole there, or,
    where the ids are whole, the table is sharded by columns (a row
    shard moved there, as DTensor's own rule does); each rank looks its
    ids up in its part.  Neither the lookup nor its backward
    (an ``index_put``) goes through DTensor's index rules, which the
    card's torch (2.11) lacks for these layouts.  Along an ids shard the
    ranks' table gradients are partial sums, and come back as such."""
    if not isinstance(table, DTensor):
        return table[idx]
    mesh, k = table.device_mesh, idx.dim()
    ipl = (idx.placements if isinstance(idx, DTensor)
           else [Replicate()] * mesh.ndim)
    tpl, gpl, opl, cols = [], [], [], 1
    for i, (ip, tp) in enumerate(zip(ipl, table.placements)):
        if isinstance(ip, Shard):
            tpl.append(Replicate())
            gpl.append(Partial())
            opl.append(ip)
        elif type(tp) is Shard and table.shape[1] % (
                cols * mesh.size(i)) == 0:
            cols *= mesh.size(i)
            tpl.append(Shard(1))
            gpl.append(Shard(1))
            opl.append(Shard(k))
        else:
            tpl.append(Replicate())
            gpl.append(Replicate())
            opl.append(Replicate())
    tl = table.redistribute(mesh, tpl).to_local(grad_placements=gpl)
    il = _local_as(idx, mesh, [p if isinstance(p, Shard) else Replicate()
                               for p in ipl])
    shape = (*idx.shape, table.shape[1])
    return DTensor.from_local(tl[il], mesh, opl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def embed(cfg: ModelConfig, params, tokens):
    # gather first, then cast: the same values as casting the table
    x = take_rows(params["table"], tokens.long()).to(cfg.activation_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg: ModelConfig, emb_params, head_params, x):
    if isinstance(x, DTensor):      # the product folds (B, S)
        x = _merge_ready(x, 0, x.dim() - 1)
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

