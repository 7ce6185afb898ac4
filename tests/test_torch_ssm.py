"""The port's ssm slice (mamba2) against ``repro.models.ssm``, the JAX
``ssd_scan`` oracles and the JAX engine's pool-free path, under bridged
weights (mamba2-370m smoke at float32).

Tolerances: the port and JAX run the same float32 math summed in
another order, so every model function, logit and state is held at
rtol=atol=1e-5.  ``ssd_scan_ref`` (the kernel's plain version, the
sequential recurrence) matches JAX's ``ssd_scan_ref`` at 1e-5 and the
Pallas kernel in interpret mode at the 1e-3 that
``tests/test_kernels.py`` holds the Pallas kernel to (the chunked and
the sequential summations differ by float rounding over up to 128
steps).  The engine's greedy tokens and ``stats()`` must equal the JAX
engine's exactly: both run the same schedule, and at float32 no argmax
lands on a near-tie.  The CUDA kernel itself is held against its plain
version on the card (``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig

ARCH = "mamba2-370m"
TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py's sweep: (l, h, p, n, chunk); the third is ragged
SWEEP = [(64, 4, 16, 8, 16), (128, 2, 32, 16, 32), (48, 4, 16, 8, 16),
         (32, 8, 64, 32, 8)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(mine, theirs, **tol):
    np.testing.assert_allclose(mine.detach().float().numpy(),
                               np.asarray(theirs, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _scan_inputs(seed, b, l, h, p, n, h0=False):
    """numpy inputs of the scan: dt post-softplus, A negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, l, n), np.float32)
    C = rng.standard_normal((b, l, n), np.float32)
    H0 = rng.standard_normal((b, h, p, n), np.float32) if h0 else None
    return x, dt, A, B, C, H0


# ---------------------------------------------------------------------------
# ssd_scan: the kernel's plain version and the chunked scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l,h,p,n,chunk", SWEEP)
def test_ssd_scan_ref_matches_jax(l, h, p, n, chunk):
    """Against JAX's ``ssd_scan_ref`` (the same recurrence) and the
    Pallas kernel in interpret mode at the sweep's shapes."""
    x, dt, A, B, C, _ = _scan_inputs(l + h, 2, l, h, p, n)
    y, hf = ref.ssd_scan_ref(_t(x), _t(dt), _t(A), _t(B), _t(C))
    yr, hr = jax_ref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, B, C)))
    _close(y, yr)
    _close(hf, hr)
    yk, hk = jax_ops.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)),
                              chunk=chunk)
    _close(y, yk, rtol=1e-3, atol=1e-3)
    _close(hf, hk, rtol=1e-3, atol=1e-3)


def test_ssd_scan_ref_initial_state_continues_the_sequence():
    """scan(second half, h0=state(first half)) == the whole, and equals
    the Pallas kernel's continuation."""
    x, dt, A, B, C, _ = _scan_inputs(7, 1, 64, 2, 16, 8)
    t = [_t(a) for a in (x, dt, A, B, C)]
    y_full, h_full = ref.ssd_scan_ref(*t)
    _, h1 = ref.ssd_scan_ref(t[0][:, :32], t[1][:, :32], t[2],
                             t[3][:, :32], t[4][:, :32])
    y2, h2 = ref.ssd_scan_ref(t[0][:, 32:], t[1][:, 32:], t[2],
                              t[3][:, 32:], t[4][:, 32:], h0=h1)
    torch.testing.assert_close(y2, y_full[:, 32:], **TOL)
    torch.testing.assert_close(h2, h_full, **TOL)
    j = list(map(jnp.asarray, (x, dt, A, B, C)))
    yj, hj = jax_ops.ssd_scan(j[0][:, 32:], j[1][:, 32:], j[2],
                              j[3][:, 32:], j[4][:, 32:], chunk=16,
                              h0=jnp.asarray(h1.numpy()))
    _close(y2, yj, rtol=1e-3, atol=1e-3)
    _close(h2, hj, rtol=1e-3, atol=1e-3)


def _bf16_pieces(t, pieces: int):
    """What the sum of ``pieces`` bfloat16 pieces of float32 ``t`` holds
    (hi, then the bf16 of each remainder), as the kernel splits a float32
    operand for the tensor cores."""
    out = torch.zeros_like(t, dtype=torch.float32)
    rest = t.float()
    for _ in range(pieces):
        piece = rest.to(torch.bfloat16).float()
        out = out + piece
        rest = rest - piece
    return out


def _chunk_parallel_reference(x, dt, A, B, C, chunk: int, h0=None,
                              pieces: int = 0):
    """The CUDA kernel's decomposition (``csrc/ssd_scan.cu``) in plain
    PyTorch, float32: per (b, chunk) the cumsum of dt A, the score
    product C B^T once for every head, each head's local end state
    sum_j (x_j dt_j exp(last - cums_j)) (x) B_j; the states passed in
    chunk order from ``h0``; then y = the inter term exp(cums_i) C_i
    state^T + the intra term (the masked, decayed, dt-scaled scores
    times x).  ``pieces`` > 0 replaces each float32 operand of a product
    (the scaled x, the carried state, the decayed scores) by the sum of
    that many bf16 pieces, as the bf16 instantiation computes them.
    Returns (y in x's dtype, final state float32)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l)
    nc = -(-l // Q)
    pad = nc * Q - l

    def chunks(t):
        t = t.float()
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, Q, *t.shape[2:])

    def sp(t):
        return _bf16_pieces(t, pieces) if pieces else t
    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(B), chunks(C)
    cums = torch.cumsum(dtc * A.float(), dim=2)               # (b,nc,Q,h)
    last = cums[:, :, -1]                                      # (b,nc,h)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # once
    w = dtc * torch.exp(last[:, :, None] - cums)
    local = torch.einsum("bcjhp,bcjn->bchpn", sp(xc * w[..., None]), Bc)
    s = (h0.float() if h0 is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = torch.exp(last[:, c])[..., None, None] * s + local[:, c]
    state = torch.stack(entering, dim=1)                       # (b,nc,h,p,n)
    inter = torch.exp(cums)[..., None] * torch.einsum(
        "bcin,bchpn->bcihp", Cc, sp(state))
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]     # (b,nc,i,j,h)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, None, :,
                                                            :, None]
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    scaled = sp(scores[..., None] * decay * dtc[:, :, None])   # (b,nc,i,j,h)
    intra = torch.einsum("bcijh,bcjhp->bcihp", scaled, xc)
    y = (inter + intra).reshape(b, nc * Q, h, p)[:, :l]
    return y.to(x.dtype), s


@pytest.mark.parametrize("l,h,p,n,chunk", SWEEP + [(70, 3, 24, 40, 32)])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_chunk_parallel_decomposition_matches_jax(l, h, p, n, chunk,
                                                  with_h0):
    """The kernel's chunk-parallel decomposition in plain PyTorch
    (``_chunk_parallel_reference``: C B^T once per (b, chunk),
    local states, the pass from h0, inter + intra) at float32 against
    the plain version, JAX's oracle and the Pallas kernel in interpret
    mode, ragged tails and an initial state included."""
    x, dt, A, B, C, H0 = _scan_inputs(l + 3 * h, 2, l, h, p, n, h0=with_h0)
    t = [_t(a) for a in (x, dt, A, B, C)]
    h0 = _t(H0) if with_h0 else None
    y, hf = _chunk_parallel_reference(*t, chunk, h0=h0)
    yr, hr = ref.ssd_scan_ref(*t, h0=h0)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hf, hr, rtol=1e-4, atol=1e-4)
    j = list(map(jnp.asarray, (x, dt, A, B, C)))
    jh0 = jnp.asarray(H0) if with_h0 else None
    yj, hj = jax_ref.ssd_scan_ref(*j, h0=jh0)
    _close(y, yj, rtol=1e-4, atol=1e-4)
    _close(hf, hj, rtol=1e-4, atol=1e-4)
    yk, hk = jax_ops.ssd_scan(*j, chunk=chunk, h0=jh0)
    _close(y, yk, rtol=1e-3, atol=1e-3)
    _close(hf, hk, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("l", [300, 512])
def test_bf16_pieces_hold_the_float32_tolerance(l):
    """The bf16 instantiation's arithmetic, modelled: x, B and C in
    bf16 (one piece each), every float32 operand of a product (the
    scaled x, the carried state, the decayed scores) as hi + lo bf16
    pieces.  At mamba2-370m's width and chunk (h=32, p=64, n=128,
    Q=256) and chip_smoke's input scale it stays within the card
    checks' float32 tolerance, 1e-4 x max |y| of the plain chunked path
    (states within 1e-4 x max |state|); one piece alone (plain bf16
    operands) does not."""
    g = torch.Generator().manual_seed(l)
    h, p, n = 32, 64, 128
    x = torch.randn((1, l, h, p), generator=g).to(torch.bfloat16).float()
    B, C = [(torch.randn((1, l, n), generator=g) * n ** -0.5)
            .to(torch.bfloat16).float() for _ in range(2)]
    dt = torch.rand((1, l, h), generator=g) * 0.02 + 0.001
    A = -(torch.rand((h,), generator=g) * 1.5 + 0.5)
    h0 = torch.randn((1, h, p, n), generator=g) * 0.1
    want, want_h = S.ssd_chunked(x, dt, A, B, C, 256, h0=h0)
    errs = {}
    for pieces in (1, 2):
        y, hf = _chunk_parallel_reference(x, dt, A, B, C, 256, h0=h0,
                                          pieces=pieces)
        errs[pieces] = (float((y - want).abs().max() / want.abs().max()),
                        float((hf - want_h).abs().max()
                              / want_h.abs().max()))
    assert max(errs[2]) <= 1e-4, errs
    assert max(errs[1]) > 1e-4, errs


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_ssd_chunked_matches_jax(use_kernel):
    """The plain chunked branch and the ``use_kernel`` branch (the plain
    version on CPU tensors) against JAX's chunked scan: a ragged tail
    over three chunks, with an initial state."""
    x, dt, A, B, C, H0 = _scan_inputs(3, 2, 40, 4, 8, 6, h0=True)
    y, hf = S.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), 16,
                          h0=_t(H0), use_kernel=use_kernel)
    yj, hj = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 16,
                            h0=jnp.asarray(H0))
    _close(y, yj, rtol=1e-4, atol=1e-4)
    _close(hf, hj, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the mamba2 block's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state,with_len", [(False, False), (True, False),
                                                 (False, True), (True, True)])
def test_causal_conv_matches_jax(models, with_state, with_len):
    _, jparams, _, params = models
    rng = np.random.default_rng(11)
    w, ch = jparams["layers"]["conv_w"].shape[1:]
    xbc = rng.standard_normal((3, 9, ch), np.float32)
    st = rng.standard_normal((3, w - 1, ch), np.float32) if with_state \
        else None
    tl = np.array([9, 2, 0], np.int32) if with_len else None
    lp = {k: v[0] for k, v in params["layers"].items()
          if not isinstance(v, dict)}
    out, new = S._causal_conv(_t(xbc), lp["conv_w"], lp["conv_b"],
                              None if st is None else _t(st),
                              None if tl is None else _t(tl))
    jout, jnew = JS._causal_conv(
        jnp.asarray(xbc), jparams["layers"]["conv_w"][0],
        jparams["layers"]["conv_b"][0],
        None if st is None else jnp.asarray(st),
        None if tl is None else jnp.asarray(tl))
    _close(out, jout)
    _close(new, jnew)


def _layer0(tree):
    return {k: (_layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def test_mamba_mix_matches_jax(models):
    """Sequence mixer: from zero state with ragged ``true_len``, and as
    a continuation of a given (conv, ssm) state."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 21, cfg.d_model), np.float32)
    tl = np.array([21, 8, 1], np.int32)
    lp, jlp = _layer0(params["layers"]), _layer0(jparams["layers"])
    jmix = jax.jit(lambda *a, **k: JS.mamba_mix(jcfg, *a, **k))
    out, st = S.mamba_mix(cfg, lp, _t(x), true_len=_t(tl))
    jout, jst = jmix(jlp, jnp.asarray(x), true_len=jnp.asarray(tl))
    _close(out, jout)
    for k in ("conv", "ssm"):
        _close(st[k], jst[k])
    out2, st2 = S.mamba_mix(cfg, lp, _t(x[:, :5]), state=st)
    jout2, jst2 = jmix(jlp, jnp.asarray(x[:, :5]), state=jst)
    _close(out2, jout2)
    for k in ("conv", "ssm"):
        _close(st2[k], jst2[k])


def test_mamba_mix_decode_matches_jax(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(13)
    lp, jlp = _layer0(params["layers"]), _layer0(jparams["layers"])
    x = rng.standard_normal((3, 1, cfg.d_model), np.float32)
    state = {k: rng.standard_normal(tuple(v.shape), np.float32)
             for k, v in S.init_state(cfg, 3, device="meta").items()}
    out, st = S.mamba_mix_decode(cfg, lp, _t(x),
                                 {k: _t(v) for k, v in state.items()})
    jout, jst = JS.mamba_mix_decode(jcfg, jlp, jnp.asarray(x),
                                    {k: jnp.asarray(v)
                                     for k, v in state.items()})
    _close(out, jout)
    for k in ("conv", "ssm"):
        _close(st[k], jst[k])


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------

def test_init_params_keep_the_jax_layout(models):
    _, jparams, cfg, _ = models
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    jflat = dict(flat(jax.tree.map(np.asarray, jparams)))
    tflat = dict(flat(mine))
    assert tflat.keys() == jflat.keys()
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape and v.dtype == torch.float32
    assert torch.all(mine["layers"]["D"] == 1)
    assert torch.all(mine["layers"]["A_log"] == 0)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_logits_and_states_match_jax(models, use_kernel):
    """Ragged rows in one 24-token bucket walked in three 8-token chunks
    (``ssm_chunk=8`` on both sides, so the state carry runs):
    last-true-token logits and every layer's (conv, ssm) state."""
    jcfg, jparams, cfg, params = models
    jcfg, cfg = jcfg.replace(ssm_chunk=8), cfg.replace(ssm_chunk=8)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    tl = np.array([24, 11, 1], np.int32)
    logits, cache = M.prefill(cfg, params, {"tokens": _t(tok)}, 64,
                              true_len=_t(tl), use_kernel=use_kernel)
    jlogits, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(tok)},
                                 64, true_len=jnp.asarray(tl))
    _close(logits, jlogits)
    for k in ("conv", "ssm"):
        _close(cache["layers"][k], jcache["layers"][k])


def test_prefill_paged_writes_rows_at_slots(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tl = np.array([16, 7], np.int32)
    slots = np.array([3, 1], np.int32)
    cache = M.init_paged_cache(cfg, 4, 64, 8, 16, device="cpu")
    jcache = JM.init_paged_cache(jcfg, 4, 64, 8, 16)
    logits, out = M.prefill_paged(cfg, params, {"tokens": _t(tok)}, 64,
                                  cache, slots=_t(slots), true_len=_t(tl))
    jlogits, jout = JM.prefill_paged(jcfg, jparams,
                                     {"tokens": jnp.asarray(tok)}, 64,
                                     jcache, slots=jnp.asarray(slots),
                                     true_len=jnp.asarray(tl))
    assert out is cache
    _close(logits, jlogits)
    for k in ("conv", "ssm"):
        _close(out["layers"][k], jout["layers"][k])
    assert not out["layers"]["ssm"][:, [0, 2]].any()
    with pytest.raises(ValueError, match="no paged KV"):
        M.prefill_paged(cfg, params, {"tokens": _t(tok)}, 64, cache,
                        slots=_t(slots), write_tables=_t(slots[:, None]))


def test_decode_steps_match_forward_and_jax(models):
    """Prefill 7 tokens, decode 5 more one at a time: each step's logits
    equal the full-sequence forward's at that position, and JAX's
    decode logits and states."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    full = M.forward(cfg, params, _t(tok))
    jfull = JM.apply(jcfg, jparams, {"tokens": jnp.asarray(tok)})[0]
    _close(full, jfull)
    _, cache = M.prefill(cfg, params, {"tokens": _t(tok[:, :7])}, 64)
    _, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(tok[:, :7])},
                           64)
    jdecode = jax.jit(lambda *a: JM.decode_step(jcfg, *a))
    for i in range(7, 12):
        pos = np.full((2,), i, np.int32)
        logits, out = M.decode_step(cfg, params, cache, _t(tok[:, i:i + 1]),
                                    _t(pos))
        jlogits, jcache = jdecode(jparams, jcache,
                                  jnp.asarray(tok[:, i:i + 1]),
                                  jnp.asarray(pos))
        assert out is cache
        torch.testing.assert_close(logits[:, 0], full[:, i], **TOL)
        _close(logits, jlogits)
    for k in ("conv", "ssm"):
        _close(cache["layers"][k], jcache["layers"][k])


def test_forward_use_kernel_matches_plain(models):
    _, _, cfg, params = models
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32))
    torch.testing.assert_close(M.forward(cfg, params, tok, use_kernel=True),
                               M.forward(cfg, params, tok), **TOL)


def test_extend_raises_as_in_jax(models):
    _, _, cfg, params = models
    cache = M.init_paged_cache(cfg, 2, 64, 8, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="cannot roll back"):
        M.extend_paged(cfg, params, cache, torch.zeros((2, 3), dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), None)
    assert not M.extendable(cfg) and not M.spec_decodable(cfg)


# ---------------------------------------------------------------------------
# the engine's pool-free path against the JAX engine
# ---------------------------------------------------------------------------

BASE = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16, 32), seed=3,
            prefix_cache=False)
FIFO = dict(BASE, policy="fifo")
ENGINE_CASES = {f"{pol}-{'kernel' if k else 'plain'}":
                (pol, dict(policy=pol, use_pallas_paged=k))
                for pol in ("fifo", "priority", "edf") for k in (False, True)}


def _prompts(vocab):
    """Prompt lengths around the 8/16/32 buckets, two past the largest
    (47 and 70 tokens catch up through decode waves)."""
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (25, 5, 32, 47, 3, 70, 12)]


def _traffic(request_cls, vocab):
    return [request_cls(uid=uid, prompt=p, max_new_tokens=6,
                        priority=uid % 3, deadline=float(uid))
            for uid, p in enumerate(_prompts(vocab))]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine per policy (it ignores ``use_pallas_paged`` on this
    family): {policy: (engine, tokens)}, filled on first use."""
    return {}


@pytest.fixture(scope="module", params=list(ENGINE_CASES))
def ssm_replay(request, models, jax_runs):
    jcfg, jparams, cfg, params = models
    policy, kw = ENGINE_CASES[request.param]
    if policy not in jax_runs:
        jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**BASE, policy=policy))
        jax_runs[policy] = (jeng, _drain(jeng, _traffic(JaxRequest,
                                                        jcfg.vocab_size)))
    jeng, jtok = jax_runs[policy]
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE, **kw),
                            device="cpu")
    tok = _drain(eng, _traffic(Request, cfg.vocab_size))
    return request.param, jeng, jtok, eng, tok


@pytest.fixture(scope="module")
def fifo_tokens(models):
    """The undisturbed fifo run's tokens, shared by the tests below."""
    _, _, cfg, params = models
    return _drain(EdgeServingEngine(cfg, params, ServeConfig(**FIFO),
                                    device="cpu"),
                  _traffic(Request, cfg.vocab_size))


def test_ssm_engine_tokens_match_jax(ssm_replay):
    case, _, jtok, _, tok = ssm_replay
    assert len(tok) == 7 and all(len(v) == 6 for v in tok.values())
    assert tok == jtok, f"token drift vs the JAX pool-free engine ({case})"


def test_ssm_engine_stats_match_jax(ssm_replay):
    """Same keys (no pool gauges) and values; catch-up rode the decode
    waves (``mixed_waves``)."""
    case, jeng, _, eng, _ = ssm_replay
    assert not jeng.paged and not eng.paged and eng.pool is None
    stats = eng.stats()
    assert stats == jeng.stats(), case
    assert "pool_blocks" not in stats and stats["mixed_waves"] > 0
    assert eng.decode_waves == eng.steps and eng.extend_waves == 0


def test_ssm_engine_disarms_int8_and_ignores_spec(models, fifo_tokens):
    """``quant_kv="int8"`` has no pages to quantize and ``spec_decode``
    cannot roll the recurrence back: both serve the vanilla tokens, as
    in JAX; ``stats()`` shows no quant keys and an idle speculator."""
    _, _, cfg, params = models
    ref_tok = fifo_tokens
    q = EdgeServingEngine(cfg, params, ServeConfig(**FIFO, quant_kv="int8"),
                          device="cpu")
    assert not q.paged and not q.quant
    assert _drain(q, _traffic(Request, cfg.vocab_size)) == ref_tok
    assert not any(k.startswith("quant") for k in q.stats())
    s = EdgeServingEngine(cfg, params, ServeConfig(**FIFO, spec_decode=True),
                          device="cpu")
    assert s.spec is None
    assert _drain(s, _traffic(Request, cfg.vocab_size)) == ref_tok
    assert s.stats()["spec_active"] is False
    d = EdgeServingEngine(cfg, params, ServeConfig(**FIFO, paged=False),
                          device="cpu")
    assert _drain(d, _traffic(Request, cfg.vocab_size)) == ref_tok


def test_ssm_preempt_resume_is_exact(models, fifo_tokens):
    """A slot preempted mid-catch-up or mid-decode takes its state rows
    with it (``extract_slot``) and resumes (``insert_slot``) to the
    undisturbed run's tokens."""
    _, _, cfg, params = models
    ref_tok = fifo_tokens
    eng = EdgeServingEngine(cfg, params, ServeConfig(**FIFO), device="cpu")
    for r in _traffic(Request, cfg.vocab_size):
        eng.submit(r)
    for _ in range(3):
        eng.drain_step()
    for slot in np.flatnonzero(eng.active):
        req = eng.preempt(int(slot))
        assert "blocks" not in req.saved_state
        assert req.saved_state["cache"]["layers"]["ssm"].shape[1] == 1
        eng.cache["layers"]["ssm"][:, int(slot)] = 7.0   # the slot is reused
        eng.queue.append(req)
    eng.run_until_drained()
    assert {r.uid: tuple(r.generated) for r in eng.completed} == ref_tok


def test_ssm_cancel_in_every_phase(models, fifo_tokens):
    """Cancel a queued request, a slot mid-catch-up and a decoding slot;
    the others still finish with the undisturbed run's tokens."""
    _, _, cfg, params = models
    ref_tok = fifo_tokens
    eng = EdgeServingEngine(cfg, params, ServeConfig(**FIFO), device="cpu")
    reqs = _traffic(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.drain_step()
    assert eng.cancel(eng.queue[-1].uid)
    for _ in range(60):
        eng.drain_step()
        live = [(s, eng.slot_req[s].uid) for s in range(3) if eng.active[s]]
        catching = [u for s, u in live if eng.pending[s] is not None
                    and eng.pending[s].size]
        decoding = [u for _, u in live if u not in catching]
        if catching and decoding:
            break
    else:
        pytest.fail("no wave had a catching and a decoding slot together")
    for uid in (catching[0], decoding[0]):
        assert eng.cancel(uid)
    eng.run_until_drained()
    assert eng.cancels == len(eng.cancelled) == 3
    assert len(eng.completed) + len(eng.cancelled) == len(reqs)
    for r in eng.completed:
        assert tuple(r.generated) == ref_tok[r.uid]
