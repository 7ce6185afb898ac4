"""The encdec family on the port (``repro_torch.models.encdec``) and its
layer functions against ``repro.models.encdec`` / ``repro.models.layers``
and the JAX engine.

The whisper-base smoke config at float32 (2 encoder and 2 decoder
layers of 128, 64 audio frames), the JAX weights bridged into the port.
Each check and its tolerance is in ``tests/_torch_extras.py``: model
outputs, logits and float pages within rtol 1e-5 / atol 1e-5 x max,
gradients within 1e-4; the engine's greedy tokens, ``stats()``, prefix
hits, hit tokens and persisted chains equal to the JAX engine's.  The
layer functions new to the port (``sinusoidal_positions``, the tanh
``gelu_mlp``, cross and non-causal ``attention_fwd``, the cross branch
of ``attention_decode``) are held on their own first.  About 80 s
serially on one intra-op thread, most of it the module-scoped JAX
engines.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_extras as X
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.data.pipeline import data_iterator
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig

torch.set_num_threads(1)

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def models():
    return X.bridge(ARCH)


def _layer0(models, key):
    """Decoder layer 0's ``key`` sub-tree, both sides."""
    _, jparams, _, params = models
    return (jax.tree.map(lambda a: a[0], jparams["decoder"][key]),
            T._layer(params["decoder"], 0)[key])


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, d", [(64, 128), (1500, 512), (7, 9)])
def test_sinusoidal_positions_match_jax(n, d):
    """The table against JAX's.  Its arguments are ``position x
    inv_timescale``: one float32 rounding step of ``exp`` in an
    inverse timescale (which XLA's and torch's ``exp`` may take apart)
    moves the argument by up to ``n x 2**-23`` at the last position, so
    the table is held within that (1.8e-4 at whisper's 1500 frames),
    and within 1e-5 where that is smaller."""
    mine = L.sinusoidal_positions(n, d).numpy()
    theirs = np.asarray(JL.sinusoidal_positions(n, d))
    assert mine.shape == theirs.shape == (n, 2 * (d // 2))
    assert np.abs(mine - theirs).max() <= max(X.REL, n * 2.0 ** -23)


def test_gelu_mlp_matches_jax_with_the_tanh_gelu(models):
    """``gelu_mlp`` with nonzero biases against JAX's; the exact erf GELU
    would sit outside the tolerance on these inputs."""
    jp, p = _layer0(models, "mlp")
    rng = np.random.default_rng(0)
    jp = dict(jp, b_in=jnp.asarray(rng.normal(0, 1, jp["b_in"].shape)
                                   .astype(np.float32)))
    p = dict(p, b_in=torch.from_numpy(np.array(jp["b_in"])))
    x = rng.normal(0, 3, (2, 5, p["w_in"].shape[0])).astype(np.float32)
    theirs = JL.gelu_mlp(jp, jnp.asarray(x))
    X.close(L.gelu_mlp(p, torch.from_numpy(x)), theirs)
    h = F.gelu(torch.from_numpy(x) @ p["w_in"] + p["b_in"])
    with pytest.raises(AssertionError):
        X.close(h @ p["w_out"] + p["b_out"], theirs)
    _, _, cfg, _ = models
    init = L.init_gelu_mlp(cfg, torch.Generator().manual_seed(0),
                           stack=(3,))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "w_in": (3, 128, 256), "b_in": (3, 256), "w_out": (3, 256, 128),
        "b_out": (3, 128)}
    assert float(init["b_in"].abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["cross", "non_causal"])
def test_attention_fwd_cross_and_non_causal_match_jax(models, mode):
    """``attention_fwd`` with a cross-attention source ``kv_x`` (18 keys
    for 5 queries, nothing rotated) and with ``causal=False`` (the
    encoder): output and the returned k / v."""
    jcfg, _, cfg, _ = models
    jp, p = _layer0(models, "cross_attn")
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    src = rng.normal(0, 1, (2, 18, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    kw = (dict(kv_x=src) if mode == "cross" else dict(causal=False))
    theirs = JL.attention_fwd(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              is_global=True,
                              **{k: jnp.asarray(v) if k == "kv_x" else v
                                 for k, v in kw.items()})
    mine = L.attention_fwd(cfg, p, torch.from_numpy(x),
                           torch.from_numpy(pos), is_global=True,
                           **{k: torch.from_numpy(v) if k == "kv_x" else v
                              for k, v in kw.items()})
    for a, b, what in zip(mine, theirs, ("out", "k", "v")):
        X.close(a, b, what=what)
    if mode == "cross":
        assert mine[1].shape[1] == 18
    causal = L.attention_fwd(cfg, p, torch.from_numpy(x),
                             torch.from_numpy(pos), is_global=True)[0]
    if mode == "non_causal":
        assert float((causal - mine[0]).abs().max()) > 1e-3


def test_cross_attention_decode_matches_jax(models):
    """``attention_decode``'s ``cross_kv`` branch: the query attends all
    entries, nothing is written, the cache comes back untouched."""
    jcfg, _, cfg, _ = models
    jp, p = _layer0(models, "cross_attn")
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    ck = rng.normal(0, 1, (3, 20, cfg.num_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    cv = rng.normal(0, 1, ck.shape).astype(np.float32)
    pos = np.array([3, 0, 11], np.int32)
    cache = L.init_kv_cache(cfg, 3, 16, device="cpu")
    before = {k: v.clone() for k, v in cache.items()}
    out, ret = L.attention_decode(cfg, p, torch.from_numpy(x), cache,
                                  torch.from_numpy(pos), is_global=True,
                                  cross_kv=(torch.from_numpy(ck),
                                            torch.from_numpy(cv)))
    jout, _ = JL.attention_decode(jcfg, jp, jnp.asarray(x),
                                  JL.init_kv_cache(jcfg, 3, 16),
                                  jnp.asarray(pos), is_global=True,
                                  cross_kv=(jnp.asarray(ck), jnp.asarray(cv)))
    X.close(out, jout)
    assert ret is cache
    assert all(torch.equal(cache[k], before[k]) for k in cache)


def test_encode_matches_jax(models):
    jcfg, jparams, cfg, params = models
    audio = X.batch_extras(cfg, np.random.default_rng(3), 2)
    X.close(encdec.encode(cfg, params, torch.from_numpy(audio)),
            JE.encode(jcfg, jparams, jnp.asarray(audio)))


def test_params_and_caches_match_jax(models):
    jcfg, jparams, cfg, _ = models
    mine = dict(X.flat(encdec.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")))
    theirs = dict(X.flat(jax.tree.map(np.asarray, jparams)))
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        assert tuple(v.shape) == theirs[k].shape, k
    for kv in (None, "int8"):
        c = M.init_paged_cache(cfg, 3, 64, 10, 8, kv_dtype=kv, device="cpu")
        jc = JM.init_paged_cache(jcfg, 3, 64, 10, 8, kv_dtype=kv)
        assert {k: tuple(v.shape) for k, v in X.flat(c)} == \
            {k: v.shape for k, v in X.flat(jc)}
    assert M.init_params(cfg.replace(param_dtype="bfloat16"),
                         torch.Generator().manual_seed(0), "cpu")[
        "decoder"]["mlp"]["w_in"].dtype == torch.bfloat16


def test_batch_shapes_and_data_match_jax():
    cfg = get_smoke_config(ARCH)
    from repro.configs import InputShape as JShape
    from repro.configs import get_smoke_config as jsc
    shape = InputShape("smoke", 32, 2, "train")
    mine = M.batch_shapes(cfg, shape)
    theirs = JM.batch_shapes(jsc(ARCH), JShape("smoke", 32, 2, "train"))
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
    step = next(data_iterator(cfg, shape, device="cpu"))
    assert step["audio_embeds"].shape == (2, 64, 128)
    assert step["tokens"].shape == (2, 32)


# ---------------------------------------------------------------------------
# the model API
# ---------------------------------------------------------------------------

def test_forward_loss_and_gradients_match_jax(models):
    grads = X.check_forward_and_loss(models)
    assert float(grads["decoder.cross_attn.wk"].abs().max()) > 0
    assert float(grads["encoder.mlp.b_in"].abs().max()) > 0


def test_prefill_and_decode_match_jax(models):
    X.check_prefill_and_decode(models)


@pytest.mark.parametrize("kv_dtype, use_pallas",
                         [(None, False), (None, True), ("int8", True)])
def test_paged_entry_points_match_jax(models, kv_dtype, use_pallas):
    X.check_paged_entry_points(models, kv_dtype, use_pallas)


def test_dense_admission_and_extend_match_jax(models):
    X.check_dense_admission_and_extend(models)


def test_positions_past_the_table_read_its_last_row(models):
    """A decoder position past ``max_target_positions`` (64 here) reads
    the table's last row, as the JAX gather clamps."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(9)
    audio = X.batch_extras(cfg, rng, 2)
    toks = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    jlog, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                          "audio_embeds": jnp.asarray(audio)},
                          96)
    log, c = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks),
                                     "audio_embeds": torch.from_numpy(audio)},
                       96)
    pos = np.array([70, 90], np.int32)
    tok = toks[:, :1]
    jlog, _ = JM.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                             jnp.asarray(pos))
    log, _ = M.decode_step(cfg, params, c, torch.from_numpy(tok),
                           torch.from_numpy(pos))
    X.close(log, jlog)


def test_decode_matches_forward(models):
    X.check_decode_matches_forward(models)


def test_padded_admission_matches_reference(models):
    X.check_padded_admission(models)


@pytest.fixture(scope="module", params=list(X.ENGINE_CASES))
def replay(request, models):
    return (request.param,) + X.replay(models, request.param)


def test_encdec_engine_tokens_match_jax_engine(replay):
    case, _, jtok, _, tok = replay
    assert len(tok) == len(X.LENS)
    assert tok == jtok, f"token drift vs the JAX engine ({case})"


def test_encdec_engine_stats_match_jax_engine(replay):
    case, jeng, _, eng, _ = replay
    assert eng.stats() == jeng.stats(), case
    if eng.paged:
        eng.pool.assert_consistent()


def test_shared_audio_hits_like_jax(models):
    """Traffic where every odd request reuses uid 0's audio and first 12
    prompt tokens: the hits rebuild the cross K/V from the audio, and
    the tokens and ``stats()`` are the JAX engine's."""
    jeng, jtok, eng, tok = X.replay(models, "fifo", shared=True)
    assert tok == jtok
    assert eng.stats() == jeng.stats()
    assert eng.prefix_cache.hits >= 1


def test_prefix_hit_equals_cold_and_jax(models):
    X.check_hit_equals_cold_and_jax(models)


def test_different_audio_never_shares(models):
    X.check_different_extras_never_share(models)


def test_restart_warm_equals_cold_and_jax(models, tmp_path):
    X.check_restart_warm(models, str(tmp_path / "encdec"))


def test_spec_greedy_equals_vanilla(models):
    X.check_spec_equals_vanilla(models)


def test_engine_other_families_whisper():
    """``tests/test_serving.py::test_engine_other_families[whisper-base]``
    on the port: three requests with audio, each generating its 4
    tokens."""
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        max_slots=2, max_len=64, prefill_buckets=(8,)), device="cpu")
    rng = np.random.default_rng(0)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 6, dtype=np.int32), max_new_tokens=4,
            extras={"audio_embeds": rng.normal(
                0, 0.1, (cfg.encoder_seq, cfg.d_model)).astype(np.float32)}))
    done = eng.run_until_drained()
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)


def test_make_requests_match_jax():
    X.check_make_requests(ARCH)


def test_serve_cli_runs_whisper_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "3", "--mode", "drain"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert out["requests"] == 3 and out["tokens"] == 9
