"""The vlm family on the port (``repro_torch.models.vlm``) against
``repro.models.vlm`` and the JAX engine.

The internvl2-76b smoke config at float32 (16 image tokens of 96, a
2-layer trunk), the JAX weights bridged into the port.  Each check and
its tolerance is in ``tests/_torch_extras.py``: model outputs, logits
and float pages within rtol 1e-5 / atol 1e-5 x max, gradients within
1e-4; the engine's greedy tokens, ``stats()``, prefix hits, hit tokens
and persisted chains equal to the JAX engine's.  The image takes the
first 16 positions of a slot's pages; its chains live in a namespace
digested from the image's bytes, and a match that does not cover the
image is a miss.  About 55 s serially on one intra-op thread, most of
it the module-scoped JAX engines.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_extras as X
from repro.models import vlm as JV
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.data.pipeline import data_iterator
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import vlm
from repro_torch.serving import (EdgeServingEngine, Request, ServeConfig,
                                 make_self_draft)

torch.set_num_threads(1)

ARCH = "internvl2-76b"


@pytest.fixture(scope="module")
def models():
    return X.bridge(ARCH)


def test_project_matches_jax_with_the_tanh_gelu(models):
    """The projector (rmsnorm, tanh GELU, two matmuls) against JAX's;
    the exact erf GELU would sit outside the tolerance on these
    inputs."""
    jcfg, jparams, cfg, params = models
    img = X.batch_extras(cfg, np.random.default_rng(0), 2) * 30.0
    theirs = JV.project(jcfg, jparams, jnp.asarray(img))
    mine = vlm.project(cfg, params, torch.from_numpy(img))
    X.close(mine, theirs, what="project")
    p = params["projector"]
    x = torch.from_numpy(img)
    x = vlm.L.rmsnorm(p["ln"], x, cfg.norm_eps)
    erf = torch.matmul(F.gelu(torch.matmul(x, p["w1"])), p["w2"])
    with pytest.raises(AssertionError):
        X.close(erf, theirs, what="erf gelu")


def test_params_layout_matches_jax(models):
    _, jparams, cfg, _ = models
    mine = dict(X.flat(vlm.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu")))
    theirs = dict(X.flat(jax.tree.map(np.asarray, jparams)))
    assert mine.keys() == theirs.keys()
    for k, v in mine.items():
        assert tuple(v.shape) == theirs[k].shape, k
    bf = M.init_params(cfg.replace(param_dtype="bfloat16"),
                       torch.Generator().manual_seed(0), "cpu")
    assert bf["projector"]["w1"].dtype == torch.bfloat16
    assert bf["projector"]["ln"]["scale"].dtype == torch.float32


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
    batch = M.make_batch(cfg, shape, torch.Generator().manual_seed(0), "cpu")
    assert batch["image_embeds"].shape == (2, 16, 96)
    step = next(data_iterator(cfg, shape, device="cpu"))
    assert step["tokens"].shape == (2, 16)
    assert step["image_embeds"].shape == (2, 16, 96)
    assert step["image_embeds"].dtype == cfg.activation_dtype
    again = next(data_iterator(cfg, shape, device="cpu"))
    assert torch.equal(step["image_embeds"], again["image_embeds"])


def test_forward_loss_and_gradients_match_jax(models):
    grads = X.check_forward_and_loss(models)
    assert float(grads["projector.w1"].abs().max()) > 0


def test_prefill_and_decode_match_jax(models):
    X.check_prefill_and_decode(models)


@pytest.mark.parametrize("kv_dtype, use_pallas",
                         [(None, False), (None, True), ("int8", True)])
def test_paged_entry_points_match_jax(models, kv_dtype, use_pallas):
    X.check_paged_entry_points(models, kv_dtype, use_pallas)


def test_dense_admission_and_extend_match_jax(models):
    X.check_dense_admission_and_extend(models)


def test_decode_matches_forward(models):
    X.check_decode_matches_forward(models)


def test_padded_admission_matches_reference(models):
    X.check_padded_admission(models)


@pytest.fixture(scope="module", params=list(X.ENGINE_CASES))
def replay(request, models):
    return (request.param,) + X.replay(models, request.param)


def test_vlm_engine_tokens_match_jax_engine(replay):
    case, _, jtok, _, tok = replay
    assert len(tok) == len(X.LENS)
    assert tok == jtok, f"token drift vs the JAX engine ({case})"


def test_vlm_engine_stats_match_jax_engine(replay):
    case, jeng, _, eng, _ = replay
    assert eng.stats() == jeng.stats(), case
    if eng.paged:
        eng.pool.assert_consistent()


def test_shared_images_hit_like_jax(models):
    """Traffic where every odd request reuses uid 0's image and first 12
    prompt tokens: hits cover the image and more, and the tokens and
    ``stats()`` are the JAX engine's."""
    jeng, jtok, eng, tok = X.replay(models, "fifo", shared=True)
    assert tok == jtok
    assert eng.stats() == jeng.stats()
    st = eng.prefix_cache.stats()
    assert st["hits"] >= 1 and st["hit_tokens"] >= 16 * st["hits"]


def test_prefix_hit_equals_cold_and_jax(models):
    X.check_hit_equals_cold_and_jax(models)


def test_different_images_never_share(models):
    X.check_different_extras_never_share(models)


def test_match_shorter_than_the_image_is_a_miss(models):
    """A chain of the request's namespace that ends inside the image (10
    of 16 positions, one page) is a miss, and its hit is rolled back: the
    acquisition and the stats are the JAX engine's."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, 9, dtype=np.int32)
    e = X.extras(cfg, rng)
    out = []
    for eng, cls in ((EdgeServingEngine(cfg, params, ServeConfig(**X.SEQ),
                                        device="cpu"), Request),
                     (JaxEngine(jcfg, jparams, JaxServeConfig(**X.SEQ)),
                      JaxRequest)):
        req = cls(uid=0, prompt=prompt, max_new_tokens=3, extras=dict(e))
        blocks = eng.pool.alloc(1)
        key = eng._key_tokens(req)[:10]
        assert (key == -42).all()
        eng.prefix_cache.insert(key, blocks, namespace=eng._key_ns(req))
        eng._lookup(req)
        out.append((req._ctx_len, list(req._ctx_blocks),
                    eng.prefix_cache.stats(), eng.pool.num_free))
        eng.pool.assert_consistent()
    assert out[0] == out[1]
    assert out[0][0] == 0 and out[0][1] == []
    assert out[0][2]["hits"] == 0


def test_namespace_digest_equals_jax(models):
    jcfg, jparams, cfg, params = models
    e = X.extras(cfg, np.random.default_rng(5))
    mine = EdgeServingEngine(cfg, params, ServeConfig(**X.SEQ), device="cpu")
    theirs = JaxEngine(jcfg, jparams, JaxServeConfig(**X.SEQ))
    a = mine._key_ns(Request(uid=0, prompt=np.arange(3), extras=e))
    b = theirs._key_ns(JaxRequest(uid=0, prompt=np.arange(3), extras=e))
    assert a == b != 0
    assert mine._key_ns(Request(uid=1, prompt=np.arange(3))) == 0


def test_restart_warm_equals_cold_and_jax(models, tmp_path):
    X.check_restart_warm(models, str(tmp_path / "vlm"))


def test_spec_greedy_equals_vanilla(models):
    X.check_spec_equals_vanilla(models)


def test_self_draft_serves_the_vlm(models):
    """``make_self_draft`` takes the vlm stack: the one-layer self-draft
    prefills its own image prefix, and speculation changes no token."""
    _, _, cfg, params = models
    dcfg, dparams = make_self_draft(cfg, params)
    assert dcfg.num_layers == 1 and dparams["projector"] is params["projector"]
    base = X.drain(EdgeServingEngine(cfg, params, ServeConfig(**X.SPEC),
                                     device="cpu"),
                   X.spec_reqs(Request, cfg))
    eng = EdgeServingEngine(cfg, params, ServeConfig(spec_decode=True,
                                                     **X.SPEC),
                            device="cpu")
    assert X.drain(eng, X.spec_reqs(Request, cfg)) == base
    assert eng.spec.prefix == 16 and eng.spec_rounds >= 1


def test_submit_budget_counts_the_image(models):
    _, _, cfg, params = models
    eng = EdgeServingEngine(cfg, params, ServeConfig(max_slots=1, max_len=32,
                                                     prefill_buckets=(8,)),
                            device="cpu")
    e = X.extras(cfg, np.random.default_rng(0))
    eng.submit(Request(uid=0, prompt=np.arange(15, dtype=np.int32),
                       extras=e, max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=np.arange(16, dtype=np.int32),
                           extras=e, max_new_tokens=2))


def test_make_requests_match_jax():
    X.check_make_requests(ARCH)


def test_serve_cli_runs_the_vlm_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "3", "--mode", "drain"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert out["requests"] == 3 and out["tokens"] == 9
