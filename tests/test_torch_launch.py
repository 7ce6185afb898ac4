"""The port's launch layer against the JAX package's: sharding rules,
input specs, the cost trace, the sequence-parallel branch and the three
step builders (the port's ``tests/test_launch.py``, plus parity).

Rule checks run on ``AbstractMesh``es of the production shapes (16, 16)
and (2, 16, 16): no process group.  The builders run on the CPU's (1, 1)
mesh of ``mesh.make_local_mesh("cpu")`` (gloo, world size 1, one
module-scoped group destroyed at the module's end), against JAX's
builders on JAX's one-device local mesh, at the phi3-medium-14b smoke
config at float32 on bridged weights.

Tolerances: specs are compared leaf for leaf, exactly.  The sequence-
parallel branch within rtol = atol = 1e-5 (the same float32 walk in two
frameworks).  Prefill and decode logits within 1e-5 x max |logit|, the
train steps' losses and gradient norms within 1e-4 relative (the
backward sums over every position, as ``tests/test_torch_training.py``
holds them); greedy tokens exactly.  The port's dot FLOPs of a prefill
within 5% of JAX's ``analyze_hlo`` (the two count 2 x M x N x K per
product; they differ only where one framework rewrites a product).
Serially this file takes about 30 s, most of it JAX tracing the full
configs' shapes and compiling the three JAX steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate
from torch.utils._pytree import tree_leaves, tree_leaves_with_path, tree_map

from repro.compat import abstract_mesh as jax_abstract_mesh
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as JD
from repro.launch import hlo_analysis as JH
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import trainer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 applicable, get_config, get_smoke_config)
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (abstract_mesh, close_mesh,
                                     make_local_mesh, mesh_devices)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.model import TensorSpec
from repro_torch.training import optimizer as O
from repro_torch.training import trainer as TR

MESH = abstract_mesh((16, 16), ("data", "model"))
MESH3 = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
JMESH = jax_abstract_mesh((16, 16), ("data", "model"))
JMESH3 = jax_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
SMOKE = "phi3-medium-14b"


def _leaves(tree):
    return tree_leaves(tree, is_leaf=SH.is_shaped)


def _shapes(cfg):
    return SP.shapes(M.init_params(cfg, None, "meta"))


def _check_divisible(shape_tree, spec_tree, mesh):
    def ok(leaf, spec):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            size = SH._axsize(mesh, ax)
            assert leaf.shape[dim] % size == 0, \
                f"{leaf.shape} dim {dim} not divisible by {ax}={size}"
    tree_map(ok, shape_tree, spec_tree, is_leaf=SH.is_shaped)


def _keys(path):
    return tuple(getattr(e, "key", getattr(e, "idx", None)) for e in path)


def _tflat(tree):
    """{path: spec tuple} of a port spec tree."""
    return {_keys(p): tuple(s) for p, s in tree_leaves_with_path(tree)}


def _jflat(tree):
    """{path: spec tuple} of a JAX spec tree, in the port's path form."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JSH.P))[0]
    return {_keys(p): tuple(s) for p, s in leaves}


# ---------------------------------------------------------------------------
# the rules (the port's tests/test_launch.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", [MESH, MESH3], ids=["single", "multi"])
def test_param_specs_divisible_all_archs(arch, mesh):
    cfg = get_config(arch)
    shapes = _shapes(cfg)
    for fsdp in (False, True):
        specs = SH.param_pspecs(cfg, mesh, shapes, fsdp=fsdp)
        _check_divisible(shapes, specs, mesh)


@pytest.mark.parametrize("arch", ["gemma3-1b", "kimi-k2-1t-a32b",
                                  "mamba2-370m", "zamba2-7b"])
def test_param_specs_actually_shard_big_tensors(arch):
    """Every >=2D tensor with a mesh-divisible dim must not be fully
    replicated (memory correctness at 1T scale)."""
    cfg = get_config(arch)
    shapes = _shapes(cfg)
    specs = SH.param_pspecs(cfg, MESH, shapes, fsdp=False)
    big_replicated = [
        (s.shape, sp) for s, sp in zip(_leaves(shapes), _leaves(specs))
        if np.prod(s.shape) * 4 > 256e6 and all(a is None for a in sp)]
    assert not big_replicated, f"large replicated tensors: {big_replicated}"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_cache_and_batch_specs_divisible(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    cfg = M.specialize(get_config(arch), shape)
    ok, _ = applicable(cfg, shape)
    if not ok:
        pytest.skip("documented skip")
    specs = SP.input_specs(cfg, shape)
    if shape.kind == "decode":
        cspecs = SH.cache_pspecs(cfg, MESH, specs["cache"],
                                 shape.global_batch)
        _check_divisible(specs["cache"], cspecs, MESH)
    else:
        bspecs = SH.batch_pspecs(cfg, MESH, specs)
        _check_divisible(specs, bspecs, MESH)


def test_input_specs_are_abstract():
    """Every leaf is a ``TensorSpec`` (shape and dtype, nothing
    allocated: the cache's shapes come from the meta device), the same
    shapes as JAX's ``ShapeDtypeStruct``s."""
    cfg = get_config("gemma3-1b")
    specs = SP.input_specs(cfg, INPUT_SHAPES["decode_32k"])
    leaves = _leaves(specs)
    assert leaves and all(isinstance(x, TensorSpec) for x in leaves)
    theirs = JSP.input_specs(jax_get_config("gemma3-1b"),
                             INPUT_SHAPES["decode_32k"])
    assert sorted(tuple(x.shape) for x in leaves) == sorted(
        tuple(x.shape) for x in jax.tree.leaves(theirs))


# ---------------------------------------------------------------------------
# the cost trace (the port's HLO analysis)
# ---------------------------------------------------------------------------

def test_flop_counter_counts_every_trip():
    """Dot FLOPs of each trip of a 5-step loop are counted: eager mode
    runs every trip, so nothing is scaled."""
    x = torch.randn(16, 64)
    ws = torch.randn(5, 64, 64)

    def f(x, ws):
        h = x
        for i in range(5):
            h = torch.tanh(h @ ws[i])
        return h.sum()
    _, traced = H.trace(f, x, ws)
    assert H.analyze_hlo(traced).flops == pytest.approx(2 * 16 * 64 * 64 * 5,
                                                        rel=0.05)


def test_trace_bytes_sane():
    a, b = torch.randn(128, 256), torch.randn(256, 128)
    _, traced = H.trace(lambda a, b: a @ b, a, b)
    lo = (128 * 256 + 256 * 128 + 128 * 128) * 4
    assert lo * 0.9 <= H.analyze_hlo(traced).bytes <= lo * 3
    rows = H.breakdown(traced)["by_flops"]
    assert rows[0]["op"] == "aten.mm.default" and rows[0]["calls"] == 1


def test_shape_bytes():
    assert H.shape_bytes(TensorSpec((128, 256), torch.float32)) \
        == 128 * 256 * 4
    assert H.shape_bytes(torch.zeros(8, dtype=torch.bfloat16)) == 16
    assert H.shape_bytes((TensorSpec((2, 2), torch.float32),
                          TensorSpec((4,), torch.int32))) == 16 + 16
    assert H.shape_bytes(TensorSpec((), torch.bool)) == 1


def test_applicability_documented_skips():
    skipped = []
    for arch in ARCH_IDS:
        ok, why = applicable(get_config(arch), INPUT_SHAPES["long_500k"])
        if not ok:
            skipped.append(arch)
            assert why
    assert set(skipped) == {"whisper-base", "internvl2-76b",
                            "kimi-k2-1t-a32b", "granite-moe-1b-a400m",
                            "phi3-medium-14b"}


# ---------------------------------------------------------------------------
# parity: the specs leaf for leaf
# ---------------------------------------------------------------------------

def _jax_shapes(fn):
    return jax.eval_shape(fn)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch):
    """param / opt (float32 and int8 moments) / batch / cache specs equal
    JAX's leaf for leaf on both production meshes, with fsdp and smart
    on and off."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    key = jax.random.PRNGKey(0)
    jshapes = _jax_shapes(lambda: JM.init_params(jcfg, key))
    shapes = _shapes(cfg)
    for jm, tm in ((JMESH, MESH), (JMESH3, MESH3)):
        for fsdp in (False, True):
            for smart in (False, True):
                kw = dict(fsdp=fsdp, smart=smart)
                assert _tflat(SH.param_pspecs(cfg, tm, shapes, **kw)) \
                    == _jflat(JSH.param_pspecs(jcfg, jm, jshapes, **kw))
        for moments in ("float32", "int8"):
            jt = JT.TrainConfig(optimizer=JO.OptimizerConfig(
                moments_dtype=moments))
            tt = TR.TrainConfig(optimizer=O.OptimizerConfig(
                moments_dtype=moments))
            jst = _jax_shapes(lambda: JT.init_train_state(jcfg, jt, key))
            st = SP.shapes(TR.init_train_state(cfg, tt, None, "meta"))
            for fsdp in (False, True):
                jp = JSH.param_pspecs(jcfg, jm, jst["params"], fsdp=fsdp)
                tp = SH.param_pspecs(cfg, tm, st["params"], fsdp=fsdp)
                assert _tflat(SH.opt_pspecs(tp, st["opt"], tm)) \
                    == _jflat(JSH.opt_pspecs(jp, jst["opt"], jm))
        for name, shape in INPUT_SHAPES.items():
            scfg, sjcfg = M.specialize(cfg, shape), JM.specialize(jcfg,
                                                                   shape)
            if not applicable(scfg, shape)[0]:
                continue
            if shape.kind != "decode":
                assert _tflat(SH.batch_pspecs(
                    scfg, tm, M.batch_shapes(scfg, shape))) == _jflat(
                    JSH.batch_pspecs(sjcfg, jm, JM.batch_shapes(sjcfg,
                                                                shape)))
                continue
            B = shape.global_batch
            cache = SP.input_specs(scfg, shape)["cache"]
            jcache = _jax_shapes(lambda: JM.init_cache(sjcfg, B,
                                                       shape.seq_len))
            for smart in (False, True):
                assert _tflat(SH.cache_pspecs(scfg, tm, cache, B,
                                              smart=smart)) \
                    == _jflat(JSH.cache_pspecs(sjcfg, jm, jcache, B,
                                               smart=smart)), name


def test_chip_smoke_golden_specs_are_jax():
    """``chip_smoke.py``'s ``LAUNCH_GOLDEN_SPECS`` (phi3-medium-14b on the
    (16, 16) mesh, the table its broken rule must miss) are JAX's."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jcfg = jax_get_config(SMOKE)
    jspecs = JSH.param_pspecs(jcfg, JMESH, _jax_shapes(
        lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
    assert {"/".join(p): s for p, s in _jflat(jspecs).items()} \
        == mod.LAUNCH_GOLDEN_SPECS


# ---------------------------------------------------------------------------
# parity: the sequence-parallel branch and the builders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def local_mesh():
    mesh = make_local_mesh("cpu")
    yield mesh
    close_mesh()


def test_local_mesh_is_one_device(local_mesh):
    assert local_mesh.mesh_dim_names == ("data", "model")
    assert tuple(local_mesh.mesh.shape) == (1, 1)
    assert mesh_devices(local_mesh) == 1 and MESH.size == 256
    assert mesh_devices(MESH3) == 512


@pytest.mark.parametrize("route", ["plain", "dtensor"])
def test_seq_parallel_matches_jax(monkeypatch, local_mesh, route):
    """n = 2 shards of S = 2048 at chunk 1024 against JAX's branch with
    the knob set on its one-device mesh; the port's plain tensors walk
    the shards in turn, its DTensors (on the local mesh) by placement.
    ``tests/test_torch_sharded.py`` holds the DTensor route on meshes
    that shard."""
    rng = np.random.default_rng(3)
    B, S, K, G, hd = 1, 2048, 1, 2, 16
    qg = rng.standard_normal((B, S, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    jmesh = jax_local_mesh()
    spec = JSH.P(None, "model", None, None, None, None)
    monkeypatch.setattr(JL, "SEQ_PARALLEL_ATTN",
                        (2, JSH.NamedSharding(jmesh, spec)))
    theirs = JL._blockwise_causal_attention(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), 0.25, 5.0,
        chunk=1024)
    layout = None
    args = [torch.from_numpy(a) for a in (qg, k, v)]
    if route == "dtensor":
        layout = SH.named(local_mesh, SH.P(None, "model", None, None,
                                           None, None))
        args = [SH.distribute(a, local_mesh, SH.P(*([None] * a.dim())))
                for a in args]
    offsets = []
    inner = L._blockwise_inner

    def recording(*a, q_offset=0, **kw):
        offsets.append(q_offset)
        return inner(*a, q_offset=q_offset, **kw)
    monkeypatch.setattr(L, "_blockwise_inner", recording)
    monkeypatch.setattr(L, "SEQ_PARALLEL_ATTN", (2, layout))
    mine = L._blockwise_causal_attention(*args, 0.25, 5.0, chunk=1024)
    assert offsets == [0, 1024]
    mine = SH.gather(mine)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                               rtol=1e-5, atol=1e-5)


def _smoke():
    return (jax_smoke_config(SMOKE).replace(dtype="float32"),
            get_smoke_config(SMOKE).replace(dtype="float32"))


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = _smoke()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(_np(jparams), "cpu")
    return jcfg, jparams, cfg, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def test_build_prefill_and_serve_match_jax(local_mesh, bridged):
    jcfg, jparams, cfg, params = bridged
    jmesh = jax_local_mesh()
    # prefill: 2 rows of 32 tokens
    shape = InputShape("t", 32, 2, "prefill")
    toks = _tokens(1, 2, 32, cfg.vocab_size)
    jlogits, _ = JSP.build_prefill(jcfg, shape, jmesh).fn(
        jparams, {"tokens": jnp.asarray(toks)})
    built = SP.build_prefill(cfg, shape, local_mesh)
    logits, cache = built.fn(params, {"tokens": torch.from_numpy(toks)})
    # the one-device mesh holds every tensor whole
    assert all(isinstance(p, Replicate)
               for p in built.out_shardings[0].placements)
    logits = SH.gather(logits)
    theirs = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), theirs, rtol=0,
                               atol=1e-5 * np.abs(theirs).max())
    assert np.array_equal(logits.numpy().argmax(-1), theirs.argmax(-1))
    # decode: one step of 2 rows at position 16 of a 32-long cache
    shape = InputShape("d", 32, 2, "decode")
    prompt = _tokens(2, 2, 16, cfg.vocab_size)
    jl0, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)},
                             32)
    tok = np.asarray(jl0)[:, -1:].argmax(-1).astype(np.int32)
    pos = np.full((2,), 16, np.int32)
    tcache = params_from_numpy(_np(jcache), "cpu")   # JAX donates jcache
    jl, _ = JSP.build_serve(jcfg, shape, jmesh).fn(
        jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = SP.build_serve(cfg, shape, local_mesh).fn(
        params, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
    tl, theirs = SH.gather(tl).numpy(), np.asarray(jl)
    np.testing.assert_allclose(tl, theirs, rtol=0,
                               atol=1e-5 * np.abs(theirs).max())
    assert np.array_equal(tl.argmax(-1), theirs.argmax(-1))


def test_build_train_matches_jax(local_mesh, bridged):
    """Two steps of each package's ``build_train`` step (4 rows, 2
    micro-batches) from the same weights and batches."""
    jcfg, jparams, cfg, params = bridged
    shape = InputShape("t", 32, 4, "train")
    ocfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    jt = JT.TrainConfig(optimizer=JO.OptimizerConfig(**ocfg),
                        microbatches=2)
    tt = TR.TrainConfig(optimizer=O.OptimizerConfig(**ocfg),
                        microbatches=2)
    jbuilt = JSP.build_train(jcfg, shape, jax_local_mesh(), jt)
    built = SP.build_train(cfg, shape, local_mesh, tt)
    assert _leaves(built.args) and all(
        isinstance(x, TensorSpec) for x in _leaves(built.args[0]))
    jstate = {"params": jparams,
              "opt": JO.init_opt_state(jt.optimizer, jparams)}
    pp = params_from_numpy(_np(jparams), "cpu")
    state = {"params": pp, "opt": O.init_opt_state(tt.optimizer, pp)}
    for s in range(2):
        toks = JD.synthetic_tokens(JD.DataConfig(), cfg.vocab_size, 4, 32,
                                   s)
        jstate, jm = jbuilt.fn(jstate, {"tokens": jnp.asarray(toks[:, :-1]),
                                        "targets": jnp.asarray(toks[:, 1:])})
        t = torch.from_numpy(toks)
        state, m = built.fn(state, {"tokens": t[:, :-1],
                                    "targets": t[:, 1:]})
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(m[key]) - float(jm[key])) \
                <= 1e-4 * abs(float(jm[key])), (key, m, jm)


def test_prefill_dot_flops_match_jax(local_mesh, bridged):
    """Per-chip dot FLOPs of a smoke prefill: the port's trace against
    JAX's ``analyze_hlo`` of the compiled step, both on one device."""
    jcfg, jparams, cfg, params = bridged
    shape = InputShape("t", 64, 2, "prefill")
    jbuilt = JSP.build_prefill(jcfg, shape, jax_local_mesh())
    compiled = jbuilt.fn.lower(*jbuilt.args).compile()
    theirs = JH.analyze_hlo(compiled.as_text()).flops
    built = SP.build_prefill(cfg, shape, local_mesh)
    toks = torch.from_numpy(_tokens(4, 2, 64, cfg.vocab_size))
    _, traced = H.trace(built.fn, params, {"tokens": toks})
    assert theirs > 0
    assert H.analyze_hlo(traced).flops == pytest.approx(theirs, rel=0.05)
