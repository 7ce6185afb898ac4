"""The hub on the port (``repro_torch.core.hub``, ``repro_torch.core.context``)
against ``repro.core``: the default home, the shared-context space and
its gradients, and the three stories of ``tests/test_system.py`` (train
-> checkpoint -> serve; the hub's day; the private federation) held to
the JAX package's reports and tokens.

Tolerances: context logits, losses and gradients within rtol 1e-5 /
atol 1e-5 x max |value|, 150 SGD steps of the context space within
1e-4 (float32, the same math summed in another order); the trained
story's losses within 1e-4 relative at float32 activations and the
served greedy tokens equal; the hub's day (plain Python) equal with the
port's hub entry set to the JAX catalogue's.  The private federation
carries DP noise, whose draws are the port's own: its round is held to
JAX's by the trust-zone gate (equal clients) and by distribution (the
two rounds' params differ by two independent noises of sigma each).
About 45 s serially, most of it the JAX train step and engine and the
two clients' jitted local steps.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import InputShape
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import context as JCX
from repro.core import hub as JH
from repro.core import orchestrator as JO
from repro.core import perf_model as JP
from repro.core import trustzones as JTZ
from repro.data import DataConfig as JaxDataConfig
from repro.data import data_iterator as jax_data_iterator
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.training import federated as JF
from repro.training import optimizer as JOPT
from repro.training import trainer as JTR
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import context as CX
from repro_torch.core import hub as PH
from repro_torch.core import orchestrator as PO
from repro_torch.core import perf_model as PP
from repro_torch.core import trustzones as PTZ
from repro_torch.data import DataConfig, data_iterator
from repro_torch.serving import Request, ServeConfig
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import federated as fed
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as TR

torch.set_num_threads(1)

SENSORS = {"cam": 32, "mic": 16}
STATIC = ("_key", "shared_dim", "hidden")


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_default_home_on_the_port():
    reg, jreg = PH.default_home(), JH.default_home()
    assert reg.names() == jreg.names()
    for n in reg.names():
        h, j = reg.get(n), jreg.get(n)
        assert (h.zone, h.owner, h.available, h.load) == \
            (j.zone, j.owner, j.available, j.load)
        assert [c.name for c in h.link.channels] == \
            [c.name for c in j.link.channels]
        assert h.spec.name == j.spec.name
    assert reg.get("hub").spec is PP.DEVICE_CATALOGUE["edgeai-hub"]
    assert reg.get("hub").spec.memory_bytes == 80e9
    assert reg.available(train_capable=True) == ["hub"]
    assert reg.least_loaded() == jreg.least_loaded()
    reg.heartbeat("vacuum", 100.0, load=0.5, battery=0.2)
    assert reg.sweep(120.0) == [n for n in reg.names() if n != "vacuum"]
    assert reg.available() == ["vacuum"]


# ---------------------------------------------------------------------------
# shared context
# ---------------------------------------------------------------------------

def _to_numpy(tree):
    """A JAX tree's arrays as numpy; Python ints stay ints."""
    return jax.tree.map(lambda a: np.asarray(a) if isinstance(a, jax.Array)
                        else a, tree)


def _views(seed, n):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, n)
    views = {k: (rng.standard_normal((4, d))[labels]
                 + 0.7 * rng.standard_normal((n, d))).astype(np.float32)
             for k, d in SENSORS.items()}
    return views, labels.astype(np.int32)


@pytest.fixture(scope="module")
def context_pair():
    jp = JCX.init_context_space(jax.random.PRNGKey(0), SENSORS, 24, 4)
    JCX.add_task_head(jp, "intent", 4)
    tree = _to_numpy({k: v for k, v in jp.items() if k != "_key"})
    p = bridge.params_from_numpy(tree, device="cpu")
    assert "_key" not in p and p["shared_dim"] == 24 and p["hidden"] == 64
    p["_key"] = torch.Generator().manual_seed(0)     # the port's generator
    return jp, p


def test_context_logits_and_loss_equal_jax(context_pair):
    jp, p = context_pair
    views, labels = _views(0, 64)
    tv = {k: torch.from_numpy(v) for k, v in views.items()}
    jv = {k: jnp.asarray(v) for k, v in views.items()}
    for sub in (("cam", "mic"), ("cam",), ("mic",)):
        _close(CX.multiview_logits(p, "intent", {k: tv[k] for k in sub}),
               JCX.multiview_logits(jp, "intent", {k: jv[k] for k in sub}))
    _close(CX.embed_views(p, {**tv, "radar": tv["cam"]}),
           JCX.embed_views(jp, jv))
    _close(CX.context_loss(p, "intent", tv, torch.from_numpy(labels)),
           JCX.context_loss(jp, "intent", jv, jnp.asarray(labels)))
    with pytest.raises(ValueError):
        CX.embed_views(p, {"radar": tv["cam"]})


def test_context_gradients_and_training_equal_jax(context_pair):
    jp, p = context_pair
    views, labels = _views(1, 128)
    tv = {k: torch.from_numpy(v) for k, v in views.items()}
    jv = {k: jnp.asarray(v) for k, v in views.items()}
    tl, jl = torch.from_numpy(labels), jnp.asarray(labels)
    jstatic = {k: jp[k] for k in STATIC}
    grad = jax.jit(jax.grad(
        lambda q, v, y: JCX.context_loss({**q, **jstatic}, "intent", v, y)))
    jq = {k: v for k, v in jp.items() if k not in STATIC}
    q = {k: v for k, v in p.items() if k not in STATIC}
    static = {k: p[k] for k in STATIC}
    for step in range(150):
        g = grad(jq, jv, jl)
        leaves = [x.detach().requires_grad_() for x in opt.tree_leaves(q)]
        loss = CX.context_loss({**opt.tree_unflatten(q, leaves), **static},
                               "intent", tv, tl)
        tg = torch.autograd.grad(loss, leaves)
        if step == 0:
            for a, b in zip(tg, jax.tree.leaves(g)):
                _close(a, b)
        with torch.no_grad():
            q = opt.sgd_update(q, opt.tree_unflatten(q, list(tg)), 0.1)
        jq = JOPT.sgd_update(jq, g, 0.1)
    for a, b in zip(opt.tree_leaves(q), jax.tree.leaves(jq)):
        _close(a, b, rtol=1e-4)


def test_add_task_head_draws_from_the_generator():
    gen = torch.Generator().manual_seed(5)
    p = CX.init_context_space(gen, SENSORS, 24, 4, device="cpu")
    assert p["_key"] is gen and sorted(p["proj"]) == ["cam", "mic"]
    assert tuple(p["proj"]["mic"].shape) == (16, 24)
    CX.add_task_head(p, "intent", 4)
    CX.add_task_head(p, "intrusion", 3)
    assert tuple(p["heads"]["intrusion"].shape) == (64, 3)
    assert not torch.equal(p["heads"]["intent"][:, :3],
                           p["heads"]["intrusion"])
    q = CX.init_context_space(torch.Generator().manual_seed(5), SENSORS, 24,
                              4, device="cpu")
    CX.add_task_head(q, "intent", 4)
    assert torch.equal(p["heads"]["intent"], q["heads"]["intent"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CX.init_context_space(None, SENSORS, 24, 4)


# ---------------------------------------------------------------------------
# the stories of tests/test_system.py
# ---------------------------------------------------------------------------

def test_story_train_checkpoint_serve_equals_jax(tmp_path):
    """30 steps from bridged weights, a checkpoint round trip, then the
    hub deploys the trained model and serves 4 requests: losses within
    1e-4 of JAX's and the same greedy tokens (float32 activations)."""
    jcfg = jax_smoke_config("gemma3-1b").replace(dtype="float32")
    cfg = get_smoke_config("gemma3-1b").replace(dtype="float32")
    shape = InputShape("t", 64, 8, "train")
    ocfg = dict(learning_rate=3e-3, warmup_steps=5, total_steps=40)
    jt = JTR.TrainConfig(optimizer=JOPT.OptimizerConfig(**ocfg), remat=None)
    pt = TR.TrainConfig(optimizer=opt.OptimizerConfig(**ocfg), remat=None)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = TR._with_grad(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    jstate, jhist = JTR.train_loop(
        jcfg, jt, jax_data_iterator(jcfg, shape, JaxDataConfig(branching=2)),
        30, state={"params": jparams,
                   "opt": JOPT.init_opt_state(jt.optimizer, jparams)})
    state, hist = TR.train_loop(
        cfg, pt, data_iterator(cfg, shape, DataConfig(branching=2),
                               device="cpu"), 30,
        state={"params": params, "opt": opt.init_opt_state(pt.optimizer,
                                                           params)})
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    for a, b in zip(hist, jhist):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    assert hist[-1]["loss"] < hist[0]["loss"]

    path = os.path.join(tmp_path, "m.npz")
    ckpt.save(path, state["params"])
    with torch.no_grad():
        restored = ckpt.restore(path, state["params"])
    scfg = dict(max_slots=2, max_len=96, prefill_buckets=(8,))
    hub = PH.EdgeAIHub.create()
    eng = hub.deploy_model("assistant", cfg, restored, ServeConfig(**scfg),
                           device="cpu")
    assert hub.engines["assistant"] is eng
    jeng = JaxEngine(jcfg, jstate["params"], JaxServeConfig(**scfg))
    for uid in range(4):
        prompt = np.arange(4 + uid, dtype=np.int32)
        hub.serve("assistant", Request(uid=uid, prompt=prompt,
                                       max_new_tokens=6))
        jeng.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=6))
    done = {r.uid: r.generated for r in eng.run_until_drained()}
    jdone = {r.uid: r.generated for r in jeng.run_until_drained()}
    assert len(done) == 4 and done == jdone


def _day(hub_mod, orch_mod, tz, full):
    hub = hub_mod.EdgeAIHub.create(policy="edf")
    for i in range(8):
        hub.submit(orch_mod.TaskSpec(kind="stream", model=full, batch=1,
                                     seq=256, priority=5, deadline_rel=0.25,
                                     arrival=i * 0.05,
                                     source_device="living-room-tv"))
    hub.submit(orch_mod.TaskSpec(kind="inference", model=full, batch=16,
                                 seq=1024, priority=0, deadline_rel=30.0,
                                 source_device="alice-phone",
                                 data=tz.DataItem("gallery", "household",
                                                  "alice")))
    moved = hub.orchestrator.fail_device("vacuum")
    return hub.run(), moved, hub.orchestrator.scheduler.trace


def test_story_hub_day_equals_jax(monkeypatch):
    rep, moved, _ = _day(PH, PO, PTZ, get_config("gemma3-1b"))
    assert rep["completed"] == 9 and rep["miss_rate"] <= 0.25
    monkeypatch.setitem(PP.DEVICE_CATALOGUE, "edgeai-hub", PP.DeviceSpec(
        **dataclasses.asdict(JP.DEVICE_CATALOGUE["edgeai-hub"])))
    port = _day(PH, PO, PTZ, get_config("gemma3-1b"))
    assert port == _day(JH, JO, JTZ, jax_get_config("gemma3-1b"))


def test_story_private_federation_matches_jax():
    """test_system's round (SecAgg, clip 1.0, noise 0.01, bf16
    activations) on the port, JAX's without SecAgg (its eager per-leaf
    masks cost ~7 s a client on the CPU; masks cancel in either sum), from
    the same weights and tokens: the same two clients pass the trust-zone
    gate, params change, and the two results differ by the two rounds'
    independent DP noises: std sigma x sqrt(2) within 5% (bf16 rounding
    of the shared update is under 1% of sigma)."""
    jcfg, cfg = jax_smoke_config("gemma3-1b"), get_smoke_config("gemma3-1b")
    shape = InputShape("fl", 32, 4, "train")
    names = ["alice-phone", "living-room-tv", "bob-old-phone"]
    jdata = {n: [next(jax_data_iterator(jcfg, shape, JaxDataConfig(
        seed=i, branching=2)))] for i, n in enumerate(names)}
    data = {n: [next(data_iterator(cfg, shape, DataConfig(
        seed=i, branching=2), device="cpu"))] for i, n in enumerate(names)}
    kw = dict(local_steps=2, local_lr=0.3, dp_clip=1.0,
              dp_noise_multiplier=0.01, secure_aggregation=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    jnew, jinfo = JH.EdgeAIHub.create().federated_round(
        jcfg, JF.FedConfig(**dict(kw, secure_aggregation=False)), jparams,
        jdata,
        JTZ.DataItem("alice-voice", "personal", "alice"))
    new, info = PH.EdgeAIHub.create().federated_round(
        cfg, fed.FedConfig(**kw), params, data,
        PTZ.DataItem("alice-voice", "personal", "alice"))
    assert info["clients"] == jinfo["clients"] == [0, 1]
    assert any(not torch.equal(a, b) for a, b in zip(
        opt.tree_leaves(new), opt.tree_leaves(params)))
    diff = torch.cat([(a - torch.from_numpy(np.array(b))).flatten()
                      for a, b in zip(opt.tree_leaves(new),
                                      jax.tree.leaves(jnew))]).double()
    sigma = 0.01 * 1.0 / 2
    assert abs(float(diff.std()) / (sigma * 2 ** 0.5) - 1) < 0.05
    assert abs(float(diff.mean())) < 5 * sigma * 2 ** 0.5 / diff.numel() ** 0.5
