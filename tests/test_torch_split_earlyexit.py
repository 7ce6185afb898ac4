"""Split computing and early exit on the port (``repro_torch.core.split``,
``repro_torch.core.earlyexit``) against ``repro.core``.

The phi3-medium-14b smoke config at float32, the JAX weights bridged
into the port.  Tolerances: logits, losses and head gradients within
rtol 1e-5 / atol 1e-5 x max |value| (the same float32 math summed in
another order); the wire's int8 bytes equal on equal inputs (both round
half to even) and its scales within float32 rounding; ``choose_split``
decisions (plain Python over the same configs) and every early-exit
report (predictions, exit layers, expected layers, savings) equal.  A
few seconds serially, most of it the jitted JAX entry points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import earlyexit as JEE
from repro.core import network as JN
from repro.core import perf_model as JP
from repro.core import split as JSP
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import earlyexit as EE
from repro_torch.core import network as PN
from repro_torch.core import perf_model as PP
from repro_torch.core import split as SP
from repro_torch.models import transformer as T

torch.set_num_threads(1)

ARCH = "phi3-medium-14b"
JCFG = jax_smoke_config(ARCH).replace(dtype="float32")
CFG = get_smoke_config(ARCH).replace(dtype="float32")
EXITS = (0,)


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    jtoks = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                               JCFG.vocab_size)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    toks = torch.from_numpy(np.array(jtoks))
    return jparams, jtoks, params, toks


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.floats(-50, 50), st.integers(2, 8), st.integers(0, 1000))
def test_quantized_bytes_equal_jax(scale, bits, seed):
    x = (scale * np.random.default_rng(seed).standard_normal((4, 8, 16))
         ).astype(np.float32)
    x[0, 0, :4] = [0.5, -0.5, 1.5, 2.5]          # ties at scale 1 rows
    jq, js = JSP.quantize_activations(jnp.asarray(x), bits)
    q, s = SP.quantize_activations(torch.from_numpy(x), bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    back = SP.dequantize_activations(q, s, torch.float32)
    jback = JSP.dequantize_activations(jq, js, jnp.float32)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-6,
                               atol=1e-30)
    assert SP.wire_bytes(x.shape, bits) == JSP.wire_bytes(x.shape, bits)


@pytest.mark.parametrize("split", [0, 1, 2])
def test_split_forward_equals_jax(setup, split):
    jparams, jtoks, params, toks = setup
    jout, jpay = JSP.split_forward(JCFG, jparams, jtoks, split, bits=8)
    out, pay = SP.split_forward(CFG, params, toks, split, bits=8)
    assert pay == jpay
    _close(out, jout)
    # the criterion of tests/test_split_earlyexit.py, on the port
    full = T.forward(CFG, params, toks)
    assert float((out - full).abs().max()) / (float(full.abs().max())
                                              + 1.0) < 0.05
    if split in (0, CFG.num_layers):
        _close(out, full)


def test_split_halves_and_bits_equal_jax(setup):
    jparams, jtoks, params, toks = setup
    x = SP.head_forward(CFG, params, toks, 1)
    _close(x, JSP.head_forward(JCFG, jparams, jtoks, 1))
    _close(SP.tail_forward(CFG, params, x, 1),
           JSP.tail_forward(JCFG, jparams, jnp.asarray(x.numpy()), 1))
    full = T.forward(CFG, params, toks)
    errs = [float((SP.split_forward(CFG, params, toks, 1, bits=b)[0]
                   - full).abs().max()) for b in (4, 8)]
    assert errs[1] < errs[0]
    gcfg = get_smoke_config("gemma3-1b")
    with pytest.raises(NotImplementedError, match="uniform"):
        SP.head_forward(gcfg, {}, toks, 1)


def _decisions(mod_sp, mod_net, mod_pm, cfg_of, hub):
    out = []
    links = (("zigbee",), ("ethernet",), ("wifi-legacy",), ("wifi6", "uwb"),
             ("ble",))
    for arch in ARCH_IDS:
        cfg = cfg_of(arch)
        if cfg.family != "dense" and cfg.family != "moe":
            continue
        cfg = cfg.replace(pattern_period=1)
        for dev in ("flagship-phone", "mid-phone", "iot-sensor",
                    "wearable", "old-phone"):
            for names in links:
                link = mod_net.MultiChannelLink(
                    [mod_net.CHANNEL_CATALOGUE[n] for n in names])
                for b, s in ((1, 128), (4, 256)):
                    d = mod_sp.choose_split(cfg, mod_pm.DEVICE_CATALOGUE[dev],
                                            hub, link, b, s)
                    out.append(dataclasses.asdict(d))
    return out


def test_choose_split_decisions_equal_jax():
    jhub = JP.DEVICE_CATALOGUE["edgeai-hub"]
    port = _decisions(SP, PN, PP, get_config,
                      PP.DeviceSpec(**dataclasses.asdict(jhub)))
    ref = _decisions(JSP, JN, JP, jax_get_config, jhub)
    assert port == ref and len(port) > 100
    assert len({d["split"] for d in port}) > 2
    cfg = get_config("gemma2-9b").replace(pattern_period=1)
    jcfg = jax_get_config("gemma2-9b").replace(pattern_period=1)
    assert SP._per_layer_flops(cfg, 512) == JSP._per_layer_flops(jcfg, 512)
    assert SP._per_layer_weight_bytes(cfg, 4) == \
        JSP._per_layer_weight_bytes(jcfg, 4)


# ---------------------------------------------------------------------------
# early exit
# ---------------------------------------------------------------------------

def _heads(exits=EXITS):
    jheads = JEE.init_exit_heads(JCFG, jax.random.PRNGKey(2), list(exits))
    return jheads, EE.init_exit_heads(CFG, list(exits), device="cpu")


def test_forward_with_exits_equals_jax(setup):
    jparams, jtoks, params, toks = setup
    jheads, heads = _heads()
    jouts = JEE.forward_with_exits(JCFG, jparams, jheads, jtoks)
    outs = EE.forward_with_exits(CFG, params, heads, toks)
    assert [i for i, _ in outs] == [i for i, _ in jouts]
    for (_, a), (_, b) in zip(outs, jouts):
        _close(a, b)
    _close(outs[-1][1], T.forward(CFG, params, toks))


def test_exit_loss_and_head_gradients_equal_jax(setup):
    jparams, jtoks, params, toks = setup
    jheads, heads = _heads()
    jbatch = {"tokens": jtoks, "targets": jtoks}
    batch = {"tokens": toks, "targets": toks}
    for w in (None, (0.3, 1.0)):
        jl = JEE.exit_loss(JCFG, jparams, jheads, jbatch, w)
        _close(EE.exit_loss(CFG, params, heads, batch, w), jl)
    jg = jax.grad(lambda ex: JEE.exit_loss(
        JCFG, jparams, {"exits": ex, "exit_layers": jheads["exit_layers"]},
        jbatch))(jheads["exits"])
    leaves = [h["ln"]["scale"].requires_grad_() for h in heads["exits"]]
    loss = EE.exit_loss(CFG, params, heads, batch)
    grads = torch.autograd.grad(loss, leaves)
    for g, j in zip(grads, jg):
        assert torch.isfinite(g).all()
        _close(g, j["ln"]["scale"], rtol=1e-4)


def _mid_threshold(params, heads, toks, reduce):
    """A threshold halfway between two rows' exit confidences, so some
    rows leave at the exit and others do not (far from either row)."""
    _, logits = EE.forward_with_exits(CFG, params, heads, toks)[0]
    conf = torch.softmax(logits.float(), -1).amax(-1)
    conf = conf.amin(-1) if reduce == "min" else conf.mean(-1)
    c = sorted(conf.tolist())
    return 0.5 * (c[1] + c[2])


@pytest.mark.parametrize("reduce", ["mean", "min"])
def test_serve_early_exit_reports_equal_jax(setup, reduce):
    jparams, jtoks, params, toks = setup
    jheads, heads = _heads()
    mid = _mid_threshold(params, heads, toks, reduce)
    seen = set()
    for th in (0.0, 0.5, 1.1, mid):
        rep = EE.serve_early_exit(CFG, params, heads, toks, th, reduce)
        jrep = JEE.serve_early_exit(JCFG, jparams, jheads, jtoks, th, reduce)
        assert rep.predictions.dtype == torch.int32
        np.testing.assert_array_equal(rep.predictions.numpy(),
                                      np.asarray(jrep.predictions))
        np.testing.assert_array_equal(rep.exit_layer.numpy(),
                                      np.asarray(jrep.exit_layer))
        assert rep.expected_layers == jrep.expected_layers
        assert rep.flops_saved_frac == jrep.flops_saved_frac
        seen.add(rep.expected_layers)
    assert len(seen) == 3          # all exit, none exit, some exit
    with pytest.raises(NotImplementedError):
        EE.forward_with_exits(get_smoke_config("gemma3-1b"), {}, heads, toks)


def test_serve_early_exit_skips_the_rest_of_the_stack(setup, monkeypatch):
    """Once every row has left, no later layer runs (the batch skip)."""
    _, _, params, toks = setup
    _, heads = _heads()
    calls = []
    block = T.block_fwd
    monkeypatch.setattr(T, "block_fwd",
                        lambda *a, **k: calls.append(1) or block(*a, **k))
    EE.serve_early_exit(CFG, params, heads, toks, threshold=0.0)
    assert len(calls) == EXITS[0] + 1
    calls.clear()
    EE.serve_early_exit(CFG, params, heads, toks, threshold=1.1)
    assert len(calls) == CFG.num_layers
