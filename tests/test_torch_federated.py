"""Federated learning on the port (``repro_torch.training.federated``)
against ``repro.training.federated``: FedAvg, DP clipping and noise,
SecAgg masks, and the hub's trust-zone-gated round.

The phi3-medium-14b smoke config at float32 activations, the JAX
weights bridged into the port, the same numpy bigram batches on both
sides (the gemma3-1b smoke config's round is held in
``tests/test_torch_hub.py``'s private federation).
Tolerances: local deltas and round params within rtol 1e-4 / atol 1e-4
x max |value| (two SGD steps of the same float32 math summed in another
order).  SecAgg masks are the port's own draws (a ``torch.Generator``
per pair), not JAX's: a masked round is held to the JAX round without
masks, since both sums cancel to the unmasked sum (float32 rounding of
N(0, 1) masks added and taken away: atol 1e-5).  DP noise is held by
its distribution.  One JAX round of two clients and one JAX local
update (each re-jits its step; the round's eager tree maps compile per
leaf shape), about 15 s serially.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import InputShape
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import hub as JH
from repro.core import trustzones as JTZ
from repro.data import DataConfig as JaxDataConfig
from repro.data import data_iterator as jax_data_iterator
from repro.models import model as JM
from repro.training import federated as JF
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import hub as PH
from repro_torch.core import trustzones as PTZ
from repro_torch.data import DataConfig, data_iterator
from repro_torch.training import federated as fed
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

ARCH = "phi3-medium-14b"
JCFG = jax_smoke_config(ARCH).replace(dtype="float32")
CFG = get_smoke_config(ARCH).replace(dtype="float32")
SHAPE = InputShape("t", 32, 4, "train")
CLIENTS = ("alice-phone", "bob-phone", "living-room-tv")
FCFG = dict(local_steps=2, local_lr=0.3)


def _close(got, want, rtol=1e-4, atol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    atol = rtol * float(np.abs(want).max()) if atol is None else atol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _trees_close(port, ref, **kw):
    leaves = jax.tree.leaves(ref)
    mine = opt.tree_leaves(port)
    assert len(mine) == len(leaves)
    for a, b in zip(mine, leaves):
        _close(a, b, **kw)


def _batches(n_batches=2):
    """Each client's batches, the same numpy tokens on both sides."""
    jax_side, port_side = {}, {}
    for i, n in enumerate(CLIENTS):
        jit = jax_data_iterator(JCFG, SHAPE, JaxDataConfig(seed=i,
                                                           branching=2))
        pit = data_iterator(CFG, SHAPE, DataConfig(seed=i, branching=2),
                            device="cpu")
        jax_side[n] = [next(jit) for _ in range(n_batches)]
        port_side[n] = [next(pit) for _ in range(n_batches)]
    return jax_side, port_side


@pytest.fixture(scope="module")
def world():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    jb, pb = _batches()
    eligible = ("alice-phone", "living-room-tv")   # bob's phone: gated
    jclients = {i: jb[n] for i, n in enumerate(eligible)}
    ref = JF.fed_round(JCFG, JF.FedConfig(dp_clip=1.0, **FCFG), jparams,
                       jclients, 0)
    return dict(jparams=jparams, params=params, jb=jb, pb=pb,
                pclients={i: pb[n] for i, n in enumerate(eligible)},
                ref=ref)


def test_batches_are_the_same_tokens(world):
    for n in CLIENTS:
        for a, b in zip(world["pb"][n], world["jb"][n]):
            np.testing.assert_array_equal(a["tokens"].numpy(),
                                          np.asarray(b["tokens"]))


def test_local_update_deltas_equal_jax(world):
    n = CLIENTS[0]
    fcfg, jfcfg = fed.FedConfig(**FCFG), JF.FedConfig(**FCFG)
    jd = JF.local_update(JCFG, jfcfg, world["jparams"], world["jb"][n])
    d = fed.local_update(CFG, fcfg, world["params"], world["pb"][n])
    assert all(x.dtype == torch.float32 and not x.requires_grad
               for x in opt.tree_leaves(d))
    _trees_close(d, jd)
    assert float(opt.global_norm(d)) > 0
    # the inputs are left as they were
    for a, b in zip(opt.tree_leaves(world["params"]),
                    jax.tree.leaves(world["jparams"])):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


@settings(max_examples=20, deadline=None)
@given(st.floats(0.1, 5.0), st.floats(0.5, 20.0))
def test_clip_update_equals_jax(clip, value):
    delta = {"w": np.full((32,), value, np.float32),
             "b": {"c": np.linspace(-value, value, 7).astype(np.float32)}}
    got = fed.clip_update(bridge.params_from_numpy(delta, device="cpu"), clip)
    want = JF.clip_update(jax.tree.map(jnp.asarray, delta), clip)
    _trees_close(got, want, rtol=1e-6)
    assert float(opt.global_norm(got)) <= clip * 1.001


@pytest.mark.parametrize("secure", [False, True])
def test_fed_round_without_noise_equals_jax(world, secure):
    fcfg = fed.FedConfig(dp_clip=1.0, secure_aggregation=secure, **FCFG)
    new, info = fed.fed_round(CFG, fcfg, world["params"],
                              world["pclients"], 0)
    jnew, jinfo = world["ref"]
    assert info["clients"] == jinfo["clients"] == [0, 1]
    _trees_close(new, jnew, atol=1e-5)
    assert info["update_norm"] == pytest.approx(jinfo["update_norm"],
                                                rel=1e-4)


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 6), st.integers(0, 100))
def test_secagg_masks_cancel(n_clients, round_seed):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(4)}
    deltas = {c: {k: v * (c + 1) for k, v in tree.items()}
              for c in range(n_clients)}
    clients = list(deltas)
    masked = {c: fed.secagg_mask(deltas[c], c, clients, round_seed)
              for c in clients}
    for k in tree:
        plain = sum(d[k] for d in deltas.values())
        got = sum(m[k] for m in masked.values())
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                                   atol=1e-3)


def test_secagg_hides_each_update_and_pairs_draw_alike():
    tree = {"w": torch.ones(8)}
    masked = fed.secagg_mask(tree, 0, [0, 1, 2], round_seed=1)
    assert float((masked["w"] - tree["w"]).abs().max()) > 0.1
    # the pair (0, 1)'s mask: + on client 0, - on client 1, same draw
    m01 = fed._pair_mask(tree, (1 * 1_000_003 + 0 * 1009 + 1) % 2 ** 31)
    a = fed.secagg_mask(tree, 0, [0, 1], 1)["w"] - tree["w"]
    b = fed.secagg_mask(tree, 1, [0, 1], 1)["w"] - tree["w"]
    torch.testing.assert_close(a, m01["w"], rtol=0, atol=1e-6)
    torch.testing.assert_close(b, -m01["w"], rtol=0, atol=1e-6)


def test_dp_noise_distribution():
    tree = {"w": torch.zeros(200_000), "v": {"u": torch.zeros(300, 300)}}
    sigma = 0.05
    gen = torch.Generator().manual_seed(3)
    noisy = fed.add_gaussian_noise(tree, sigma, gen)
    x = torch.cat([t.flatten() for t in opt.tree_leaves(noisy)]).double()
    n = x.numel()
    assert abs(float(x.mean())) < 5 * sigma / n ** 0.5
    assert abs(float(x.std()) / sigma - 1) < 0.01
    again = fed.add_gaussian_noise(tree, sigma,
                                   torch.Generator().manual_seed(3))
    assert torch.equal(again["w"], noisy["w"])


def test_fed_round_noise_and_seed(world):
    """DP noise at sigma = multiplier x clip / clients, from a generator
    seeded ``seed + round_idx``: the same round twice is the same."""
    kw = dict(dp_clip=1.0, dp_noise_multiplier=0.5, **FCFG)
    fcfg = fed.FedConfig(**kw)
    clean, _ = fed.fed_round(CFG, fed.FedConfig(dp_clip=1.0, **FCFG),
                             world["params"], world["pclients"], 0)
    noisy, _ = fed.fed_round(CFG, fcfg, world["params"], world["pclients"],
                             0)
    again, _ = fed.fed_round(CFG, fcfg, world["params"], world["pclients"],
                             0)
    assert all(torch.equal(a, b) for a, b in zip(opt.tree_leaves(noisy),
                                                 opt.tree_leaves(again)))
    diff = torch.cat([(a - b).flatten() for a, b in zip(
        opt.tree_leaves(noisy), opt.tree_leaves(clean))]).double()
    sigma = 0.5 * 1.0 / 2
    assert abs(float(diff.std()) / sigma - 1) < 0.05


def _eligible(hub_mod, tz, item):
    hub = hub_mod.EdgeAIHub.create()
    devices = {n: (hub.registry.get(n).zone, hub.registry.get(n).owner)
               for n in hub.registry.available()}
    return tz.filter_devices(item, devices)


def test_zone_gated_clients_equal_jax(world):
    for zone, owner in (("personal", "alice"), ("personal", "bob"),
                        ("household", "alice"), ("public", "eve"),
                        ("work", "alice")):
        assert _eligible(PH, PTZ, PTZ.DataItem("d", zone, owner)) == \
            _eligible(JH, JTZ, JTZ.DataItem("d", zone, owner))
    hub = PH.EdgeAIHub.create()
    fcfg = fed.FedConfig(dp_clip=1.0, **FCFG)
    new, info = hub.federated_round(CFG, fcfg, world["params"], world["pb"],
                                    PTZ.DataItem("alice-voice", "personal",
                                                 "alice"))
    assert info["clients"] == [0, 1]   # bob's phone gated out
    _trees_close(new, world["ref"][0], atol=1e-5)
    with pytest.raises(PTZ.AccessError):
        hub.federated_round(CFG, fcfg, world["params"], world["pb"],
                            PTZ.DataItem("corp-docs", "work", "alice"))
