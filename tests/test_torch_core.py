"""The hub's pure-Python core on the port (``repro_torch.core``: the
performance model, network, trust zones, placement, scheduler and
orchestrator) against ``repro.core``.

These modules are plain Python arithmetic over the same configs, so the
port is held to exact equality: estimates, transfers, zone decisions,
knapsack choices, every event of the scheduler's trace, every QoE
report, every placement and every ``fail_device`` move.  The one
deliberate difference is the hub's own entry: the port's carries the
H100's figures (``test_hub_entry_is_the_h100``), so the orchestrator is
compared with the port's hub entry set to the JAX catalogue's, and a
test states what the H100's figures change.  A few seconds serially.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import hub as JH
from repro.core import network as JN
from repro.core import orchestrator as JO
from repro.core import perf_model as JP
from repro.core import placement as JPL
from repro.core import scheduler as JS
from repro.core import trustzones as JTZ
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import hub as PH
from repro_torch.core import network as PN
from repro_torch.core import orchestrator as PO
from repro_torch.core import perf_model as PP
from repro_torch.core import placement as PPL
from repro_torch.core import scheduler as PS
from repro_torch.core import trustzones as PTZ

torch.set_num_threads(1)

ZONES = ("personal", "household", "work", "public")


def _asdict(obj):
    return dataclasses.asdict(obj)


def _port_spec(jdev):
    """The port's ``DeviceSpec`` with a JAX entry's figures."""
    return PP.DeviceSpec(**_asdict(jdev))


@pytest.fixture
def jax_hub_figures(monkeypatch):
    """The port's catalogue with its hub entry set to the JAX one."""
    monkeypatch.setitem(PP.DEVICE_CATALOGUE, "edgeai-hub",
                        _port_spec(JP.DEVICE_CATALOGUE["edgeai-hub"]))


# ---------------------------------------------------------------------------
# performance model
# ---------------------------------------------------------------------------

def test_hub_entry_is_the_h100():
    hub = PP.DEVICE_CATALOGUE["edgeai-hub"]
    assert (hub.peak_flops, hub.mem_bw, hub.memory_bytes, hub.peak_power,
            hub.idle_power) == (989e12, 3.35e12, 80e9, 700.0, 71.07)
    assert hub.train_capable and hub.kind == "hub"
    assert hub.dvfs_states == JP.DEVICE_CATALOGUE["edgeai-hub"].dvfs_states
    assert (PP.PEAK_FLOPS_BF16, PP.HBM_BW, PP.ICI_BW) == (989e12, 3.35e12,
                                                          50e9)


def test_other_devices_are_copied():
    assert list(PP.DEVICE_CATALOGUE) == list(JP.DEVICE_CATALOGUE)
    for name, jdev in JP.DEVICE_CATALOGUE.items():
        if name != "edgeai-hub":
            assert _asdict(PP.DEVICE_CATALOGUE[name]) == _asdict(jdev), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_costs_and_estimates_equal_jax(arch):
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    assert PP.model_flops_per_token(pcfg) == JP.model_flops_per_token(jcfg)
    assert PP.train_flops(pcfg, 4096) == JP.train_flops(jcfg, 4096)
    for b, s in ((1, 1), (4, 256), (16, 1024)):
        costs = [(PP.inference_cost(pcfg, b, s), JP.inference_cost(jcfg, b, s)),
                 (PP.inference_cost(pcfg, b, s, weight_bits=8),
                  JP.inference_cost(jcfg, b, s, weight_bits=8)),
                 (PP.training_cost(pcfg, b, s), JP.training_cost(jcfg, b, s))]
        for pc, jc in costs:
            assert _asdict(pc) == _asdict(jc)
            assert pc.mem_bytes == jc.mem_bytes
            for jdev in JP.DEVICE_CATALOGUE.values():
                for dvfs in (1.0, 0.5):
                    pe = PP.estimate(pc, _port_spec(jdev), dvfs=dvfs)
                    je = JP.estimate(jc, jdev, dvfs=dvfs)
                    assert _asdict(pe) == _asdict(je)
                    assert pe.bottleneck == je.bottleneck


def test_historical_estimator_equals_jax():
    ph, jh = PP.HistoricalEstimator(0.3), JP.HistoricalEstimator(0.3)
    rng = np.random.default_rng(0)
    for _ in range(40):
        k, d = f"t{rng.integers(3)}", f"d{rng.integers(2)}"
        lat = float(rng.uniform(0.01, 2.0))
        ph.observe(k, d, lat)
        jh.observe(k, d, lat)
    for k in ("t0", "t1", "t2", "t9"):
        for d in ("d0", "d1"):
            assert ph.predict(k, d) == jh.predict(k, d)


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

LINKS = (("wifi6",), ("wifi6", "uwb"), ("wifi-legacy", "uwb"),
         ("wifi6", "5g-local", "ble"), ("zigbee",), ("ethernet", "wifi6"))


def test_channel_catalogue_equals_jax():
    assert {k: _asdict(v) for k, v in PN.CHANNEL_CATALOGUE.items()} == \
        {k: _asdict(v) for k, v in JN.CHANNEL_CATALOGUE.items()}


@pytest.mark.parametrize("names", LINKS)
def test_link_send_reserve_and_best_channel_equal_jax(names):
    pl = PN.MultiChannelLink([PN.CHANNEL_CATALOGUE[n] for n in names])
    jl = JN.MultiChannelLink([JN.CHANNEL_CATALOGUE[n] for n in names])
    ops = [("reserve", "stream", 0.6), ("reserve", "other", 0.6),
           ("reserve", "other", 0.3), ("send", None, 1e6),
           ("send", "stream", 5e6), ("send", "other", 100.0),
           ("release", "stream", None), ("reserve", "third", 0.5),
           ("send", "third", 3e7), ("send", None, 64.0),
           ("reserve", "bad", 0.0), ("release", "nobody", None)]
    for op, tenant, arg in ops:
        if op == "reserve":
            assert pl.reserve(tenant, arg) == jl.reserve(tenant, arg)
        elif op == "release":
            pl.release(tenant)
            jl.release(tenant)
        else:
            assert _asdict(pl.send(arg, tenant=tenant)) == \
                _asdict(jl.send(arg, tenant=tenant))
        assert pl.free_fraction == jl.free_fraction
    for nbytes in (1.0, 100.0, 1e4, 1e6, 1e8, 5e8):
        pc, pt = pl.best_single_channel(nbytes)
        jc, jt = jl.best_single_channel(nbytes)
        assert (pc.name, pt) == (jc.name, jt)
        for ch in pl.channels:
            assert PN.transfer_time(nbytes, ch) == JN.transfer_time(
                nbytes, JN.CHANNEL_CATALOGUE[ch.name])
    with pytest.raises(ValueError):
        PN.MultiChannelLink([])


# ---------------------------------------------------------------------------
# trust zones
# ---------------------------------------------------------------------------

def test_allowed_over_the_whole_grid():
    acls = (frozenset(), frozenset({"dev"}), frozenset({"other"}))
    n = 0
    for dz in ZONES:
        for vz in ZONES:
            for owner in ("alice", "eve"):
                for allow in acls:
                    for deny in acls:
                        pd = PTZ.DataItem("x", dz, "alice", allow, deny)
                        jd = JTZ.DataItem("x", dz, "alice", allow, deny)
                        got = PTZ.allowed(pd, "dev", vz, owner)
                        assert got == JTZ.allowed(jd, "dev", vz, owner)
                        if got:
                            PTZ.check(pd, "dev", vz, owner)
                        else:
                            with pytest.raises(PTZ.AccessError):
                                PTZ.check(pd, "dev", vz, owner)
                        n += 1
    assert n == 4 * 4 * 2 * 3 * 3
    assert PTZ.DEFAULT_FLOW == JTZ.DEFAULT_FLOW
    narrow = {"household": {"public"}}
    for dz in ZONES:
        assert PTZ.ZonePolicy(narrow).zone_allows(dz, "household") == \
            JTZ.ZonePolicy(narrow).zone_allows(dz, "household")


def test_filter_devices_equals_jax():
    devices = {"a": ("personal", "alice"), "b": ("personal", "bob"),
               "c": ("household", "alice"), "d": ("work", "alice"),
               "e": ("public", "eve")}
    for dz in ZONES:
        pd, jd = PTZ.DataItem("x", dz, "alice"), JTZ.DataItem("x", dz, "alice")
        assert PTZ.filter_devices(pd, devices) == \
            JTZ.filter_devices(jd, devices)


# ---------------------------------------------------------------------------
# placement knapsack
# ---------------------------------------------------------------------------

def _opts(mod, items):
    return [mod.PlacementOption(f"d{d}", f"acc{i}", cost=c, utility=u)
            for i, (d, c, u) in enumerate(items)]


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 9),
                          st.floats(0.1, 10)), min_size=1, max_size=8),
       st.integers(1, 20), st.booleans())
def test_knapsack_and_greedy_equal_jax(items, budget, exclusive):
    pc, pu = PPL.solve_knapsack(_opts(PPL, items), budget,
                                exclusive_per_device=exclusive)
    jc, ju = JPL.solve_knapsack(_opts(JPL, items), budget,
                                exclusive_per_device=exclusive)
    assert [_asdict(o) for o in pc] == [_asdict(o) for o in jc]
    assert pu == ju
    assert sum(o.cost for o in pc) <= budget
    pg, pgu = PPL.greedy_partition(_opts(PPL, items), budget)
    jg, jgu = JPL.greedy_partition(_opts(JPL, items), budget)
    assert [_asdict(o) for o in pg] == [_asdict(o) for o in jg]
    assert pgu == jgu and pu >= pgu - 1e-9


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _workload(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        arrival = float(rng.uniform(0, 6))
        out.append(dict(
            uid=uid, kind=str(rng.choice(["inference", "stream",
                                          "training"])),
            duration_s=float(rng.uniform(0.05, 2.0)),
            device=f"d{rng.integers(2)}", priority=int(rng.integers(0, 4)),
            deadline=(arrival + float(rng.uniform(0.2, 4.0))
                      if rng.random() < 0.7 else None),
            arrival=arrival, preemptible=bool(rng.random() < 0.8)))
    return out


def _schedule(mod, policy, tasks, until=float("inf")):
    s = mod.EdgeScheduler(policy)
    for t in tasks:
        s.submit(mod.AITask(**t))
    done = s.run(until)
    return s, [(t.uid, t.start_time, t.finish_time, t.preemptions,
                t.remaining_s, t.missed_deadline) for t in done]


@pytest.mark.parametrize("policy", ["fifo", "priority", "edf"])
def test_scheduler_traces_and_reports_equal_jax(policy):
    preempted = 0
    for seed in range(6):
        tasks = _workload(seed)
        ps, pdone = _schedule(PS, policy, tasks)
        js, jdone = _schedule(JS, policy, tasks)
        assert ps.trace == js.trace
        assert pdone == jdone
        assert ps.qoe_report() == js.qoe_report()
        assert ps.now == js.now
        preempted += ps.qoe_report()["preemptions"]
        # a run cut short resumes to the same end
        pc, _ = _schedule(PS, policy, tasks, until=2.0)
        jc, _ = _schedule(JS, policy, tasks, until=2.0)
        assert pc.trace == jc.trace and pc.qoe_report() == jc.qoe_report()
    if policy == "fifo":
        assert preempted == 0
    else:
        assert preempted > 0


def test_scheduler_helpers_equal_jax():
    assert PS.EdgeScheduler().qoe_report() == {"completed": 0}
    for pol in ("fifo", "priority", "edf"):
        for kw in (dict(priority=2, arrival=1.5, deadline=None, uid=3),
                   dict(priority=0, arrival=0.0, deadline=4.0, uid=1)):
            assert PS.admission_rank(pol, **kw) == JS.admission_rank(pol,
                                                                     **kw)
    with pytest.raises(ValueError):
        PS.admission_rank("lifo")
    vals = [3.0, 1.0, 7.5, 2.25]
    assert PS.quantile_higher(vals, 0.99) == JS.quantile_higher(vals, 0.99)
    assert PS.Estimate is PP.Estimate and PS.TaskCost is PP.TaskCost


# ---------------------------------------------------------------------------
# orchestrator and hub (the port's hub entry set to the JAX figures)
# ---------------------------------------------------------------------------

def _home_rows(reg):
    return [(n, _asdict(reg.get(n).spec), reg.get(n).zone, reg.get(n).owner,
             [_asdict(c) for c in reg.get(n).link.channels])
            for n in reg.names()]


def test_default_home_equals_jax(jax_hub_figures):
    assert _home_rows(PH.default_home()) == _home_rows(JH.default_home())
    assert _home_rows(PH.default_home("h2")) == \
        _home_rows(JH.default_home("h2"))


def _specs(mod, tz, cfg_of):
    """The orchestrator workloads: test_system's day (8 streams and a
    gallery batch), the example's (12 and 4), training, zone-gated and
    split-eligible tasks."""
    full = cfg_of("gemma3-1b", "full")
    smoke = cfg_of("gemma3-1b", "smoke")
    phi3 = cfg_of("phi3-medium-14b", "full")   # fits no single device
    out = []
    for i in range(8):
        out.append(mod.TaskSpec(kind="stream", model=full, batch=1, seq=256,
                                priority=5, deadline_rel=0.25,
                                arrival=i * 0.05,
                                source_device="living-room-tv"))
    out.append(mod.TaskSpec(kind="inference", model=full, batch=16,
                            seq=1024, priority=0, deadline_rel=30.0,
                            source_device="alice-phone",
                            data=tz.DataItem("gallery", "household",
                                             "alice")))
    for i in range(12):
        out.append(mod.TaskSpec(kind="stream", model=full, batch=1, seq=256,
                                priority=5, deadline_rel=0.2,
                                arrival=0.5 + i * 0.05,
                                source_device="living-room-tv"))
    for i in range(4):
        out.append(mod.TaskSpec(
            kind="inference", model=full, batch=32, seq=1024, priority=0,
            deadline_rel=30.0, arrival=0.5 + i * 0.1,
            source_device="alice-phone",
            data=tz.DataItem("gallery", "household", "alice")))
    out.append(mod.TaskSpec(kind="training", model=smoke, batch=8, seq=128,
                            arrival=0.3))
    out.append(mod.TaskSpec(kind="inference", model=smoke, batch=1, seq=64,
                            arrival=0.1, data=tz.DataItem(
                                "alice-health", "personal", "alice")))
    out.append(mod.TaskSpec(kind="inference", model=smoke, batch=64,
                            seq=2048, arrival=0.0))
    for dev in ("alice-phone", "alice-watch", "door-sensor"):
        out.append(mod.TaskSpec(kind="inference", model=phi3, batch=4,
                                seq=256, arrival=0.2, source_device=dev,
                                allow_split=True))
    for i in range(3):   # bob's personal notes: bob's devices only
        out.append(mod.TaskSpec(kind="inference", model=smoke, batch=4,
                                seq=512, arrival=0.4 + i * 0.3,
                                deadline_rel=2.0, data=tz.DataItem(
                                    "bob-notes", "personal", "bob")))
    return out


def _cfg_jax(arch, scale):
    return jax_get_config(arch) if scale == "full" else jax_smoke_config(arch)


def _cfg_port(arch, scale):
    return get_config(arch) if scale == "full" else get_smoke_config(arch)


def _day(hub_mod, orch_mod, tz, cfg_of, fail=("vacuum",)):
    hub = hub_mod.EdgeAIHub.create(policy="edf")
    specs = _specs(orch_mod, tz, cfg_of)
    places = [_asdict(hub.orchestrator.place(s)) for s in specs]
    uids = [hub.submit(s) for s in specs]
    moved = []
    for name in fail:
        moved.append(hub.orchestrator.fail_device(name))
    first = hub.run(until=0.6)
    # the device bob's notes went to drops out mid-day
    notes = hub.orchestrator._task_meta[uids[-1]][1].device
    moved.append(hub.orchestrator.fail_device(notes))
    report = hub.run()
    meta = {u: (_asdict(p), s.arrival)
            for u, (s, p) in hub.orchestrator._task_meta.items()}
    history = {k: v for k, v in hub.orchestrator.history._table.items()}
    return dict(places=places, uids=uids, moved=moved, first=first,
                report=report, trace=hub.orchestrator.scheduler.trace,
                meta=meta, history=history,
                depth={n: hub.registry.get(n).queue_depth
                       for n in hub.registry.names()})


def test_orchestrator_day_equals_jax(jax_hub_figures):
    port = _day(PH, PO, PTZ, _cfg_port)
    ref = _day(JH, JO, JTZ, _cfg_jax)
    assert port == ref
    assert any(p["split"] is not None for p in port["places"])
    assert port["moved"][-1] and port["report"]["completed"] > 0


def test_orchestrator_places_and_fails_over_like_jax(jax_hub_figures):
    """test_core's single-task cases, on both packages."""
    for hub_mod, orch_mod, tz, cfg_of in ((PH, PO, PTZ, _cfg_port),
                                          (JH, JO, JTZ, _cfg_jax)):
        hub = hub_mod.EdgeAIHub.create()
        cfg = cfg_of("gemma3-1b", "smoke")
        assert hub.orchestrator.place(orch_mod.TaskSpec(
            kind="training", model=cfg, batch=8, seq=128)).device == "hub"
        uid = hub.submit(orch_mod.TaskSpec(kind="inference", model=cfg,
                                           batch=64, seq=2048))
        dev = hub.orchestrator._task_meta[uid][1].device
        moved = hub.orchestrator.fail_device(dev)
        assert moved and hub.orchestrator._task_meta[moved[0]][1].device \
            != dev
        with pytest.raises(tz.AccessError):
            tz.check(tz.DataItem("x", "work", "alice"), "tv", "household",
                     "alice")
    with pytest.raises(RuntimeError, match="no feasible device"):
        hub = PH.EdgeAIHub.create()
        for n in hub.registry.names():
            hub.registry.get(n).available = False
        hub.orchestrator.place(PO.TaskSpec(kind="inference",
                                           model=get_smoke_config("gemma3-1b")))


def test_h100_figures_change_what_fits_and_how_fast():
    """With its own figures the port's hub holds 80e9 bytes, not the JAX
    catalogue's 16e9: phi3-medium-14b's 28 GB of 16-bit weights fit it,
    so a task that no device of the JAX home can take is placed on the
    hub; and a task the JAX hub already took keeps its device and runs
    faster (the H100's bandwidth and rate are 4.1x and 5.0x)."""
    phi3 = get_config("phi3-medium-14b")
    jhub = JH.EdgeAIHub.create()
    with pytest.raises(RuntimeError, match="no feasible device"):
        jhub.orchestrator.place(JO.TaskSpec(
            kind="inference", model=jax_get_config("phi3-medium-14b"),
            batch=1, seq=128))
    phub = PH.EdgeAIHub.create()
    place = phub.orchestrator.place(PO.TaskSpec(kind="inference", model=phi3,
                                                batch=1, seq=128))
    assert place.device == "hub"
    assert 16e9 < PP.inference_cost(phi3, 1, 128).mem_bytes <= 80e9
    for arch, b, s in (("gemma3-1b", 1, 256), ("gemma3-1b", 32, 1024)):
        jp = jhub.orchestrator.place(JO.TaskSpec(
            kind="inference", model=jax_get_config(arch), batch=b, seq=s,
            source_device="alice-phone"))
        pp = phub.orchestrator.place(PO.TaskSpec(
            kind="inference", model=get_config(arch), batch=b, seq=s,
            source_device="alice-phone"))
        assert pp.device == jp.device == "hub"
        assert pp.latency_s < jp.latency_s
    assert PP.DEVICE_CATALOGUE["edgeai-hub"].memory_bytes / \
        JP.DEVICE_CATALOGUE["edgeai-hub"].memory_bytes == 5.0
