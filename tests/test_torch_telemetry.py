"""The port's span tracer and its engine wiring against the JAX package.

Units: ``tests/test_telemetry.py``'s tracer cases (spans nest, slot
residencies close, the exact TTFT decomposition, the dump and its
summary, the validator catching breaks) run on both packages'
``telemetry`` modules, and the two give equal outputs under the same
fake clock.

Engine: ``tests/test_telemetry.py``'s traffic (a shared 21-token
prefix, a 41-token prompt past the largest bucket) through the port's
engine and the JAX engine at float32 on bridged weights, traced with
``make_clock(1e-4)`` — a clock that ticks on every read, so equal
event lists mean the two engines stamp the same events in the same
order: a paged phi3 engine with the prefix cache, the same speculating
(``spec_round`` events), the dense ``paged=False`` twin, and the
pool-free mamba2-370m engine.  Traced tokens equal untraced tokens and
the JAX engine's; ``stats()``, ``chrome_events()`` and
``request_summaries()`` equal the JAX engine's.  Plus the ``stats()``
schema snapshots of ``tests/test_telemetry.py`` on the port.

Serially about 25 s, most of it the four module-scoped JAX engines.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import telemetry as jax_telemetry
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
from repro_torch.serving import telemetry as torch_telemetry
from tests import test_telemetry as jax_cases

torch.set_num_threads(1)

MODULES = [jax_telemetry, torch_telemetry]
MODULE_IDS = ["repro", "repro_torch"]


# ---------------------------------------------------------------------------
# tracer units, on both packages
# ---------------------------------------------------------------------------

def _nested(tel):
    tr = tel.Tracer(clock=jax_cases.make_clock())
    with tr.span("outer", step=1):
        with tr.span("inner"):
            tr.instant("mark")
    tr.begin("u7", tid=10)
    tr.end(10)
    tr.end(10)                        # idempotent: no unmatched E
    return tr.chrome_events()


def _open_residencies(tel):
    tr = tel.Tracer(clock=jax_cases.make_clock())
    tr.begin("u1", tid=10)
    tr.begin("u2", tid=11)
    return tr.chrome_events()


def _lifecycle(tel):
    tr = tel.Tracer(clock=jax_cases.make_clock())
    tr.req_event(5, "submit")
    tr.req_event(5, "queued", depth=1)
    tr.req_event(5, "admitted", slot=0)
    tr.req_event(5, "prefill_chunk", n=8)
    tr.req_event(5, "prompt_done")
    tr.req_event(5, "first_token")
    tr.req_event(5, "tokens", n=1)
    tr.req_event(5, "spec_round", proposed=3, accepted=2)
    tr.req_event(5, "tokens", n=3)
    tr.req_event(5, "finish", n_generated=4)
    return tr.request_summaries()


def _roundtrip(tel, path):
    tr = tel.Tracer(clock=jax_cases.make_clock())
    with tr.span("step"):
        tr.req_event(0, "submit")
        tr.req_event(0, "finish")
    meta = tr.dump_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    return meta, trace, tel.summarize_trace(trace)


BROKEN = [
    [{"ph": "B", "ts": 0}],                                   # missing keys
    [{"ph": "E", "ts": 0, "pid": 0, "tid": 3}],               # E without B
    [{"ph": "B", "name": "u", "ts": 0, "pid": 0, "tid": 3}],  # unclosed B
    [{"ph": "X", "name": "s", "ts": 0, "dur": -1, "pid": 0, "tid": 0}],
]


@pytest.mark.parametrize("tel", MODULES, ids=MODULE_IDS)
def test_spans_nest_and_validate(tel):
    evs = _nested(tel)
    assert tel.validate_chrome_trace(evs) == []
    xs = [e for e in evs if e["ph"] == "X"]
    inner = next(e for e in xs if e["name"] == "inner")
    outer = next(e for e in xs if e["name"] == "outer")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["args"] == {"step": 1}


@pytest.mark.parametrize("tel", MODULES, ids=MODULE_IDS)
def test_open_residencies_auto_close(tel):
    assert tel.validate_chrome_trace(_open_residencies(tel)) == []


@pytest.mark.parametrize("tel", MODULES, ids=MODULE_IDS)
def test_request_summary_decomposition_exact(tel):
    (row,) = _lifecycle(tel)
    assert row["uid"] == 5
    assert (row["queue_wait_us"] + row["prefill_us"]
            + row["first_wave_us"]) == row["ttft_us"]
    assert row["e2e_us"] >= row["ttft_us"]
    assert row["n_tokens"] == 4
    assert len(row["itl_us"]) == 3
    assert row["itl_us"][0] > 0 and row["itl_us"][1:] == [0.0, 0.0]
    assert row["spec_rounds"] == [(3, 2)]


@pytest.mark.parametrize("tel", MODULES, ids=MODULE_IDS)
def test_dump_and_summarize_roundtrip(tel, tmp_path):
    meta, trace, s = _roundtrip(tel, tmp_path / "t.json")
    assert len(trace["traceEvents"]) == meta["events"]
    assert s["problems"] == []
    assert s["phases"][0]["name"] == "step"
    assert len(s["requests"]) == 1


@pytest.mark.parametrize("tel", MODULES, ids=MODULE_IDS)
def test_validator_catches_structural_breaks(tel):
    missing, unmatched, unclosed, negative = (
        tel.validate_chrome_trace(evs) for evs in BROKEN)
    assert missing
    assert any("without matching B" in p for p in unmatched)
    assert any("unclosed" in p for p in unclosed)
    assert any("non-negative dur" in p for p in negative)


@pytest.mark.parametrize("case", ["nested", "open", "lifecycle",
                                  "roundtrip", "broken"])
def test_tracer_units_equal_across_packages(case, tmp_path):
    """Each unit's output (events, summaries, the dump, its summary,
    the validator's findings) from the port's module equals the JAX
    module's under the same fake clock."""
    def run(tel, tag):
        if case == "nested":
            return _nested(tel)
        if case == "open":
            return _open_residencies(tel)
        if case == "lifecycle":
            return _lifecycle(tel)
        if case == "roundtrip":
            return _roundtrip(tel, tmp_path / f"{tag}.json")
        return [tel.validate_chrome_trace(evs) for evs in BROKEN]
    assert run(torch_telemetry, "port") == run(jax_telemetry, "jax")


def test_default_clock_stamps_sum_exactly():
    """Without an injected clock the port's tracer reads ``grid_clock``:
    every stamp is a multiple of 2**-14 us, so the TTFT decomposition
    sums exactly on the host's real clock, not only under a fake one."""
    tr = torch_telemetry.Tracer()
    assert tr.clock is torch_telemetry.grid_clock
    for uid in range(6):
        tr.req_event(uid, "submit")
    for uid in range(6):
        for name in ("admitted", "prompt_done", "first_token"):
            with tr.span("work"):
                sum(range(2000 * (uid + 1)))
            tr.req_event(uid, name)
    for ev in tr.chrome_events():
        assert ev["ts"] * 2 ** 14 == int(ev["ts"] * 2 ** 14)
    for row in tr.request_summaries():
        assert (row["queue_wait_us"] + row["prefill_us"]
                + row["first_wave_us"]) == row["ttft_us"] > 0
    t = torch_telemetry.grid_clock()
    assert t * 2 ** 20 == int(t * 2 ** 20)


def test_track_layout_and_clock_are_the_jax_packages():
    for name in ("ENGINE_TID", "FRONTEND_TID", "SLOT_TID0"):
        assert getattr(torch_telemetry, name) == getattr(jax_telemetry, name)
    assert torch_telemetry.default_clock is jax_telemetry.default_clock


# ---------------------------------------------------------------------------
# engine twins
# ---------------------------------------------------------------------------

BASE = dict(max_slots=2, max_len=96, prefill_buckets=(8, 16, 32), seed=3,
            policy="priority")
# case -> (arch, ServeConfig fields over BASE)
CASES = {
    "paged": ("phi3-medium-14b", dict(paged=True, prefix_cache=True)),
    "spec": ("phi3-medium-14b", dict(paged=True, prefix_cache=True,
                                     spec_decode=True, draft_arch="self")),
    "dense_twin": ("phi3-medium-14b", dict(paged=False, prefix_cache=False)),
    "pool_free": ("mamba2-370m", dict()),
}


def _traffic(request_cls, vocab):
    """``tests/test_telemetry.py``'s traffic, made the same way."""
    return [request_cls(uid=r.uid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens,
                        priority=r.priority, deadline=r.deadline)
            for r in jax_cases._traffic(vocab)]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: tuple(r.generated) for r in eng.completed}


_BRIDGED = {}


def _bridge(arch):
    if arch not in _BRIDGED:
        jcfg = jax_smoke_config(arch).replace(dtype="float32")
        jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
            jax.random.PRNGKey(0))
        cfg = get_smoke_config(arch).replace(dtype="float32")
        _BRIDGED[arch] = (jcfg, jparams, cfg, params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"))
    return _BRIDGED[arch]


@pytest.fixture(scope="module", params=list(CASES))
def twin(request):
    """(case, JAX traced engine, JAX tokens, port traced engine, port
    traced tokens, port untraced tokens) for one case, both traced
    engines under ``make_clock(1e-4)``."""
    arch, kw = CASES[request.param]
    jcfg, jparams, cfg, params = _bridge(arch)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(
        **BASE, **kw, trace=True, trace_clock=jax_cases.make_clock(1e-4)))
    jtok = _drain(jeng, _traffic(JaxRequest, jcfg.vocab_size))
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        **BASE, **kw, trace=True, trace_clock=jax_cases.make_clock(1e-4)),
        device="cpu")
    tok = _drain(eng, _traffic(Request, cfg.vocab_size))
    plain = EdgeServingEngine(cfg, params, ServeConfig(**BASE, **kw),
                              device="cpu")
    assert plain.tracer is None
    untraced = _drain(plain, _traffic(Request, cfg.vocab_size))
    return request.param, jeng, jtok, eng, tok, untraced


def test_traced_tokens_equal_untraced_and_jax(twin):
    case, _, jtok, eng, tok, untraced = twin
    assert len(tok) == 4 and all(len(t) == 5 for t in tok.values())
    assert tok == untraced
    assert tok == jtok
    assert eng.paged == (case != "dense_twin" and case != "pool_free")


def test_stats_equal_jax(twin):
    _, jeng, _, eng, _, _ = twin
    assert eng.stats() == jeng.stats()


def test_chrome_events_equal_jax(twin):
    """Event for event: name, phase, track, stamp, duration and args."""
    case, jeng, _, eng, _, _ = twin
    mine, theirs = eng.tracer.chrome_events(), jeng.tracer.chrome_events()
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a == b
    names = {e.get("name", "").split(" u")[0] for e in mine}
    assert {"step", "admit", "plan", "dispatch", "sync", "retire",
            "publish", "prefill_dispatch", "prefill_sync",
            "request_summary"} <= names
    assert ("spec_round" in names) == (case == "spec")
    assert ("draft" in names) == (case == "spec")


def test_request_summaries_equal_jax_and_exact(twin):
    _, jeng, _, eng, _, _ = twin
    rows = eng.tracer.request_summaries()
    assert rows == jeng.tracer.request_summaries()
    assert [r["uid"] for r in rows] == [0, 1, 2, 3]
    for row in rows:
        assert (row["queue_wait_us"] + row["prefill_us"]
                + row["first_wave_us"]) == row["ttft_us"]
        assert row["e2e_us"] >= row["ttft_us"]
        assert row["n_tokens"] == 5 and len(row["itl_us"]) == 4


def test_dump_is_valid_and_summarizes_as_jax(twin, tmp_path):
    _, jeng, _, eng, _, _ = twin
    meta = eng.dump_chrome_trace(str(tmp_path / "port.json"))
    jeng.dump_chrome_trace(str(tmp_path / "jax.json"))
    mine = json.loads((tmp_path / "port.json").read_text())
    theirs = json.loads((tmp_path / "jax.json").read_text())
    assert meta["requests"] == 4
    assert meta["events"] == len(mine["traceEvents"])
    assert torch_telemetry.validate_chrome_trace(mine["traceEvents"]) == []
    assert (torch_telemetry.summarize_trace(mine)
            == jax_telemetry.summarize_trace(theirs))


def test_dump_requires_trace_enabled(tmp_path):
    _, _, cfg, params = _bridge("phi3-medium-14b")
    eng = EdgeServingEngine(cfg, params, ServeConfig(**BASE), device="cpu")
    with pytest.raises(ValueError, match="tracing is off"):
        eng.dump_chrome_trace(str(tmp_path / "never.json"))
    assert not (tmp_path / "never.json").exists()


def test_preempt_resume_and_cancel_are_traced():
    """A preempted request's residency closes and its resume opens a new
    one; a cancelled one ends its lifecycle with ``cancel`` (the events
    JAX's ``preempt`` / ``_admit_resumed`` / ``_mark_cancelled``
    record)."""
    _, _, cfg, params = _bridge("phi3-medium-14b")
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        **BASE, prefix_cache=False, trace=True), device="cpu")
    reqs = _traffic(Request, cfg.vocab_size)
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    eng.step()
    slot = next(s for s in range(2) if eng.slot_req[s] is reqs[0])
    eng.submit(eng.preempt(slot))
    assert eng.cancel(reqs[1].uid)
    eng.run_until_drained()
    assert torch_telemetry.validate_chrome_trace(
        eng.tracer.chrome_events()) == []
    log = {uid: [name for name, _, _ in evs]
           for uid, evs in eng.tracer.requests.items()}
    assert log[0].count("admitted") == 1
    assert ["preempt", "resubmit", "queued", "resume"] == [
        n for n in log[0] if n in ("preempt", "resubmit", "queued",
                                   "resume")][-4:]
    assert log[0][-1] == "finish"
    assert log[1][-1] == "cancel"
    begins = [e for e in eng.tracer.events if e["ph"] == "B"
              and e["args"]["uid"] == 0]
    assert len(begins) == 2


# ---------------------------------------------------------------------------
# stats() schema snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag,kw,expected", jax_cases.SCHEMA_AXES,
                         ids=[a[0] for a in jax_cases.SCHEMA_AXES])
def test_stats_schema_snapshot(tag, kw, expected):
    cfg = get_smoke_config("phi3-medium-14b").replace(dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        max_slots=2, max_len=96, prefill_buckets=(8, 16, 32), **kw),
        device="cpu")
    assert tuple(eng.stats().keys()) == expected, tag
