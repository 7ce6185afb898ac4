"""The port's always-on frontend and serve CLI against the JAX package.

``tests/test_async_serve.py``'s five contracts on the port's
``AsyncServingFrontend`` (streamed tokens equal ``req.generated``, a
mid-flight arrival with its callback, cancel mid-flight with no page
leaked, shutdown without drain, shutdown flushing the prefix store for
a warm restart); a twin: four requests submitted before the first step
stream the JAX frontend's tokens, and under one tick clock the traced
frontends record the same events; a traced frontend's
``cancel_applied`` / ``frontend_queues`` events and its dump at
shutdown; steps on the executor thread whatever the caller's grad mode
(weights that require grad, the hand-kernel switch on); a step that
raises fails every open handle instead of hanging it; and the CLI in
both modes, in process, at smoke scale on the CPU: the JAX CLI's JSON
keys, ``--trace`` writing a valid trace, ``--params`` served the same
in both modes.

Serially about 30 s, most of it the JAX CLI's two runs and the JAX
twin frontend.
"""
import asyncio
import contextlib
import io
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.serving import EdgeServingEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import AsyncServingFrontend, StreamHandle
from repro_torch.models import model as M
from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
from repro_torch.serving.telemetry import validate_chrome_trace
from repro_torch.training import checkpoint as ckpt
from tests.test_telemetry import make_clock

torch.set_num_threads(1)

ARCH = "phi3-medium-14b"        # sharable + spec-decodable smoke arch
LIMIT_S = 120                   # every await of a frontend run


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _scfg(**kw):
    base = dict(max_slots=2, max_len=96, prefill_buckets=(8, 16), seed=11)
    base.update(kw)
    return ServeConfig(**base)


def _req(uid, n=6, cls=Request, **kw):
    rng = np.random.default_rng(100 + uid)
    kw.setdefault("max_new_tokens", 5)
    return cls(uid=uid, prompt=rng.integers(0, 64, n, dtype=np.int32), **kw)


def _assert_no_leak(eng):
    cached = eng.prefix_cache.num_blocks if eng.prefix_cache else 0
    assert eng.pool.num_free + cached == eng.pool.num_blocks
    eng.pool.assert_consistent()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


# ---------------------------------------------------------------------------
# the JAX file's contracts, on the port
# ---------------------------------------------------------------------------

def test_streamed_tokens_match_generated(setup):
    cfg, params = setup
    eng = EdgeServingEngine(cfg, params, _scfg(), device="cpu")

    async def run():
        fe = AsyncServingFrontend(eng)
        await fe.start()
        handles = [fe.submit(_req(uid)) for uid in range(4)]
        assert all(isinstance(h, StreamHandle) for h in handles)
        streams = {}

        async def collect(h):
            streams[h.uid] = [tok async for tok in h]
        await asyncio.gather(*(collect(h) for h in handles))
        done = [await h.done for h in handles]
        await fe.shutdown()
        return fe, done, streams

    fe, done, streams = _run(run())
    assert len(done) == 4
    for r in done:
        assert not r.cancelled and len(r.generated) == 5
        assert streams[r.uid] == [int(t) for t in r.generated]
    assert len(fe.ttft_ms) == 4 and len(fe.itl_ms) == 16
    snap = fe.metrics()
    assert snap["frontend.steps"] == fe.steps > 0
    assert snap["frontend.streams"] == 0
    assert snap["frontend.inbox_depth"] == snap["frontend.pending_cancels"] \
        == 0
    _assert_no_leak(eng)


def test_mid_flight_arrival_and_callback(setup):
    """A request submitted while another is decoding joins the live
    batch; the per-token callback fires once per token, in order."""
    cfg, params = setup
    eng = EdgeServingEngine(cfg, params, _scfg(chunked_prefill=True),
                            device="cpu")
    seen = []

    async def run():
        fe = AsyncServingFrontend(eng)
        await fe.start()
        h0 = fe.submit(_req(0, max_new_tokens=10))
        first = await h0.tokens.get()
        assert first is not None
        h1 = fe.submit(_req(1, max_new_tokens=3),
                       on_token=lambda req, tok: seen.append((req.uid, tok)))
        r1 = await h1.done
        r0 = await h0.done
        await fe.shutdown()
        return r0, r1

    r0, r1 = _run(run())
    assert len(r0.generated) == 10 and len(r1.generated) == 3
    assert seen == [(1, int(t)) for t in r1.generated]
    assert eng.stats()["wave_admitted"] >= 1
    _assert_no_leak(eng)


def test_cancel_mid_flight_stops_stream(setup):
    cfg, params = setup
    eng = EdgeServingEngine(cfg, params, _scfg(), device="cpu")

    async def run():
        fe = AsyncServingFrontend(eng)
        await fe.start()
        h = fe.submit(_req(0, max_new_tokens=64))
        await h.tokens.get()                    # it is decoding
        ok = await fe.cancel(h.uid)
        r = await h.done
        toks = [t async for t in h]             # the stream ends
        unknown = await fe.cancel(999)
        await fe.shutdown()
        return fe, ok, r, toks, unknown

    fe, ok, r, toks, unknown = _run(run())
    assert ok and r.cancelled and r.done
    assert unknown is False
    assert len(r.generated) < 64
    assert len(fe.cancel_ms) == 1
    _assert_no_leak(eng)


def test_shutdown_nodrain_cancels_outstanding(setup):
    cfg, params = setup
    eng = EdgeServingEngine(cfg, params, _scfg(), device="cpu")

    async def run():
        fe = AsyncServingFrontend(eng)
        await fe.start()
        hs = [fe.submit(_req(uid, max_new_tokens=64)) for uid in range(3)]
        await hs[0].tokens.get()
        await fe.shutdown(drain=False)
        with pytest.raises(RuntimeError, match="shutting down"):
            fe.submit(_req(9))
        return [await h.done for h in hs]

    done = _run(run())
    assert all(r.done for r in done)
    assert any(r.cancelled for r in done)
    assert eng.stats()["cancels"] >= 1
    _assert_no_leak(eng)


def test_shutdown_flushes_persist_store(setup, tmp_path):
    """Graceful shutdown writes hot chains; a restarted engine
    rehydrates them warm."""
    cfg, params = setup
    path = str(tmp_path / "hub_store.npz")
    sys_prompt = np.arange(1, 17, dtype=np.int32)   # page-aligned prefix

    def reqs():
        out = []
        for uid in range(3):
            rng = np.random.default_rng(uid)
            tail = rng.integers(0, 64, 4, dtype=np.int32)
            out.append(Request(uid=uid,
                               prompt=np.concatenate([sys_prompt, tail]),
                               max_new_tokens=4))
        return out

    async def serve_all(eng):
        fe = AsyncServingFrontend(eng)
        await fe.start()
        hs = [fe.submit(r) for r in reqs()]
        for h in hs:
            await h.done
        return await fe.shutdown()

    eng1 = EdgeServingEngine(cfg, params, _scfg(prefix_persist_path=path),
                             device="cpu")
    stats = _run(serve_all(eng1))
    assert stats["persist_saved_chains"] >= 1

    eng2 = EdgeServingEngine(cfg, params, _scfg(prefix_persist_path=path),
                             device="cpu")
    assert eng2.stats()["persist_loaded_chains"] >= 1
    _run(serve_all(eng2))
    assert eng2.stats()["prefix_hits"] >= 1     # restart-warm hit


# ---------------------------------------------------------------------------
# twin: the port's frontend against the JAX frontend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


async def _serve_four(frontend_cls, eng, cls):
    """Four requests submitted before the loop's first step (a drain's
    schedule), one longer than the largest bucket; their streams."""
    fe = frontend_cls(eng)
    await fe.start()
    handles = [fe.submit(_req(uid, n=6 + 7 * uid, cls=cls))
               for uid in range(4)]
    streams = {}

    async def collect(h):
        streams[h.uid] = [tok async for tok in h]
    await asyncio.gather(*(collect(h) for h in handles))
    await fe.shutdown()
    return streams


def test_frontend_streams_jax_tokens(bridged):
    """The same four requests through the port's frontend and the JAX
    frontend on bridged weights: equal streams, equal to each engine's
    ``req.generated``; traced under one tick clock each, the two
    frontends and engines record the same events."""
    jcfg, jparams, cfg, params = bridged
    kw = dict(max_slots=2, max_len=96, prefill_buckets=(8, 16), seed=11,
              trace=True)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(
        **kw, trace_clock=make_clock(1e-4)))
    theirs = _run(_serve_four(jax_serve.AsyncServingFrontend, jeng,
                              JaxRequest))
    eng = EdgeServingEngine(cfg, params, ServeConfig(
        **kw, trace_clock=make_clock(1e-4)), device="cpu")
    mine = _run(_serve_four(AsyncServingFrontend, eng, Request))
    assert mine == theirs
    assert len(mine) == 4 and all(len(t) == 5 for t in mine.values())
    assert mine == {r.uid: [int(t) for t in r.generated]
                    for r in eng.completed}
    assert eng.tracer.chrome_events() == jeng.tracer.chrome_events()


def test_traced_frontend_records_cancel_and_dumps(setup, tmp_path):
    cfg, params = setup
    eng = EdgeServingEngine(cfg, params, _scfg(trace=True), device="cpu")
    path = str(tmp_path / "fe.json")

    async def run():
        fe = AsyncServingFrontend(eng, trace_path=path)
        await fe.start()
        h0 = fe.submit(_req(0, max_new_tokens=64))
        h1 = fe.submit(_req(1, max_new_tokens=4))
        await h0.tokens.get()
        assert await fe.cancel(h0.uid)
        await h1.done
        return await fe.shutdown()

    out = _run(run())
    assert out["trace"]["path"] == path and out["trace"]["requests"] == 2
    trace = json.loads(open(path).read())
    events = trace["traceEvents"]
    assert len(events) == out["trace"]["events"]
    assert validate_chrome_trace(events) == []
    applied = [e for e in events if e.get("name") == "cancel_applied"]
    assert len(applied) == 1 and applied[0]["args"]["uid"] == 0
    assert applied[0]["args"]["latency_ms"] >= 0
    queues = [e for e in events if e.get("name") == "frontend_queues"]
    assert queues and all(e["ph"] == "C" for e in queues)
    assert {"streams", "engine_queue"} == set(queues[0]["args"])
    rows = {e["args"]["uid"]: e["args"] for e in events
            if e.get("name") == "request_summary"}
    assert rows[1]["n_tokens"] == 4 and rows[0]["n_tokens"] < 64
    assert eng.cancels == 1
    _assert_no_leak(eng)


# ---------------------------------------------------------------------------
# the executor thread
# ---------------------------------------------------------------------------

def test_steps_ignore_the_callers_grad_mode(setup):
    """Weights that require grad (a trainer's leaves), the hand-kernel
    switch on (its CPU path refuses autograd inputs): the executor
    thread, where grad mode is on whatever the caller set, serves the
    tokens a drain under ``torch.no_grad()`` serves."""
    cfg, params = setup

    def require_grad(tree):
        return {k: (require_grad(v) if isinstance(v, dict) else
                    (v.detach().clone().requires_grad_(True)
                     if v.is_floating_point() else v))
                for k, v in tree.items()}
    needy = require_grad(params)
    scfg = _scfg(use_pallas_paged=True)
    with torch.no_grad():
        ref = EdgeServingEngine(cfg, params, scfg, device="cpu")
        for uid in range(3):
            ref.submit(_req(uid))
        ref.run_until_drained()
    want = {r.uid: [int(t) for t in r.generated] for r in ref.completed}
    eng = EdgeServingEngine(cfg, needy, scfg, device="cpu")

    async def run():
        fe = AsyncServingFrontend(eng)
        await fe.start()
        hs = [fe.submit(_req(uid)) for uid in range(3)]
        out = {h.uid: [t async for t in h] for h in hs}
        await fe.shutdown()
        return out

    assert torch.is_grad_enabled()
    assert _run(run()) == want


def test_a_step_that_raises_fails_the_handles(setup):
    cfg, params = setup
    eng = EdgeServingEngine(cfg, params, _scfg(), device="cpu")

    def broken():
        raise RuntimeError("wave failed")
    eng.step = broken

    async def run():
        fe = AsyncServingFrontend(eng)
        await fe.start()
        h = fe.submit(_req(0))
        with pytest.raises(RuntimeError, match="wave failed"):
            await h.done
        assert [t async for t in h] == []       # the stream ended
        assert isinstance(fe._task.exception(), RuntimeError)
        with pytest.raises(RuntimeError, match="wave failed"):
            await fe.shutdown()

    _run(run())


# ---------------------------------------------------------------------------
# the CLI, in process
# ---------------------------------------------------------------------------

def _line(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().splitlines()[0])


def _jax_main(argv):
    saved = sys.argv
    sys.argv = ["repro.launch.serve"] + argv
    try:
        jax_serve.main()
    finally:
        sys.argv = saved


@pytest.mark.parametrize("mode", ["async", "drain"])
def test_cli_prints_the_jax_keys_and_a_valid_trace(mode, tmp_path):
    argv = ["--requests", "3", "--max-new", "3", "--mode", mode]
    mine = _line(serve.main, argv + ["--device", "cpu", "--trace",
                                     str(tmp_path / "port.json")])
    theirs = _line(_jax_main, argv + ["--trace", str(tmp_path / "jax.json")])
    assert list(mine) == list(theirs)
    assert mine["requests"] == 3 and mine["tokens"] == 9
    assert mine["trace"]["requests"] == 3
    trace = json.loads((tmp_path / "port.json").read_text())
    assert validate_chrome_trace(trace["traceEvents"]) == []
    assert len(trace["traceEvents"]) == mine["trace"]["events"]


def test_cli_defaults_to_async_and_serves_params_alike(setup, tmp_path):
    """``--mode`` defaults to async; a ``--params`` checkpoint serves
    the same tokens in both modes when every request arrives before the
    first step (``--arrival-gap-ms 0``)."""
    assert serve.parse_args([]).mode == "async"
    assert serve.parse_args([]).arrival_gap_ms == 5.0
    cfg = get_smoke_config("gemma3-1b")
    params = M.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    path = str(tmp_path / "ckpt")
    ckpt.save(path, params)
    argv = ["--device", "cpu", "--params", path, "--requests", "3",
            "--max-new", "4", "--arrival-gap-ms", "0"]
    texts = {}
    for mode in ("async", "drain"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve.main(argv + ["--mode", mode])
        texts[mode] = out.getvalue().splitlines()
    assert "goodput_ttft" in json.loads(texts["async"][0])
    assert texts["async"][1:] == texts["drain"][1:]
    assert len(texts["drain"]) == 4
