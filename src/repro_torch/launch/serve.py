"""Always-on serving frontend over the step-driven engine, and the serve
CLI (PyTorch port of ``repro.launch.serve``).

``AsyncServingFrontend`` wraps ``EdgeServingEngine`` in an asyncio loop
with no drain assumption: requests arrive and are cancelled mid-flight,
tokens stream to per-request handles (and optional callbacks) as each
step retires them, and a graceful shutdown flushes the prefix store
(``engine.close()``) and, traced, writes the Chrome trace.

Threading model: the engine is single-threaded.  Every engine call
(``submit`` / ``cancel`` / ``step`` / ``close``) happens in the one
background ``_run`` task; the public API posts intents to an inbox and
wakes the loop.  ``step`` runs on the loop's default executor, so the
loop stays responsive to arrivals during a wave; that thread starts
with its own grad mode, current device and current stream, so the
frontend makes the engine's device current for each step (kernels
launch on its default stream) and ``step`` itself runs under
``torch.no_grad()``.  A step that raises ends the loop and fails every
open handle with the error, so no caller waits forever.

    python -m repro_torch.launch.serve --scale full
    python -m repro_torch.launch.serve --scale full --trace PATH
    python -m repro_torch.launch.serve --mode drain --scale full
    python -m repro_torch.launch.serve --arch phi3-medium-14b --scale full
    python -m repro_torch.launch.serve --arch mamba2-370m --scale full
    python -m repro_torch.launch.serve --arch zamba2-7b --scale full
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --scale full
    python -m repro_torch.launch.serve --arch whisper-base --scale full
    python -m repro_torch.launch.serve --arch internvl2-76b --scale smoke
    python -m repro_torch.launch.serve --arch phi3-medium-14b --persist PATH

``--mode async`` (the default, as in the JAX CLI) submits
``--requests`` random prompts into a live frontend ``--arrival-gap-ms``
apart and streams their tokens; ``--mode drain`` submits them all and
steps the engine until it drains.  Either prints one JSON line with the
JAX CLI's keys for that mode.  ``--trace PATH`` records the engine's
spans and request lifecycles and writes a Perfetto / chrome://tracing
JSON to PATH at the end (the line gains a ``trace`` key).  The engine
runs at ``ServeConfig``'s defaults, as the JAX CLI's does: the radix
prefix cache is on wherever the arch can share pages.  ``--persist
PATH`` reads a prefix store from PATH at startup and writes the warm
chains back at the end (``engine.close()``), adding the JAX CLI's
``persist_*`` keys to the line.  The default
arch is gemma3-1b, as in the JAX CLI.  Weights are random, from a seeded
``torch.Generator`` on the device, or restored from ``--params`` (a
checkpoint of ``training.checkpoint.save``, as ``launch.train
--checkpoint`` writes) onto them.  On a CUDA device the engine reads
paged decode KV through the hand-written ``paged_attention`` kernel (a
moe model too: its router, dispatch and expert products are plain
PyTorch, as the JAX package computes them outside any kernel; an
ssm or hybrid model, served without a page pool, runs its admission
prefills' scan through ``ssd_scan`` instead, and the hybrid's shared
attention block through ``flash_attention``) and stores weights in the
activation dtype (every weight is cast to it before use, so the math is
unchanged).  ``--spec`` serves speculatively (``--draft self`` for the
early-exit self-draft or a registry id, ``--gamma`` tokens a round) and
adds the acceptance numbers to the line.
"""
from __future__ import annotations

import argparse
import asyncio
import json
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.devices import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (EdgeServingEngine, Request, ServeConfig,
                                 default_clock)
from repro_torch.serving.telemetry import FRONTEND_TID
from repro_torch.training import checkpoint as ckpt


class StreamHandle:
    """Per-request streaming view handed back by ``submit``.

    Tokens arrive on an asyncio queue as the engine retires them (a
    ``None`` sentinel ends the stream); ``done`` resolves with the
    finished ``Request`` (``req.cancelled`` tells a mid-flight cancel
    from completion), or with the error of a step that raised.  Create
    it on the running loop.
    """

    def __init__(self, req: Request, clock: Callable[[], float] = None):
        self.req = req
        self.uid = req.uid
        self.delivered = 0
        self.tokens: asyncio.Queue = asyncio.Queue()
        self.done: asyncio.Future = (
            asyncio.get_running_loop().create_future())
        self._clock = clock if clock is not None else default_clock
        self.t_submit = self._clock()
        self.t_tokens: list[float] = []     # arrival time of each token

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        while True:
            tok = await self.tokens.get()
            if tok is None:
                return
            yield tok


class AsyncServingFrontend:
    """Always-on asyncio frontend: admit, stream, cancel, shut down.

    The background task loops ``engine.step()`` while work exists and
    parks on an event when idle, so an idle frontend burns no cycles but
    wakes on the next arrival.  Per-token delivery diffs
    ``req.generated`` after each step: the engine knows nothing of the
    frontend.  ``frontend.*`` gauges join the engine's registry.
    """

    def __init__(self, engine: EdgeServingEngine,
                 trace_path: Optional[str] = None):
        self.engine = engine
        self.trace_path = trace_path
        # the engine's trace clock, so frontend stamps and engine spans
        # share one timeline
        self._clock = (engine.tracer.clock if engine.tracer is not None
                       else default_clock)
        self._inbox: list[Request] = []
        self._cancels: list[tuple[int, asyncio.Future, float]] = []
        self._handles: dict[int, StreamHandle] = {}
        self._callbacks: dict[int, Callable] = {}
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closing = False
        self.ttft_ms: list[float] = []      # first-token latency/request
        self.itl_ms: list[float] = []       # every inter-token gap
        self.cancel_ms: list[float] = []    # cancel() call -> applied
        self.steps = 0
        m = engine.metrics
        m.gauge("frontend.steps", lambda: self.steps)
        m.gauge("frontend.streams", lambda: len(self._handles))
        m.gauge("frontend.inbox_depth", lambda: len(self._inbox))
        m.gauge("frontend.pending_cancels", lambda: len(self._cancels))

    def metrics(self) -> dict:
        """Snapshot of the whole registry: engine, subsystems and the
        frontend gauges."""
        return self.engine.metrics.collect()

    # -- public API (call from coroutines on the running loop) --------
    async def start(self) -> None:
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._run())

    def submit(self, req: Request,
               on_token: Optional[Callable[[Request, int], None]] = None,
               ) -> StreamHandle:
        """Enqueue a request; returns a handle streaming its tokens."""
        if self._closing:
            raise RuntimeError("frontend is shutting down")
        h = StreamHandle(req, clock=self._clock)
        self._handles[req.uid] = h
        if on_token is not None:
            self._callbacks[req.uid] = on_token
        self._inbox.append(req)
        self._wake.set()
        return h

    def cancel(self, uid: int) -> asyncio.Future:
        """Request mid-flight cancellation; the future resolves True /
        False once the engine applied it (between steps)."""
        fut = asyncio.get_running_loop().create_future()
        self._cancels.append((uid, fut, self._clock()))
        self._wake.set()
        return fut

    async def shutdown(self, drain: bool = True) -> dict:
        """Stop the loop, flush the prefix store and, traced, write the
        trace.  ``drain=True`` finishes in-flight and queued work first;
        ``drain=False`` cancels everything outstanding."""
        if not drain:
            for uid in list(self._handles):
                self.cancel(uid)
        self._closing = True
        self._wake.set()
        if self._task is not None:
            await self._task
        out = self.engine.close()           # persists hot chains
        if self.trace_path and self.engine.tracer is not None:
            out["trace"] = dict(
                self.engine.dump_chrome_trace(self.trace_path),
                path=self.trace_path)
        return out

    def slo_stats(self, ttft_slo_ms: float = 1e9,
                  itl_slo_ms: float = 1e9) -> dict:
        """TTFT / ITL percentiles plus goodput under the given SLO."""
        def pct(xs, q):
            if not xs:
                return 0.0
            s = sorted(xs)
            return s[min(len(s) - 1, int(q * len(s)))]
        return {
            "ttft_p50_ms": round(pct(self.ttft_ms, 0.50), 2),
            "ttft_p99_ms": round(pct(self.ttft_ms, 0.99), 2),
            "itl_p50_ms": round(pct(self.itl_ms, 0.50), 2),
            "itl_p99_ms": round(pct(self.itl_ms, 0.99), 2),
            "goodput_ttft": round(
                sum(1 for t in self.ttft_ms if t <= ttft_slo_ms)
                / max(1, len(self.ttft_ms)), 3),
            "goodput_itl": round(
                sum(1 for t in self.itl_ms if t <= itl_slo_ms)
                / max(1, len(self.itl_ms)), 3),
        }

    # -- internals ----------------------------------------------------
    def _drain_control(self) -> None:
        """Apply queued submits and cancels on the loop, between steps:
        the only place besides ``step`` that touches the engine."""
        eng = self.engine
        tr = eng.tracer
        inbox, self._inbox = self._inbox, []
        for req in inbox:
            h = self._handles[req.uid]
            h.t_submit = self._clock()
            eng.submit(req)
        cancels, self._cancels = self._cancels, []
        for uid, fut, t0 in cancels:
            ok = eng.cancel(uid)
            if ok:
                lat_ms = (self._clock() - t0) * 1e3
                self.cancel_ms.append(lat_ms)
                if tr is not None:
                    tr.instant("cancel_applied", tid=FRONTEND_TID,
                               uid=uid, latency_ms=lat_ms)
            if not fut.done():
                fut.set_result(ok)
            if ok:
                self._resolve(uid)
        if tr is not None and (inbox or cancels):
            tr.counter("frontend_queues", tid=FRONTEND_TID,
                       streams=len(self._handles),
                       engine_queue=len(eng.queue))

    def _deliver(self) -> None:
        """Diff ``req.generated`` against what each handle has seen and
        stream the delta; resolve handles whose request finished."""
        now = self._clock()
        for uid in list(self._handles):
            h = self._handles[uid]
            req = h.req
            n = len(req.generated)
            while h.delivered < n:
                tok = int(req.generated[h.delivered])
                h.delivered += 1
                if h.t_tokens:
                    self.itl_ms.append((now - h.t_tokens[-1]) * 1e3)
                else:
                    self.ttft_ms.append((now - h.t_submit) * 1e3)
                h.t_tokens.append(now)
                h.tokens.put_nowait(tok)
                cb = self._callbacks.get(uid)
                if cb is not None:
                    cb(req, tok)
            if req.done:
                self._resolve(uid)

    def _resolve(self, uid: int) -> None:
        h = self._handles.pop(uid, None)
        self._callbacks.pop(uid, None)
        if h is None:
            return
        h.tokens.put_nowait(None)
        if not h.done.done():
            h.done.set_result(h.req)

    def _fail(self, exc: BaseException) -> None:
        """The loop ended on an error: end every open stream and fail
        every open handle and cancel future with it."""
        futs = [h.done for h in self._handles.values()]
        futs += [fut for _, fut, _ in self._cancels]
        for h in self._handles.values():
            h.tokens.put_nowait(None)
        self._handles.clear()
        self._callbacks.clear()
        for fut in futs:
            if fut.done():
                continue
            if isinstance(exc, asyncio.CancelledError):
                fut.cancel()
            else:
                fut.set_exception(exc)

    def _step(self) -> int:
        """One engine step, on the executor thread: with the engine's
        device current there (a new thread starts on device 0)."""
        dev = self.engine.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else nullcontext()):
            return self.engine.step()

    async def _run(self) -> None:
        try:
            await self._loop()
        except BaseException as exc:
            self._fail(exc)
            raise

    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        eng = self.engine
        while True:
            self._drain_control()
            busy = bool(eng.queue) or bool(eng.active.any())
            if busy:
                await loop.run_in_executor(None, self._step)
                self.steps += 1
                self._deliver()
                continue
            if self._inbox or self._cancels:
                continue                    # new intents: apply now
            if self._closing:
                return
            self._wake.clear()
            if self._inbox or self._cancels or self._closing:
                continue                    # landed before the clear
            await self._wake.wait()


def build_engine(arch: str, scale: str, scfg_kw: dict, device=None,
                 seed: int = 0, params_path: Optional[str] = None):
    """(cfg, engine) for ``arch`` at ``scale`` ("smoke" | "full") with
    random weights from ``seed`` on ``device`` (default ``cuda``), or the
    checkpoint at ``params_path`` restored onto them: each leaf on the
    engine's device in the dtype of the weight it replaces.  The
    ``ServeConfig`` takes ``scfg_kw`` over its defaults, with
    ``use_pallas_paged`` defaulting to True on a CUDA device."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if scale == "smoke" else get_config(arch)
    if dev.type == "cuda":
        cfg = cfg.replace(param_dtype=cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, gen, dev)
    if params_path:
        restored = ckpt.restore(params_path, params)
        params = _cast_like(restored, params)
    scfg = ServeConfig(**{"use_pallas_paged": dev.type == "cuda",
                          **scfg_kw})
    return cfg, EdgeServingEngine(cfg, params, scfg, device=dev)


def _cast_like(tree, like):
    if isinstance(tree, dict):
        return {k: _cast_like(v, like[k]) for k, v in tree.items()}
    return tree.to(like.dtype)


def make_requests(cfg, n: int, min_prompt: int, max_prompt: int,
                  max_new: int, policy: str) -> list:
    """``n`` requests with prompts of ``min_prompt..max_prompt`` random
    tokens and, for the vlm and encdec families, their stub image or
    audio embeddings (``0.1 * normal``, float32), all from one
    ``np.random.default_rng(0)`` in the JAX CLI's order: the JAX CLI's
    traffic, bit for bit."""
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(n):
        length = int(rng.integers(min_prompt, max_prompt + 1))
        extras = {}
        if cfg.family == "vlm":
            extras["image_embeds"] = rng.normal(
                0, 0.1, (cfg.num_image_tokens, cfg.image_embed_dim)
            ).astype(np.float32)
        if cfg.family == "encdec":
            extras["audio_embeds"] = rng.normal(
                0, 0.1, (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, length, dtype=np.int32),
            max_new_tokens=max_new,
            priority=uid % 3,
            deadline=float(uid) if policy == "edf" else None,
            extras=extras))
    return reqs


def run_drain(eng, reqs) -> dict:
    """Submit every request, step until the engine drains, and return
    the raw (unrounded) drain numbers: counts, elapsed seconds, tok/s
    and the sorted per-request TTFTs in ms.  Each step ends with the
    device result copied to the host, so host stamps bound the work."""
    t0 = default_clock()
    t_submit, t_first = {}, {}
    for req in reqs:
        eng.submit(req)
        t_submit[req.uid] = default_clock()
    while eng.queue or eng.active.any():
        eng.step()
        now = default_clock()
        for r in reqs:
            if r.uid not in t_first and r.generated:
                t_first[r.uid] = now
    dt = default_clock() - t0
    toks = sum(len(r.generated) for r in eng.completed)
    ttft = sorted((t_first[u] - t_submit[u]) * 1e3 for u in t_first)
    return {"requests": len(eng.completed), "decode_steps": eng.steps,
            "tokens": toks, "elapsed_s": dt, "tok_per_s": toks / dt,
            "ttft_ms": ttft}


async def serve_async(eng, reqs, arrival_gap_ms: float = 5.0,
                      trace_path: Optional[str] = None) -> dict:
    """Staggered arrivals into a live frontend: submit ``reqs``
    ``arrival_gap_ms`` apart, wait for every one, shut down.  Returns
    the frontend's ``slo_stats()`` and shutdown keys with the request,
    token and step counts (the JAX CLI's async-mode keys but the
    timing ones ``main`` adds)."""
    fe = AsyncServingFrontend(eng, trace_path=trace_path)
    await fe.start()
    handles = []
    gap = arrival_gap_ms / 1e3
    for req in reqs:
        handles.append(fe.submit(req))
        if gap:
            await asyncio.sleep(gap)
    done = [await h.done for h in handles]
    out = dict(fe.slo_stats())
    out.update(await fe.shutdown())
    out["requests"] = len(done)
    out["tokens"] = sum(len(r.generated) for r in done)
    out["decode_steps"] = fe.steps
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--mode", choices=("async", "drain"), default="async",
                    help="async: always-on frontend with staggered "
                         "arrivals and streaming; drain: submit all, then "
                         "step until the engine drains")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="0 disables top-k filtering")
    ap.add_argument("--policy", choices=("fifo", "priority", "edf"),
                    default="priority",
                    help="QoE admission ordering (core.scheduler)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding (serving.spec_decode)")
    ap.add_argument("--draft", default="self",
                    help="draft arch for --spec: a registry id, or "
                         "'self' for the early-exit self-draft")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculation width (proposals per round + 1); "
                         "also the multi-token catch-up chunk")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill: admit prompts as wave spans "
                         "interleaved with decode (no blocking prefill)")
    ap.add_argument("--arrival-gap-ms", type=float, default=5.0,
                    help="async mode: gap between request arrivals")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record engine spans and request lifecycles and "
                         "write a Perfetto / chrome://tracing JSON to PATH "
                         "at the end")
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--persist", metavar="PATH", default=None,
                    help="prefix-store path: rehydrate the radix prefix "
                         "cache from PATH at startup and save the hot "
                         "chains back when the drain ends; a corrupt or "
                         "mismatched store is rejected (cold start).  "
                         "Only engages on prefix-sharable archs")
    ap.add_argument("--params", default=None,
                    help="checkpoint to serve (training.checkpoint.save "
                         "format), restored onto the seeded weights")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg, eng = build_engine(args.arch, args.scale, dict(
        max_slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, top_k=args.top_k,
        policy=args.policy, spec_decode=args.spec,
        draft_arch=args.draft if args.spec else None,
        spec_gamma=args.gamma, chunked_prefill=args.chunked,
        prefix_persist_path=args.persist, trace=bool(args.trace)),
        args.device, params_path=args.params)
    reqs = make_requests(cfg, args.requests, args.min_prompt,
                         args.max_prompt, args.max_new, args.policy)
    if args.mode == "async":
        t0 = default_clock()
        out = asyncio.run(serve_async(eng, reqs, args.arrival_gap_ms,
                                      args.trace))
        dt = default_clock() - t0
        out["elapsed_s"] = round(dt, 2)
        out["tok_per_s"] = round(out["tokens"] / dt, 1)
        out["policy"] = args.policy
    else:
        raw = run_drain(eng, reqs)
        ttft = raw["ttft_ms"]
        out = {
            "requests": raw["requests"],
            "decode_steps": raw["decode_steps"], "tokens": raw["tokens"],
            "elapsed_s": round(raw["elapsed_s"], 2),
            "tok_per_s": round(raw["tok_per_s"], 1),
            "ttft_p50_ms": round(ttft[len(ttft) // 2], 1),
            "ttft_p99_ms": round(ttft[min(len(ttft) - 1,
                                          int(0.99 * len(ttft)))], 1),
            "policy": args.policy,
        }
        if args.persist:
            out.update(eng.close())     # save the warm chains back
        if args.trace:
            out["trace"] = dict(eng.dump_chrome_trace(args.trace),
                                path=args.trace)
    st = eng.stats()
    if args.spec:
        out.update({
            "spec_active": st["spec_active"],
            "spec_accept_rate": round(st["spec_acceptance"], 3),
            "spec_tokens_per_step": round(st["spec_tokens_per_round"], 3),
        })
    if args.chunked:
        out.update({"mixed_waves": st["mixed_waves"],
                    "wave_admitted": st["wave_admitted"]})
    if args.persist:
        out.update({
            "persist_loaded_chains": st.get("persist_loaded_chains", 0),
            "persist_loaded_blocks": st.get("persist_loaded_blocks", 0),
            "persist_rejected": st.get("persist_rejected", ""),
            "prefix_hits": st.get("prefix_hits", 0),
            "prefix_hit_tokens": st.get("prefix_hit_tokens", 0),
        })
    print(json.dumps(out))
    for r in eng.completed[:3]:
        print(f"  req {r.uid}: {list(map(int, r.generated[:10]))}...")


if __name__ == "__main__":
    main()
