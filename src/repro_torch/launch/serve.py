"""Serve a model through the port's engine: the drain-mode CLI (PyTorch
port of ``repro.launch.serve``; the asyncio frontend is a later slice).

    python -m repro_torch.launch.serve --scale full
    python -m repro_torch.launch.serve --arch phi3-medium-14b --scale full
    python -m repro_torch.launch.serve --arch mamba2-370m --scale full
    python -m repro_torch.launch.serve --arch zamba2-7b --scale full

submits ``--requests`` random prompts, steps the engine until it drains
and prints one JSON line (the JAX CLI's drain-mode keys).  The default
arch is gemma3-1b, as in the JAX CLI.  Weights are random, from a seeded
``torch.Generator`` on the device, or restored from ``--params`` (a
checkpoint of ``training.checkpoint.save``, as ``launch.train
--checkpoint`` writes) onto them.  On a CUDA device the engine reads
paged decode KV through the hand-written ``paged_attention`` kernel (an
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
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.devices import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (EdgeServingEngine, Request, ServeConfig,
                                 default_clock)
from repro_torch.training import checkpoint as ckpt


def build_engine(arch: str, scale: str, scfg_kw: dict, device=None,
                 seed: int = 0, params_path: Optional[str] = None):
    """(cfg, engine) for ``arch`` at ``scale`` ("smoke" | "full") with
    random weights from ``seed`` on ``device`` (default ``cuda``), or the
    checkpoint at ``params_path`` restored onto them: each leaf on the
    engine's device in the dtype of the weight it replaces."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if scale == "smoke" else get_config(arch)
    if dev.type == "cuda":
        cfg = cfg.replace(param_dtype=cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, gen, dev)
    if params_path:
        restored = ckpt.restore(params_path, params)
        params = _cast_like(restored, params)
    scfg = ServeConfig(prefix_cache=False,
                       use_pallas_paged=dev.type == "cuda", **scfg_kw)
    return cfg, EdgeServingEngine(cfg, params, scfg, device=dev)


def _cast_like(tree, like):
    if isinstance(tree, dict):
        return {k: _cast_like(v, like[k]) for k, v in tree.items()}
    return tree.to(like.dtype)


def make_requests(cfg, n: int, min_prompt: int, max_prompt: int,
                  max_new: int, policy: str) -> list:
    """``n`` requests with prompts of ``min_prompt..max_prompt`` random
    tokens from ``np.random.default_rng(0)`` (the JAX CLI's traffic)."""
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(n):
        length = int(rng.integers(min_prompt, max_prompt + 1))
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, length, dtype=np.int32),
            max_new_tokens=max_new,
            priority=uid % 3,
            deadline=float(uid) if policy == "edf" else None))
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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke")
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
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=24)
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
        spec_gamma=args.gamma, chunked_prefill=args.chunked), args.device,
        params_path=args.params)
    reqs = make_requests(cfg, args.requests, args.min_prompt,
                         args.max_prompt, args.max_new, args.policy)
    raw = run_drain(eng, reqs)
    ttft = raw["ttft_ms"]
    out = {
        "requests": raw["requests"], "decode_steps": raw["decode_steps"],
        "tokens": raw["tokens"], "elapsed_s": round(raw["elapsed_s"], 2),
        "tok_per_s": round(raw["tok_per_s"], 1),
        "ttft_p50_ms": round(ttft[len(ttft) // 2], 1),
        "ttft_p99_ms": round(ttft[min(len(ttft) - 1,
                                      int(0.99 * len(ttft)))], 1),
        "policy": args.policy,
    }
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
    print(json.dumps(out))
    for r in eng.completed[:3]:
        print(f"  req {r.uid}: {list(map(int, r.generated[:10]))}...")


if __name__ == "__main__":
    main()
