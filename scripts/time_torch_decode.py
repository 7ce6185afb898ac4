"""Wall time of the port's direct dense decode step on the GPU.

Times ``repro_torch.models.model.decode_step`` (plain tensors, no
kernel switch) for each ``--arch`` at full width, random weights from
seed 0, a prompt of ``--pos`` tokens prefilled into a ``--cache``-long
cache of ``--rows`` rows, then ``--reps`` steps of the same token at the
same position (the same writes every step), each to a synchronised end
after ``--warmup`` untimed steps; ``ARCH:LAYERS`` cuts the depth.  The
step is host-bound (eager per-layer dispatch), so what it measures is
mostly the host's work per layer.

The package comes from ``PYTHONPATH``, so the same script times two
trees of the repo one after the other on one card:

  PYTHONPATH=src python scripts/time_torch_decode.py \\
      --arch gemma3-1b --arch phi3-medium-14b:8

Prints one JSON line: the card's name and power limit, the tree's
package path, and per arch the median, mean and min wall ms.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_arch(arch: str, layers, rows: int, cache: int, pos: int,
              reps: int, warmup: int) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (rows, pos), device="cuda",
                           generator=gen, dtype=torch.int32)
    with torch.no_grad():
        logits, kv = M.prefill(cfg, params, {"tokens": prompt}, cache)
        tok = logits[:, -1:].argmax(-1).int()
        at = torch.full((rows,), pos, dtype=torch.int32, device="cuda")
        ms = []
        for i in range(warmup + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.decode_step(cfg, params, kv, tok, at)
            torch.cuda.synchronize()
            if i >= warmup:
                ms.append((time.perf_counter() - t0) * 1e3)
    del params, kv
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "rows": rows, "cache": cache,
            "position": pos, "reps": reps,
            "median_ms": statistics.median(ms),
            "mean_ms": statistics.fmean(ms), "min_ms": min(ms)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", required=True,
                    help="ARCH or ARCH:LAYERS (depth cut); repeatable")
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--cache", type=int, default=4096)
    ap.add_argument("--pos", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    import repro_torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_decode: no CUDA device")
    out = {"card": _card(), "package": repro_torch.__file__, "archs": {}}
    for spec in args.arch:
        arch, _, layers = spec.partition(":")
        out["archs"][spec] = time_arch(arch, int(layers or 0), args.rows,
                                       args.cache, args.pos, args.reps,
                                       args.warmup)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
