"""Run the port's dry-run over the whole (arch x shape x mesh) grid, one
process per (arch, shape) pair and several at a time, and compare it
with a JAX dry-run's records.

Each pair runs as ``python -m repro_torch.launch.dryrun --arch A --shape
S --mesh both --out OUT`` (a process brings up its own fake world of
256 / 512 ranks, so pairs cannot share one).  The records land in OUT,
one JSON line each.  The whole grid takes about 18 minutes with 6 jobs
on 8 cores; the slowest pairs (the ``prefill_32k`` of internvl2-76b
and kimi-k2, 14-18 minutes alone) start first.

  PYTHONPATH=src python scripts/torch_dryrun_grid.py --out grid.jsonl -j 6

``--compare JAX.jsonl`` prints a markdown table, one row per (arch,
shape): each mesh's status and per-chip dot FLOPs, collective bytes and
temporaries' peak as port / JAX (ratio), JAX's from ``python -m
repro.launch.dryrun --all --mesh both --out JAX.jsonl``.  With
``--no-run`` it only reads the two files.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES

# Pairs whose traces take longest go first, so the pool's tail is short.
_SLOW = ("prefill_32k", "train_4k", "long_500k", "decode_32k")


def run_grid(out: str, jobs: int, pairs=None) -> float:
    pairs = pairs or sorted(
        ((a, s) for a in ARCH_IDS for s in INPUT_SHAPES),
        key=lambda p: _SLOW.index(p[1]) if p[1] in _SLOW else len(_SLOW))
    env = dict(os.environ)
    t0 = time.perf_counter()
    running: list[tuple[subprocess.Popen, tuple[str, str], float]] = []
    todo = list(pairs)
    while todo or running:
        while todo and len(running) < jobs:
            a, s = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", "both", "--out", out]
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            running.append((p, (a, s), time.perf_counter()))
        for item in list(running):
            p, (a, s), t = item
            if p.poll() is None:
                continue
            running.remove(item)
            tail = p.stdout.read().strip().splitlines()[-1:] if p.stdout else []
            print(f"[{time.perf_counter() - t0:7.1f}s] {a} x {s}: rc "
                  f"{p.returncode} in {time.perf_counter() - t:.1f}s "
                  f"{tail[0] if tail else ''}", flush=True)
        time.sleep(0.5)
    return time.perf_counter() - t0


def _load(path: str) -> dict:
    recs = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def _g(x) -> str:
    return "-" if x is None else f"{x:.3g}"


def _pair(p: dict, j: dict, field: str) -> str:
    """``port / JAX`` of one record field, and their ratio."""
    a, b = p.get(field), j.get(field)
    if a is None or b is None:
        return f"{_g(a)} / {_g(b)}"
    return f"{_g(a)} / {_g(b)} ({a / b:.2f})"


def compare(port_path: str, jax_path: str) -> None:
    """A markdown table, one row per applicable (arch, shape): each
    mesh's status and each field as ``port / JAX (ratio)``."""
    port, ref = _load(port_path), _load(jax_path)
    for name, recs in (("port", port), ("jax", ref)):
        print(name, {s: sum(r["status"] == s for r in recs.values())
                     for s in ("ok", "skipped", "error")})
    fields = (("hlo_flops_per_chip", "dot FLOPs"),
              ("coll_bytes_per_chip", "collective bytes"),
              ("temp_bytes_per_chip", "temporaries"))
    print("| arch | shape | status single / multi (port; JAX) | "
          + " | ".join(f"{t} {m} (port / JAX)" for _, t in fields
                       for m in ("single", "multi")) + " |")
    print("|---|---|---|" + "---|" * 2 * len(fields))
    skipped = []
    for a, s in sorted({(a, s) for a, s, _ in set(port) | set(ref)}):
        ps = [port.get((a, s, m), {}) for m in ("single", "multi")]
        js = [ref.get((a, s, m), {}) for m in ("single", "multi")]
        if all(r.get("status") == "skipped" for r in ps + js):
            skipped.append(f"{a} {s}")
            continue
        st = " / ".join(r.get("status", "missing") for r in ps) + "; " \
            + " / ".join(r.get("status", "missing") for r in js)
        cols = [_pair(p, j, f) for f, _ in fields for p, j in zip(ps, js)]
        print(f"| {a} | {s} | {st} | " + " | ".join(cols) + " |")
    print("skipped on both meshes by both:", ", ".join(skipped))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dryrun_grid.jsonl")
    ap.add_argument("-j", "--jobs", type=int, default=6)
    ap.add_argument("--compare", default=None,
                    help="JAX dry-run JSONL to compare --out with")
    ap.add_argument("--no-run", action="store_true",
                    help="only compare the files already written")
    args = ap.parse_args(argv)
    if not args.no_run:
        took = run_grid(args.out, args.jobs)
        recs = _load(args.out)
        print(f"grid done in {took:.0f}s: " + ", ".join(
            f"{sum(r['status'] == s for r in recs.values())} {s}"
            for s in ("ok", "skipped", "error")))
    if args.compare:
        compare(args.out, args.compare)


if __name__ == "__main__":
    main()
