"""Multi-pod dry-run: build and trace every (arch x shape x mesh) (PyTorch
port of ``repro.launch.dryrun``).

For each combination this builds the step of ``launch.specs`` on the
production mesh (256 or 512 ranks of PyTorch's fake process group, this
process rank 0) and runs it once under ``FakeTensorMode``: tensors carry
shapes and no memory, ops compute nothing and collectives return at
once.  A failure there (a sharding rule DTensor cannot follow, an op
without a sharding rule, a non-divisible dim) is a bug in the system and
is recorded as ``"error"``.  The trace of rank 0's ops gives the
roofline terms (``launch.roofline``); ``memory_analysis`` states the
per-chip argument bytes and the peak of the step's live temporaries
under fake mode.  Results stream to stdout and, with --out, to a JSON
lines file.

The plan traced is the port's, which is not XLA's, so the per-chip
terms are not JAX's where the plans differ.  Every (arch, shape, mesh)
JAX's dry-run compiles traces here too (70 ``ok``, the same 10
skipped); per-chip dot FLOPs agree with JAX's within 5% on 32 of the 70
records.  The divergences, largest first (PERF.md's grid table, from
``scripts/torch_dryrun_grid.py``):

* Attention where the kv heads do not divide the model axis: q, k and v
  are gathered over it and every model rank computes its rows'
  attention whole, where XLA shards head_dim and all-reduces the score
  tiles: ``prefill_32k`` at 3.8-7.4x JAX's dot FLOPs (gemma3-1b,
  gemma2-9b, phi3-medium-14b, internvl2-76b, whisper-base).  The
  multi-pod ``train_4k`` is 2.2-4.6x for those and the ssm and hybrid
  families (gemma3-27b, whose 16 kv heads divide the axis, 1.16x):
  there the sequence carries the model shard, which the chunked and
  blockwise walks gather; mamba2, which has no attention, is 4.6x too,
  a cause not traced yet.
* One-token reads against a cache sharded on head_dim or time take
  DTensor's own route, which moves the cache's shards: collective bytes
  3.5-2070x JAX's on the ``decode_32k`` and ``long_500k`` of gemma3-1b,
  gemma3-27b, zamba2-7b and phi3-medium-14b (zamba2-7b ``long_500k``
  also 11.5-12.2x the dot FLOPs, mamba2-370m's 2.3x).
* The moe dispatch gathers every token for every expert: collective
  bytes 1.7-7.9x JAX's on the prefills and train steps of granite-moe
  and kimi-k2.
* The cache a prefill makes is held whole on every rank until the step
  lays it out by its out sharding, and eager autograd holds every
  layer's saved activations: the temporaries' peak is 0.03-169x JAX's.

The counts are the installed torch's: where the model leaves a layout
to DTensor's rules (the weight gradients' products), versions pick
differently (whisper-base's multi-pod ``train_4k``: 4.89e12 dot FLOPs a
chip on torch 2.13, 2.743e12 on 2.11).

On a (2, 2) mesh at the smoke widths of gemma3-1b (K = 2 and K = 1)
and mamba2-370m the dot FLOPs agree with JAX's within 5%
(``tests/test_torch_sharded.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

``scripts/torch_dryrun_grid.py`` runs the grid one process per (arch,
shape), several at a time, and compares it with a JAX dry-run's records.
"""
from __future__ import annotations

import argparse
import json
import traceback

from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, applicable, get_config
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import presets as pz
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.telemetry import default_clock
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as tr


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of (D)Tensors."""
    return sum(hlo.shape_bytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves(tree))


def run_one(arch: str, shape_name: str, mesh_name: str, *,
            preset: pz.RunPreset, verbose: bool = True) -> dict:
    shape = INPUT_SHAPES[shape_name]
    cfg = M.specialize(get_config(arch), shape)
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    cfg = cfg.replace(param_dtype=preset.param_dtype,
                      moe_rowwise=preset.moe_rowwise)
    tcfg = tr.TrainConfig(
        optimizer=opt.OptimizerConfig(moments_dtype=preset.moments_dtype),
        microbatches=preset.microbatches, remat=preset.remat,
        accum_dtype=preset.accum_dtype)

    t0 = default_clock()
    knob = L.SEQ_PARALLEL_ATTN
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            built = sp.build(cfg, shape, mesh, tcfg=tcfg, fsdp=preset.fsdp,
                             smart=preset.smart)
            args = sp.allocate(built.args, mesh.device_type)
            t_build = default_clock() - t0
            placed = [sp.sh.place(a, mesh, s)
                      for a, s in zip(args, built.in_shardings)]
            with hlo.Trace() as traced:
                built.fn(*placed)
            traced.arg_bytes = _local_bytes(placed)
            t_trace = default_clock() - t0 - t_build
    except Exception as e:  # a failure HERE is a bug in the system
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}
    finally:
        L.SEQ_PARALLEL_ATTN = knob

    chips = mesh_devices(mesh)
    r = rl.analyze(traced, arch=arch, shape_name=shape_name,
                   mesh_name=mesh_name, chips=chips,
                   model_flops=rl.model_flops_for(cfg, shape))
    rec = {"status": "ok", **r.to_dict(),
           "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
           "preset": preset.__dict__,
           "memory_analysis": (
               f"per-chip argument bytes {r.arg_bytes_per_chip:.0f}; "
               f"peak of the step's live temporaries under FakeTensorMode "
               f"{r.temp_bytes_per_chip:.0f} bytes")}
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] "
              f"compute={r.compute_s:.3e}s memory={r.memory_s:.3e}s "
              f"collective={r.collective_s:.3e}s -> {r.bottleneck}-bound; "
              f"args/chip={r.arg_bytes_per_chip/2**30:.2f}GiB "
              f"temp/chip={r.temp_bytes_per_chip/2**30:.2f}GiB "
              f"useful={r.useful_ratio:.2f} "
              f"(build {t_build:.0f}s trace {t_trace:.0f}s)", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="full grid: every (arch x shape)")
    ap.add_argument("--preset", choices=("baseline", "optimized"),
                    default="baseline")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        combos = [(a, s, m) for a in ARCH_IDS for s in INPUT_SHAPES
                  for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required without --all")
        combos = [(args.arch, args.shape, m) for m in meshes]

    getter = pz.baseline if args.preset == "baseline" else pz.optimized
    n_ok = n_skip = n_err = 0
    for arch, shape, mesh in combos:
        rec = run_one(arch, shape, mesh, preset=getter(arch))
        rec.setdefault("preset_name", args.preset)
        if rec["status"] == "ok":
            n_ok += 1
        elif rec["status"] == "skipped":
            n_skip += 1
            print(f"[{arch} x {shape} x {mesh}] SKIP: {rec['reason']}")
        else:
            n_err += 1
            print(f"[{arch} x {shape} x {mesh}] ERROR: {rec['error']}")
        if args.out:
            with open(args.out, "a") as f:
                rec.pop("trace", None)
                f.write(json.dumps(rec) + "\n")
    print(f"dry-run done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
