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

The plan traced is the port's, which is not XLA's in two places, so the
per-chip terms are not JAX's there.  Attention walks rank by rank with
rows and kv heads sharded (``layers._shardwise``); where K does not
divide the model axis, q, k and v are gathered over it and every model
rank computes its rows' attention whole, where XLA shards head_dim and
all-reduces each score tile (gemma3-1b ``prefill_32k`` on the (16, 16)
mesh: 2.99e13 dot FLOPs and 4.01e10 collective bytes per chip here,
8.29e12 and 2.01e11 in JAX's dry-run).  And the cache a prefill makes
is held whole on every rank until the step lays it out by its out
sharding, which counts in the temporaries' peak.  On a (2, 2) mesh at
gemma3-1b's smoke width, with K = 2 and with K = 1, the dot FLOPs agree
with JAX's within 5% (``tests/test_torch_sharded.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl
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
