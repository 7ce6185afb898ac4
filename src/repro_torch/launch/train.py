"""Training launcher (PyTorch port of ``repro.launch.train``).

Runs real AdamW steps of ``--arch`` on one device (default ``cuda``;
``--device cpu`` runs on the CPU) on the synthetic bigram data, with
random weights from a seeded ``torch.Generator``:

    python -m repro_torch.launch.train --arch gemma3-1b --scale full \
        --steps 3 --batch 4 --seq 4096 --microbatches 2

It takes the JAX launcher's flags (plus ``--device``) and prints its
JSON keys each logged step (``step``, ``elapsed_s``, ``loss``, ``ce``,
``aux``, ``grad_norm``, ``lr``).  As the JAX launcher does, it runs the
``specs.build_train`` step that the dry-run traces, here on the (1, 1)
mesh of ``mesh.make_local_mesh`` over the device: the config system,
the sharding rules and the step function are shared, so a passing
dry-run is the deploy config.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, InputShape, get_config,
                                 get_smoke_config)
from repro_torch.data import DataConfig, data_iterator
from repro_torch.devices import resolve_device
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import close_mesh, make_local_mesh
from repro_torch.models import model as M
from repro_torch.serving.telemetry import default_clock
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as tr


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke",
                    help="smoke = reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moments", choices=("float32", "int8"),
                    default="float32")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    return ap.parse_args(argv)


def train_config(args: argparse.Namespace) -> tr.TrainConfig:
    """The flags' AdamW schedule (warm-up a tenth of the steps) and
    micro-batches."""
    return tr.TrainConfig(
        optimizer=opt.OptimizerConfig(
            learning_rate=args.lr, warmup_steps=max(args.steps // 10, 1),
            total_steps=args.steps, moments_dtype=args.moments),
        microbatches=args.microbatches)


def build(args: argparse.Namespace):
    """(cfg, state, built, data iterator) for the parsed flags: the config
    at its scale, the train state from seed 0 on the device,
    ``specs.build_train``'s artifact on the device's local mesh (its
    ``fn`` is the step) and the bigram data (branching 4)."""
    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.scale == "smoke"
           else get_config(args.arch))
    shape = InputShape("cli", args.seq, args.batch, "train")
    cfg = M.specialize(cfg, shape)
    tcfg = train_config(args)
    built = sp.build_train(cfg, shape, make_local_mesh(dev), tcfg)
    state = tr.init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    it = data_iterator(cfg, shape, DataConfig(branching=4), device=dev)
    return cfg, state, built, it


def main(argv=None) -> None:
    args = parse_args(argv)
    group_up = dist.is_initialized()
    try:
        _run(args)
    finally:
        if not group_up:               # the local mesh's group is ours
            close_mesh()


def _run(args: argparse.Namespace) -> None:
    _, state, built, it = build(args)
    t0 = default_clock()
    for step in range(args.steps):
        batch = next(it)
        state, metrics = built.fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            print(json.dumps({"step": step,
                              "elapsed_s": round(default_clock() - t0, 1),
                              **m}), flush=True)
    if args.checkpoint:
        ckpt.save(args.checkpoint, sp.sh.gather(state["params"]),
                  {"arch": args.arch, "steps": args.steps})
        print(f"saved params -> {args.checkpoint}")


if __name__ == "__main__":
    main()
