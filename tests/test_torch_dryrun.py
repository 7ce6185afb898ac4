"""The port's dry-run and train launcher end to end (the port's
``tests/test_dryrun_integration.py``).

The dry-run CLI runs in a subprocess: it brings up a fake process group
of 256 or 512 ranks, and a process holds one default group, which this
test process must not keep.  The train CLI runs in this process on the
CPU's world-size-1 mesh, which ``main`` takes down when it returns.
Its losses are held to ``trainer.make_train_step``'s from the same seed
and data: bit for bit in this process (the built step on the local
mesh runs the same aten ops on whole tensors), and as the CLI prints
them (rounded to 4 places).  Serially this file takes about 40 s, most
of it the two dry-run subprocesses.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import train
from repro_torch.launch.mesh import close_mesh
from repro_torch.training import trainer as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_ARGV = ["--device", "cpu", "--scale", "smoke", "--steps", "3",
              "--batch", "4", "--seq", "32", "--microbatches", "2",
              "--log-every", "1"]


def _run_dryrun(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=REPO)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_traces_and_reports(tmp_path, mesh):
    out = tmp_path / "rec.jsonl"
    r = _run_dryrun(["--arch", "mamba2-370m", "--shape", "decode_32k",
                     "--mesh", mesh, "--out", str(out)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["status"] == "ok"
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    for term in ("compute_s", "memory_s", "collective_s"):
        assert rec[term] >= 0.0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["hlo_flops_per_chip"] > 0
    assert rec["arg_bytes_per_chip"] > 0
    assert "per-chip argument bytes" in rec["memory_analysis"]
    # rank 0 holds 1/16 of the batch (the data axis) or 1/32 (pod x data)
    assert sum(rec["coll_counts"].values()) > 0


def test_dryrun_documented_skip(tmp_path):
    out = tmp_path / "rec.jsonl"
    r = _run_dryrun(["--arch", "phi3-medium-14b", "--shape", "long_500k",
                     "--mesh", "single", "--out", str(out)])
    assert r.returncode == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["status"] == "skipped"
    assert "full-attention" in rec["reason"]


def test_train_cli_runs_build_train(capsys):
    """``launch.train`` steps through ``specs.build_train``'s artifact on
    the local mesh; its losses are ``make_train_step``'s, and ``main``
    leaves no process group behind."""
    up = dist.is_initialized()
    train.main(SMOKE_ARGV)
    assert dist.is_initialized() == up
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1, 2]

    args = train.parse_args(SMOKE_ARGV)
    try:
        cfg, state, built, it = train.build(args)
        assert dist.is_initialized() and dist.get_world_size() == 1
        direct = TR.make_train_step(cfg, train.train_config(args))
        dstate = state
        for ln in lines:
            batch = next(it)
            state, m = built.fn(state, batch)
            dstate, dm = direct(dstate, batch)
            for key in ("loss", "ce", "grad_norm", "lr"):
                assert float(m[key]) == float(dm[key]), (key, m, dm)
                assert round(float(dm[key]), 4) == ln[key]
    finally:
        close_mesh()
    assert isinstance(m["loss"], torch.Tensor)
