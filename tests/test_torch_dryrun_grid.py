"""The port's dry-run at full size on five routes that DTensor's rules
refuse unless the model layer lays them out itself (``models.layers``:
``reduced_onto_tokens``, the rank-by-rank ``attention_weights_and_out``,
``grad_relaid``; ``models.ssm``'s rank-by-rank scan; on some torch
versions ``models.moe``'s expert places and ``models.transformer``'s
ring fill).

One dry-run subprocess per (arch, shape, mesh), all at once (each
brings up its own fake world of 256 / 512 ranks):

* whisper-base ``train_4k`` on the multi-pod mesh: the batch on ``pod``
  and ``data`` leaves eight rows a rank, so the projections' partial
  sums go onto the sequence, which the attention products and the
  weight gradients' flattens fold into a strided shard;
* gemma3-27b ``decode_32k`` on the pod mesh: rows on ``data`` and its
  16 kv heads on ``model``, folded into one batch dim by the attention
  products;
* mamba2-370m ``prefill_32k`` on the pod mesh: two rows a data rank, so
  ``in_proj``'s partial sums go onto the sequence, which the scan's
  products fold with the rows;
* granite-moe-1b-a400m ``train_4k`` on the pod mesh: the moe router's
  expert places counted rank by rank (``moe._places``);
* gemma3-1b ``prefill_32k`` on the pod mesh: its local layers' rings
  filled by a rotation, without ``index_put``.

DTensor has no rule for the last two routes' former ops (``ne``,
``cummax``, ``index_put_``) in every torch version, so they are traced
here and on the card (``chip_smoke.py``'s ``dryrun`` phase).  Each must
trace ``ok`` with per-chip dot FLOPs and collective bytes counted.
About 60 s of wall time (the five traces take 10-45 s each on one core,
plus each process's start).
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [("whisper-base", "train_4k", "multi"),
         ("gemma3-27b", "decode_32k", "single"),
         ("mamba2-370m", "prefill_32k", "single"),
         ("granite-moe-1b-a400m", "train_4k", "single"),
         ("gemma3-1b", "prefill_32k", "single")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape, mesh in PAIRS:
        out = tmp / f"{arch}-{shape}-{mesh}.jsonl"
        procs[(arch, shape, mesh)] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO))
    recs = {}
    for key, (out, p) in procs.items():
        try:
            log = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            for _, q in procs.values():
                q.kill()
            raise
        recs[key] = (json.loads(out.read_text().splitlines()[0])
                     if out.exists() else {"status": "missing", "log": log})
        recs[key]["log"] = log[-3000:]
    return recs


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_full_size_route_traces_ok(records, pair):
    rec = records[pair]
    assert rec["status"] == "ok", rec.get("error", rec["log"])
    assert rec["hlo_flops_per_chip"] > 0
    # the explicit redistributes' collectives are counted
    assert rec["coll_bytes_per_chip"] > 0
    assert sum(rec["coll_counts"].values()) > 0
