"""The port's launch steps on meshes that really shard, with numbers.

Four CPU processes (gloo over the loopback device, rendezvous on a
``FileStore`` under ``tmp_path``) form one world, laid out as a (2, 2)
("data", "model") mesh and a (1, 4) one.  Each rank runs this file as a
script (``_worker``): every case drives the DTensor route of the model
layer — the sequence-parallel knob's shards, the rank-by-rank attention
walks (``layers._shardwise``), the masked per-shard cache write
(``layers.row_write``) where the cache's time axis is split, the
redistributes of ``_split_ready`` / ``_merge_ready`` — and holds the
gathered result against the same function on plain tensors (the route
the CPU parity tests hold against JAX) on the same seeded inputs.  Rank
0 writes one JSON record per case; the tests below read them.

Beside the world, one more process (``_flops``) holds the per-chip dot
FLOPs of a prefill against JAX's ``analyze_hlo`` on a mesh that shards:
JAX compiles ``launch.specs.build_prefill`` on four host devices as a
(2, 2) mesh, and the port traces its own builder's step on a (2, 2)
mesh of PyTorch's fake process group under ``FakeTensorMode``
(``hlo_analysis.Trace``, this rank's shards), both at gemma3-1b's smoke
config with S = 512, where attention (chunked local and plain global)
is a large share of the work: once with K = 2 kv heads (the port's
walks keep the head shard) and once with K = 1 (q, k and v are gathered
over the model axis, as JAX's partitioner also does here).  Within 5%.

Tolerances: float32 throughout.  The knob's output within rtol = atol =
1e-5 (each rank walks its shards' chunks as the unsplit walk does);
logits and caches within 1e-5 x the reference's max |value| (a sharded
contraction sums its partial products in another order); greedy tokens
exactly; two train steps' losses and gradient norms within 1e-5
relative (the second step's loss reads the first step's update; the
updated weights are not compared element by element, since AdamW's
first step is lr x g / (|g| + eps), which turns the summation order's
noise in a near-zero gradient into a move of up to lr).  The world starts once
for the module; serially it takes about 25 s.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CASES = ["seq_parallel", "prefill_decode_phi3", "prefill_decode_gemma",
         "decode_b1_time_split_data", "decode_b1_time_split_model",
         "train_phi3"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    out = tmp / "records.json"
    flops = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "flops"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r),
         str(tmp / "store"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(WORLD)]
    logs = []
    for p in procs + [flops]:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs + [flops]:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs + [flops]), "\n".join(
        f"process {r} rc {p.returncode}:\n{log[-4000:]}"
        for r, (p, log) in enumerate(zip(procs + [flops], logs)))
    records = json.loads(out.read_text())
    records["flops"] = json.loads(logs[-1].strip().splitlines()[-1])
    return records


@pytest.mark.parametrize("case", CASES)
def test_sharded_route_matches_plain(world, case):
    rec = world[case]
    assert rec["ok"], rec
    assert rec["sharded"], f"{case}: no tensor was actually sharded: {rec}"


def test_seq_parallel_offsets(world):
    """Each rank walked its own shards: the offsets it passed to
    ``_blockwise_inner`` are its mesh coordinate's, on every rank."""
    for row in world["seq_parallel"]["rows"]:
        assert row["offsets_by_rank"] == row["expected_by_rank"], row


@pytest.mark.parametrize("kv_heads", ["2", "1"])
def test_prefill_dot_flops_match_jax_on_sharded_mesh(world, kv_heads):
    rec = world["flops"][kv_heads]
    assert rec["jax"] > 0 and rec["attention_share"] > 0.1, rec
    assert rec["port"] == pytest.approx(rec["jax"], rel=0.05), rec


def test_decode_crosses_time_shards(world):
    """The b = 1 decodes wrote positions on both sides of a shard
    boundary of the time axis."""
    for case in ("decode_b1_time_split_data", "decode_b1_time_split_model"):
        rec = world[case]
        assert rec["time_shards"] > 1
        assert len(set(rec["shards_written"])) > 1, rec


# ---------------------------------------------------------------------------
# the worker: one rank of the world
# ---------------------------------------------------------------------------

def _worker(rank: int, store_path: str, out_path: str) -> None:
    import time

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training import trainer as TR

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    ids = torch.arange(WORLD)
    mesh22 = DeviceMesh("cpu", ids.reshape(2, 2),
                        mesh_dim_names=("data", "model"))
    mesh14 = DeviceMesh("cpu", ids.reshape(1, 4),
                        mesh_dim_names=("data", "model"))
    records = {}

    def gathered(tree):
        return SH.gather(tree)

    def sharded(tree) -> bool:
        return any(isinstance(t, DTensor)
                   and any(isinstance(p, Shard) for p in t.placements)
                   for t in tree_leaves(tree))

    def close(a, b, rel=1e-5) -> float:
        """max |a - b| / max |b|, asserted under ``rel``."""
        a, b = a.detach().float(), b.detach().float()
        assert a.shape == b.shape, (a.shape, b.shape)
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max()) / scale
        assert err <= rel, err
        return err

    def close_tree(a, b) -> float:
        if isinstance(b, dict):
            return max(close_tree(a[k], b[k]) for k in b)
        return close(a, b)

    def smoke(arch):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        gen = torch.Generator().manual_seed(0)
        return cfg, M.init_params(cfg, gen, "cpu")

    def tokens(seed, B, S, vocab):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, vocab, (B, S)).astype(np.int32))

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            rec = fn()
            rec["ok"] = True
            rec["seconds"] = time.perf_counter() - t0
        except Exception as e:          # recorded, and the rank fails
            rec = {"ok": False, "error": repr(e)}
            records[name] = rec
            raise
        records[name] = rec

    # -- the sequence-parallel knob: n shards over the model axis --------
    def seq_parallel():
        rng = np.random.default_rng(3)
        B, S, K, G, hd, chunk = 2, 256, 2, 2, 16, 32
        qg, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for s in ((B, S, K, G, hd), (B, S, K, hd),
                                   (B, S, K, hd)))
        want = L._blockwise_inner(qg, k, v, 0.25, 5.0, chunk)
        inner, rows, any_sharded = L._blockwise_inner, [], False
        for mesh, n in ((mesh22, 2), (mesh22, 4), (mesh14, 4)):
            layout = SH.named(mesh, SH.P(None, "model", None, None, None,
                                         None))
            args = [SH.distribute(t, mesh, SH.P("data", *([None] *
                                                          (t.dim() - 1))))
                    for t in (qg, k, v)]
            seen = []

            def recording(*a, q_offset=0, **kw):
                seen.append(q_offset)
                return inner(*a, q_offset=q_offset, **kw)
            L._blockwise_inner, L.SEQ_PARALLEL_ATTN = recording, (n, layout)
            try:
                out = L._blockwise_causal_attention(*args, 0.25, 5.0,
                                                    chunk=chunk)
            finally:
                L._blockwise_inner, L.SEQ_PARALLEL_ATTN = inner, None
            any_sharded |= sharded(out)
            got = out.full_tensor()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            per, m = S // n, mesh.size(1)
            seen_all = [None] * WORLD
            dist.all_gather_object(seen_all, seen)
            coords = [(r // mesh.size(1), r % mesh.size(1))
                      for r in range(WORLD)]
            rows.append({
                "mesh": list(mesh.mesh.shape), "shards": n,
                "max_abs_err": float((got - want).abs().max()),
                "offsets_by_rank": seen_all,
                "expected_by_rank": [
                    [(c[1] * (n // m) + j) * per for j in range(n // m)]
                    for c in coords]})
        return {"rows": rows, "sharded": any_sharded}

    # -- builders: prefill then decode steps, against the direct calls ---
    def prefill_decode(arch, mesh, B=2, S=64, T=96, steps=3):
        cfg, params = smoke(arch)
        # the global layers take the blockwise walk at this S
        L.BLOCKWISE_THRESHOLD, L.BLOCKWISE_CHUNK = 64, 32
        try:
            batch = {"tokens": tokens(1, B, S, cfg.vocab_size)}
            built = SP.build_prefill(cfg, InputShape("p", S, B, "prefill"),
                                     mesh)
            logits, cache = built.fn(params, batch)
            is_sharded = sharded(logits) or sharded(cache)
            lw, cw = M.prefill(cfg, params, batch, S)
            errs = {"prefill_logits": close(gathered(logits), lw),
                    "prefill_cache": close_tree(gathered(cache), cw)}
        finally:
            L.BLOCKWISE_THRESHOLD, L.BLOCKWISE_CHUNK = 8192, 1024
        errs.update(decode_steps(cfg, params, mesh, B, T, S - 2, steps))
        return {"errors": errs, "sharded": is_sharded}

    def decode_steps(cfg, params, mesh, B, T, P, steps, smart=False):
        prompt = tokens(2, B, P, cfg.vocab_size)
        l0, cache0 = M.prefill(cfg, params, {"tokens": prompt}, T)
        built = SP.build_serve(cfg, InputShape("d", T, B, "decode"), mesh,
                               smart=smart)
        # each route writes its own copy in place
        cache_w = tree_map(torch.clone, cache0)
        cache = SH.place(tree_map(torch.clone, cache0), mesh,
                         built.in_shardings[1])
        tok = l0[:, -1:].argmax(-1).int()
        errs = {}
        for i in range(steps):
            pos = torch.full((B,), P + i, dtype=torch.int32)
            lb, cache = built.fn(params, cache, tok, pos)
            lw, _ = M.decode_step(cfg, params, cache_w, tok, pos)
            lb = gathered(lb)
            errs[f"decode_{i}_logits"] = close(lb, lw)
            assert torch.equal(lb.argmax(-1), lw.argmax(-1))
            errs[f"decode_{i}_cache"] = close_tree(gathered(cache), cache_w)
            tok = lw[:, -1:].argmax(-1).int()
        return errs

    # -- b = 1: the cache's time axis split, writes on both sides --------
    def decode_b1(mesh, smart):
        cfg, params = smoke("gemma3-1b")
        T, P, steps = 32, 14, 5
        shape = InputShape("d", T, 1, "decode")
        built = SP.build_serve(cfg, shape, mesh, smart=smart)
        kspec = built.in_shardings[1]["super"]["global"]["k"]
        tdim = len(kspec.spec) - 3
        split = [mesh.size(i) for i, p in enumerate(kspec.placements)
                 if isinstance(p, Shard) and p.dim == tdim]
        assert split, f"the cache's time axis is not split: {kspec}"
        n = split[0]
        errs = decode_steps(cfg, params, mesh, 1, T, P, steps, smart=smart)
        written = [((P + i) % T) // (T // n) for i in range(steps)]
        return {"errors": errs, "sharded": True, "time_shards": n,
                "cache_spec": [str(a) for a in kspec.spec],
                "shards_written": written}

    # -- one train step through build_train ------------------------------
    def train_phi3():
        cfg, params = smoke("phi3-medium-14b")
        ocfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=2)
        tcfg = TR.TrainConfig(optimizer=O.OptimizerConfig(**ocfg),
                              microbatches=1)
        B, S = 2, 16
        built = SP.build_train(cfg, InputShape("t", S, B, "train"),
                               mesh22, tcfg)
        step = TR.make_train_step(cfg, tcfg)

        def fresh():
            p = tree_map(torch.clone, params)
            return {"params": p, "opt": O.init_opt_state(tcfg.optimizer, p)}
        state, direct, errs = fresh(), fresh(), {}
        for i in range(2):
            t = tokens(5 + i, B, S + 1, cfg.vocab_size)
            batch = {"tokens": t[:, :-1], "targets": t[:, 1:]}
            state, m = built.fn(state, batch)
            is_sharded = sharded(state)
            direct, dm = step(direct, batch)
            for k in ("loss", "grad_norm"):
                errs[f"{k}_{i}"] = abs(float(m[k]) - float(dm[k])) \
                    / abs(float(dm[k]))
        assert max(errs.values()) <= 1e-5, errs
        return {"errors": errs, "sharded": is_sharded}

    run("seq_parallel", seq_parallel)
    run("prefill_decode_phi3",
        lambda: prefill_decode("phi3-medium-14b", mesh22))
    run("prefill_decode_gemma", lambda: prefill_decode("gemma3-1b", mesh22))
    run("decode_b1_time_split_data", lambda: decode_b1(mesh22, False))
    run("decode_b1_time_split_model", lambda: decode_b1(mesh14, True))
    run("train_phi3", train_phi3)
    dist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(records, f)
    dist.destroy_process_group()


def _flops() -> None:
    """Per-chip dot FLOPs of a gemma3-1b smoke prefill (4 x 512) on a
    (2, 2) mesh, JAX's compiled step against the port's trace, for K = 2
    and K = 1; prints one JSON line."""
    import jax
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.launch import hlo_analysis as JH
    from repro.launch import specs as JSP
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import _ensure_world, close_mesh

    torch.set_num_threads(1)
    shape = InputShape("p", 512, 4, "prefill")
    jmesh = jax.make_mesh((2, 2), ("data", "model"))
    _ensure_world("fake", 4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    out = {}
    for K in (2, 1):
        jcfg = jax_smoke_config("gemma3-1b").replace(dtype="float32",
                                                     num_kv_heads=K)
        cfg = get_smoke_config("gemma3-1b").replace(dtype="float32",
                                                    num_kv_heads=K)
        jb = JSP.build_prefill(jcfg, shape, jmesh)
        theirs = JH.analyze_hlo(jb.fn.lower(*jb.args).compile().as_text())
        with FakeTensorMode(allow_non_fake_inputs=True):
            built = SP.build_prefill(cfg, shape, mesh)
            args = SP.allocate(built.args, "cpu")
            placed = [SP.sh.place(a, mesh, s)
                      for a, s in zip(args, built.in_shardings)]
            with H.Trace() as traced:
                built.fn(*placed)
        mine = H.analyze_hlo(traced)
        bmm = sum(r["flops"] for r in H.breakdown(traced, top=1000)
                  ["by_flops"] if r["op"] == "aten.bmm.default")
        out[str(K)] = {"jax": theirs.flops, "port": mine.flops,
                       "attention_share": bmm / mine.flops}
    close_mesh()
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1] == "flops":
        _flops()
    else:
        _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
