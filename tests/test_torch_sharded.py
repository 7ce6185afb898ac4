"""The port's launch steps on meshes that really shard, with numbers.

Four CPU processes (gloo over the loopback device, rendezvous on a
``FileStore`` under ``tmp_path``) form one world, laid out as a (2, 2)
("data", "model") mesh, a (1, 4) one, and the multi-pod axes ("pod",
"data", "model") as (2, 1, 2) and (2, 2, 1).  Each rank runs this file
as a script (``_worker``): every case drives the DTensor route of the
model layer — the sequence-parallel knob's shards, the rank-by-rank
attention walks and core (``layers._shardwise``), the masked per-shard
cache write (``layers.row_write``) where the cache's time axis is split,
the redistributes of ``_split_ready`` / ``_merge_ready``, the partial
sums reduced onto the tokens (``reduced_onto_tokens``), the rank-by-rank
ssm scan and its gradients, the moe layer's flatten and combine with
the rows on pod and data, and with the rows on pod and the sequence on
data (its input's gradient too), and train steps whose sequence carries the
model shard (two rows a rank on the (2, 1, 2) mesh) — and holds the
gathered result against the same function on plain tensors (the route
the CPU parity tests hold against JAX) on the same seeded inputs.  Rank
0 writes one JSON record per case; the tests below read them.

Beside the world, one more process (``_flops``) holds the per-chip dot
FLOPs of a prefill against JAX's ``analyze_hlo`` on a mesh that shards:
JAX compiles ``launch.specs.build_prefill`` on four host devices as a
(2, 2) mesh, and the port traces its own builder's step on a (2, 2)
mesh of PyTorch's fake process group under ``FakeTensorMode``
(``hlo_analysis.Trace``, this rank's shards), at gemma3-1b's smoke
config with S = 512, where attention (chunked local and plain global)
is a large share of the work: once with K = 2 kv heads (the port's
walks keep the head shard) and once with K = 1 (q, k and v are gathered
over the model axis, as JAX's partitioner also does here); and at
mamba2-370m's (S = 512, two chunks of the scan).  Within 5%.  Two more
processes (``_traces``, without JAX, half the cases each) trace each
repaired route's step under ``FakeTensorMode``, as the dry-run does
(``_fake_traces``): with real tensors torch 2.13 runs some strided
layouts whose sharding propagation fails on fake tensors, so the fake
traces are the ones that show the dry-run's errors.  ``python tests/test_torch_sharded.py
traces [CASE ...]`` prints them for the installed torch, whose DTensor
rules differ between versions.

Tolerances: float32 throughout.  The knob's output within rtol = atol =
1e-5 (each rank walks its shards' chunks as the unsplit walk does);
logits and caches within 1e-5 x the reference's max |value| (a sharded
contraction sums its partial products in another order), except the
ssm prefill's, within 5e-5: its scan amplifies the order of
``in_proj``'s sum (splitting that contraction in two on plain tensors
moves the smoke model's logits past 1e-5 x max as well); greedy tokens
exactly; two train steps' losses and gradient norms within 1e-5
relative (the second step's loss reads the first step's update; the
updated weights are not compared element by element, since AdamW's
first step is lr x g / (|g| + eps), which turns the summation order's
noise in a near-zero gradient into a move of up to lr).  The world
starts once for the module; serially it takes about 150 s (2.4x that
under a full parallel test run).
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
         "train_phi3", "decode_kv_heads_on_model", "attention_seq_shard",
         "ssm_prefill_decode", "train_three_axis_gemma",
         "train_three_axis_whisper", "moe_pod_data_granite",
         "moe_seq_on_data_kimi", "train_ssm", "ssd_scan_gradients",
         "prefill_ring_three_axis", "train_three_axis_kimi"]
# the cases of the routes this file's DTensor repairs cover; each is also
# traced as the dry-run traces it (``_flops``)
TRACED = CASES[6:]


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
    # the fake traces in two processes, half the cases each
    traces = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "traces", *half],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for half in (TRACED[0::2], TRACED[1::2])]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r),
         str(tmp / "store"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(WORLD)]
    procs += [flops, *traces]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=900)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"process {r} rc {p.returncode}:\n{log[-4000:]}"
        for r, (p, log) in enumerate(zip(procs, logs)))
    records = json.loads(out.read_text())
    records["flops"], *halves = (
        json.loads(log.strip().splitlines()[-1]) for log in logs[-3:])
    records["traces"] = {k: v for half in halves for k, v in half.items()}
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


def test_ssm_prefill_dot_flops_match_jax_on_sharded_mesh(world):
    """mamba2-370m's smoke prefill (4 x 512, two chunks of 256) on the
    (2, 2) mesh: the scan's products per chip against JAX's."""
    rec = world["flops"]["ssm"]
    assert rec["jax"] > 0, rec
    assert rec["port"] == pytest.approx(rec["jax"], rel=0.05), rec


@pytest.mark.parametrize("case", TRACED)
def test_sharded_route_traces_under_fake_tensors(world, case):
    """The case's step traced as the dry-run traces it: under
    ``FakeTensorMode`` on a fake world of four, where a layout DTensor's
    rules refuse fails to propagate (with real tensors some of them
    run)."""
    rec = world["traces"][case]
    assert rec["ok"], rec


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
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._pytree import (tree_flatten_with_path, tree_leaves,
                                     tree_map)

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
    # the multi-pod mesh's axes: rows on pod (and data), one row a rank
    mesh212 = DeviceMesh("cpu", ids.reshape(2, 1, 2),
                         mesh_dim_names=("pod", "data", "model"))
    mesh221 = DeviceMesh("cpu", ids.reshape(2, 2, 1),
                         mesh_dim_names=("pod", "data", "model"))
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

    def close_tree(a, b, rel=1e-5) -> float:
        if isinstance(b, dict):
            return max(close_tree(a[k], b[k], rel) for k in b)
        return close(a, b, rel)

    def smoke(arch):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        gen = torch.Generator().manual_seed(0)
        return cfg, M.init_params(cfg, gen, "cpu")

    def tokens(seed, B, S, vocab):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, vocab, (B, S)).astype(np.int32))

    def extras(cfg, B, seed):
        """The encdec's audio embeddings beside its tokens."""
        if cfg.family != "encdec":
            return {}
        a = np.random.default_rng(seed).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        return {"audio_embeds": torch.from_numpy(0.1 * a)}

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
    def prefill_decode(arch, mesh, B=2, S=64, T=96, steps=3,
                       blockwise=True, rel=1e-5):
        cfg, params = smoke(arch)
        if blockwise:   # the global layers take the blockwise walk at S
            L.BLOCKWISE_THRESHOLD, L.BLOCKWISE_CHUNK = 64, 32
        try:
            batch = {"tokens": tokens(1, B, S, cfg.vocab_size)}
            built = SP.build_prefill(cfg, InputShape("p", S, B, "prefill"),
                                     mesh)
            logits, cache = built.fn(params, batch)
            is_sharded = sharded(logits) or sharded(cache)
            lw, cw = M.prefill(cfg, params, batch, S)
            errs = {"prefill_logits": close(gathered(logits), lw, rel),
                    "prefill_cache": close_tree(gathered(cache), cw, rel)}
        finally:
            L.BLOCKWISE_THRESHOLD, L.BLOCKWISE_CHUNK = 8192, 1024
        errs.update(decode_steps(cfg, params, mesh, B, T, S - 2, steps,
                                 rel=rel))
        return {"errors": errs, "sharded": is_sharded}

    def decode_steps(cfg, params, mesh, B, T, P, steps, smart=False,
                     rel=1e-5):
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
            errs[f"decode_{i}_logits"] = close(lb, lw, rel)
            assert torch.equal(lb.argmax(-1), lw.argmax(-1))
            errs[f"decode_{i}_cache"] = close_tree(gathered(cache), cache_w,
                                                   rel)
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

    # -- rows on data and kv heads on model: the (B, K) fold ------------
    def decode_kv_heads_on_model():
        cfg, params = smoke("phi3-medium-14b")
        B, T = 4, 64                  # two rows a data rank, K = 2
        shape = InputShape("d", T, B, "decode")
        kspec = next(s for path, s in tree_flatten_with_path(
            SP.build_serve(cfg, shape, mesh22).in_shardings[1])[0]
            if path[-1].key == "k")
        assert kspec.spec[-4] == "data" and kspec.spec[-2] == "model", kspec
        errs = decode_steps(cfg, params, mesh22, B, T, 20, 3)
        return {"errors": errs, "sharded": True,
                "cache_spec": [str(a) for a in kspec.spec]}

    # -- the plain branch with the query sequence sharded ----------------
    def attention_seq_shard():
        rng = np.random.default_rng(4)
        B, S, K, G, hd = 2, 32, 2, 2, 16
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for s in ((B, S, K, G, hd), (B, S, K, hd),
                                   (B, S, K, hd)))
        m = L.window_mask(S, S, 8)[None, None, None]
        want = L.attention_weights_and_out(q, k, v, m, scale=0.25,
                                           softcap=5.0)
        errs = {}
        for name, qspec in (("seq_on_model", ("data", "model")),
                            ("seq_on_data", (None, "data"))):
            qd = SH.distribute(q, mesh22, SH.P(*qspec, None, None, None))
            kd, vd = (SH.distribute(t, mesh22, SH.P(qspec[0], None, None,
                                                    None)) for t in (k, v))
            with implicit_replication():
                got = L.attention_weights_and_out(qd, kd, vd, m, scale=0.25,
                                                  softcap=5.0)
            errs[name] = close(got.full_tensor(), want)
        return {"errors": errs, "sharded": True}

    # -- the scan rank by rank: outputs and every input's gradient -------
    def ssd_scan_gradients():
        from repro_torch.models import ssm
        rng = np.random.default_rng(6)
        b, l, h, p, n, chunk = 2, 96, 4, 8, 16, 32

        def arr(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.standard_normal(shape))
                                    .astype(np.float32))
        x, B, C = arr(b, l, h, p), arr(b, l, n), arr(b, l, n)
        dt, A = arr(b, l, h, scale=0.1).abs(), -arr(h).abs()
        h0, wy, wh = arr(b, h, p, n), arr(b, l, h, p), arr(b, h, p, n)
        ins = (x, dt, A, B, C, h0)

        def loss(args, gather):
            y, hf = ssm.ssd_chunked(*args[:5], chunk, h0=args[5])
            return (gather(y) * wy).sum() + (gather(hf) * wh).sum(), y
        plain = [t.clone().requires_grad_() for t in ins]
        want, y_want = loss(plain, lambda t: t)
        want.backward()
        # the sequence on model (as a product's partial sums leave it),
        # the rows on data
        specs = (("data", "model", None, None), ("data", "model", None),
                 (None,), ("data", "model", None), ("data", "model", None),
                 ("data", None, None, None))
        dts = [SH.distribute(t, mesh22, SH.P(*sp)).requires_grad_()
               for t, sp in zip(ins, specs)]
        with implicit_replication():
            got, y_got = loss(dts, lambda t: t.full_tensor())
            got.backward()
        errs = {"y": close(y_got.full_tensor(), y_want)}
        for name, d, t in zip(("x", "dt", "A", "B", "C", "h0"), dts, plain):
            errs[f"grad_{name}"] = close(d.grad.full_tensor(), t.grad)
        return {"errors": errs, "sharded": True}

    # -- one train step through build_train ------------------------------
    def train_phi3():
        return train("phi3-medium-14b", mesh22, 2, 16)

    def train(arch, mesh, B, S):
        cfg, params = smoke(arch)
        ocfg = dict(learning_rate=1e-3, warmup_steps=1, total_steps=2)
        tcfg = TR.TrainConfig(optimizer=O.OptimizerConfig(**ocfg),
                              microbatches=1)
        built = SP.build_train(cfg, InputShape("t", S, B, "train"),
                               mesh, tcfg)
        step = TR.make_train_step(cfg, tcfg)

        def fresh():
            p = tree_map(torch.clone, params)
            return {"params": p, "opt": O.init_opt_state(tcfg.optimizer, p)}
        state, direct, errs = fresh(), fresh(), {}
        for i in range(2):
            t = tokens(5 + i, B, S + 1, cfg.vocab_size)
            batch = {"tokens": t[:, :-1], "targets": t[:, 1:]}
            batch.update(extras(cfg, B, 6 + i))
            state, m = built.fn(state, batch)
            is_sharded = sharded(state)
            direct, dm = step(direct, batch)
            for k in ("loss", "grad_norm"):
                errs[f"{k}_{i}"] = abs(float(m[k]) - float(dm[k])) \
                    / abs(float(dm[k]))
        assert max(errs.values()) <= 1e-5, errs
        return {"errors": errs, "sharded": is_sharded}

    # -- a moe forward with the rows on pod and data ---------------------
    def moe_pod_data():
        from repro_torch.models import moe
        from repro_torch.models.transformer import _layer
        B, S, errs = 4, 32, {}
        # the layer alone (kimi's has a shared expert): its output comes
        # back laid out as its input's rows, not as partial sums
        for arch in ("granite-moe-1b-a400m", "kimi-k2-1t-a32b"):
            cfg, params = smoke(arch)
            x = torch.from_numpy(np.random.default_rng(9).standard_normal(
                (B, S, cfg.d_model)).astype(np.float32))
            lp = _layer(params["moe_layers"]["moe"], 0)
            want, aux_w = moe.moe_mlp(cfg, lp, x)
            xd = SH.distribute(x, mesh221, SH.P(("pod", "data"), None,
                                                None))
            with implicit_replication():
                got, aux = moe.moe_mlp(cfg, lp, xd)
            assert tuple(got.placements) == tuple(xd.placements), \
                got.placements
            errs[f"moe_mlp_{arch}"] = close(got.full_tensor(), want)
            errs[f"moe_aux_{arch}"] = close(gathered(aux), aux_w)
        cfg, params = smoke("granite-moe-1b-a400m")
        batch = {"tokens": tokens(8, B, S, cfg.vocab_size)}
        built = SP.build_prefill(cfg, InputShape("p", S, B, "prefill"),
                                 mesh221)
        logits, cache = built.fn(params, batch)
        lw, cw = M.prefill(cfg, params, batch, S)
        errs.update(prefill_logits=close(gathered(logits), lw),
                    prefill_cache=close_tree(gathered(cache), cw))
        return {"errors": errs, "sharded": sharded(logits)}

    # -- the moe layer with rows on pod and the sequence on data ---------
    def moe_seq_on_data():
        """The layout the multi-pod prefill hands kimi-k2's moe layers:
        the token flatten would fold the sequence's data shard into a
        strided shard of the tokens.  The output and the input's
        gradient against plain autograd."""
        from repro_torch.models import moe
        from repro_torch.models.transformer import _layer
        B, S, errs = 4, 32, {}
        for arch in ("kimi-k2-1t-a32b", "granite-moe-1b-a400m"):
            cfg, params = smoke(arch)
            rng = np.random.default_rng(10)
            x, w = (torch.from_numpy(rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)) for _ in range(2))
            lp = _layer(params["moe_layers"]["moe"], 0)
            xp = x.clone().requires_grad_()
            want, aux_w = moe.moe_mlp(cfg, lp, xp)
            torch.sum(want * w).backward()
            xd = SH.distribute(x, mesh221, SH.P("pod", "data", None))
            xd.requires_grad_()
            with implicit_replication():
                got, aux = moe.moe_mlp(cfg, lp, xd)
                torch.sum(got * SH.distribute(w, mesh221, SH.P(
                    "pod", "data", None))).backward()
            errs[f"moe_mlp_{arch}"] = close(got.full_tensor(), want)
            errs[f"moe_aux_{arch}"] = close(gathered(aux), aux_w)
            errs[f"moe_grad_x_{arch}"] = close(xd.grad.full_tensor(),
                                               xp.grad)
        return {"errors": errs, "sharded": sharded(xd)}

    run("seq_parallel", seq_parallel)
    run("prefill_decode_phi3",
        lambda: prefill_decode("phi3-medium-14b", mesh22))
    run("prefill_decode_gemma", lambda: prefill_decode("gemma3-1b", mesh22))
    run("decode_b1_time_split_data", lambda: decode_b1(mesh22, False))
    run("decode_b1_time_split_model", lambda: decode_b1(mesh14, True))
    run("train_phi3", train_phi3)
    run("decode_kv_heads_on_model", decode_kv_heads_on_model)
    run("attention_seq_shard", attention_seq_shard)
    run("ssm_prefill_decode",
        lambda: prefill_decode("mamba2-370m", mesh22, B=2, S=512, T=520,
                               steps=2, blockwise=False, rel=5e-5))
    run("train_three_axis_gemma", lambda: train("gemma3-1b", mesh212, 2, 64))
    run("train_three_axis_whisper",
        lambda: train("whisper-base", mesh212, 2, 64))
    run("moe_pod_data_granite", moe_pod_data)
    run("moe_seq_on_data_kimi", moe_seq_on_data)
    # the scan's heads on model: B and C's gradients summed over them
    run("train_ssm", lambda: train("mamba2-370m", mesh22, 2, 320))
    run("ssd_scan_gradients", ssd_scan_gradients)
    # the ring layers' fill and the moe layer's gradients on the
    # three-axis mesh: routes some torch versions' DTensor rules refuse
    # unless the model lays them out itself (``_fill_local``'s rotation,
    # ``moe._places``, ``take_rows``, ``moe._grad_laid_as``)
    run("prefill_ring_three_axis",
        lambda: prefill_decode("gemma3-1b", mesh212))
    run("train_three_axis_kimi",
        lambda: train("kimi-k2-1t-a32b", mesh212, 2, 64))
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
    # the ssm prefill: in_proj's partial sums reduced, the scan on rows
    jcfg = jax_smoke_config("mamba2-370m").replace(dtype="float32")
    cfg = get_smoke_config("mamba2-370m").replace(dtype="float32")
    jb = JSP.build_prefill(jcfg, shape, jmesh)
    theirs = JH.analyze_hlo(jb.fn.lower(*jb.args).compile().as_text())
    with FakeTensorMode(allow_non_fake_inputs=True):
        built = SP.build_prefill(cfg, shape, mesh)
        args = SP.allocate(built.args, "cpu")
        placed = [SP.sh.place(a, mesh, s)
                  for a, s in zip(args, built.in_shardings)]
        with H.Trace() as traced:
            built.fn(*placed)
    out["ssm"] = {"jax": theirs.flops,
                  "port": H.analyze_hlo(traced).flops}
    close_mesh()
    print(json.dumps(out))


def _fake_traces(mesh22, cases=()) -> dict:
    """Each repaired route's step (or those of ``cases``) at its world
    case's sizes, traced as the dry-run traces a step: under
    ``FakeTensorMode`` on the fake world of four that is up.  {case:
    {"ok": bool, "error": str}}."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.transformer import _layer
    from repro_torch.training import trainer as TR

    ids = torch.arange(WORLD)
    mesh212 = DeviceMesh("cpu", ids.reshape(2, 1, 2),
                         mesh_dim_names=("pod", "data", "model"))
    mesh221 = DeviceMesh("cpu", ids.reshape(2, 2, 1),
                         mesh_dim_names=("pod", "data", "model"))

    def step(arch, kind, mesh, S, B):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        shape = InputShape("x", S, B, kind)
        built = (SP.build_train(cfg, shape, mesh, TR.TrainConfig())
                 if kind == "train" else SP.build(cfg, shape, mesh))
        built.fn(*SP.allocate(built.args, "cpu"))

    def attention():
        q = torch.empty(2, 32, 2, 2, 16)
        k = v = torch.empty(2, 32, 2, 16)
        m = L.window_mask(32, 32, 8)[None, None, None]
        qd = SH.distribute(q, mesh22, SH.P("data", "model", None, None,
                                           None))
        kd, vd = (SH.distribute(t, mesh22, SH.P("data", None, None, None))
                  for t in (k, v))
        with implicit_replication():
            L.attention_weights_and_out(qd, kd, vd, m, scale=0.25,
                                        softcap=5.0)

    # kimi-k2's smoke weights, made before fake mode takes the factories
    kimi = get_smoke_config("kimi-k2-1t-a32b").replace(dtype="float32")
    kimi_moe = _layer(M.init_params(kimi, None, "cpu")["moe_layers"]["moe"],
                      0)

    def moe_layer():
        xd = SH.distribute(torch.empty(4, 32, kimi.d_model), mesh221,
                           SH.P("pod", "data", None)).requires_grad_()
        with implicit_replication():
            out, aux = moe.moe_mlp(kimi, kimi_moe, xd)
            (out.sum() + aux).backward()

    def scan():
        from repro_torch.models import ssm
        b, l, h, p, n = 2, 96, 4, 8, 16
        on = lambda *spec: SH.P(*spec)  # noqa: E731
        ins = [SH.distribute(torch.empty(*shape), mesh22, spec)
               .requires_grad_() for shape, spec in (
                   ((b, l, h, p), on("data", "model", None, None)),
                   ((b, l, h), on("data", "model", None)),
                   ((h,), on(None)),
                   ((b, l, n), on("data", "model", None)),
                   ((b, l, n), on("data", "model", None)))]
        with implicit_replication():
            y, hf = ssm.ssd_chunked(*ins, 32)
            (y.sum() + hf.sum()).backward()

    runs = {
        "decode_kv_heads_on_model":
            lambda: step("phi3-medium-14b", "decode", mesh22, 64, 4),
        "attention_seq_shard": attention,
        "ssm_prefill_decode":
            lambda: step("mamba2-370m", "prefill", mesh22, 512, 2),
        "train_three_axis_gemma":
            lambda: step("gemma3-1b", "train", mesh212, 64, 2),
        "train_three_axis_whisper":
            lambda: step("whisper-base", "train", mesh212, 64, 2),
        "moe_pod_data_granite":
            lambda: step("granite-moe-1b-a400m", "prefill", mesh221, 32, 4),
        "moe_seq_on_data_kimi": moe_layer,
        "train_ssm": lambda: step("mamba2-370m", "train", mesh22, 320, 2),
        "ssd_scan_gradients": scan,
        "prefill_ring_three_axis":
            lambda: step("gemma3-1b", "prefill", mesh212, 64, 2),
        "train_three_axis_kimi":
            lambda: step("kimi-k2-1t-a32b", "train", mesh212, 64, 2),
    }
    out = {}
    for case, fn in runs.items():
        if cases and case not in cases:
            continue
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn()
            out[case] = {"ok": True}
        except Exception as e:      # recorded: the test names the case
            out[case] = {"ok": False, "error": f"{type(e).__name__}: "
                         f"{str(e)[-600:]}"}
    return out


def _traces(cases=()) -> None:
    """``_fake_traces`` alone (or its ``cases``), without JAX, on this
    machine's torch: prints {case: {"ok": bool, "error": str}} as one
    JSON line."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import _ensure_world, close_mesh

    torch.set_num_threads(1)
    _ensure_world("fake", WORLD)
    out = _fake_traces(DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                                  mesh_dim_names=("data", "model")), cases)
    close_mesh()
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1] == "flops":
        _flops()
    elif sys.argv[1] == "traces":
        _traces(sys.argv[2:])
    else:
        _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
