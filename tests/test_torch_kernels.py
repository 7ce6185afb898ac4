"""The port's paged_attention, paged_extend_attention and quant_matmul
plain versions against the JAX oracles and the JAX Pallas kernels (run
in interpret mode on the CPU, as ``tests/test_kernels.py`` runs them),
plus the device dispatch.

The hand-written CUDA kernel itself runs only on the card: its tests
are in ``tests/test_torch_kernels_cuda.py``.  Inputs are made from a
numpy seed and handed to both frameworks.  Tolerances: the port's plain
version and the JAX oracle are the same float32 math (rtol=atol=1e-5);
against the Pallas kernel's online softmax the decode sweep of
``tests/test_kernels.py`` uses 2e-3, and so do the decode tests here;
the extend read is held to the Pallas kernel at rtol=atol=1e-5 (its
online softmax differs from the full softmax by float rounding only).
``quant_matmul``: the port's plain version and the JAX oracle are the
same float32 dequant product (rtol=atol=1e-5; a bfloat16 output within
one bfloat16 step).  The Pallas kernel rounds x to bfloat16 first: fed x
already rounded, it differs in summation order only (rtol=atol=1e-5);
fed float32 x, each output lies within 2**-8 x (|x| @ |w|) of the plain
version (a bfloat16 rounding moves each x by at most 2**-9 of itself).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as JL
from repro_torch.kernels import build, checks, ops, ref, splits
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_extend_attention as pea
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import ssd_scan as ssd

SHAPES = [(3, 4, 2, 32, 12, 8, 4),       # B, H, K, hd, nB, bs, n_blk
          (2, 8, 8, 64, 10, 16, 2),
          (4, 4, 1, 128, 20, 8, 4)]


def _paged_case(seed, B, H, kv, hd, nB, bs, n_blk, holes=False, q_std=0.5):
    """Random q and pool; each row gets a random length and distinct
    pages.  ``holes`` adds a -1 entry inside a row's used span and an
    empty row (all -1, length 0)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, hd)) * q_std).astype(np.float32)
    kp = (rng.standard_normal((nB, bs, kv, hd)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((nB, bs, kv, hd)) * 0.5).astype(np.float32)
    bt = np.full((B, n_blk), -1, np.int32)
    lengths = np.zeros((B,), np.int32)
    perm = rng.permutation(nB)
    used = 0
    for b in range(B):
        n = int(rng.integers(1, n_blk * bs + 1))
        lengths[b] = n
        k = -(-n // bs)
        bt[b, :k] = perm[used:used + k]
        used += k
    if holes:
        bt[0, :] = perm[:n_blk]
        lengths[0] = n_blk * bs
        bt[0, 1] = -1                     # unallocated page mid-row
        bt[B - 1, :] = -1                 # inactive slot
        lengths[B - 1] = 0
    return q, kp, vp, bt, lengths


def _quantize(x):
    qx, s = JL.quantize_kv(jnp.asarray(x))
    return np.array(qx), np.array(s)


def _both(args, softcap, hd, k_scale=None, v_scale=None, scale=None):
    """(port plain, JAX oracle, JAX Pallas) outputs as numpy."""
    q, kp, vp, bt, ln = args
    kw = dict(scale=hd ** -0.5 if scale is None else scale, softcap=softcap)
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, ln)]
    tk = dict(kw)
    jk = dict(kw)
    if k_scale is not None:
        tk.update(k_scale=torch.from_numpy(k_scale),
                  v_scale=torch.from_numpy(v_scale))
        jk.update(k_scale=jnp.asarray(k_scale), v_scale=jnp.asarray(v_scale))
    mine = ref.paged_attention_ref(*t, **tk).numpy()
    j = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    oracle = np.asarray(jax_ref.paged_attention_ref(*j, **jk))
    pallas = np.asarray(jax_ops.paged_attention(*j, **jk))
    return mine, oracle, pallas


@pytest.mark.parametrize("B,H,kv,hd,nB,bs,n_blk", SHAPES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_attention_ref_matches_jax(B, H, kv, hd, nB, bs, n_blk,
                                         softcap):
    args = _paged_case(B * 7 + H, B, H, kv, hd, nB, bs, n_blk)
    mine, oracle, pallas = _both(args, softcap, hd)
    np.testing.assert_allclose(mine, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, pallas, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,H,kv,hd,nB,bs,n_blk", SHAPES[:2])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_attention_ref_int8_matches_jax(B, H, kv, hd, nB, bs, n_blk,
                                              softcap):
    """int8 pages with per-(page, offset, kv-head) scales, as written by
    the JAX ``quantize_kv``."""
    q, kp, vp, bt, ln = _paged_case(B * 11 + H, B, H, kv, hd, nB, bs, n_blk)
    kq, ks = _quantize(kp)
    vq, vs = _quantize(vp)
    mine, oracle, pallas = _both((q, kq, vq, bt, ln), softcap, hd, ks, vs)
    np.testing.assert_allclose(mine, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, pallas, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_unallocated_pages_and_empty_rows(softcap):
    """-1 entries are skipped by both; an empty row is each side's own
    definition: the oracles' all-masked softmax (mean of page 0), the
    Pallas kernel's 0."""
    B, H, kv, hd, nB, bs, n_blk = 4, 8, 2, 64, 24, 8, 5
    args = _paged_case(5, B, H, kv, hd, nB, bs, n_blk, holes=True)
    mine, oracle, pallas = _both(args, softcap, hd)
    np.testing.assert_allclose(mine, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine[:-1], pallas[:-1], rtol=2e-3, atol=2e-3)
    assert np.all(pallas[-1] == 0.0)
    page0 = args[2][0].mean(axis=0)               # (K, hd)
    np.testing.assert_allclose(mine[-1], np.repeat(page0, H // kv, axis=0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,kv,hd,nB,bs,n_blk", SHAPES)
def test_paged_attention_ref_binding_softcap_matches_jax(B, H, kv, hd, nB, bs,
                                                         n_blk):
    """At scale 1 with queries at 3 x randn the scores reach tens, so a
    softcap of 20 binds: it moves the output by more than 0.1, far past
    the tolerances, and both sides still agree."""
    args = _paged_case(B * 13 + H, B, H, kv, hd, nB, bs, n_blk, q_std=3.0)
    mine, oracle, pallas = _both(args, 20.0, hd, scale=1.0)
    np.testing.assert_allclose(mine, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, pallas, rtol=2e-3, atol=2e-3)
    free, _, _ = _both(args, 0.0, hd, scale=1.0)
    assert np.abs(mine - free).max() > 0.1


def test_cpu_tensors_dispatch_to_plain_version():
    args = _paged_case(3, *SHAPES[0])
    t = [torch.from_numpy(a) for a in args]
    pa.launches = 0
    out = ops.paged_attention(*t, scale=0.125, softcap=0.0)
    assert pa.launches == 0
    expect = ref.paged_attention_ref(*t, scale=0.125, softcap=0.0)
    assert torch.equal(out, expect)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fall-back: the kernel wrapper takes CUDA tensors or raises."""
    t = [torch.from_numpy(a) for a in _paged_case(3, *SHAPES[0])]
    pa.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(*t, scale=0.125)
    assert pa.launches == 0


def test_build_path_is_keyed_by_source_hash():
    assert set(build.KERNELS) == {"flash_attention", "paged_attention",
                                  "paged_extend_attention", "quant_matmul",
                                  "ssd_scan"}
    for name in build.KERNELS:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert path == build.library_path(name)
        assert (build.CSRC / build.KERNELS[name][0]).exists()


@pytest.mark.parametrize("G,hd,bs", [(4, 128, 16), (8, 256, 16), (1, 64, 8)])
def test_shared_memory_fits_a_block(G, hd, bs):
    """The decode plan's block fits for every dtype pair, at a short and a
    4096-token table."""
    for n_blk in (32, 4096 // bs):
        for page, q in PLAN_DTYPES:
            plan = pa.paged_plan(4, 2, G, 1, n_blk, bs, hd, page, q, 132)
            assert plan.smem <= checks.SMEM_LIMIT
            assert plan.smem == pa.smem_bytes(
                G, hd, bs, plan.chunk, plan.stages,
                torch.empty((), dtype=page).element_size(),
                torch.empty((), dtype=q).element_size(), suffix=False,
                mma=plan.mma)


# ---------------------------------------------------------------------------
# the split plan and the split-and-merge arithmetic of both paged kernels
# ---------------------------------------------------------------------------

PLAN_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.int8, torch.float32), (torch.int8, torch.bfloat16)]
# B, K, G, S, n_blk, bs, hd, suffix: phi3's serving decode and extend,
# 4 x 4096 tokens, gemma3-1b's global layers, a one-page table, a batch
# wide enough to need no split
PLANS = [(4, 10, 4, 1, 32, 16, 128, False), (4, 10, 4, 4, 32, 16, 128, True),
         (4, 10, 4, 1, 256, 16, 128, False), (4, 1, 4, 1, 256, 16, 256, False),
         (4, 1, 4, 5, 64, 16, 256, True), (3, 2, 2, 1, 1, 8, 32, False),
         (64, 8, 4, 4, 64, 16, 128, True)]


@pytest.mark.parametrize("B,K,G,S,n_blk,bs,hd,suffix", PLANS)
@pytest.mark.parametrize("page,q", PLAN_DTYPES,
                         ids=["f32", "bf16", "int8", "int8-bf16q"])
def test_paged_plan_covers_each_table_entry_once(B, K, G, S, n_blk, bs, hd,
                                                 suffix, page, q):
    """Splits of ``pages`` entries cover the table exactly once, none of
    them empty by construction; chunks no longer than a split, one stage
    only when a chunk is the whole split; row tiles of at most
    ``ROW_TILE`` rows; at least two blocks an SM of a 132-SM card where
    the table, the merge's cap on splits and a split's floor of a tile's
    rows in keys allow; tensor cores only for bf16 queries over bf16 /
    int8 pages."""
    plan = pa.paged_plan(B, K, G, S, n_blk, bs, hd, page, q, 132, suffix)
    cover = [j // plan.pages for j in range(n_blk)]
    assert sorted(set(cover)) == list(range(plan.splits))
    assert (plan.splits - 1) * plan.pages < n_blk <= plan.splits * plan.pages
    assert 1 <= plan.chunk <= plan.pages
    assert plan.stages == min(pa.MAX_STAGES, -(-plan.pages // plan.chunk))
    assert plan.rows == min(G * S, pa.ROW_TILE)
    tiles = -(-G * S // plan.rows)
    assert plan.blocks == B * K * tiles * plan.splits
    assert plan.pages * bs >= plan.rows or plan.pages == n_blk
    assert plan.blocks >= 2 * 132 or plan.splits == n_blk \
        or plan.splits >= min(hd, pa.MAX_SPLITS) \
        or B * K * tiles >= 2 * 132 or plan.pages == -(-plan.rows // bs)
    assert plan.splits <= min(hd, pa.MAX_SPLITS)
    assert plan.mma == (q == torch.bfloat16 and page != torch.float32
                        and hd % 16 == 0)
    if (B, K, n_blk) == (4, 10, 32):
        assert plan.blocks >= 2 * 132 and plan.splits > 1


@pytest.mark.parametrize("B,K,G,S,n_blk,bs,hd,suffix", PLANS)
@pytest.mark.parametrize("page,q", PLAN_DTYPES,
                         ids=["f32", "bf16", "int8", "int8-bf16q"])
def test_paged_plan_sizes_fit(B, K, G, S, n_blk, bs, hd, suffix, page, q):
    """The block's shared memory is ``smem_bytes`` of the plan and fits
    ``checks.SMEM_LIMIT``; a split plan's workspace holds one float32
    partial (m, l, acc[hd]) per (row, kv head, split, query row)."""
    plan = pa.paged_plan(B, K, G, S, n_blk, bs, hd, page, q, 132, suffix)
    elt = torch.empty((), dtype=page).element_size()
    q_elt = torch.empty((), dtype=q).element_size()
    assert plan.smem == pa.smem_bytes(plan.rows, hd, bs, plan.chunk,
                                      plan.stages, elt, q_elt, suffix=suffix,
                                      mma=plan.mma) <= checks.SMEM_LIMIT
    stage = 2 * plan.chunk * bs * hd * elt
    assert stage <= max(pa.STAGE_BYTES, 2 * bs * hd * elt)
    assert plan.workspace == (B * K * plan.splits * G * S * (hd + 2)
                              if plan.splits > 1 else 0)


def _random_plan(rng, n_blk):
    """A plan of random split length (the model needs splits and pages)."""
    pages = int(rng.integers(1, n_blk + 1))
    return pa.PagedPlan(-(-n_blk // pages), pages, 1, 1, False, 0, 0, 0,
                        pa.ROW_TILE)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_merge_equals_plain_version(seed, softcap):
    """The kernel's split arithmetic (partials per split, merged in split
    order) at float32 over random splits equals the plain version, -1
    pages and splits with no key included; a row with no key gives 0,
    the Pallas kernel's rule."""
    rng = np.random.default_rng(seed)
    B, H, kv, hd, nB, bs, n_blk = 4, 8, 2, 32, 40, 4, 9
    args = _paged_case(seed, B, H, kv, hd, nB, bs, n_blk, holes=True,
                       q_std=3.0)
    t = [torch.from_numpy(a) for a in args]
    kw = dict(scale=1.0, softcap=softcap)
    plan = _random_plan(rng, n_blk)
    got = pa.split_reference(*t, plan, **kw)
    want = ref.paged_attention_ref(*t, **kw)
    torch.testing.assert_close(got[:-1], want[:-1], rtol=1e-5, atol=1e-5)
    assert torch.all(got[-1] == 0)
    _, _, pallas = _both(args, softcap, hd, scale=1.0)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-3, atol=2e-3)
    if plan.splits > 1:         # row 0 fills the table: its last split counts
        broken = pa.split_reference(*t, plan, drop=plan.splits - 1, **kw)
        assert float((broken[0] - want[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_extend_split_merge_equals_plain_version(seed, quant):
    """The extend read's split arithmetic over random splits (the suffix
    in the last split, which may hold no context) equals the plain
    version at float32, the -1 hole and the pos-0 row included."""
    rng = np.random.default_rng(seed)
    shape = EXT_SHAPES[0]
    args, scales = _extend_case(seed, *shape, quant=quant, q_std=3.0)
    t = [torch.from_numpy(a) for a in args]
    kw = dict(scale=1.0, softcap=20.0)
    if scales:
        kw.update(k_scale=torch.from_numpy(scales[0]),
                  v_scale=torch.from_numpy(scales[1]))
    plan = _random_plan(rng, shape[-1])
    got = pea.split_reference(*t, plan, **kw)
    torch.testing.assert_close(got, ref.paged_extend_attention_ref(*t, **kw),
                               rtol=1e-5, atol=1e-5)


# B, K, G, n_blk, bs, hd of the int8 catch-up waves the engine serves:
# gemma3-1b's global layers (4 slots, max_len 2048) and phi3-medium-14b
# at max_len 512 and 2048; and the widest S each may be sent (up to
# max_len; gemma3-1b's ring layers cap it at its 512-token window)
SERVED_EXTEND = {"gemma3-1b": ((4, 1, 4, 128, 16, 256), 512),
                 "phi3-512": ((4, 10, 4, 32, 16, 128), 512),
                 "phi3-2048": ((4, 10, 4, 128, 16, 128), 2048)}


@pytest.mark.parametrize("shape", SERVED_EXTEND, ids=list(SERVED_EXTEND))
@pytest.mark.parametrize("page", [torch.int8, torch.bfloat16],
                         ids=["int8", "bf16"])
def test_extend_plan_fits_every_served_width(shape, page):
    """Every extend width from 1 to the shape's limit plans a block within
    ``checks.SMEM_LIMIT`` (the wrapper's refusal never fires), on the
    tensor cores, with tiles of at most ``ROW_TILE`` rows and splits of at
    least a tile's rows in keys.  The first version's plan held all G x S
    rows and the float suffix, and refused gemma3-1b from S = 22 and phi3
    from S = 41."""
    (B, K, G, n_blk, bs, hd), top = SERVED_EXTEND[shape]
    for S in range(1, top + 1):
        plan = pa.paged_plan(B, K, G, S, n_blk, bs, hd, page,
                             torch.bfloat16, 132, suffix=True)
        checks.shared_memory(pea.NAME, plan.smem)
        assert plan.mma and plan.rows == min(G * S, pa.ROW_TILE)
        assert plan.pages * bs >= plan.rows or plan.pages == n_blk
        assert plan.splits <= min(hd, pa.MAX_SPLITS)


@pytest.mark.parametrize("S,G,rows", [(5, 4, 8), (7, 2, 3), (6, 1, 1),
                                      (4, 4, 64), (9, 4, 6)])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_extend_row_tiled_split_merge_equals_plain_version(S, G, rows,
                                                           quant):
    """The extend read's arithmetic over row tiles (a tile reads the
    suffix only up to its last token) and random splits equals the plain
    version at float32, tiles that end inside a token's G rows and one
    row a tile included; a merge without the last split (which holds the
    suffix) does not."""
    rng = np.random.default_rng(S * 10 + G)
    B, kv, hd, nB, bs, n_blk = 3, 2, 32, 14, 8, 4
    args, scales = _extend_case(S + G, B, S, G * kv, kv, hd, nB, bs, n_blk,
                                quant=quant, q_std=3.0)
    t = [torch.from_numpy(a) for a in args]
    kw = dict(scale=1.0, softcap=20.0)
    if scales:
        kw.update(k_scale=torch.from_numpy(scales[0]),
                  v_scale=torch.from_numpy(scales[1]))
    plan = _random_plan(rng, n_blk)._replace(rows=rows)
    want = ref.paged_extend_attention_ref(*t, **kw)
    got = pea.split_reference(*t, plan, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    broken = pea.split_reference(*t, plan, drop=plan.splits - 1, **kw)
    assert float((broken - want).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# paged_extend_attention
# ---------------------------------------------------------------------------

EXT_SHAPES = [(3, 4, 8, 2, 32, 14, 8, 4),      # B, S, H, K, hd, nB, bs, n_blk
              (2, 1, 4, 1, 16, 8, 8, 3)]


def _extend_case(seed, B, S, H, kv, hd, nB, bs, n_blk, quant=False,
                 q_std=0.5):
    """Random queries, suffix and pool; row 0 has a -1 hole below its
    pos, the last row sits at pos 0 (no context), stale bytes fill every
    page past each row's pos."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, hd)) * q_std).astype(np.float32)
    kp = (rng.standard_normal((nB, bs, kv, hd)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((nB, bs, kv, hd)) * 0.5).astype(np.float32)
    kn = (rng.standard_normal((B, S, kv, hd)) * 0.5).astype(np.float32)
    vn = (rng.standard_normal((B, S, kv, hd)) * 0.5).astype(np.float32)
    bt = np.full((B, n_blk), -1, np.int32)
    perm = rng.permutation(nB)
    pos = np.zeros((B,), np.int32)
    used = 0
    for b in range(B - 1):
        pos[b] = int(rng.integers(bs + 1, n_blk * bs - S + 1))
        k = -(-(pos[b] + S) // bs)
        bt[b, :k] = perm[used:used + k]
        used += k
    bt[0, 0] = -1                              # hole below pos
    bt[B - 1, 0] = perm[used]                  # pos 0: its write page only
    scales = ()
    if quant:
        kp, ks = _quantize(kp)
        vp, vs = _quantize(vp)
        scales = (ks, vs)
    return (q, kp, vp, kn, vn, bt, pos), scales


def _extend_three(args, scales, **kw):
    """(port plain, JAX oracle, JAX Pallas) outputs as numpy."""
    t = [torch.from_numpy(a) for a in args]
    j = [jnp.asarray(a) for a in args]
    tk, jk = dict(kw), dict(kw)
    if scales:
        tk.update(k_scale=torch.from_numpy(scales[0]),
                  v_scale=torch.from_numpy(scales[1]))
        jk.update(k_scale=jnp.asarray(scales[0]),
                  v_scale=jnp.asarray(scales[1]))
    mine = ref.paged_extend_attention_ref(*t, **tk).numpy()
    oracle = np.asarray(jax_ref.paged_extend_attention_ref(*j, **jk))
    pallas = np.asarray(jax_ops.paged_extend_attention(*j, **jk))
    return mine, oracle, pallas


@pytest.mark.parametrize("shape", EXT_SHAPES)
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_extend_attention_ref_matches_jax(shape, quant, softcap):
    args, scales = _extend_case(sum(shape) + quant, *shape, quant=quant)
    mine, oracle, pallas = _extend_three(args, scales,
                                         scale=shape[4] ** -0.5,
                                         softcap=softcap)
    np.testing.assert_allclose(mine, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_extend_attention_ref_binding_softcap(quant):
    """Queries at 3 x randn and scale 1: scores reach tens, so softcap 20
    moves the output by more than 0.1 and both sides still agree."""
    shape = EXT_SHAPES[0]
    args, scales = _extend_case(7, *shape, quant=quant, q_std=3.0)
    capped = _extend_three(args, scales, scale=1.0, softcap=20.0)
    np.testing.assert_allclose(capped[0], capped[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(capped[0], capped[2], rtol=1e-5, atol=1e-5)
    free = ref.paged_extend_attention_ref(
        *[torch.from_numpy(a) for a in args], scale=1.0,
        **({} if not scales else dict(
            k_scale=torch.from_numpy(scales[0]),
            v_scale=torch.from_numpy(scales[1])))).numpy()
    assert np.abs(capped[0] - free).max() > 0.1


def test_extend_pos_zero_row_sees_only_its_suffix():
    """A row at pos 0 reads no page: its output is causal attention over
    the suffix alone, whatever its pages hold."""
    shape = EXT_SHAPES[0]
    (q, kp, vp, kn, vn, bt, pos), _ = _extend_case(9, *shape)
    t = [torch.from_numpy(a) for a in (q, kp, vp, kn, vn, bt, pos)]
    out = ref.paged_extend_attention_ref(*t, scale=0.25)
    empty = [torch.from_numpy(a) for a in (q, kp * 0 + 7, vp * 0 - 7, kn,
                                             vn, bt, pos)]
    again = ref.paged_extend_attention_ref(*empty, scale=0.25)
    assert torch.equal(out[-1], again[-1])
    assert not torch.equal(out[0], again[0])


def test_extend_cpu_tensors_dispatch_to_plain_version():
    args, scales = _extend_case(3, *EXT_SHAPES[0], quant=True)
    t = [torch.from_numpy(a) for a in args]
    kw = dict(scale=0.2, k_scale=torch.from_numpy(scales[0]),
              v_scale=torch.from_numpy(scales[1]))
    pea.launches = 0
    out = ops.paged_extend_attention(*t, **kw)
    assert pea.launches == 0
    assert torch.equal(out, ref.paged_extend_attention_ref(*t, **kw))


def test_extend_kernel_wrapper_refuses_cpu_tensors():
    t = [torch.from_numpy(a) for a in _extend_case(3, *EXT_SHAPES[0])[0]]
    pea.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        pea.paged_extend_attention(*t, scale=0.2)
    assert pea.launches == 0


@pytest.mark.parametrize("G,S,hd,bs,fits", [
    (4, 4, 128, 16, True),          # phi3 on the serving path: ~43 KB
    (8, 8, 256, 16, True),          # needs the opt-in above 48 KB
    (1, 1, 64, 16, True),
    (16, 16, 256, 16, True)])       # R = 256 rows of 256: 4 tiles of 64
def test_extend_shared_memory(G, S, hd, bs, fits):
    """The plan of float32 pages and queries (the largest block) fits
    wherever the first version's block did, and where its 256 rows of
    hd 256 did not: a block holds one tile of rows."""
    plan = pea.paged_plan(4, 2, G, S, 32, bs, hd, torch.float32,
                          torch.float32, 132, suffix=True)
    smem = plan.smem
    assert (smem <= checks.SMEM_LIMIT) == fits
    if fits:
        return
    with pytest.raises(ValueError, match="does not fit"):
        checks.shared_memory(pea.NAME, smem)


# ---------------------------------------------------------------------------
# quant_matmul
# ---------------------------------------------------------------------------

def _qm_case(seed, m, k, n, bits=8):
    """x at randn, a randn / sqrt(k) weight quantized per output channel
    by the JAX host helper (outputs of order 1)."""
    from repro.kernels.quant_matmul import quantize_weights
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    wq, scale = quantize_weights(jnp.asarray(w), bits)
    return x, np.array(wq), np.array(scale)


def _bf16_round(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("m,k,n", [(4, 64, 128), (3, 200, 72), (130, 96, 8),
                                   (1, 33, 17)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_matmul_ref_equals_jax_ref(m, k, n, out_dtype):
    """Ragged shapes included (the Pallas kernel needs divisible blocks,
    the oracle does not)."""
    x, wq, scale = _qm_case(m * 7 + n, m, k, n)
    mine = ref.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(wq),
                                torch.from_numpy(scale),
                                out_dtype=getattr(torch, out_dtype))
    theirs = jax_ref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(wq),
                                      jnp.asarray(scale),
                                      out_dtype=getattr(jnp, out_dtype))
    assert str(mine.dtype) == f"torch.{out_dtype}"
    tol = (dict(rtol=1e-5, atol=1e-5) if out_dtype == "float32"
           else dict(rtol=2 ** -8, atol=1e-5))
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(theirs, np.float32), **tol)


@pytest.mark.parametrize("m,k,n", [(32, 64, 128), (8, 512, 256),
                                   (16, 128, 64)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_ref_close_to_pallas(m, k, n, bits):
    """The Pallas kernel in interpret mode: on x rounded to bfloat16
    beforehand it is the plain version up to summation order; on float32
    x it is within the bfloat16-input bound."""
    x, wq, scale = _qm_case(m + k + bits, m, k, n, bits)
    t = [torch.from_numpy(a) for a in (wq, scale)]
    xb = _bf16_round(x)
    pallas = np.asarray(jax_ops.quant_matmul(
        jnp.asarray(xb), jnp.asarray(wq), jnp.asarray(scale),
        out_dtype=jnp.float32))
    mine = ref.quant_matmul_ref(torch.from_numpy(xb), *t,
                                out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(mine, pallas, rtol=1e-5, atol=1e-5)
    pallas32 = np.asarray(jax_ops.quant_matmul(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
        out_dtype=jnp.float32))
    mine32 = ref.quant_matmul_ref(torch.from_numpy(x), *t,
                                  out_dtype=torch.float32).numpy()
    bound = 2 ** -8 * (np.abs(x) @ np.abs(wq * scale[None, :])) + 1e-6
    assert (np.abs(mine32 - pallas32) <= bound).all()
    assert np.abs(mine32 - pallas32).max() > 0     # the rounding is seen


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weights_equal_jax(bits):
    from repro.kernels.quant_matmul import quantize_weights
    w = np.random.default_rng(bits).standard_normal((64, 48)).astype(
        np.float32)
    q, s = qm.quantize_weights(torch.from_numpy(w), bits)
    jq, js = quantize_weights(jnp.asarray(w), bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))


def test_quant_matmul_cpu_tensors_dispatch_to_plain_version():
    x, wq, scale = [torch.from_numpy(a) for a in _qm_case(1, 4, 64, 72)]
    qm.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        out = ops.quant_matmul(x.to(dtype), wq, scale, out_dtype=dtype)
        assert out.dtype == dtype
        assert torch.equal(out, ref.quant_matmul_ref(x.to(dtype), wq, scale,
                                                     out_dtype=dtype))
    assert qm.launches == 0


def test_quant_matmul_kernel_wrapper_refuses_cpu_tensors():
    x, wq, scale = [torch.from_numpy(a) for a in _qm_case(1, 4, 64, 72)]
    qm.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        qm.quant_matmul(x, wq, scale)
    assert qm.launches == 0


@pytest.mark.parametrize("M,K,N,decode", [
    (4, 5120, 5120, True), (4, 5120, 1280, True), (4, 5120, 17920, True),
    (4, 17920, 5120, True), (8, 5120, 1280, True), (1, 5120, 17920, True),
    (3, 200, 72, False), (4, 16, 5120, False)],
    ids=["wq-wo", "wk-wv", "wgate-wup", "wdown", "wk-m8", "wgate-m1",
         "ragged", "k16"])
def test_quant_matmul_gemv_plan(M, K, N, decode):
    """The M <= 8 kernel's plan on a 132-SM card: 256-column blocks (16
    k lanes) for outputs 4096 wide or more, 64-column blocks (64 k
    lanes) below; whole k-lane slices that cover K exactly once; a
    workspace of splits x M x N float32 partials when K is split (none
    otherwise); at least two blocks an SM at every decode shape; a K of
    one or a few slices is cut as finely as it goes."""
    plan = qm.gemv_plan(M, K, N, 132)
    lanes = 16 if N >= 4096 else 64
    assert plan.cols == 4096 // lanes
    assert plan.k_chunk % lanes == 0
    assert (plan.splits - 1) * plan.k_chunk < K <= plan.splits * plan.k_chunk
    assert plan.blocks == -(-N // plan.cols) * plan.splits
    assert plan.workspace == (plan.splits * M * N if plan.splits > 1 else 0)
    if decode:
        assert plan.blocks >= 264 and plan.splits > 1
    else:
        assert plan.splits == -(-K // lanes)


# (M, K, N): the draft's prefill rows against phi3-medium-14b's four
# projections, a ragged K and N, and M just past the one-pass kernel
MMA_SHAPES = [(M, K, N) for M in (9, 16, 64, 300, 512, 2048)
              for K, N in ((5120, 17920), (5120, 5120), (5120, 1280),
                           (17920, 5120))] + [(130, 96, 8), (65, 5000, 72),
                                              (200, 100, 1280)]


def _mma_blocks(plan, M, K, N):
    """(m0, n0, k_begin, k_end) of every block of an M > 8 plan, in
    launch order, as ``csrc/quant_matmul.cu``'s kernel decodes its block
    index (row blocks fastest, then column blocks, then slices of K)."""
    m_blocks = -(-M // plan.rows)
    out = []
    for split in range(plan.splits):
        k0 = split * plan.k_chunk
        for t in range(plan.tiles):
            out.append(((t % m_blocks) * plan.rows, (t // m_blocks) *
                        plan.cols, k0, min(K, k0 + plan.k_chunk)))
    return out


@pytest.mark.parametrize("M,K,N", MMA_SHAPES,
                         ids=[f"{m}x{k}x{n}" for m, k, n in MMA_SHAPES])
def test_quant_matmul_mma_plan_covers_each_tile_once(M, K, N):
    """The M > 8 kernel's plan on a 132-SM card: 64-row tiles up to 64
    rows, 128- or 256-row ones above, K split only for 64-row tiles;
    slices of whole 64-row K steps; its blocks (decoded as the kernel
    decodes its block index) cover every output tile once and, within a
    tile, every k once; a workspace of splits x M x N partials and one
    counter a tile when K is split; the block's shared memory fits."""
    plan = qm.mma_plan(M, K, N, 132)
    assert (plan.rows == 64) == (M <= 64)
    assert plan.splits == 1 or plan.rows == 64
    assert (plan.rows, plan.cols) in qm.MMA_TILES
    assert plan.k_chunk % qm.MMA_BK == 0
    assert (plan.splits - 1) * plan.k_chunk < K <= plan.splits * plan.k_chunk
    assert plan.tiles == -(-M // plan.rows) * -(-N // plan.cols)
    assert plan.blocks == plan.tiles * plan.splits
    assert plan.workspace == (plan.splits * M * N if plan.splits > 1 else 0)
    assert plan.smem == qm.mma_smem(plan.rows, plan.cols) <= checks.SMEM_LIMIT
    spans = {}
    for m0, n0, k0, k1 in _mma_blocks(plan, M, K, N):
        assert m0 % plan.rows == 0 and n0 % plan.cols == 0
        assert 0 <= m0 < M and 0 <= n0 < N and 0 <= k0 < k1 <= K
        spans.setdefault((m0, n0), []).append((k0, k1))
    assert len(spans) == plan.tiles
    for ranges in spans.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_quant_matmul_mma_plan_follows_the_timed_choices():
    """The plan's rules are the H100 timings' choices: up to 64 rows
    (bound by the weight bytes) K is split until every SM has a block;
    from 512 rows the wide projections take 256 x 128 tiles unsplit, and
    the narrow wk / wv at 512 rows 128 x 128 (40 tiles beat 20 of 256
    rows and every split); 300 rows pad to 384 in 128-row tiles, not to
    512."""
    for M in (9, 16, 64):
        for K, N in ((5120, 17920), (5120, 5120), (5120, 1280),
                     (17920, 5120)):
            assert qm.mma_plan(M, K, N, 132).blocks >= 132
    for M in (512, 2048):
        for K, N in ((5120, 17920), (5120, 5120), (17920, 5120)):
            plan = qm.mma_plan(M, K, N, 132)
            assert (plan.rows, plan.cols, plan.splits) == (256, 128, 1)
    assert qm.mma_plan(512, 5120, 1280, 132)[:3] == (128, 128, 1)
    assert qm.mma_plan(300, 5120, 5120, 132).rows == 128


def test_quant_matmul_counters_are_kept_per_stream():
    """Split calls on two streams may run at once, so each (device,
    stream) gets its own zeroed column-block counters; a stream's
    counters are reused, and grown when a call needs more."""
    dev = torch.device("cpu")
    a = splits.counters_for(dev, 11, 20)
    assert splits.counters_for(dev, 11, 20) is a
    b = splits.counters_for(dev, 12, 20)
    assert b is not a and a.numel() >= 20 and not b.any()
    c = splits.counters_for(dev, 11, a.numel() + 1)
    assert c.numel() > a.numel() and not c.any()
    for key in ((dev, 11), (dev, 12)):
        splits._counters.pop(key)


# ---------------------------------------------------------------------------
# ssd_scan (the parity of its plain version with JAX is in
# tests/test_torch_ssm.py)
# ---------------------------------------------------------------------------

def _ssd_case(b=2, l=20, h=3, p=8, n=4):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((b, l, h, p), generator=g),
            torch.rand((b, l, h), generator=g), -torch.rand(h, generator=g),
            torch.randn((b, l, n), generator=g),
            torch.randn((b, l, n), generator=g))


def test_ssd_scan_kernel_wrapper_refuses_cpu_tensors():
    ssd.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(*_ssd_case(), chunk=8)
    assert ssd.launches == 0


def test_ssd_scan_cpu_tensors_dispatch_to_plain_version():
    """CPU tensors take the sequential plain version and launch
    nothing."""
    args = _ssd_case()
    ssd.launches = 0
    y, hf = ops.ssd_scan(*args, chunk=8)
    assert ssd.launches == 0
    assert y.shape == (2, 20, 3, 8) and hf.shape == (2, 3, 8, 4)
    assert hf.dtype == torch.float32
    want = ref.ssd_scan_ref(*args)
    assert torch.equal(y, want[0]) and torch.equal(hf, want[1])


@pytest.mark.parametrize("p,n,Q,fits", [(64, 128, 256, True),
                                        (32, 16, 256, True),
                                        (64, 128, 1024, True),
                                        (64, 128, 32768, False)])
def test_ssd_scan_shared_memory(p, n, Q, fits):
    """mamba2-370m's full width at its chunk of 256 fits a block; the
    chunk's dt and cumsum grow with Q, so a huge chunk does not."""
    assert (ssd.shared_bytes(p, n, Q) <= checks.SMEM_LIMIT) == fits


# (b, l, h, p, n, Q): mamba2-370m's prefills (4 x 1024, one row, the
# path's max_len 2048), zamba2-7b's state width, a head count no group
# divides, a ragged chunk and tail
SSD_PLANS = [(4, 1024, 32, 64, 128, 256), (1, 1024, 32, 64, 128, 256),
             (4, 2048, 32, 64, 128, 256), (4, 1024, 32, 64, 64, 256),
             (4, 1000, 30, 64, 128, 256), (2, 70, 8, 32, 16, 16),
             (3, 5, 8, 32, 16, 5), (1, 600, 7, 24, 40, 100)]


def _ssd_grids(b, l, h, n, Q):
    """Blocks of the local-state, score and output launches, as
    ``csrc/ssd_scan.cu::launch`` sizes their grids."""
    nc, T = -(-l // Q), -(-Q // ssd.TILE)
    return (b * nc * h * -(-n // ssd.STATE_SLICE), b * nc * T * (T + 1) // 2,
            b * nc * T * h)


def _ssd_out_blocks(b, l, h, Q):
    """(row b, chunk, first position, end position, head) of every
    output block that holds positions, as the output kernel decodes its
    block index (head, chunk x row tile, row)."""
    nc, T = -(-l // Q), -(-Q // ssd.TILE)
    out = []
    for bi in range(b):
        for y in range(nc * T):
            c, it = divmod(y, T)
            t0, i0 = c * Q, it * ssd.TILE
            qv = min(Q, l - t0)
            if i0 >= qv:
                continue
            for head in range(h):
                out.append((bi, c, t0 + i0, t0 + min(i0 + ssd.TILE, qv),
                            head))
    return out


@pytest.mark.parametrize("b,l,h,p,n,Q", SSD_PLANS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_ssd_plan_covers_each_position_once(b, l, h, p, n, Q, dtype):
    """The four launches: the output blocks that hold positions (decoded
    as the kernel decodes its block index) cover every (row, position,
    head) exactly once, in 64-row tiles that stay inside their chunk;
    the plan's shared memory of every block fits; its workspace holds a
    state per (b, chunk, head), the chunks' cumsums and totals, and the
    score tiles of every tile pair j <= i."""
    plan = ssd.ssd_plan(b, l, h, p, n, Q, dtype)
    nc = -(-l // Q)
    assert plan.chunks == nc and plan.row_tiles == -(-Q // ssd.TILE)
    T = plan.row_tiles
    assert max(plan.state_smem, plan.score_smem,
               plan.out_smem) <= checks.SMEM_LIMIT
    assert plan.workspace == b * nc * (h * (p * n + Q + 1)
                                       + T * (T + 1) // 2 * 64 * 64)
    seen = np.zeros((b, l, h), np.int32)
    for bi, c, i0, i1, head in _ssd_out_blocks(b, l, h, Q):
        assert c * Q <= i0 < i1 <= min(l, (c + 1) * Q) and i1 - i0 <= ssd.TILE
        seen[bi, i0:i1, head] += 1
    assert (seen == 1).all()


def test_ssd_plan_fills_the_card():
    """At mamba2-370m's served prefills every SM of a 132-SM card gets two
    output blocks or more, and at least one local-state block, even for a
    single row; the score tiles are computed once per (b, chunk), not per
    head."""
    for b in (1, 4):
        state_blocks, score_blocks, out_blocks = _ssd_grids(b, 1024, 32,
                                                            128, 256)
        assert out_blocks >= 2 * 132 and state_blocks >= 132
        assert score_blocks == b * 4 * 10       # 4 chunks, 10 tile pairs


# ---------------------------------------------------------------------------
# flash_attention: the plain version against the JAX oracle (float32,
# 1e-6) and the Pallas kernel in interpret mode (2e-3, the tolerance of
# tests/test_kernels.py's sweep); each sweep shape of that file paired
# with one of its window / softcap cases, plus a ragged S and T != S
# ---------------------------------------------------------------------------

FLASH_CASES = [                     # B, S, T, H, K, hd, window, softcap
    (2, 64, 64, 4, 2, 32, 0, 0.0),
    (2, 128, 128, 4, 4, 64, 16, 0.0),
    (2, 32, 32, 8, 1, 128, 0, 50.0),
    (2, 256, 256, 2, 2, 64, 32, 30.0),
    (1, 40, 40, 4, 2, 32, 16, 0.0),        # ragged S (no tile divides it)
    (2, 64, 32, 4, 1, 32, 0, 0.0),         # T < S: keys end before queries
]
FLASH_IDS = ["s64", "s128-w16", "s32-cap50", "s256-w32-cap30", "ragged40",
             "t32-s64"]


def _flash_case(B, S, T, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * 0.5).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))


@pytest.mark.parametrize("B,S,T,H,K,hd,window,softcap", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_attention_ref_matches_jax(B, S, T, H, K, hd, window, softcap):
    q, k, v = _flash_case(B, S, T, H, K, hd, seed=S + H)
    kw = dict(scale=hd ** -0.5, window=window, softcap=softcap)
    mine = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   **kw).numpy()
    j = [jnp.asarray(a) for a in (q, k, v)]
    oracle = np.asarray(jax_ref.flash_attention_ref(*j, **kw))
    pallas = np.asarray(jax_ops.flash_attention(*j, **kw))
    np.testing.assert_allclose(mine, oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mine, pallas, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,S,T,H,K,hd,window,softcap", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_attention_ref_in_float64(B, S, T, H, K, hd, window, softcap):
    """Given float64 inputs the plain version computes in float64 (the
    reference the card checks hold the kernel to): the same function as
    JAX's oracle, to float32's rounding."""
    q, k, v = _flash_case(B, S, T, H, K, hd, seed=S + H)
    kw = dict(scale=hd ** -0.5, window=window, softcap=softcap)
    mine = ref.flash_attention_ref(
        *(torch.from_numpy(a).double() for a in (q, k, v)), **kw)
    assert mine.dtype == torch.float64
    oracle = np.asarray(jax_ref.flash_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))
    np.testing.assert_allclose(mine.numpy(), oracle, rtol=1e-6, atol=1e-6)


def test_flash_attention_cpu_tensors_dispatch_to_plain_version():
    t = [torch.from_numpy(a) for a in _flash_case(2, 40, 40, 4, 2, 32)]
    fa.launches = 0
    out = ops.flash_attention(*t, scale=0.2, window=16, softcap=20.0)
    assert fa.launches == 0
    assert torch.equal(out, ref.flash_attention_ref(*t, scale=0.2, window=16,
                                                    softcap=20.0))


def test_flash_attention_kernel_wrapper_refuses_cpu_tensors():
    t = [torch.from_numpy(a) for a in _flash_case(2, 40, 40, 4, 2, 32)]
    fa.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*t, scale=0.2)
    assert fa.launches == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("hd,padded", [(32, 64), (64, 64), (128, 128),
                                       (256, 256)])
def test_flash_attention_shared_memory(hd, padded, dtype):
    """Every instantiation fits a block.  bfloat16: a 128-row query tile
    and two stages of 64-row key and value tiles, bfloat16 rows padded by
    8 (hd 256: 202,752 bytes).  float32: three 64 x (hd + 4) float32
    tiles and the 64 x 68 probability tile."""
    assert fa.padded_head_dim(hd) == padded
    if dtype == torch.bfloat16:
        want = 2 * (128 + 2 * 2 * 64) * (padded + 8)
    else:
        want = 4 * (3 * 64 * (padded + 4) + 64 * 68)
    assert fa.shared_bytes(hd, dtype) == want
    assert fa.shared_bytes(hd, dtype) <= checks.SMEM_LIMIT


# ---------------------------------------------------------------------------
# no kernel op silently cuts a gradient: each raises under autograd, on
# CPU tensors as on CUDA ones (the plain version stands in for the kernel)
# ---------------------------------------------------------------------------

def _op_calls():
    g = torch.Generator().manual_seed(0)
    q3, kp, vp, bt, ln = map(torch.from_numpy, _paged_case(3, *SHAPES[0]))
    q4 = torch.randn((3, 2, 4, 32), generator=g)
    kn = torch.randn((3, 2, 2, 32), generator=g)
    x, dt, A, Bm, Cm = _ssd_case()
    fq, fk, fv = map(torch.from_numpy, _flash_case(2, 40, 40, 4, 2, 32))
    wq = torch.randint(-127, 128, (16, 8), generator=g, dtype=torch.int8)
    pos = torch.tensor([4, 9, 0], dtype=torch.int32)
    return {
        "flash_attention": ((fq, fk, fv), lambda a: ops.flash_attention(
            *a, scale=0.2, window=16)),
        "paged_attention": ((q3, kp, vp), lambda a: ops.paged_attention(
            a[0], a[1], a[2], bt, ln, scale=0.2)),
        "paged_extend_attention": ((q4, kp, vp, kn, kn.clone()),
                                   lambda a: ops.paged_extend_attention(
            a[0], a[1], a[2], a[3], a[4], bt, pos, scale=0.2)),
        "quant_matmul": ((torch.randn((3, 16), generator=g),),
                         lambda a: ops.quant_matmul(
            a[0], wq, torch.rand(8, generator=g), out_dtype=torch.float32)),
        "ssd_scan": ((x, dt, A, Bm, Cm), lambda a: ops.ssd_scan(*a, chunk=8)),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "paged_extend_attention", "quant_matmul",
                                  "ssd_scan"])
def test_kernel_ops_refuse_gradients(name):
    """With any floating input requiring grad the op raises; under
    ``torch.no_grad()``, or with no input requiring grad, it runs."""
    inputs, call = _op_calls()[name]
    call(inputs)
    for i in range(len(inputs)):
        needy = list(inputs)
        needy[i] = inputs[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="no backward"):
            call(needy)
        with torch.no_grad():
            call(needy)
