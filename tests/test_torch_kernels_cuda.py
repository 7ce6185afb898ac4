"""The hand-written ``flash_attention``, ``paged_attention``,
``paged_extend_attention``, ``quant_matmul`` and ``ssd_scan`` CUDA
kernels against their plain PyTorch versions, on the card; the gradient
guard of every kernel op on CUDA tensors; and the gemma superblock
trunk's forward on the card against the CPU's.

Marked ``cuda``: without a GPU every test skips with a reason (the check
happens inside the fixture, never at import).  On the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels_cuda.py

This file imports no JAX (and ``--noconftest`` keeps the JAX package's
``tests/conftest.py`` out), so it runs where only PyTorch is installed.
Tolerances, stated per output dtype, against the plain version
computed in float32 from the same inputs: float32 and int8 pages under
float32 queries are the same float32 math summed in another order
(rtol=atol=1e-4); a bfloat16 output (bfloat16 pages, or int8 pages under
bfloat16 queries as int8 serving runs them) is that float32 result
rounded once to bfloat16, so it lies within one bfloat16 step of it
(rtol=2**-8, atol=1e-5).
Queries at 3 x randn make each softmax peaked, so a skipped page, a
wrong head or a wrong row length moves the output far past these
tolerances.  ``quant_matmul`` is fed x already rounded to bfloat16 (the
kernel rounds x, the plain version does not), so only the summation
order differs: float32 outputs of order 1 within rtol=atol=1e-4, and a
bfloat16 output within one bfloat16 step of the float32 result
(rtol=2**-8, atol=1e-4).  ``ssd_scan`` is held against the model's
plain chunked path in float32 on the same inputs (the same sums in
another order): within 1e-4 x max |y|, plus one bfloat16 step of each
value for a bfloat16 y.  ``flash_attention`` is held at the paged
reads' tolerances (float32 within rtol=atol=1e-4, a bfloat16 output
within one bfloat16 step) against its plain version computed in
float64: in near-tie rows at scale 1 the exact result, rounded to
bfloat16, can miss the float32 plain version by more than a step; two
broken versions (the window ignored, the causal mask one key late) lie
far outside.
"""
import pytest
import torch

from repro_torch.kernels import checks
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_extend_attention as pea
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2 ** -8, atol=1e-5)}
# (page dtype, query dtype): the query dtype is the output's; float32
# queries over int8 pages, and the bfloat16 ones int8 serving runs
PAGES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.int8, torch.float32), (torch.int8, torch.bfloat16)]
PAGE_IDS = ["float32", "bfloat16", "int8", "int8-bf16q"]
# a softcap that binds (scores of tens at scale 1) moves the output by
# more than this, far beyond every tolerance
CAP_MOVES = 0.1


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _quantize(x):
    """Symmetric int8 per head_dim vector, as ``layers.quantize_kv``."""
    scale = x.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _case(device, dtype, q_dtype=None, B=4, H=40, K=10, hd=128, nB=160,
          bs=16, n_blk=32, seed=0, lengths=None):
    """Random lengths with the last row empty, or the given ``lengths``
    (every row)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g) * 3.0
    kp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    vp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    perm = torch.randperm(nB, generator=g)
    bt = torch.full((B, n_blk), -1, dtype=torch.int32)
    given = lengths
    lengths = torch.zeros((B,), dtype=torch.int32)
    used = 0
    for b in range(B if given is not None else B - 1):
        n = int(torch.randint(1, n_blk * bs + 1, (1,), generator=g)) \
            if given is None else given[b]
        k = -(-n // bs)
        bt[b, :k] = perm[used:used + k].to(torch.int32)
        lengths[b] = n
        used += k
    if lengths[0] > bs:
        bt[0, 0] = -1                            # hole inside row 0
    scales = {}
    if dtype == torch.int8:
        kp, ks = _quantize(kp)
        vp, vs = _quantize(vp)
        scales = dict(k_scale=ks.to(device), v_scale=vs.to(device))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q = q.to(q_dtype or (torch.float32 if dtype == torch.int8 else dtype))
    to = dict(device=device)
    return (q.to(**to), kp.to(**to), vp.to(**to), bt.to(**to),
            lengths.to(**to)), scales


def _plain(args, **kw):
    """The plain version in float32 on the kernel's inputs."""
    q, *rest = args
    return ref.paged_attention_ref(q.float(), *rest, **kw)


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_kernel_matches_plain_version(device, dtype, q_dtype, softcap):
    """softcap 50 runs at scale 1, where scores reach tens and it binds."""
    args, scales = _case(device, dtype, q_dtype)
    scale = 1.0 if softcap else 128 ** -0.5
    kw = dict(scale=scale, softcap=softcap, **scales)
    before = pa.launches
    out = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    exp = _plain(args, **kw)
    assert out.dtype == q_dtype
    torch.testing.assert_close(out[:-1].float(), exp[:-1], **TOL[q_dtype])
    assert torch.all(out[-1] == 0)             # empty row: the kernel's 0


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
def test_kernel_softcap_binds(device, dtype, q_dtype):
    args, scales = _case(device, dtype, q_dtype, seed=3)
    outs = {}
    for softcap in (0.0, 20.0):
        kw = dict(scale=1.0, softcap=softcap, **scales)
        outs[softcap] = pa.paged_attention(*args, **kw)[:-1].float()
        torch.testing.assert_close(outs[softcap], _plain(args, **kw)[:-1],
                                   **TOL[q_dtype])
    assert float((outs[20.0] - outs[0.0]).abs().max()) > CAP_MOVES


@pytest.mark.parametrize("G,hd,bs", [(1, 64, 8), (8, 256, 16), (2, 32, 32),
                                     (2, 16, 8)])
def test_kernel_shapes(device, G, hd, bs):
    K = 2
    args, _ = _case(device, torch.float32, B=3, H=G * K, K=K, hd=hd, nB=40,
                    bs=bs, n_blk=6, seed=G + hd)
    out = pa.paged_attention(*args, scale=hd ** -0.5)
    exp = ref.paged_attention_ref(*args, scale=hd ** -0.5)
    torch.testing.assert_close(out[:-1], exp[:-1], **TOL[torch.float32])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 18),
                                      (torch.bfloat16, 20),
                                      (torch.int8, 24)])
def test_wrapper_rejects_rows_that_are_not_whole_vectors(device, dtype, hd):
    """The kernel stages page rows in 16-byte loads."""
    (q, kp, vp, bt, ln), scales = _case(device, dtype, B=3, H=4, K=2, hd=hd,
                                        nB=40, n_blk=6)
    with pytest.raises(ValueError, match="16-byte vectors"):
        pa.paged_attention(q, kp, vp, bt, ln, scale=1.0, **scales)


def test_wrapper_rejects_unaligned_pools(device):
    (q, kp, vp, bt, ln), _ = _case(device, torch.float32, B=3, H=4, K=2,
                                   hd=32, nB=40, n_blk=6)
    flat = torch.empty(kp.numel() + 1, dtype=kp.dtype, device=device)
    shifted = flat[1:].view(kp.shape)            # 4 bytes past an aligned base
    shifted.copy_(kp)
    with pytest.raises(ValueError, match="k_pages is not 16-byte aligned"):
        pa.paged_attention(q, shifted, vp, bt, ln, scale=1.0)


def test_wrapper_rejects_bad_arguments(device):
    (q, kp, vp, bt, ln), _ = _case(device, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, kp, vp, bt.long(), ln, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q.transpose(0, 1), kp, vp, bt, ln, scale=1.0)
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_attention(q, kp.to(torch.int8), vp.to(torch.int8), bt, ln,
                           scale=1.0)


# split boundaries, long rows, gemma3-1b's global-layer shape (one kv
# head of 256) and repeatability: the split kernels' own cases.  The
# plan is the wrapper's for these shapes on this card.

def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _boundary(plan, bs, n_blk, S=0):
    """Lengths (pos, with S suffix tokens behind them) exactly two
    splits long, one page short of that, the whole table, and the whole
    table but three (the row whose split 1 becomes a -1 hole)."""
    edge = 2 * plan.pages * bs
    return [edge, edge - bs, n_blk * bs - S, n_blk * bs - S - 3]


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
def test_kernel_on_split_boundaries(device, dtype, q_dtype):
    """Rows ending on a split boundary, one page short of it, filling
    the table, and one whose split 1 is all -1 (that split reads
    nothing): within tolerance, and two calls bitwise equal."""
    plan = pa.paged_plan(4, 10, 4, 1, 32, 16, 128, dtype, q_dtype,
                         _sms(device))
    assert plan.splits > 2
    args, scales = _case(device, dtype, q_dtype, nB=160, seed=7,
                         lengths=_boundary(plan, 16, 32))
    args[3][-1, plan.pages:2 * plan.pages] = -1
    kw = dict(scale=1.0, softcap=50.0, **scales)
    out = pa.paged_attention(*args, **kw)
    torch.testing.assert_close(out.float(), _plain(args, **kw),
                               **TOL[q_dtype])
    assert torch.equal(out, pa.paged_attention(*args, **kw))


@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.int8, torch.bfloat16)],
    ids=["bfloat16", "int8-bf16q"])
def test_kernel_long_rows(device, dtype, q_dtype):
    """phi3's width over 256-page tables, rows of 4096, 4001, 2500 and 17
    positions: many chunks a split, through both stages of the ring (and,
    for these bf16 queries, each warp on its own key groups)."""
    plan = pa.paged_plan(4, 10, 4, 1, 256, 16, 128, dtype, q_dtype,
                         _sms(device))
    assert plan.stages == 2 and plan.mma
    args, scales = _case(device, dtype, q_dtype, nB=1024, n_blk=256, seed=8,
                         lengths=[4096, 4001, 2500, 17])
    kw = dict(scale=128 ** -0.5, **scales)
    out = pa.paged_attention(*args, **kw)
    torch.testing.assert_close(out.float(), _plain(args, **kw),
                               **TOL[q_dtype])
    assert torch.equal(out, pa.paged_attention(*args, **kw))


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
def test_kernel_gemma_global_shape(device, dtype, q_dtype):
    """gemma3-1b's global layers: H=4 over K=1, hd 256, ragged rows."""
    args, scales = _case(device, dtype, q_dtype, B=4, H=4, K=1, hd=256,
                         nB=256, n_blk=64, seed=9,
                         lengths=[1024, 17, 700, 1000])
    kw = dict(scale=256 ** -0.5, **scales)
    out = pa.paged_attention(*args, **kw)
    torch.testing.assert_close(out.float(), _plain(args, **kw),
                               **TOL[q_dtype])


# ---------------------------------------------------------------------------
# paged_extend_attention
# ---------------------------------------------------------------------------

def _extend_case(device, dtype, q_dtype=None, B=4, S=4, H=40, K=10, hd=128,
                 nB=160, bs=16, n_blk=32, seed=0, pos=None):
    """Queries at 3 x randn, suffix and pool at 0.5 x randn; ragged pos
    with each row's pages scattered over the pool, a -1 hole below row
    0's pos, the last row at pos 0, stale bytes past every pos (or the
    given ``pos``, every row, and no hole).  The suffix is in q's dtype,
    as the caller passes it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g) * 3.0
    kp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    vp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    kn = torch.randn((B, S, K, hd), generator=g) * 0.5
    vn = torch.randn((B, S, K, hd), generator=g) * 0.5
    perm = torch.randperm(nB, generator=g).to(torch.int32)
    bt = torch.full((B, n_blk), -1, dtype=torch.int32)
    given = pos
    pos = torch.zeros((B,), dtype=torch.int32)
    used = 0
    for b in range(B if given is not None else B - 1):
        pos[b] = int(torch.randint(bs + 1, n_blk * bs - S + 1, (1,),
                                   generator=g)) if given is None \
            else given[b]
        k = -(-(int(pos[b]) + S) // bs)
        bt[b, :k] = perm[used:used + k]
        used += k
    if given is None:
        bt[0, 0] = -1
        bt[B - 1, 0] = perm[used]
    scales = {}
    if dtype == torch.int8:
        kp, ks = _quantize(kp)
        vp, vs = _quantize(vp)
        scales = dict(k_scale=ks.to(device), v_scale=vs.to(device))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q_dtype = q_dtype or (torch.float32 if dtype == torch.int8 else dtype)
    q, kn, vn = q.to(q_dtype), kn.to(q_dtype), vn.to(q_dtype)
    to = dict(device=device)
    return (q.to(**to), kp.to(**to), vp.to(**to), kn.to(**to), vn.to(**to),
            bt.to(**to), pos.to(**to)), scales


def _extend_plain(args, **kw):
    q, kp, vp, kn, vn, bt, pos = args
    return ref.paged_extend_attention_ref(q.float(), kp, vp, kn.float(),
                                          vn.float(), bt, pos, **kw)


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_extend_kernel_matches_plain_version(device, dtype, q_dtype, softcap):
    """softcap 50 runs at scale 1, where scores reach tens and it binds;
    every row, the pos-0 row included, is compared."""
    args, scales = _extend_case(device, dtype, q_dtype)
    kw = dict(scale=1.0 if softcap else 128 ** -0.5, softcap=softcap,
              **scales)
    before = pea.launches
    out = pea.paged_extend_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pea.launches == before + 1
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    torch.testing.assert_close(out.float(), _extend_plain(args, **kw),
                               **TOL[q_dtype])


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
def test_extend_kernel_softcap_binds(device, dtype, q_dtype):
    args, scales = _extend_case(device, dtype, q_dtype, seed=3)
    outs = {}
    for softcap in (0.0, 20.0):
        kw = dict(scale=1.0, softcap=softcap, **scales)
        outs[softcap] = pea.paged_extend_attention(*args, **kw).float()
        torch.testing.assert_close(outs[softcap], _extend_plain(args, **kw),
                                   **TOL[q_dtype])
    assert float((outs[20.0] - outs[0.0]).abs().max()) > CAP_MOVES


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 4, 8])
def test_extend_kernel_shapes(device, G, hd, S):
    """Up to R = G * S = 64 query rows of head_dim 256 (149 KB of shared
    memory at one page a chunk, past the 48 KB default)."""
    K = 2
    args, scales = _extend_case(device, torch.int8, B=3, S=S, H=G * K, K=K,
                                hd=hd, nB=40, bs=16, n_blk=6,
                                seed=G * 100 + hd + S)
    kw = dict(scale=hd ** -0.5, **scales)
    out = pea.paged_extend_attention(*args, **kw)
    torch.testing.assert_close(out, _extend_plain(args, **kw),
                               **TOL[torch.float32])


def test_extend_wrapper_rejects_bad_arguments(device):
    (q, kp, vp, kn, vn, bt, pos), _ = _extend_case(device, torch.float32,
                                                   B=3, H=8, K=2, hd=32,
                                                   nB=40, n_blk=6)
    call = pea.paged_extend_attention
    with pytest.raises(ValueError, match="CUDA"):
        call(q.cpu(), kp, vp, kn, vn, bt, pos, scale=1.0)
    with pytest.raises(ValueError, match="int32"):
        call(q, kp, vp, kn, vn, bt, pos.long(), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        call(q.transpose(1, 2), kp, vp, kn, vn, bt, pos, scale=1.0)
    with pytest.raises(ValueError, match="k_new"):
        call(q, kp, vp, kn.to(torch.bfloat16), vn, bt, pos, scale=1.0)
    with pytest.raises(ValueError, match="k_scale"):
        call(q, kp.to(torch.int8), vp.to(torch.int8), kn, vn, bt, pos,
             scale=1.0)
    with pytest.raises(ValueError, match="16-byte vectors"):
        call(q[..., :18].contiguous(), kp[..., :18].contiguous(),
             vp[..., :18].contiguous(), kn[..., :18].contiguous(),
             vn[..., :18].contiguous(), bt, pos, scale=1.0)
    flat = torch.empty(kp.numel() + 1, dtype=kp.dtype, device=device)
    shifted = flat[1:].view(kp.shape)
    shifted.copy_(kp)
    with pytest.raises(ValueError, match="k_pages is not 16-byte aligned"):
        call(q, shifted, vp, kn, vn, bt, pos, scale=1.0)


def test_extend_kernel_takes_rows_past_the_first_versions_limit(device):
    """G = 16, S = 16, hd = 256 (256 query rows, which the first
    version's block could not hold): four row tiles, within tolerance."""
    args, _ = _extend_case(device, torch.float32, B=1, S=16, H=32, K=2,
                           hd=256, nB=8, bs=16, n_blk=2, pos=[7])
    plan = pea.paged_plan(1, 2, 16, 16, 2, 16, 256, torch.float32,
                          torch.float32, _sms(device), suffix=True)
    assert plan.rows == 64 and plan.smem <= checks.SMEM_LIMIT
    out = pea.paged_extend_attention(*args, scale=1.0)
    torch.testing.assert_close(out, _extend_plain(args, scale=1.0),
                               **TOL[torch.float32])


# (name, B, S, H, K, hd, n_blk): the widths an int8 catch-up wave may have
# at gemma3-1b's global layers (the first version refused S >= 22) and at
# phi3's (S >= 41), and a row count one past a 64-row tile (G = 1)
EXTEND_WIDTHS = [("gemma", 4, S, 4, 1, 256, 128) for S in (16, 21, 22, 64,
                                                         512)] \
    + [("phi3", 4, S, 40, 10, 128, 32) for S in (41, 64)] \
    + [("tile+1", 2, 65, 4, 4, 128, 16), ("tile+4", 2, 17, 8, 2, 64, 16)]


@pytest.mark.parametrize("name,B,S,H,K,hd,n_blk", EXTEND_WIDTHS,
                         ids=[f"{w[0]}-S{w[2]}" for w in EXTEND_WIDTHS])
@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.int8, torch.bfloat16), (torch.int8, torch.float32)],
    ids=["int8-bf16q", "int8"])
def test_extend_kernel_served_widths(device, name, B, S, H, K, hd, n_blk,
                                     dtype, q_dtype):
    """Each width against the plain version (the tiles' merge and the
    streamed suffix included), and two calls bitwise equal."""
    args, scales = _extend_case(device, dtype, q_dtype, B=B, S=S, H=H, K=K,
                                hd=hd, nB=B * n_blk + 8, n_blk=n_blk,
                                seed=S + H)
    kw = dict(scale=hd ** -0.5, softcap=50.0, **scales)
    out = pea.paged_extend_attention(*args, **kw)
    torch.testing.assert_close(out.float(), _extend_plain(args, **kw),
                               **TOL[q_dtype])
    assert torch.equal(out, pea.paged_extend_attention(*args, **kw))


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
def test_extend_kernel_on_split_boundaries(device, dtype, q_dtype):
    """pos on a split boundary, one page short of it, at the table's end
    and with split 1 all -1: within tolerance, two calls bitwise
    equal."""
    plan = pea.paged_plan(4, 10, 4, 4, 32, 16, 128, dtype, q_dtype,
                          _sms(device), suffix=True)
    assert plan.splits > 2
    args, scales = _extend_case(device, dtype, q_dtype, seed=7,
                                pos=_boundary(plan, 16, 32, S=4))
    args[5][-1, plan.pages:2 * plan.pages] = -1
    kw = dict(scale=1.0, softcap=50.0, **scales)
    out = pea.paged_extend_attention(*args, **kw)
    torch.testing.assert_close(out.float(), _extend_plain(args, **kw),
                               **TOL[q_dtype])
    assert torch.equal(out, pea.paged_extend_attention(*args, **kw))


@pytest.mark.parametrize("dtype,q_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.int8, torch.bfloat16)],
    ids=["bfloat16", "int8-bf16q"])
def test_extend_kernel_long_rows(device, dtype, q_dtype):
    """phi3's width, pos 4092, 3001, 2000 and 0 over 256-page tables:
    many chunks a split (each warp on its own key groups)."""
    plan = pea.paged_plan(4, 10, 4, 4, 256, 16, 128, dtype, q_dtype,
                          _sms(device), suffix=True)
    assert plan.stages == 2 and plan.mma
    args, scales = _extend_case(device, dtype, q_dtype, nB=1024, n_blk=256,
                                seed=8, pos=[4092, 3001, 2000, 0])
    kw = dict(scale=128 ** -0.5, **scales)
    out = pea.paged_extend_attention(*args, **kw)
    torch.testing.assert_close(out.float(), _extend_plain(args, **kw),
                               **TOL[q_dtype])
    assert torch.equal(out, pea.paged_extend_attention(*args, **kw))


@pytest.mark.parametrize("dtype,q_dtype", PAGES, ids=PAGE_IDS)
def test_extend_kernel_gemma_global_shape(device, dtype, q_dtype):
    """H=4 over K=1, hd 256, S=4, ragged pos with a row at pos 0."""
    args, scales = _extend_case(device, dtype, q_dtype, H=4, K=1, hd=256,
                                nB=256, n_blk=64, seed=9)
    kw = dict(scale=256 ** -0.5, **scales)
    out = pea.paged_extend_attention(*args, **kw)
    torch.testing.assert_close(out.float(), _extend_plain(args, **kw),
                               **TOL[q_dtype])


# ---------------------------------------------------------------------------
# quant_matmul
# ---------------------------------------------------------------------------

QM_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
          torch.bfloat16: dict(rtol=2 ** -8, atol=1e-4)}


def _qm_case(device, M, K, N, x_dtype, seed=0):
    """x at randn rounded to bfloat16 (then held in ``x_dtype``), and a
    randn / sqrt(K) weight quantized per output channel, so outputs are
    of order 1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((M, K), generator=g).to(torch.bfloat16).to(x_dtype)
    w = torch.randn((K, N), generator=g) * K ** -0.5
    wq, scale = qm.quantize_weights(w)
    return x.to(device), wq.to(device), scale.to(device)


@pytest.mark.parametrize("M", [1, 4, 16, 130])
@pytest.mark.parametrize("K", [64, 200, 5120])
@pytest.mark.parametrize("N", [8, 72, 1280])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quant_matmul_matches_plain_version(device, M, K, N, x_dtype):
    """Both kernels (M <= 8 and M > 8) over ragged K and N; out_dtype is
    x's, as ``weight_einsum`` asks."""
    x, wq, scale = _qm_case(device, M, K, N, x_dtype, seed=M + K + N)
    before = qm.launches
    out = qm.quant_matmul(x, wq, scale, out_dtype=x_dtype)
    torch.cuda.synchronize()
    assert qm.launches == before + 1
    assert out.dtype == x_dtype and out.shape == (M, N)
    exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
    torch.testing.assert_close(out.float(), exp, **QM_TOL[x_dtype])


def test_quant_matmul_rounds_x_to_bfloat16(device):
    """On float32 x the kernel computes with x rounded to bfloat16, as
    the TPU kernel does: it matches the plain version on the rounded x,
    not on x."""
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn((4, 512), generator=g).to(device)
    w = torch.randn((512, 64), generator=g) * 512 ** -0.5
    wq, scale = [t.to(device) for t in qm.quantize_weights(w)]
    out = qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
    xb = x.to(torch.bfloat16).float()
    torch.testing.assert_close(
        out, ref.quant_matmul_ref(xb, wq, scale, out_dtype=torch.float32),
        **QM_TOL[torch.float32])
    assert float((out - ref.quant_matmul_ref(x, wq, scale,
                                             out_dtype=torch.float32))
                 .abs().max()) > 1e-4


def test_quant_matmul_unaligned_weight_rows(device):
    """A weight that starts 1 byte past an aligned base takes the masked
    scalar loads, with the same result."""
    x, wq, scale = _qm_case(device, 4, 96, 80, torch.float32, seed=5)
    flat = torch.empty(wq.numel() + 1, dtype=torch.int8, device=device)
    shifted = flat[1:].view(wq.shape)
    shifted.copy_(wq)
    for M in (4, 40):
        xm = x.repeat(M // 4, 1).contiguous()
        torch.testing.assert_close(
            qm.quant_matmul(xm, shifted, scale, out_dtype=torch.float32),
            qm.quant_matmul(xm, wq, scale, out_dtype=torch.float32))


# phi3-medium-14b's decode projections (K, N), and a K that the plan's
# slices do not divide
QM_DECODE = [(5120, 5120), (5120, 1280), (5120, 17920), (17920, 5120),
             (5000, 1280)]


@pytest.mark.parametrize("K,N", QM_DECODE, ids=[f"{k}x{n}" for k, n in
                                                  QM_DECODE])
@pytest.mark.parametrize("M", range(1, 9))
def test_quant_matmul_gemv_decode_shapes(device, M, K, N):
    """The M <= 8 kernel at every row count against the plain version,
    K split across blocks as the plan says (the last slice of the 5000
    rows is shorter)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = qm.gemv_plan(M, K, N, sms)
    assert plan.splits > 1
    if K == 5000:
        assert K % plan.k_chunk
    x, wq, scale = _qm_case(device, M, K, N, torch.bfloat16, seed=M + K)
    out = qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
    torch.testing.assert_close(out, exp, **QM_TOL[torch.float32])


@pytest.mark.parametrize("M,K,N", [(4, 5120, 1280), (4, 5120, 17920),
                                   (8, 17920, 5120), (4, 64, 1280),
                                   (3, 200, 72)])
def test_quant_matmul_gemv_is_bitwise_repeatable(device, M, K, N):
    """Two calls on the same inputs give the same bits, K split or not
    (the partials are summed in slice order, never by float atomics)."""
    x, wq, scale = _qm_case(device, M, K, N, torch.bfloat16, seed=3)
    outs = [qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# the draft's prefill rows (up to 4 prompts padded to a power-of-two
# bucket) against phi3-medium-14b's projections: the M > 8 kernel
PREFILL_M = [9, 16, 64, 300, 2048]


@pytest.mark.parametrize("K,N", QM_DECODE[:4], ids=[f"{k}x{n}" for k, n in
                                                      QM_DECODE[:4]])
@pytest.mark.parametrize("M", PREFILL_M)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quant_matmul_prefill_shapes(device, M, K, N, x_dtype):
    """The M > 8 kernel at the draft's prefill rows on its plan's tile
    (64 rows with K split up to 64 rows, 128 or 256 above)."""
    x, wq, scale = _qm_case(device, M, K, N, x_dtype, seed=M + N)
    out = qm.quant_matmul(x, wq, scale, out_dtype=x_dtype)
    torch.cuda.synchronize()
    exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
    torch.testing.assert_close(out.float(), exp, **QM_TOL[x_dtype])


# per tile of the M > 8 kernel, shapes its plan maps to that tile on a
# 132-SM card (64-row tiles split K) with the edges the projections do
# not reach: K not a multiple of 64 (a split's last slice shorter), weight
# rows not 16-byte vectors, x rows not 16-byte vectors
PREFILL_TILE_CASES = {
    (256, 128): [(512, 1000, 5120), (512, 1024, 5000), (512, 100, 5120)],
    (128, 256): [(300, 1000, 11264), (300, 1024, 11272), (300, 100, 11264)],
    (128, 128): [(300, 1000, 1280), (300, 1024, 1288), (130, 100, 1280)],
    (64, 256): [(40, 1000, 4096), (40, 1024, 4104), (40, 100, 4096)],
    (64, 128): [(40, 1000, 1280), (40, 200, 72), (40, 100, 1280)]}


@pytest.mark.parametrize("tile,M,K,N", [
    (tile, *shape) for tile, shapes in PREFILL_TILE_CASES.items()
    for shape in shapes], ids=[
    f"{t[0]}x{t[1]}-{edge}" for t in PREFILL_TILE_CASES
    for edge in ("ragged-K", "N%16", "K%8")])
def test_quant_matmul_every_prefill_tile(device, tile, M, K, N):
    """Every tile of the M > 8 kernel, reached through the shapes
    ``mma_plan`` gives it, on the edges the projections do not reach,
    split and unsplit."""
    plan = qm.mma_plan(M, K, N, _sms(device))
    assert (plan.rows, plan.cols) == tile
    x, wq, scale = _qm_case(device, M, K, N, torch.float32, seed=K + N)
    out = qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    exp = ref.quant_matmul_ref(x, wq, scale, out_dtype=torch.float32)
    torch.testing.assert_close(out, exp, **QM_TOL[torch.float32])


@pytest.mark.parametrize("M,K,N", [(512, 5120, 17920), (512, 5120, 1280),
                                   (64, 17920, 5120), (16, 5120, 1280)])
def test_quant_matmul_prefill_is_bitwise_repeatable(device, M, K, N):
    """Two calls of the M > 8 kernel give the same bits, K split (its
    partials summed in split order) or not."""
    x, wq, scale = _qm_case(device, M, K, N, torch.bfloat16, seed=4)
    outs = [qm.quant_matmul(x, wq, scale, out_dtype=torch.float32)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_quant_matmul_wrapper_rejects_bad_arguments(device):
    x, wq, scale = _qm_case(device, 4, 64, 72, torch.float32)
    call = qm.quant_matmul
    with pytest.raises(ValueError, match="CUDA"):
        call(x.cpu(), wq, scale)
    with pytest.raises(ValueError, match="contiguous"):
        call(x, wq.t().contiguous().t(), scale)
    with pytest.raises(TypeError, match="int8"):
        call(x, wq.float(), scale)
    with pytest.raises(ValueError, match="scale"):
        call(x, wq, scale[:-1])
    with pytest.raises(ValueError, match="x must be"):
        call(x[:, :-1].contiguous(), wq, scale)
    with pytest.raises(TypeError, match="out_dtype"):
        call(x, wq, scale, out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

def _ssd_case(device, b, l, h, p, n, dtype, seed=0):
    """x, B, C as strided views into one tensor (as the model passes
    them); dt small enough that the carried state matters."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    xbc = torch.cat([torch.randn((b, l, h * p), generator=g),
                     torch.randn((b, l, 2 * n), generator=g) * n ** -0.5],
                    dim=-1).to(dtype).to(device)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    dt = (torch.rand((b, l, h), generator=g) * 0.02 + 0.001).to(device)
    A = -(torch.rand((h,), generator=g) * 1.5 + 0.5).to(device)
    return x, dt, A, xbc[..., h * p:h * p + n], xbc[..., h * p + n:]


def _ssd_close(got, want):
    allowed = 1e-4 * float(want.abs().max())
    if got.dtype == torch.bfloat16:
        allowed = allowed + 2 ** -8 * want.abs()
    assert bool(((got.float() - want).abs() <= allowed).all()), \
        float((got.float() - want).abs().max())


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 16, 32, 64, 128, 256), (4, 300, 32, 64, 128, 256),
    (2, 1024, 32, 64, 128, 256), (2, 70, 8, 32, 16, 16),
    (3, 5, 8, 32, 16, 256), (1, 200, 3, 24, 40, 64),
    (4, 2048, 32, 64, 128, 256),   # the path's max_len: 8 chunks
    (1, 1024, 32, 64, 128, 256),   # one row
    (2, 1024, 112, 64, 64, 256),   # zamba2-7b's width
    (4, 1000, 30, 64, 128, 256),   # 30 heads, a ragged tail
    (1, 600, 7, 64, 128, 100)])    # a chunk no 64-row tile divides
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_matches_plain_chunked_path(device, b, l, h, p, n, chunk,
                                             dtype):
    x, dt, A, B, C = _ssd_case(device, b, l, h, p, n, dtype, seed=l + h)
    before = ssd.launches
    y, hf = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1 and y.dtype == dtype
    yr, hr = ssm.ssd_chunked(x.float(), dt, A, B.float(), C.float(), chunk)
    _ssd_close(y, yr)
    _ssd_close(hf, hr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_initial_state_continues_the_sequence(device, dtype):
    x, dt, A, B, C = _ssd_case(device, 2, 600, 32, 64, 128, dtype, seed=3)
    y_all, h_all = ssm.ssd_chunked(x.float(), dt, A, B.float(), C.float(),
                                   256)
    _, h1 = ssd.ssd_scan(x[:, :300], dt[:, :300], A, B[:, :300],
                         C[:, :300], chunk=256)
    y2, h2 = ssd.ssd_scan(x[:, 300:], dt[:, 300:], A, B[:, 300:],
                          C[:, 300:], chunk=256, h0=h1)
    _ssd_close(y2, y_all[:, 300:])
    _ssd_close(h2, h_all)


def test_ssd_scan_plain_version_agrees(device):
    x, dt, A, B, C = _ssd_case(device, 2, 130, 4, 16, 8, torch.float32)
    y, hf = ssd.ssd_scan(x, dt, A, B, C, chunk=32)
    yr, hr = ref.ssd_scan_ref(x, dt, A, B, C)
    _ssd_close(y, yr)
    _ssd_close(hf, hr)


def test_ssd_scan_wrapper_rejects_bad_arguments(device):
    x, dt, A, B, C = _ssd_case(device, 1, 20, 4, 16, 8, torch.float32)
    call = ssd.ssd_scan
    with pytest.raises(ValueError, match="CUDA"):
        call(x.cpu(), dt, A, B, C)
    with pytest.raises(TypeError, match="float32"):
        call(x, dt.to(torch.bfloat16), A, B, C)
    with pytest.raises(TypeError, match="differ"):
        call(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="packed"):
        wide = torch.zeros((1, 20, 4, 32), device=device)
        call(wide[..., :16], dt, A, B, C)
    with pytest.raises(ValueError, match="out of range"):
        big = torch.zeros((1, 20, 1, 128), device=device)
        call(big, dt[..., :1], A[:1], B, C)
    # one chunk of 40000 positions: its dt and cumsum alone are 320 KB
    long = 40_000
    with pytest.raises(ValueError, match="shared memory"):
        call(torch.zeros((1, long, 1, 16), device=device),
             torch.zeros((1, long, 1), device=device), A[:1],
             torch.zeros((1, long, 8), device=device),
             torch.zeros((1, long, 8), device=device), chunk=long)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH = [                                   # B, S, T, H, K, hd, window
    (2, 4096, 4096, 4, 1, 256, 0),          # gemma3-1b evaluation, global
    (2, 4096, 4096, 4, 1, 256, 512),        # and local layers
    (2, 512, 512, 40, 10, 128, 0),          # phi3's GQA
    (2, 300, 300, 4, 1, 256, 64),           # ragged S
    (2, 300, 200, 8, 2, 128, 0),            # T < S
    (1, 130, 190, 4, 4, 64, 16),            # T > S
    (3, 40, 40, 4, 2, 32, 0),               # a head_dim below the tile
    (4, 1024, 1024, 32, 32, 112, 0),        # zamba2-7b's prefill, MHA
]
FLASH_IDS = ["path-global", "path-local", "phi3-gqa", "ragged300",
             "t200-s300", "t190-s130", "hd32", "zamba2-hd112"]


def _flash_case(device, B, S, T, H, K, hd, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g) * 3.0
    k = torch.randn((B, T, K, hd), generator=g) * 0.5
    v = torch.randn((B, T, K, hd), generator=g) * 0.5
    return tuple(t.to(dtype).to(device) for t in (q, k, v))


def _flash_plain(q, k, v, **kw):
    return ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                   **kw).float()


@pytest.mark.parametrize("B,S,T,H,K,hd,window", FLASH, ids=FLASH_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_matches_plain_version(device, B, S, T, H, K, hd,
                                               window, dtype):
    q, k, v = _flash_case(device, B, S, T, H, K, hd, dtype, seed=S + H)
    kw = dict(scale=hd ** -0.5, window=window)
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and out.dtype == dtype
    assert torch.allclose(out.float(), _flash_plain(q, k, v, **kw),
                          **TOL[dtype])


@pytest.mark.parametrize("S,T", [(257, 65), (130, 129), (300, 191)])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_attention_bf16_ragged_tails(device, S, T, hd):
    """The tensor-core path at every head dim, with key counts whose
    ragged last tile lands in either stage of the (K, V) ring and query
    counts one row past a 128-row block."""
    q, k, v = _flash_case(device, 2, S, T, 4, 2, hd, torch.bfloat16,
                          seed=S + T + hd)
    kw = dict(scale=hd ** -0.5, window=0)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.allclose(out.float(), _flash_plain(q, k, v, **kw),
                          **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_softcap_binds(device, dtype):
    """At scale 1 the scores reach tens and a softcap of 50 binds."""
    q, k, v = _flash_case(device, 2, 300, 300, 4, 1, 256, dtype, seed=5)
    capped = fa.flash_attention(q, k, v, scale=1.0, window=64, softcap=50.0)
    free = fa.flash_attention(q, k, v, scale=1.0, window=64)
    want = _flash_plain(q, k, v, scale=1.0, window=64, softcap=50.0)
    assert torch.allclose(capped.float(), want, **TOL[dtype])
    assert float((capped.float() - free.float()).abs().max()) > CAP_MOVES


def _shifted_plain(q, k, v, scale, window):
    """What a kernel whose causal mask is one key late computes: query i
    sees keys up to i + 1 (and the window one key later too)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None] + 1
    j = torch.arange(T, device=q.device)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float()).reshape(q.shape)


def test_flash_attention_broken_versions_fail(device):
    """The window ignored, or the causal mask one key late: either lies
    far outside the tolerance the kernel meets."""
    q, k, v = _flash_case(device, 2, 1024, 1024, 4, 1, 256, torch.float32,
                          seed=9)
    kw = dict(scale=256 ** -0.5, window=128)
    out = fa.flash_attention(q, k, v, **kw)
    want = _flash_plain(q, k, v, **kw)
    assert torch.allclose(out, want, **TOL[torch.float32])
    for broken in (_flash_plain(q, k, v, scale=kw["scale"]),
                   _shifted_plain(q, k, v, **kw)):
        assert not torch.allclose(broken, want, **TOL[torch.float32])
        assert float((broken - out).abs().max()) > CAP_MOVES


def test_flash_attention_wrapper_rejects_bad_arguments(device):
    q, k, v = _flash_case(device, 1, 8, 8, 4, 2, 32, torch.float32)
    call = fa.flash_attention
    with pytest.raises(ValueError, match="CUDA"):
        call(q.cpu(), k, v, scale=1.0)
    with pytest.raises(TypeError, match="differ"):
        call(q, k.to(torch.bfloat16), v, scale=1.0)
    with pytest.raises(ValueError, match="group"):
        call(q[:, :, :3].contiguous(), k, v, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        call(q.transpose(1, 2), k, v, scale=1.0)
    with pytest.raises(ValueError, match="16-byte vectors"):
        x = torch.zeros((1, 8, 4, 6), dtype=torch.bfloat16, device=device)
        call(x, x[:, :, :2].contiguous(), x[:, :, :2].contiguous(),
             scale=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 8, 1, 320), device=device)
        call(x, x, x, scale=1.0)
    with pytest.raises(ValueError, match=">= 0"):
        call(q, k, v, scale=1.0, window=-1)


# ---------------------------------------------------------------------------
# no kernel op silently cuts a gradient (on CUDA tensors; the CPU twins
# are held to the same in tests/test_torch_kernels.py)
# ---------------------------------------------------------------------------

def _grad_calls(device):
    g = torch.Generator(device="cpu").manual_seed(0)
    (q, kp, vp, bt, ln), _ = _case(device, torch.float32, B=2, H=4, K=2,
                                   hd=32, nB=8, bs=4, n_blk=2)
    kn = (torch.randn((2, 3, 2, 32), generator=g) * 0.5).to(device)
    q4 = torch.randn((2, 3, 4, 32), generator=g).to(device)
    fq, fk, fv = _flash_case(device, 2, 40, 40, 4, 2, 32, torch.float32)
    x, dt, A, Bm, Cm = _ssd_case(device, 1, 20, 4, 16, 8, torch.float32)
    wq = torch.randint(-127, 128, (16, 8), generator=g,
                       dtype=torch.int8).to(device)
    scale = torch.rand(8, generator=g).to(device)
    pos = torch.tensor([3, 0], dtype=torch.int32, device=device)
    return {
        "flash_attention": (fq, lambda t: ops.flash_attention(
            t, fk, fv, scale=0.2), fa),
        "paged_attention": (q, lambda t: ops.paged_attention(
            t, kp, vp, bt, ln, scale=0.2), pa),
        "paged_extend_attention": (q4, lambda t: ops.paged_extend_attention(
            t, kp, vp, kn, kn, bt, pos, scale=0.2), pea),
        "quant_matmul": (torch.randn((3, 16), generator=g).to(device),
                         lambda t: ops.quant_matmul(t, wq, scale), qm),
        "ssd_scan": (x.contiguous(), lambda t: ops.ssd_scan(
            t, dt, A, Bm, Cm, chunk=8), ssd),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "paged_extend_attention", "quant_matmul",
                                  "ssd_scan"])
def test_kernel_ops_refuse_gradients_on_cuda(device, name):
    """An input that requires grad makes the op raise before launching;
    under ``torch.no_grad()`` the same call launches the kernel."""
    x, call, module = _grad_calls(device)[name]
    before = module.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        call(x.clone().requires_grad_(True))
    assert module.launches == before
    with torch.no_grad():
        call(x.clone().requires_grad_(True))
    torch.cuda.synchronize()
    assert module.launches == before + 1


# ---------------------------------------------------------------------------
# the superblock trunk on the card
# ---------------------------------------------------------------------------

def test_superblock_forward_on_cuda_matches_the_cpu(device):
    """gemma3-1b's smoke config (2 super-blocks of 2 local + 1 global) at
    8 layers, so the remainder locals run too, at float32 with TF32 off:
    the card's logits (plain path and the kernel path) and loss within
    1e-4 of the CPU's, relative to their largest magnitude."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("gemma3-1b").replace(dtype="float32",
                                                num_layers=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(tree, dev):
        return {k: (to(v, dev) if isinstance(v, dict) else v.to(dev))
                for k, v in tree.items()}
    on_card = to(params, device)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with torch.no_grad():
        want, _ = M.apply(cfg, params, batch)
        want_loss, _ = M.loss_fn(cfg, params, batch)
        for use_flash in (False, True):
            card = to(batch, device)
            before = fa.launches
            got, _ = M.apply(cfg, on_card, card, use_flash=use_flash)
            loss, _ = M.loss_fn(cfg, on_card, card, use_flash=use_flash)
            assert fa.launches - before == (16 if use_flash else 0)
            scale = float(want.abs().max())
            assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
            assert abs(float(loss) - float(want_loss)) <= \
                1e-4 * abs(float(want_loss))
