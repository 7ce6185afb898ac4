"""The hand-written ``paged_attention``, ``paged_extend_attention``,
``quant_matmul`` and ``ssd_scan`` CUDA kernels against their plain
PyTorch versions, on the card.

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
value for a bfloat16 y.
"""
import pytest
import torch

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
          bs=16, n_blk=32, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g) * 3.0
    kp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    vp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    perm = torch.randperm(nB, generator=g)
    bt = torch.full((B, n_blk), -1, dtype=torch.int32)
    lengths = torch.zeros((B,), dtype=torch.int32)
    used = 0
    for b in range(B - 1):                       # last row stays empty
        n = int(torch.randint(1, n_blk * bs + 1, (1,), generator=g))
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


# ---------------------------------------------------------------------------
# paged_extend_attention
# ---------------------------------------------------------------------------

def _extend_case(device, dtype, q_dtype=None, B=4, S=4, H=40, K=10, hd=128,
                 nB=160, bs=16, n_blk=32, seed=0):
    """Queries at 3 x randn, suffix and pool at 0.5 x randn; ragged pos
    with each row's pages scattered over the pool, a -1 hole below row
    0's pos, the last row at pos 0, stale bytes past every pos.  The
    suffix is in q's dtype, as the caller passes it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g) * 3.0
    kp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    vp = torch.randn((nB, bs, K, hd), generator=g) * 0.5
    kn = torch.randn((B, S, K, hd), generator=g) * 0.5
    vn = torch.randn((B, S, K, hd), generator=g) * 0.5
    perm = torch.randperm(nB, generator=g).to(torch.int32)
    bt = torch.full((B, n_blk), -1, dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    used = 0
    for b in range(B - 1):
        pos[b] = int(torch.randint(bs + 1, n_blk * bs - S + 1, (1,),
                                   generator=g))
        k = -(-(int(pos[b]) + S) // bs)
        bt[b, :k] = perm[used:used + k]
        used += k
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
    """Up to R = G * S = 64 query rows of head_dim 256 (165 KB of shared
    memory, past the 48 KB default)."""
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


def test_extend_wrapper_refuses_shapes_that_do_not_fit(device):
    """G = 16, S = 16, hd = 256: 256 query rows need more shared memory
    than a block may use; the wrapper says so and launches nothing."""
    args, _ = _extend_case(device, torch.float32, B=1, S=16, H=32, K=2,
                           hd=256, nB=8, bs=16, n_blk=2)
    before = pea.launches
    with pytest.raises(ValueError, match="does not fit"):
        pea.paged_extend_attention(*args, scale=1.0)
    assert pea.launches == before


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
    (3, 5, 8, 32, 16, 256), (1, 200, 3, 24, 40, 64)])
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
