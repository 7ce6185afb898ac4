"""The hand-written ``paged_attention`` CUDA kernel against its plain
PyTorch version, on the card.

Marked ``cuda``: without a GPU every test skips with a reason (the check
happens inside the fixture, never at import).  On the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels_cuda.py

This file imports no JAX (and ``--noconftest`` keeps the JAX package's
``tests/conftest.py`` out), so it runs where only PyTorch is installed.
Tolerances, stated per dtype, against the plain version computed in
float32 from the same inputs: float32 and int8 pages (float32 queries)
are the same float32 math summed in another order (rtol=atol=1e-4);
a bfloat16 output is that float32 result rounded once to bfloat16, so
it lies within one bfloat16 step of it (rtol=2**-8, atol=1e-5).
Queries at 3 x randn make each softmax peaked, so a skipped page, a
wrong head or a wrong row length moves the output far past these
tolerances.
"""
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2 ** -8, atol=1e-5),
       torch.int8: dict(rtol=1e-4, atol=1e-4)}
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


def _case(device, dtype, B=4, H=40, K=10, hd=128, nB=160, bs=16, n_blk=32,
          seed=0):
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
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    to = dict(device=device)
    return (q.to(**to), kp.to(**to), vp.to(**to), bt.to(**to),
            lengths.to(**to)), scales


def _plain(args, **kw):
    """The plain version in float32 on the kernel's inputs."""
    q, *rest = args
    return ref.paged_attention_ref(q.float(), *rest, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_kernel_matches_plain_version(device, dtype, softcap):
    """softcap 50 runs at scale 1, where scores reach tens and it binds."""
    args, scales = _case(device, dtype)
    scale = 1.0 if softcap else 128 ** -0.5
    kw = dict(scale=scale, softcap=softcap, **scales)
    before = pa.launches
    out = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    exp = _plain(args, **kw)
    torch.testing.assert_close(out[:-1].float(), exp[:-1], **TOL[dtype])
    assert torch.all(out[-1] == 0)             # empty row: the kernel's 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_softcap_binds(device, dtype):
    args, scales = _case(device, dtype, seed=3)
    outs = {}
    for softcap in (0.0, 20.0):
        kw = dict(scale=1.0, softcap=softcap, **scales)
        outs[softcap] = pa.paged_attention(*args, **kw)[:-1].float()
        torch.testing.assert_close(outs[softcap], _plain(args, **kw)[:-1],
                                   **TOL[dtype])
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
