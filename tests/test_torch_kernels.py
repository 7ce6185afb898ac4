"""The port's paged_attention plain version against the JAX oracle and
the JAX Pallas kernel (run in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it), plus the device dispatch.

The hand-written CUDA kernel itself runs only on the card: its tests
are in ``tests/test_torch_kernels_cuda.py``.  Inputs are made from a
numpy seed and handed to both frameworks.  Tolerances: the port's plain
version and the JAX oracle are the same float32 math (rtol=atol=1e-5);
against the Pallas kernel's online softmax the sweep of
``tests/test_kernels.py`` uses 2e-3, and so does this file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as JL
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import paged_attention as pa

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
    path = build.library_path("paged_attention")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("paged_attention-") and path.suffix == ".so"
    assert path == build.library_path("paged_attention")
    assert (build.CSRC / "paged_attention.cu").exists()


@pytest.mark.parametrize("G,hd,bs", [(4, 128, 16), (8, 256, 16), (1, 64, 8)])
def test_shared_memory_fits_a_block(G, hd, bs):
    assert pa.smem_bytes(G, hd, bs) <= pa._SMEM_LIMIT
