"""Build and load the hand-written CUDA kernels.

Each source in ``repro_torch/csrc`` has a plain C interface and is
compiled at first use by ``nvcc`` straight into a shared library for
Hopper (``sm_90a``), then loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds.  Libraries go to ``build/repro_torch_kernels/`` at
the root of the checkout, named by a hash of the source and the flags: an
edited source builds anew, an unchanged one is loaded as it is.

Nothing here runs at import time; ``load`` builds on demand and
``build_all`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> (source file, {C symbol: (argtypes, restype)})
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
KERNELS = {
    "paged_attention": ("paged_attention.cu", {
        "repro_paged_attention": (
            [_P, _P, _P, _P, _P, _P, _P, _P,      # q k v ks vs tables len out
             _P, _P,                              # workspace, counters
             _I, _I, _I, _I, _I, _I,              # B H K hd bs n_blk
             _I, _I, _I, _I, _I, _I,              # splits pages chunk stages
                                                  # mma smem
             _F, _F,                              # scale softcap
             _I, _I,                              # q dtype, page dtype
             _P],                                 # stream
            _I),
    }),
    "paged_extend_attention": ("paged_extend_attention.cu", {
        "repro_paged_extend_attention": (
            [_P, _P, _P, _P, _P,                  # q k v ks vs
             _P, _P, _P, _P, _P,                  # k_new v_new tables pos out
             _P, _P,                              # workspace, counters
             _I, _I, _I, _I, _I, _I, _I,          # B S H K hd bs n_blk
             _I, _I, _I, _I, _I, _I, _I,          # rows splits pages chunk
                                                  # stages mma smem
             _F, _F,                              # scale softcap
             _I, _I,                              # q dtype, page dtype
             _P],                                 # stream
            _I),
    }),
    "ssd_scan": ("ssd_scan.cu", {
        "repro_ssd_scan": (
            [_P, _P, _P, _P, _P, _P, _P, _P,      # x dt A B C h0 y hout
             _P,                                  # workspace
             _I, _I, _I, _I, _I, _I,              # batch L H P N Q
             _L, _L, _L, _L, _L, _L, _L, _L,      # x dt B C batch/row strides
             _I,                                  # dtype of x, B, C, y
             _P],                                 # stream
            _I),
    }),
    "flash_attention": ("flash_attention.cu", {
        "repro_flash_attention": (
            [_P, _P, _P, _P,                      # q k v out
             _I, _I, _I, _I, _I, _I,              # B S T H K hd
             _F, _F, _I,                          # scale softcap window
             _I,                                  # dtype of q, k, v, out
             _P],                                 # stream
            _I),
    }),
    "quant_matmul": ("quant_matmul.cu", {
        "repro_quant_matmul": (
            [_P, _P, _P, _P, _P,                  # x, packed x, wq scale out
             _P, _P,                              # workspace, counters
             _I, _I, _I,                          # M K N
             _I, _I, _I, _I,                      # rows cols splits k_chunk
             _I, _I,                              # x dtype, out dtype
             _P],                                 # stream
            _I),
    }),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the CUDA kernels are built on the GPU host")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is (or will be) built: keyed
    by the source, the shared headers of ``csrc`` and the flags."""
    h = hashlib.sha256((CSRC / KERNELS[name][0]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    (process or None, temporary output, final path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp, out) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for kernel {name!r} "
                               f"(exit {proc.returncode}):\n{log}")
        # ptxas reports registers, shared memory and spills per kernel
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)      # atomic: concurrent builds agree
    return out


def build_all() -> dict[str, Path]:
    """Build every kernel library that is not built yet, one ``nvcc``
    per source, all started together.  Returns {name: library path};
    each library's ``nvcc`` output sits beside it as ``<name>.log``."""
    started = {name: _start(name) for name in KERNELS}
    return {name: _finish(name, *job) for name, job in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed, with ``argtypes``/``restype`` declared for every symbol."""
    lib = _loaded.get(name)
    if lib is None:
        path = _finish(name, *_start(name))
        lib = ctypes.CDLL(str(path))
        for sym, (argtypes, restype) in KERNELS[name][1].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[name] = lib
    return lib
