"""Boundaries of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port times only through its
telemetry clock."""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {list(_modules())!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 20
    assert res["bad"] == []
    swept = set(_modules())
    assert {"repro_torch.serving.spec_decode",
            "repro_torch.kernels.quant_matmul",
            "repro_torch.core.earlyexit",
            "repro_torch.models.ssm",
            "repro_torch.kernels.ssd_scan",
            "repro_torch.kernels.flash_attention",
            "repro_torch.training.trainer",
            "repro_torch.training.checkpoint",
            "repro_torch.data.pipeline",
            "repro_torch.launch.train"} <= swept


def test_no_source_imports_jax_or_repro():
    assert {PKG / "models" / "ssm.py", PKG / "kernels" / "ssd_scan.py",
            PKG / "kernels" / "flash_attention.py",
            PKG / "training" / "optimizer.py",
            PKG / "launch" / "train.py"} <= set(SOURCES)
    offenders = []
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert offenders == []


def test_no_direct_clock_calls_under_the_port():
    """The sweep ``scripts/check.sh`` runs over ``src/``: timing goes
    through ``serving.telemetry.default_clock``."""
    pat = re.compile(r"time\.(time|perf_counter|monotonic)\(\)")
    swept = set(PKG.rglob("*.py"))
    assert {PKG / "models" / "ssm.py", PKG / "kernels" / "ssd_scan.py"} \
        <= swept
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(PKG.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []


def test_kernel_sources_live_in_csrc():
    assert (PKG / "csrc" / "paged_attention.cu").exists()
    text = (PKG / "csrc" / "paged_attention.cu").read_text()
    assert "flash_attention.py" in text and "3.35 TB/s" in text
    text = (PKG / "csrc" / "quant_matmul.cu").read_text()
    assert "src/repro/kernels/quant_matmul.py" in text and "`_kernel`" in text
    assert "3.35 TB/s" in text and "989 TFLOP/s" in text
    text = (PKG / "csrc" / "ssd_scan.cu").read_text()
    assert "src/repro/kernels/ssd_scan.py" in text and "`_kernel`" in text
    assert "3.35 TB/s" in text and "67 TFLOP/s" in text
    text = (PKG / "csrc" / "flash_attention.cu").read_text()
    assert "src/repro/kernels/flash_attention.py" in text
    assert "`_kernel`" in text and "`flash_attention`" in text
    assert "3.35 TB/s" in text and "989" in text
