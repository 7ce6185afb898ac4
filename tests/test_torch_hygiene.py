"""Boundaries of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, the port times only through its
telemetry clock, and every public name of a ``repro`` module that has a
port counterpart is there too — working, or raising
``NotImplementedError`` that names its ROADMAP item."""
import ast
import importlib
import importlib.util
import inspect
import json
import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

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
            "repro_torch.launch.train",
            "repro_torch.core.perf_model",
            "repro_torch.core.network",
            "repro_torch.core.trustzones",
            "repro_torch.core.resource",
            "repro_torch.core.placement",
            "repro_torch.core.scheduler",
            "repro_torch.core.split",
            "repro_torch.core.orchestrator",
            "repro_torch.core.context",
            "repro_torch.core.hub",
            "repro_torch.training.federated"} <= swept


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


# ---------------------------------------------------------------------------
# public names: the JAX package's, found in the port
# ---------------------------------------------------------------------------

# names the port keeps in another module (one wrapper module a kernel)
MOVED = {
    ("repro.kernels.flash_attention", "paged_attention"):
        "repro_torch.kernels.paged_attention",
    ("repro.kernels.flash_attention", "paged_extend_attention"):
        "repro_torch.kernels.paged_extend_attention",
}


def _twins():
    """Modules of ``repro`` whose ``repro_torch`` counterpart exists."""
    import repro
    out = []
    for info in pkgutil.walk_packages(repro.__path__, "repro."):
        port = "repro_torch" + info.name[len("repro"):]
        if importlib.util.find_spec(port) is not None:
            out.append(info.name)
    return out


def _public_names(module) -> list:
    """Public functions and classes of the JAX package that ``module``
    binds itself (def, class, assignment) or, for a package, re-exports;
    names it merely imports for its own use are not its API."""
    is_pkg = hasattr(module, "__path__")
    names = set()
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and is_pkg:
            names |= {a.asname or a.name for a in node.names}
    out = []
    for name in sorted(names):
        obj = getattr(module, name, None)
        if (not name.startswith("_") and callable(obj)
                and not inspect.ismodule(obj)
                and (getattr(obj, "__module__", "") or "").startswith(
                    "repro.")):
            out.append(name)
    return out


@pytest.mark.parametrize("jax_name", _twins())
def test_public_names_are_ported_or_name_their_item(jax_name):
    roadmap = (ROOT / "ROADMAP.md").read_text()
    jax_mod = importlib.import_module(jax_name)
    port_name = "repro_torch" + jax_name[len("repro"):]
    port_mod = importlib.import_module(port_name)
    missing = []
    for name in _public_names(jax_mod):
        home = MOVED.get((jax_name, name))
        obj = getattr(importlib.import_module(home) if home else port_mod,
                      name, None)
        if obj is None:
            missing.append(name)
            continue
        item = getattr(obj, "roadmap_item", None)
        if item is not None:
            assert item.split()[0] in roadmap, (name, item)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                obj()
            continue
        theirs = getattr(jax_mod, name)
        if inspect.isclass(theirs):
            missing += [f"{name}.{a}" for a in vars(theirs)
                        if not a.startswith("_") and not hasattr(obj, a)]
    assert missing == [], f"{port_name} lacks {missing}"


def test_tracer_and_frontend_are_ported():
    """A.8's tracer and frontend are the port's own: no stand-in of
    ``unported.not_ported`` among them, the tracer's ``ServeConfig``
    fields construct, and no source of the port cites A.8 as unported."""
    from repro_torch.launch import serve
    from repro_torch.serving import EdgeServingEngine, ServeConfig, telemetry
    names = {"Tracer": telemetry.Tracer,
             "validate_chrome_trace": telemetry.validate_chrome_trace,
             "summarize_trace": telemetry.summarize_trace,
             "dump_chrome_trace": EdgeServingEngine.dump_chrome_trace,
             "AsyncServingFrontend": serve.AsyncServingFrontend,
             "StreamHandle": serve.StreamHandle}
    stubs = [n for n, obj in names.items()
             if getattr(obj, "roadmap_item", None) is not None]
    assert stubs == []
    assert ServeConfig(trace=True, trace_clock=lambda: 0.0).trace
    cites = [str(p.relative_to(ROOT)) for p in SOURCES
             if "A.8" in p.read_text()]
    assert cites == []


def test_moe_family_is_ported():
    """A.9.1's moe family is the port's own: ``models.moe`` holds every
    public name of ``repro.models.moe`` working (none a stand-in of
    ``unported.not_ported``), the model API dispatches to it, and no
    source of the port cites A.9.1 as unported."""
    from repro.models import moe as jax_moe
    from repro_torch.models import model, moe
    names = _public_names(jax_moe)
    assert {"moe_mlp", "capacity", "prefill_paged", "extend"} <= set(names)
    stubs = [n for n in names
             if getattr(getattr(moe, n), "roadmap_item", None) is not None]
    assert stubs == []
    assert model._FAMILIES["moe"] is moe
    cites = [str(p.relative_to(ROOT)) for p in SOURCES
             if "A.9.1" in p.read_text()]
    assert cites == []


def test_vlm_encdec_families_are_ported():
    """A.9.2's vlm and A.9.3's encdec families are the port's own:
    ``models.vlm`` and ``models.encdec`` hold every public name of their
    JAX modules working, the layer functions the encdec family brought
    are no stand-ins, the model API dispatches to both (no family is
    left to refuse), the engine takes requests with extras, and no
    source of the port cites A.9.2 or A.9.3 as unported."""
    import numpy as np
    from repro.models import encdec as jax_encdec
    from repro.models import vlm as jax_vlm
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encdec, layers, model, vlm
    from repro_torch.serving import EdgeServingEngine, Request, ServeConfig
    stubs = []
    for jax_mod, mod in ((jax_vlm, vlm), (jax_encdec, encdec)):
        names = _public_names(jax_mod)
        assert {"init_params", "prefill_paged", "extend"} <= set(names)
        stubs += [n for n in names
                  if getattr(getattr(mod, n), "roadmap_item", None)
                  is not None]
    stubs += [n for n in ("gelu_mlp", "init_gelu_mlp", "sinusoidal_positions")
              if getattr(getattr(layers, n), "roadmap_item", None)
              is not None]
    assert stubs == []
    assert model._FAMILIES["vlm"] is vlm and model._FAMILIES["encdec"] is encdec
    assert not getattr(model, "_FAMILY_ITEMS", None)
    cfg = get_smoke_config("internvl2-76b")
    import torch
    eng = EdgeServingEngine(cfg, model.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), ServeConfig(),
        device="cpu")
    eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                       extras={"image_embeds": np.zeros(
                           (cfg.num_image_tokens, cfg.image_embed_dim),
                           np.float32)}))
    assert len(eng.queue) == 1
    cites = [str(p.relative_to(ROOT)) for p in SOURCES
             if "A.9.2" in p.read_text() or "A.9.3" in p.read_text()]
    assert cites == []


HUB_MODULES = ("core", "core.perf_model", "core.network", "core.trustzones",
               "core.resource", "core.placement", "core.scheduler",
               "core.split", "core.orchestrator", "core.earlyexit",
               "core.context", "core.hub", "training.federated")


@pytest.mark.parametrize("name", HUB_MODULES)
def test_hub_core_is_ported(name):
    """A.10's hub core and federated round are the port's own: every
    public name of the JAX module is there and none is a stand-in of
    ``unported.not_ported``."""
    jax_mod = importlib.import_module("repro." + name)
    port = importlib.import_module("repro_torch." + name)
    names = _public_names(jax_mod)
    assert names
    stubs = [n for n in names
             if getattr(getattr(port, n, None), "roadmap_item", None)
             is not None or not hasattr(port, n)]
    assert stubs == []
    stubs = [n for n in vars(port)
             if getattr(getattr(port, n), "roadmap_item", None) is not None]
    assert stubs == []


def test_port_perf_model_states_no_tpu_figure():
    """The port's performance model carries the H100's figures: no
    number of its module constants or of its hub entry is one of the
    JAX catalogue's TPU figures."""
    from repro.core import perf_model as jax_pm
    from repro_torch.core import perf_model as pm
    tpu = {jax_pm.PEAK_FLOPS_BF16, jax_pm.HBM_BW, 197e12, 819e9, 16e9}
    consts = {k: v for k, v in vars(pm).items()
              if k.isupper() and isinstance(v, (int, float))}
    assert {"PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"} <= set(consts)
    hub = pm.DEVICE_CATALOGUE["edgeai-hub"]
    figures = list(consts.values()) + [hub.peak_flops, hub.mem_bw,
                                       hub.memory_bytes, hub.peak_power]
    assert not tpu & set(figures)
    text = (PKG / "core" / "perf_model.py").read_text()
    assert "H100" in text and not re.search(r"TPU|v5e|197e12|819e9", text)
