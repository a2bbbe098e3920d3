"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports JAX or the JAX package, its configs equal the reference's, and
its entry points refuse to fall back to the CPU silently."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.configs as jcfg
import repro_torch.configs as tcfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
STANDALONE = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None          # any attempt to import jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules
       if m == "repro" or m.startswith("repro.")
       or (m.startswith("jax") and sys.modules[m] is not None)]
print(len(names), "modules;", "leaked:", bad)
print(" ".join(names))
assert not bad, bad
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(ROOT / "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "leaked: []" in out.stdout
    assert int(out.stdout.split()[0]) >= 54      # every submodule walked
    walked = out.stdout.splitlines()[1].split()
    for mod in ("models.mla", "models.moe", "kernels.paged_attention",
                "serve.spec", "serve.proposer", "kernels.ref",
                "kernels.inner_product", "kernels.gelu",
                "kernels.conv_direct", "kernels.conv_winograd",
                "core.roofline.microbench", "core.roofline.report",
                "core.analysis", "launch.primitives"):
        assert f"repro_torch.{mod}" in walked


@pytest.mark.parametrize("path", STANDALONE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), (path, m)


@pytest.mark.parametrize("arch", jcfg.ALL_ARCHS)
@pytest.mark.parametrize("shrink", [False, True], ids=["full", "smoke"])
def test_configs_equal_reference(arch, shrink):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    if shrink:
        j, t = jcfg.smoke(j), tcfg.smoke(t)
    ja, ta = dataclasses.asdict(j), dataclasses.asdict(t)
    assert ja == ta
    assert tcfg.list_archs() == jcfg.list_archs()
    assert tuple(tcfg.ALL_ARCHS) == tuple(jcfg.ALL_ARCHS)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without")
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, EngineConfig
    cfg = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params)                       # default device "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    Engine(cfg, params, EngineConfig(device="cpu"))   # asked for: fine


def test_unported_blocks_raise_with_roadmap_item():
    from repro_torch.models import init_params
    for arch, item in [("jamba-v0.1-52b", "item 8"),
                       ("xlstm-350m", "item 8"),
                       ("whisper-small", "item 9")]:
        cfg = tcfg.smoke(tcfg.get_config(arch))
        with pytest.raises(NotImplementedError, match=item):
            init_params(cfg, torch.Generator().manual_seed(0), "cpu")
