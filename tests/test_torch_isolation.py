"""PyTorch port isolation: the port and ``chip_smoke.py`` import nothing of
JAX or of the JAX package ``repro``, importing the port compiles nothing,
and ``chip_smoke.py`` refuses to report a result without a CUDA card."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = """
import json, pkgutil, importlib, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.kernels import _build
print(json.dumps({"mods": sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "jaxlib", "repro")),
                  "built": _build.build_log, "n": len([k for k in sys.modules
                                                      if k.startswith("repro_torch")])}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["mods"] == []
    assert res["built"] == {}
    assert res["n"] >= 15


def _run_smoke(cwd: Path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _torch_cuda():
    import torch

    return torch.cuda.is_available()


def test_chip_smoke_fails_without_a_card():
    if _torch_cuda():
        pytest.skip("a CUDA card is visible: chip_smoke.py would run for real")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
