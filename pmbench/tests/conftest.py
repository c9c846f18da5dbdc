"""Fixtures of the benchmark's own tests (``python -m pytest pmbench/tests``
from the repository root; the program comes from ``src/``)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

# the sizes a test can hold: the configurations' cases cut, all else kept
TINY_CASES = {"table6-L5": 4000, "table6-L1": 1500}


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json and pmbench/ copied to ``dest``, the configurations
    cut to ``TINY_CASES``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "pmbench", dest / "pmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, n in TINY_CASES.items():
        path = dest / "pmbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["num_cases"] = n
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture(autouse=True)
def _modules_of_other_tests(monkeypatch):
    """A test runner that imported the JAX package for other test files in
    this process would fail every in-process run on the harness's check of
    loaded modules: hold those runs to what they load themselves.  The check
    as the benchmark meets it runs in fresh processes (``test_imports``)."""
    from pmbench import harness

    before = {m.split(".")[0] for m in sys.modules}
    check = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: sorted(set(check()) - before))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return tiny_copy(tmp_path)


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA card is attached (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
