"""What the benchmark loads: never JAX, the JAX package or its benchmarks;
and the reference never the program."""
import ast
import json
import subprocess
import sys

from pmbench.tests.conftest import ROOT

REFERENCE_FILES = ["pmbench/reference.py", "pmbench/gen.py",
                   "pmbench/peaks.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "pmbench" / "verbs").glob("*.py"))

LOAD_ALL = r"""
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root / "src"))
import pmbench.run, pmbench.harness, pmbench.trace, pmbench.control
from pmbench import harness, traffic
bench = json.loads((root / "BENCHMARK.json").read_text())
for c in bench["configs"]:
    json.loads((root / c["file"]).read_text())
for w in bench["workloads"]:
    harness.load_cell(root, w["name"])
    for v in traffic.verb_names(traffic.load(root, w["traffic"])):
        harness.verb(v)
for p in (root / "pmbench" / "verbs").glob("*.py"):
    harness.verb(p.stem) if p.stem != "__init__" else None
for m in bench["per_layer"]:
    harness.metric_reader(root, m["name"])
if len(sys.argv) > 2:           # and one short run of a cell on the CPU
    import time
    for trace in (False, True):
        harness.run_cell(root, sys.argv[2], 7, 0.5, trace, "cpu", time.time())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_modules(code: str, root=ROOT, *more) -> set:
    out = subprocess.run([sys.executable, "-c", code, str(root), *more],
                         capture_output=True, text=True, cwd=root, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax_or_the_jax_package(tiny_root):
    (tiny_root / "src").symlink_to(ROOT / "src")
    loaded = top_level_modules(LOAD_ALL, tiny_root, "L1-panel")
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    assert "repro_torch" in loaded        # the program is what it measures


PLANTED = r"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from pmbench import harness
r = harness.run_cell(Path("."), "L1-panel", 2**31 + 17, 0.3, True, "cpu",
                     time.time())
print(json.dumps(r.line))
"""


def test_a_metric_file_that_loads_jax_stops_the_run(tiny_root):
    """A per-layer metric's reader, loaded after the window, that imports
    ``jax`` (a stub here): the run prints no result and names it."""
    (tiny_root / "jax").mkdir()
    (tiny_root / "jax" / "__init__.py").write_text("")
    reader = tiny_root / "pmbench" / "metrics" / "fold_ms.py"
    reader.write_text("import jax  # noqa: F401\n" + reader.read_text())
    out = subprocess.run([sys.executable, "-c", PLANTED, str(ROOT / "src")],
                         cwd=tiny_root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "jax" in out.stderr


def test_the_reference_imports_nothing_of_the_program():
    for rel in REFERENCE_FILES:
        tree = ast.parse((ROOT / rel).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("repro_torch", "repro",
                                                  "jax"), (rel, name)
    code = ("import sys, json; sys.path.insert(0, sys.argv[1] + '/src')\n"
            "import pmbench.reference, pmbench.gen\n"
            "import importlib, pathlib\n"
            "for p in pathlib.Path(sys.argv[1], 'pmbench', 'verbs')"
            ".glob('*.py'):\n"
            "    importlib.import_module('pmbench.verbs.' + p.stem)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" not in top_level_modules(code)
