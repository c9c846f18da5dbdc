"""The harness is data: a new configuration, traffic mix and per-layer
metric are new files and entries, run by name with no edit; and the
rules ``BENCHMARK.json`` keeps."""
import json
import re
import subprocess
import sys

import pytest

from pmbench import traffic
from pmbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

RUN = r"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from pmbench import harness
for trace in (False, True):
    r = harness.run_cell(Path("."), sys.argv[2], 2**31 + 9, 0.5, trace, "cpu",
                         time.time())
    print(json.dumps(r.line))
"""


def test_a_new_cell_is_files_and_entries(tiny_root):
    pm = tiny_root / "pmbench"
    cfg = json.loads((pm / "configs" / "table6-L1.json").read_text())
    cfg.update(name="tiny-new", num_cases=800, num_activities=9, model_seed=3)
    for col in ("attr0", "attr1"):
        cfg["columns"].pop(col)
    cfg["extra_numeric_attrs"] = 0
    (pm / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    (pm / "traffic" / "bands.json").write_text(json.dumps({
        "name": "bands", "deck": 10, "verbs": {"eventually_follows": 0.5, "dfg": 0.5},
        "filters": {"case_band": 0.6, "none": 0.4},
        "case_band": {"min_share": 0.2, "max_share": 0.3},
        "sample_per_stratum": 1}))
    (pm / "metrics" / "fold_share_pct.py").write_text(
        "def read(t):\n"
        "    if not t.spans.get('facade'):\n"
        "        return None\n"
        "    return 100.0 * t.spans.get('fold', 0.0) / t.spans['facade']\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-new", "source": "a test",
                             "file": "pmbench/configs/tiny-new.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-bands", "config": "tiny-new",
                               "traffic": "bands", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "fold_share_pct", "unit": "%",
                               "better": "lower", "source": "program_span",
                               "layer": "engine and verbs",
                               "moves": "events_per_s",
                               "workloads": ["tiny-bands"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RUN, str(ROOT / "src"),
                          "tiny-bands"], cwd=tiny_root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(x) for x in out.stdout.strip().splitlines())
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"events_per_s", "request_p95_ms",
                                     "peak_device_gib", "setup_s"}
    assert set(traced["metrics"]) == {"fold_share_pct"}
    assert 0 < traced["metrics"]["fold_share_pct"]["value"] <= 100
    assert list(plain)[-1] == "check"


def test_benchmark_json_keeps_its_rules():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in e2e
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for w in cells.values():
        assert w["chips"] == 1
        assert w["config"] in configs
        assert (ROOT / "pmbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert 1 <= len(w["why"]) <= 200
    for c in configs.values():
        assert c["file"].startswith("pmbench/") and (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())[
            "reduced"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert (ROOT / "pmbench" / "metrics" / f"{m['name']}.py").exists()
    # a full check of 24 cells fits its 43,200 s
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_mix_key_the_generator_does_not_read_is_refused(tiny_root):
    """Every mix is a closed loop of one client: a mix asking for more
    clients or think time is refused, not run as something else."""
    path = tiny_root / "pmbench" / "traffic" / "widgets.json"
    mix = json.loads(path.read_text())
    traffic.load(tiny_root, "widgets")
    path.write_text(json.dumps(dict(mix, clients=4)))
    with pytest.raises(ValueError, match="clients"):
        traffic.load(tiny_root, "widgets")
