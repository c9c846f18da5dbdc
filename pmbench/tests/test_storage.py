"""A configuration whose log lives in EDF files: only a file and entries,
run by the harness through the file-backed ``Dataset``; a fault in the
file path comes out not correct; a ``storage`` the harness does not read
is refused; a resident configuration sets up as it did."""
import json
import tempfile
import time

import pytest
import torch

from repro_torch.storage import edf

from pmbench import gen, harness, program_spans
from pmbench.tests.conftest import ROOT

STORAGE = {"format": "edf", "version": 3, "codec": "zlib1",
           "row_group_rows": 512, "files": 2}
CELLS = {"edf-widgets": "widgets", "edf-panel": "panel"}
E2E = {"events_per_s", "request_p95_ms", "peak_device_gib", "setup_s"}
# what a traced run on the CPU has to read (no device: the device-trace
# metrics read nothing)
ON_THE_CPU = {"facade_self_ms", "readback_ms", "host_syncs_per_request",
              "program_copy_mb"}


def add_config(root, storage=STORAGE, name="tiny-edf"):
    pm = root / "pmbench"
    cfg = json.loads((pm / "configs" / "table6-L5.json").read_text())
    cfg.update(name=name, storage=storage)
    (pm / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "a test",
                             "file": f"pmbench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    for cell, mix in CELLS.items():
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": mix, "chips": 1,
                                   "why": "a test"})
    for m in bench["per_layer"]:
        m["workloads"] += list(CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def edf_root(tiny_root, tmp_path, monkeypatch):
    """A tiny root with a file-backed configuration and its two cells;
    the runs' temporary directories go under ``tmp_path / "tmp"``."""
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    return add_config(tiny_root)


def run(root, cell, trace=False, seed=2**31 + 33):
    seconds = 1.5 if cell == "edf-widgets" else 0.4
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu",
                            time.time())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_file_backed_cell_is_files_and_entries(edf_root, tmp_path, cell):
    bench = json.loads((edf_root / "BENCHMARK.json").read_text())
    plain = run(edf_root, cell)
    assert plain.line["correct"], plain.line["check"]
    assert set(plain.line["metrics"]) == E2E
    assert any(" storage " in s for s in plain.stderr
               if s.startswith("pmbench: set-up s"))
    traced = run(edf_root, cell, trace=True)
    assert traced.line["correct"], traced.line["check"]
    got = traced.line["metrics"]
    assert ON_THE_CPU <= set(got) <= {m["name"] for m in bench["per_layer"]}
    # the five readers read what program_spans reads from the same window
    numbers = program_spans.numbers(traced.data.program)
    for name, value in numbers.items():
        assert got[name]["value"] == value
    assert set(got) & {f.__name__ for f in program_spans.READERS} == \
        set(numbers)
    assert traced.data.program.count.get("collect") == len(
        traced.data.requests)
    # every run's files are gone
    assert list((tmp_path / "tmp").glob("pmbench-edf-*")) == []


def drop_last_group(read_header):
    """A reader that misses each file's last row group."""
    def fault(path):
        header, base = read_header(path)
        last = header["groups"].pop()
        header["nrows"] -= last["nrows"]
        return header, base
    return fault


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_fault_in_the_file_path_is_not_correct(edf_root, monkeypatch,
                                                 cell):
    monkeypatch.setattr(edf, "read_header", drop_last_group(edf.read_header))
    line = run(edf_root, cell).line
    assert not line["correct"], line["check"]


def test_the_files_cut_the_log_into_case_ranges(tmp_path):
    cfg = dict(harness.load_config(ROOT, "table6-L1"), num_cases=700,
               storage=dict(STORAGE, files=3))
    cols = gen.generate(cfg, 5, torch.device("cpu"))
    paths = harness.write_log(cols, cfg, tmp_path)
    assert len(paths) == 3
    parts = [edf.read(p, device="cpu")[0] for p in paths]
    back = {k: torch.cat([f[k] for f in parts]) for k in cols}
    assert all(torch.equal(back[k], cols[k]) for k in cols)
    # contiguous case ranges: no case in two files, about a third each
    firsts = [int(f[gen.CASE][0]) for f in parts]
    lasts = [int(f[gen.CASE][-1]) for f in parts]
    assert firsts == [0, 233, 466] and all(
        a < b for a, b in zip(lasts, firsts[1:]))
    assert all(edf.read_header(p)[0]["version"] == 3 for p in paths)


@pytest.mark.parametrize("storage", [
    dict(STORAGE, compression_level=6),                 # a key not read
    {k: v for k, v in STORAGE.items() if k != "files"},  # one left out
    dict(STORAGE, format="parquet"),
    dict(STORAGE, files=0),
], ids=["unknown_key", "missing_key", "other_format", "no_files"])
def test_a_storage_the_harness_does_not_read_is_refused(tiny_root, storage):
    add_config(tiny_root, storage)
    with pytest.raises(ValueError, match="storage"):
        harness.load_cell(tiny_root, "edf-widgets")


def test_a_resident_configuration_sets_up_as_before(tiny_root):
    _, _, cfg, mix = harness.load_cell(tiny_root, "L1-panel")
    marks = []
    dev = torch.device("cpu")
    cols, ds = harness.prepare(cfg, mix, 2**31 + 3, dev, marks)
    assert [m[0] for m in marks] == ["imports", "kernels", "log", "warm-up"]
    assert not ds.is_files and harness.file_sigs(ds) == []
    assert gen.digest(cols) == gen.digest(gen.generate(cfg, 2**31 + 3, dev))
    assert ds.num_cases == cfg["num_cases"]


def test_the_control_runs_over_the_files_and_fails(edf_root, tmp_path):
    from pmbench import control

    limits = harness.load_json(edf_root / "pmbench" / "limits.json")
    for out in control.readings(edf_root, "edf-panel", [2**31 + 4], 1, 0.4,
                                "cpu"):
        prog = dict(out["program"], unanswered=out["failed"],
                    inputs_changed=0)
        assert harness.verdict(prog, limits)[0], out
        ctl = dict(out["control"], unanswered=0, inputs_changed=0)
        assert not harness.verdict(ctl, limits)[0], out
    assert list((tmp_path / "tmp").glob("pmbench-edf-*")) == []
