"""The storage layer's four readers (``decode_ms``, ``scan_wait_ms``,
``h2d_ms``, ``groups_folded_per_request``): on hand-built traces, nothing
from a program without the file path's counters, 0.0 where a counter or
span is nought; and one traced CPU run of a small ``L5-edf-panel`` that
reads the three a CPU can."""
import json
import tempfile
import time

import pytest

from pmbench import harness, program_spans
from pmbench import trace as harness_trace
from pmbench.tests.conftest import ROOT

READERS = ("decode_ms", "scan_wait_ms", "h2d_ms", "groups_folded_per_request")
# the counters of a program whose file path has none (the collect path's)
OLD_COUNTERS = {"host_syncs": 61, "d2h_bytes": 8, "h2d_bytes": 226,
                "answer_tensors": 16, "answer_d2h_bytes": 4096,
                "answer_pinned_new": 0}
FILE_COUNTERS = {"scan_groups_read": 0, "scan_groups_cached": 0,
                 "scan_groups_skipped": 0, "scan_rows_read": 0,
                 "scan_bytes_read": 0, "scan_h2d_bytes": 0,
                 "edf_decode_ns": 0, "state_cache_hits": 0,
                 "state_cache_misses": 0, "state_cache_evictions": 0,
                 "memo_hits": 0, "memo_misses": 0}


def data(counters, host_s=None, device_s_in=None, device=True, n=2):
    program = program_spans.ProgramTrace(
        requests=list(range(n)), counters=counters, host_s=host_s or {},
        count={}, device_s_in=device_s_in or {}, fold_idle_s=None,
        case_filter_s=[], idle_gaps=[])
    return harness_trace.TraceData(
        requests=list(range(n)), cfg={}, rows=10, num_cases=2, spans={},
        device_s_in={}, kernels=0, busy_s=1.0 if device else None,
        window_s=3.0, device_ops=[], idle_gaps=[], program=program)


def reader(name):
    return harness.metric_reader(ROOT, name)


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_the_file_path(name):
    assert reader(name)(data(dict(OLD_COUNTERS))) is None
    assert reader(name)(data(None)) is None
    empty = data(dict(OLD_COUNTERS))
    empty.program = None
    assert reader(name)(empty) is None


@pytest.mark.parametrize("name", READERS)
def test_nought_reads_zero(name):
    got = reader(name)(data(dict(OLD_COUNTERS, **FILE_COUNTERS)))
    assert got == 0.0 and isinstance(got, float)


def test_each_reads_its_counter_or_span_a_request():
    counters = dict(FILE_COUNTERS, edf_decode_ns=3_000_000,
                    scan_groups_read=134)
    t = data(dict(OLD_COUNTERS, **counters),
             host_s={"scan.wait": 0.25, "scan.read": 0.05, "scan": 9.0},
             device_s_in={"scan.h2d": 0.004, "scan": 1.0})
    assert reader("decode_ms")(t) == pytest.approx(1.5)
    assert reader("scan_wait_ms")(t) == pytest.approx(150.0)
    assert reader("h2d_ms")(t) == pytest.approx(2.0)
    assert reader("groups_folded_per_request")(t) == 67.0
    # a device-trace metric reads nothing without a device
    t_cpu = data(t.program.counters, device_s_in={"scan.h2d": 0.004},
                 device=False)
    assert reader("h2d_ms")(t_cpu) is None


def test_a_traced_cpu_run_of_the_file_panel_reads_three(tiny_root, tmp_path,
                                                        monkeypatch):
    """The cell cut to 20,000 cases in 1,024-row groups (enough bytes for
    ``auto`` to stream it); the card's ``h2d_ms`` reads nothing here."""
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    path = tiny_root / "pmbench" / "configs" / "table6-L5-edf.json"
    cfg = json.loads(path.read_text())
    cfg["num_cases"] = 20000
    cfg["storage"]["row_group_rows"] = 1024
    path.write_text(json.dumps(cfg))
    res = harness.run_cell(tiny_root, "L5-edf-panel", 2**31 + 41, 0.4, True,
                           "cpu", time.time())
    assert res.line["correct"], res.line["check"]
    got = {k: v["value"] for k, v in res.line["metrics"].items()}
    assert set(got) == {"decode_ms", "scan_wait_ms",
                        "groups_folded_per_request"}
    p = res.data.program
    n = len(p.requests)
    assert got["groups_folded_per_request"] == \
        p.counters["scan_groups_read"] / n > 0
    assert got["decode_ms"] == p.counters["edf_decode_ns"] / n * 1e-6 > 0
    assert got["scan_wait_ms"] > 0
    assert list((tmp_path / "tmp").glob("pmbench-edf-*")) == []
