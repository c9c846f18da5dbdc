"""The reduction of a traced window to the program's spans and counters
(``pmbench.program_spans``), on hand-written chrome traces; and the
harness's seven readers, which the program's spans leave as they were."""
import dataclasses

import pytest

from pmbench import harness, program_spans
from pmbench import trace as harness_trace
from pmbench.tests.conftest import ROOT


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def launch(ts, corr, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1.0, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


REQUEST = [span("pmbench.request", 0.0, 1000.0),
           span("pmbench.facade", 0.0, 800.0),
           span("pmbench.filter", 10.0, 190.0),
           span("pmbench.fold", 300.0, 480.0),
           span("pmbench.readback", 850.0, 150.0)]
PROGRAM = [span("repro_torch.collect", 5.0, 790.0),
           span("repro_torch.facade.dims", 6.0, 3.0),
           span("repro_torch.filter", 12.0, 180.0),
           span("repro_torch.filter.case", 15.0, 170.0),
           span("repro_torch.filter.case.phase1", 20.0, 60.0),
           span("repro_torch.filter.case.keep", 90.0, 90.0),
           span("repro_torch.fold", 305.0, 470.0),
           span("repro_torch.fold.halo", 310.0, 40.0),
           span("repro_torch.fold.update.stats", 360.0, 300.0),
           span("repro_torch.kernel.ordered_histogram", 400.0, 20.0),
           span("repro_torch.fold.finalize.stats", 670.0, 100.0)]
# launches and the device ops they correlate with; the ordered fold's
# kernels are launched at 405 and 410 (one launch event of each CUDA API)
# and run later
DEVICE = [launch(30.0, 1), kernel("phase_one", 35.0, 40.0, 1),
          launch(100.0, 2), kernel("Memcpy HtoD", 150.0, 60.0, 2,
                                   "gpu_memcpy"),
          launch(405.0, 3), kernel("fold_bins", 440.0, 50.0, 3),
          launch(410.0, 4, "cuda_driver"),
          kernel("count_tile", 490.0, 30.0, 4),
          launch(680.0, 5), kernel("finalize_op", 690.0, 20.0, 5),
          launch(860.0, 6), kernel("Memcpy DtoH", 860.0, 100.0, 6,
                                   "gpu_memcpy")]


def reduced(events, before=None, after=None):
    return program_spans.reduce(events, ["r0"], before, after)


def test_a_device_op_goes_to_the_innermost_span_that_launched_it():
    p = reduced(REQUEST + PROGRAM + DEVICE)
    got = {k: round(v * 1e6, 6) for k, v in p.device_s_in.items()}
    assert got == {"filter.case.phase1": 40.0, "filter.case.keep": 60.0,
                   "kernel.ordered_histogram": 80.0,
                   "fold.finalize.stats": 20.0}
    # the client's read-back lies in no program span
    assert program_spans.ordered_fold_ms(p) == pytest.approx(80e-3)


def test_case_filter_time_runs_to_its_last_device_op():
    p = reduced(REQUEST + PROGRAM + DEVICE)
    # the span is 15-185; its H2D copy ends at 210
    assert p.case_filter_s == [pytest.approx(195e-6)]
    assert program_spans.case_filter_ms(p) == pytest.approx(195e-3)


def test_an_idle_gap_goes_to_the_innermost_span_holding_it():
    p = reduced(REQUEST + PROGRAM + DEVICE)
    gaps = {k: round(v * 1e6, 6) for k, v in p.idle_gaps}
    # busy: 35-75, 150-210, 440-520, 690-710, 860-960
    # gaps (midpoint): 0-35 (17.5), 75-150 (112.5), 210-440 (325),
    # 520-690 (605), 710-860 (785), 960-1000 (980: no program span, the
    # harness's read-back)
    assert gaps == {"filter.case": 35.0, "filter.case.keep": 75.0,
                    "fold.halo": 230.0, "fold.update.stats": 170.0,
                    "collect": 150.0, "readback": 40.0}
    assert p.fold_idle_s == pytest.approx((470.0 - 80.0 - 20.0) * 1e-6)


def test_without_program_spans_gaps_keep_the_harness_names():
    p = reduced(REQUEST + DEVICE)
    assert {k for k, _ in p.idle_gaps} <= set(harness_trace.GAP_ORDER) | {
        "between requests"}
    assert p.device_s_in == {} and p.case_filter_s == []


@pytest.mark.parametrize("reader", program_spans.READERS,
                         ids=lambda f: f.__name__)
def test_each_reader_reads_nothing_where_nothing_is(reader):
    # no program spans and no counters: the program before them
    assert reader(reduced(REQUEST + DEVICE)) is None
    # no device: only the case filter's span has something to read
    on_host = reader(reduced(REQUEST + PROGRAM))
    if reader is program_spans.case_filter_ms:
        assert on_host == pytest.approx(170e-3)
    else:
        assert on_host is None


def test_counters_read_their_difference_over_the_window():
    before = {"host_syncs": 10, "d2h_bytes": 100, "h2d_bytes": 0}
    after = {"host_syncs": 71, "d2h_bytes": 2_000_100, "h2d_bytes": 1_000_000}
    p = reduced(REQUEST + PROGRAM + DEVICE, before, after)
    assert program_spans.host_syncs_per_request(p) == 61
    assert program_spans.program_copy_mb(p) == pytest.approx(3.0)
    # a panel: no filter.case span, so no case_filter_ms
    p = reduced(REQUEST + [s for s in PROGRAM if "case" not in s["name"]]
                + DEVICE, before, after)
    assert program_spans.case_filter_ms(p) is None
    assert set(program_spans.numbers(p)) == {
        "host_syncs_per_request", "program_copy_mb", "ordered_fold_ms",
        "fold_idle_ms"}


def test_the_harness_readers_read_the_same_with_program_spans():
    """The seven accepted per-layer metrics read the same numbers from a
    window with and without the program's spans in it."""
    import json

    recorder = harness_trace.Recorder(lambda: None)
    recorder.spans = [(e["name"][len("pmbench."):], 0,
                       e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                      for e in REQUEST]

    class Req:
        kind, verbs = "cases_containing", ("stats",)

    cfg = json.loads((ROOT / "pmbench" / "configs" / "table6-L1.json")
                     .read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    program = {f.__name__ for f in program_spans.READERS}

    def read(events):
        data = harness_trace.reduce(events, recorder, [Req()], cfg, 7_000,
                                    1_000)
        return {m["name"]: harness.metric_reader(ROOT, m["name"])(data)
                for m in bench["per_layer"] if m["name"] not in program}

    without = read(REQUEST + DEVICE)
    assert len(without) == 7 and all(v is not None for v in without.values())
    assert read(REQUEST + PROGRAM + DEVICE) == without


@pytest.mark.parametrize("counters", [True, False])
def test_the_five_readers_read_what_numbers_gives(counters):
    """Each of ``pmbench/metrics/{the five}.py`` reads, from the reduction
    the harness hands it, the number ``program_spans.numbers`` gives for
    the same window; nothing where the run has no program trace."""
    before = {"host_syncs": 10, "d2h_bytes": 100, "h2d_bytes": 0}
    after = {"host_syncs": 132, "d2h_bytes": 4_000_100, "h2d_bytes": 500}
    events = REQUEST + PROGRAM + DEVICE
    recorder = harness_trace.Recorder(lambda: None)
    prog = program_spans.reduce(events, ["r0", "r1"],
                                *((before, after) if counters else (None,
                                                                    None)))
    data = harness_trace.reduce(events, recorder, ["r0", "r1"], {}, 7_000,
                                1_000, prog)
    want = program_spans.numbers(prog)
    assert len(want) == (5 if counters else 3)
    for fn in program_spans.READERS:
        reader = harness.metric_reader(ROOT, fn.__name__)
        assert reader(data) == want.get(fn.__name__)
        assert reader(dataclasses.replace(data, program=None)) is None


def test_host_seconds_and_count_of_each_program_span():
    p = reduced(REQUEST + PROGRAM + DEVICE)
    assert p.count == {s["name"][len("repro_torch."):]: 1 for s in PROGRAM}
    assert p.host_s["filter.case"] == pytest.approx(170e-6)
    assert p.host_s["kernel.ordered_histogram"] == pytest.approx(20e-6)
    # a span opened outside the window (the warm-up's) is not counted
    early = span("repro_torch.collect", -500.0, 100.0)
    q = reduced([early] + REQUEST + PROGRAM + DEVICE)
    assert q.count == p.count and q.host_s == p.host_s
