"""PyTorch port, the collect path's spans and counters (``repro_torch.trace``)
on the CPU.

For one request of each (filter kind, verb) pair of a dashboard's widgets
and of the fused eight-verb panel, over a small in-memory log:

* under a CPU ``torch.profiler`` the exported trace holds the spans of
  ``repro_torch.trace``'s table, each under the parent the table gives
  (the ``kernel.*`` spans wrap CUDA launches, so a CPU run has none);
* with no profiler running no span enters ``record_function``;
* the answers are bitwise the same with the profiler on and off;
* the counters' difference over the request is pinned: the host syncs and
  the bytes of every copy between host and device that the request makes
  on a card (the counters count on every device).
"""
import collections
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import cases_containing, col, trace  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.eventframe import CASE  # noqa: E402
from repro_torch.data.synthetic import generate  # noqa: E402

NC = 300            # cases in the log
A = 26              # activities

FILTERS = {
    "none": None,
    "cases_containing": cases_containing(3),
    "attr_lt": col("attr0") < 500,
    "case_band": col(CASE).between(20, 120),
}
WIDGETS = ("dfg", "variants", "performance_dfg", "activity_counts",
           "case_durations", "heuristics", "stats")
PANEL = ("dfg", "activity_counts", "case_sizes", "case_durations",
         "variants", "performance_dfg", "eventually_follows", "stats")
PAIRS = [(kind, (verb,)) for kind in FILTERS for verb in WIDGETS] + \
        [(kind, PANEL) for kind in FILTERS]
IDS = [f"{kind}-{'+'.join(verbs) if len(verbs) == 1 else 'panel'}"
       for kind, verbs in PAIRS]

# the members of the stats verb's own compose
STATS = ("activity_counts", "case_sizes", "case_durations", "sojourn_times")


@pytest.fixture(scope="module")
def ds():
    frame, tables = generate(NC, A, seed=5, device="cpu")
    return repro_torch.open(frame, tables=tables, device="cpu")


def ask(ds, kind, verbs):
    pred = FILTERS[kind]
    d = ds if pred is None else ds.filter(pred)
    if len(verbs) > 1:
        return d.collect_many(verbs).results
    return d.collect(verbs[0]).result


# ------------------------------------------------------------------ spans
def expected_spans(kind, verbs) -> collections.Counter:
    """(span, parent span) of one request, as the table in
    ``repro_torch.trace`` places them."""
    pairs = [("collect", None), ("facade.dims", "collect"),
             ("filter", "collect"), ("fold", "collect"),
             ("collect.deliver", "collect")]
    if kind == "cases_containing":
        pairs += [("filter.case", "filter"),
                  ("filter.case.phase1", "filter.case"),
                  ("filter.case.keep", "filter.case")]
    elif kind != "none":
        pairs.append(("filter.rows", "filter"))
    if mergeable(verbs):
        pairs.append(("fold.halo", "fold"))
    for verb in verbs:
        for step in ("init", "update", "finalize"):
            pairs.append((f"fold.{step}.{verb}", "fold"))
            if verb == "stats":
                pairs += [(f"fold.{step}.{m}", f"fold.{step}.stats")
                          for m in STATS]
    return collections.Counter(pairs)


def mergeable(verbs) -> bool:
    dims = engine.Dims(A, NC)
    return all(engine.mergeable(engine.kernel_spec(v).make(dims))
               for v in verbs)


def traced_spans(path) -> collections.Counter:
    """(span, parent span) of every ``repro_torch.`` span in an exported
    chrome trace; the parent is the innermost span holding it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(trace.PREFIX):])
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(trace.PREFIX)]
    out = collections.Counter()
    for i, (s, e, name) in enumerate(spans):
        holders = [(h1 - h0, n) for j, (h0, h1, n) in enumerate(spans)
                   if j != i and h0 <= s and e <= h1]
        out[(name, min(holders)[1] if holders else None)] += 1
    return out


def profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("kind,verbs", PAIRS, ids=IDS)
def test_spans_nest_as_the_table_says(ds, tmp_path, kind, verbs):
    ask(ds, kind, verbs)
    _, prof = profiled(lambda: ask(ds, kind, verbs))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert traced_spans(path) == expected_spans(kind, verbs)


@pytest.mark.parametrize("kind,verbs", PAIRS, ids=IDS)
def test_no_span_enters_record_function_without_a_profiler(
        ds, monkeypatch, kind, verbs):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    ask(ds, kind, verbs)
    assert entered == []
    assert trace.span("collect") is trace.span("fold")


def leaves(x) -> list:
    """A result's arrays and values in a fixed order; tensors as
    (dtype, shape, bytes), so equal leaves are bitwise equal."""
    if isinstance(x, torch.Tensor):
        return [(str(x.dtype), tuple(x.shape), x.numpy().tobytes())]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [v for f in dataclasses.fields(x)
                for v in leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in [k] + leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in leaves(y)]
    if isinstance(x, (set, frozenset)):
        return [tuple(sorted(x))]
    return [x]


@pytest.mark.parametrize("kind,verbs", PAIRS, ids=IDS)
def test_answers_bitwise_equal_with_the_profiler_on_and_off(
        ds, kind, verbs):
    off = ask(ds, kind, verbs)
    on, _ = profiled(lambda: ask(ds, kind, verbs))
    assert leaves(on) == leaves(off)


# --------------------------------------------------------------- counters
CARRY = (5, 18)                 # init_row_carry: case, act, ts, rv, exists
SEG = (6, 22)                   # ... and the segment id (int32)
L2 = (4, 14)                    # discovery's two-back row
INIT_H2D = {                    # (syncs, bytes) of each verb's init
    "dfg": CARRY, "activity_counts": CARRY, "performance_dfg": CARRY,
    "eventually_follows": CARRY, "sojourn_times": CARRY,
    "case_sizes": SEG, "case_durations": SEG, "variants": SEG,
    "heuristics": (CARRY[0] + L2[0], CARRY[1] + L2[1]),
}


def init_h2d(verb) -> tuple:
    if verb == "stats":
        return tuple(map(sum, zip(*(INIT_H2D[m] for m in STATS))))
    return INIT_H2D[verb]


def expected_counts(ds, kind, verbs) -> dict:
    """What one request copies between host and device on a card."""
    syncs = d2h = h2d = 0
    # the facade's Dims: num_cases, an int64 count (the activity table
    # gives num_activities)
    syncs, d2h = syncs + 1, d2h + 8
    if kind == "cases_containing":
        # num_cases again, the phase-one kernel's carry, its (num_cases,)
        # bool keep mask down and up again
        syncs += 1 + SEG[0] + 2
        d2h += 8 + NC
        h2d += SEG[1] + NC
    for verb in verbs:
        s, b = init_h2d(verb)
        syncs, h2d = syncs + s, h2d + b
    if mergeable(verbs):
        # the halo: two int64 scalars, then (case, act, rv) of the first
        # p rows and of the last row, p covering the first case's run
        case = ds.frame[CASE]
        p = max(2, int((case == case[0]).sum()))
        syncs, d2h = syncs + 2, d2h + 16 + 8 * (3 * p + 3)
    if "heuristics" in verbs:
        # three float32 thresholds up; the start and end activity sets
        # (two (A,) int32 vectors) down
        syncs, h2d = syncs + 3 + 2, h2d + 3 * 4
        d2h += 2 * A * 4
    out = {"host_syncs": syncs, "d2h_bytes": d2h, "h2d_bytes": h2d}
    # a CPU answer is already in host memory: the delivery copies nothing
    out.update(answer_tensors=0, answer_d2h_bytes=0, answer_pinned_new=0)
    # the CPU takes the kernels' plain versions: nothing launches
    out.update({k: 0 for k in trace.counters() if k.startswith("launches.")})
    return out


@pytest.mark.parametrize("kind,verbs", PAIRS, ids=IDS)
def test_counters_of_one_request_are_pinned(ds, kind, verbs):
    ask(ds, kind, verbs)
    before = trace.counters()
    ask(ds, kind, verbs)
    after = trace.counters()
    got = {k: after[k] - before[k] for k in after}
    assert got == expected_counts(ds, kind, verbs)


def test_capacities_without_a_table_read_two_scalars():
    frame, _ = generate(NC, A, seed=5, device="cpu")
    ds = repro_torch.open(frame, device="cpu")
    before = trace.counters()
    assert (ds.num_activities, ds.num_cases) == (
        int(frame["concept:name"].max()) + 1, NC)
    after = trace.counters()
    # the activities' int32 max and the cases' int64 count
    assert (after["host_syncs"] - before["host_syncs"],
            after["d2h_bytes"] - before["d2h_bytes"]) == (2, 4 + 8)


def test_helpers_do_what_their_call_sites_did():
    t = torch.arange(6, dtype=torch.int32)
    before = trace.counters()
    assert trace.host_read(t, torch.Tensor.tolist) == list(range(6))
    assert trace.host_read(t.sum(), int) == 15
    assert np.array_equal(trace.host_read(t).numpy(), np.arange(6))
    keep = np.array([True, False, True])
    up = trace.to_device(keep, "cpu")
    assert up.dtype == torch.bool and up.tolist() == [True, False, True]
    assert trace.to_device(-1, "cpu", torch.int32).dtype == torch.int32
    after = trace.counters()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"host_syncs": 5, "d2h_bytes": 24 + 8 + 24, "h2d_bytes": 3 + 4}
