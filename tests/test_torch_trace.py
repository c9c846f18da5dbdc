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
  on a card (the counters count on every device); the file path's
  counters stay at nought.

And for the same log kept in an EDF file, the panel and its stitching
members on the streaming engine, with the read-ahead on and off:

* the file path's counters are the sums of the returned ``ScanReport``,
  the decode time is counted on whichever thread decodes, the read-ahead's
  counters count the groups it delivered, and a memo hit reads nothing;
* under a CPU ``torch.profiler`` the ``scan.*`` spans nest as the table in
  ``repro_torch.trace`` says, all on the calling thread.
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
from repro_torch.dataset import engines  # noqa: E402
from repro_torch.query import statecache  # noqa: E402
from repro_torch.storage import edf  # noqa: E402

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


def program_events(path) -> list[dict]:
    """The ``repro_torch.`` spans of an exported chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(trace.PREFIX)]


def traced_spans(path) -> collections.Counter:
    """(span, parent span) of every ``repro_torch.`` span in an exported
    chrome trace; the parent is the innermost span holding it."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(trace.PREFIX):])
             for e in program_events(path)]
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
    # a resident log touches nothing of the file path
    out.update(dict.fromkeys(FILE_COUNTERS, 0))
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


# ---------------------------------------------------------- the file path
FILE_COUNTERS = ("scan_groups_read", "scan_groups_cached",
                 "scan_groups_skipped", "scan_rows_read", "scan_bytes_read",
                 "scan_h2d_bytes", "edf_decode_ns", "scan_ahead_ready",
                 "scan_ahead_waited", "state_cache_hits",
                 "state_cache_misses", "state_cache_evictions", "memo_hits",
                 "memo_misses")
GROUP_ROWS = 256
STITCHED = tuple(v for v in PANEL if mergeable((v,)))
FILE_CASES = [(verbs, prefetch, kind) for verbs in ("panel", "stitched")
              for prefetch in (0, 1) for kind in ("none", "case_band")]
FILE_IDS = [f"{v}-prefetch{p}-{k}" for v, p, k in FILE_CASES]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The module's log as one EDF file of 256-row groups."""
    frame, tables = generate(NC, A, seed=5, device="cpu")
    path = str(tmp_path_factory.mktemp("edf") / "log.edf")
    edf.write(path, frame, tables=tables, row_group_rows=GROUP_ROWS)
    return [path]


@pytest.fixture
def fresh(monkeypatch):
    """An empty result memo and group-state cache."""
    engines.clear_result_cache()
    monkeypatch.setattr(statecache, "_CACHE", None)
    yield
    engines.clear_result_cache()


def ask_files(paths, verbs, prefetch, kind, engine_name="streaming"):
    ds = repro_torch.open(paths, device="cpu")
    pred = FILTERS[kind]
    d = ds if pred is None else ds.filter(pred)
    return d.collect_many(PANEL if verbs == "panel" else STITCHED,
                          engine=engine_name, prefetch=prefetch)


def changed(fn) -> tuple:
    """``fn()`` and the counters' difference over it."""
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("verbs,prefetch,kind", FILE_CASES, ids=FILE_IDS)
def test_file_counters_are_the_scan_reports(paths, fresh, verbs, prefetch,
                                            kind):
    res, got = changed(lambda: ask_files(paths, verbs, prefetch, kind))
    r = res.report
    assert {f: got[f"scan_{f}"] for f in engines.SCAN_FIELDS} == \
        {f: getattr(r, f) for f in engines.SCAN_FIELDS}
    assert r.groups_read + r.groups_cached + r.groups_skipped \
        == r.groups_total
    assert r.groups_read > 0 and got["edf_decode_ns"] > 0
    assert (got["memo_hits"], got["memo_misses"]) == (0, 1)
    # the decoded groups go to the device whole; a band adds ghost chunks
    schema = edf.EDFReader(paths[0]).schema
    row = sum(np.dtype(schema[c]["dtype"]).itemsize for c in r.columns)
    if kind == "none":
        assert got["scan_h2d_bytes"] == r.rows_read * row
    else:
        assert r.groups_skipped > 0
        assert got["scan_h2d_bytes"] > r.rows_read * row
    grouped = verbs == "stitched"
    # the read-ahead delivers every read group of the sequential scan, and
    # none where the scan reads itself (prefetch 0, the grouped path)
    ahead = r.groups_read if prefetch and not grouped else 0
    assert got["scan_ahead_ready"] + got["scan_ahead_waited"] == ahead
    assert (got["state_cache_hits"], got["state_cache_misses"],
            got["state_cache_evictions"]) == \
        (0, r.groups_read if grouped else 0, 0)
    # asked again: the memo answers and nothing is read
    _, again = changed(lambda: ask_files(paths, verbs, prefetch, kind))
    assert {k: again[k] for k in FILE_COUNTERS} == \
        dict(dict.fromkeys(FILE_COUNTERS, 0), memo_hits=1)
    if grouped:     # the memo cleared, every read group from the cache
        engines.clear_result_cache()
        res2, third = changed(lambda: ask_files(paths, verbs, prefetch, kind))
        assert res2.report.groups_cached == r.groups_read
        assert (third["scan_groups_cached"], third["state_cache_hits"],
                third["scan_groups_read"], third["edf_decode_ns"]) == \
            (r.groups_read, r.groups_read, 0, 0)


def expected_scan_spans(verbs, prefetch, kind) -> set:
    """(span, parent span) of a streaming collect's ``scan*`` spans."""
    pairs = {("scan", "collect"), ("scan.plan", "scan"), ("scan.h2d", "scan")}
    if verbs == "stitched":
        pairs |= {("scan.read", "scan"), ("scan.merge", "scan")}
    else:
        pairs.add(("scan.wait", "scan") if prefetch else ("scan.read", "scan"))
    if kind == "case_band":
        pairs |= {("scan.ghost", "scan"), ("scan.h2d", "scan.ghost")}
    return pairs


@pytest.mark.parametrize("verbs,prefetch,kind", FILE_CASES, ids=FILE_IDS)
def test_file_path_spans_nest_as_the_table_says(paths, fresh, tmp_path, verbs,
                                                prefetch, kind):
    _, prof = profiled(lambda: ask_files(paths, verbs, prefetch, kind))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = traced_spans(path)
    assert {p for p in spans if p[0].startswith("scan")} == \
        expected_scan_spans(verbs, prefetch, kind)
    # the plan, then its compile; one copy a read group outside a ghost
    res = ask_files(paths, verbs, prefetch, kind)
    assert spans[("scan.plan", "scan")] == 2
    assert spans[("scan.h2d", "scan")] == res.report.groups_read
    # the verbs fold inside the scan, as they fold inside ``fold`` in memory
    assert spans[("fold.update.dfg", "scan")] > 0
    assert ("filter", "collect") not in spans
    # every span on the calling thread; the read-ahead opens none
    assert len({e["tid"] for e in program_events(path)}) == 1


def test_autos_estimate_is_a_scan_plan_span(paths, fresh, tmp_path):
    res, prof = profiled(lambda: ask_files(paths, "panel", 1, "case_band",
                                           "auto"))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = traced_spans(path)
    assert spans[("scan.plan", "collect")] == 1
    # the tiny log goes eager: filter and fold as in memory, no scan
    assert res.engine == "eager" and ("filter", "collect") in spans
    assert not any(p[0] == "scan" for p in spans)


def test_file_counters_lose_no_update_across_threads(paths, fresh,
                                                     monkeypatch):
    """More threads than cores at a short switch interval: the counters
    the read-ahead thread and concurrent collects update keep every add
    (the decode clock faked to advance 1 ns a read on each thread)."""
    import sys
    import threading

    from repro_torch.query import exec as qexec

    tick = threading.local()

    def clock():
        tick.n = getattr(tick, "n", 0) + 1
        return tick.n

    monkeypatch.setattr(edf.time, "perf_counter_ns", clock)
    reader = edf.EDFReader(paths[0])
    cols, valid = reader.read_group_numpy(0)
    nbytes = sum(a.nbytes for a in cols.values())
    cache = statecache.StateCache(0)
    report = type("R", (), dict.fromkeys(engines.SCAN_FIELDS, 1))
    threads, rounds = 16, 200
    before = trace.counters()

    def work():
        for _ in range(rounds):
            reader.read_group_numpy(0)
            qexec._h2d(cols, valid, "cpu")
            cache.get(("no", "such", "key"))
            engines._count_scan(report)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    after = trace.counters()
    got = {k: after[k] - before[k] for k in after}
    n = threads * rounds
    assert got["edf_decode_ns"] == n
    assert got["scan_h2d_bytes"] == n * nbytes
    assert got["state_cache_misses"] == n
    assert all(got[f"scan_{f}"] == n for f in engines.SCAN_FIELDS)
