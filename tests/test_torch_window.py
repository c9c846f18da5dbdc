"""PyTorch port, sliding windows (``Dataset.window``), incremental
collects and the caches behind them, held on the CPU against the JAX
package's ``repro`` over the same EDF files (written by the JAX package's
``edf.write``, int32 ids).

Mirrors the JAX package's ``tests/test_window.py``: every window's result
equals JAX's window bitwise (centrality ``flow`` within 1e-6) and mining
its rows from scratch; windows by row groups re-merge cached group states
(a second sweep folds nothing); windows by time equal the same filter
collected directly; ``drift`` and ``conformance`` per window equal JAX's;
appending a file re-decodes only the fresh groups; the result memo is
zero-read until a file changes; ``explain()`` prints the state-cache
accounting.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import random_log, sorted_frame  # noqa: E402
from torch_scan_helpers import scan_reports_equal as _reports_equal  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.dataset import engines as jengines  # noqa: E402
from repro.query.statecache import state_cache as jcache  # noqa: E402
from repro.storage import edf as jedf  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.eventframe import TIMESTAMP  # noqa: E402
from repro_torch.dataset import engines as tengines  # noqa: E402
from repro_torch.dataset.window import _unit_chunks  # noqa: E402
from repro_torch.query.statecache import state_cache as tcache  # noqa: E402
from repro_torch.storage.edf import EDFReader  # noqa: E402

VERBS = ("dfg", "variants", "case_sizes", "case_durations",
         "activity_counts", "eventually_follows", "alpha", "heuristics",
         "discovery", "stats", "sojourn_times", "performance_dfg", "graph",
         "reachability", "bottleneck_paths", "node_centrality")
N_ACTS, N_CASES = 6, 50
FLOW_ATOL = 1e-6


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, path="result"):
    """Bitwise; fingerprints as uint32; centrality ``flow`` within
    ``FLOW_ATOL`` of JAX (bitwise against the port itself)."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name),
                  f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (int, float, str, frozenset)):
        assert got == want, path
    else:
        g, w = _host(got), _host(want)
        if w.dtype == np.uint32 and g.dtype == np.int64:
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                           w.dtype)
        if path.endswith(".flow") and not isinstance(want, torch.Tensor):
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOW_ATOL,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _fresh():
    tcache().clear()
    jcache().clear()
    tengines.clear_result_cache()
    jengines.clear_result_cache()


def _jslice(frame, a, b):
    return type(frame)({k: v[a:b] for k, v in frame.columns.items()},
                       {k: v[a:b] for k, v in frame.valid.items()},
                       frame.rows_valid()[a:b])


@pytest.fixture(scope="module")
def twofiles(tmp_path_factory):
    """Two EDF files with tiny row groups and a case cut mid-file, written
    by the JAX package (int32 ids)."""
    rng = np.random.default_rng(3)
    frame, tables = sorted_frame(
        random_log(rng, n_cases=N_CASES, n_acts=N_ACTS, max_len=9))
    tmp = tmp_path_factory.mktemp("twindow")
    p1, p2 = str(tmp / "a.edf"), str(tmp / "b.edf")
    cut = frame.nrows // 2
    jedf.write(p1, _jslice(frame, 0, cut), tables, version=3,
               row_group_rows=19)
    jedf.write(p2, _jslice(frame, cut, frame.nrows), tables, version=3,
               row_group_rows=19)
    return frame, [p1, p2]


def _open(paths):
    return repro_torch.open(paths, num_activities=N_ACTS, num_cases=N_CASES,
                            device="cpu")


def _jopen(paths):
    return repro.open(paths, num_activities=N_ACTS, num_cases=N_CASES)


# ------------------------------------------------------------- by groups
@pytest.mark.parametrize("verb", VERBS)
def test_group_windows_match_jax_and_scratch(twofiles, verb):
    """Every verb — mergeable or not — windowed by row groups equals JAX's
    windows and a sequential scratch fold of exactly those units."""
    _, paths = twofiles
    _fresh()
    w = _open(paths).window(by="groups", size=3, step=2)
    jw = _jopen(paths).window(by="groups", size=3, step=2)
    assert w.bounds() == jw.bounds() and len(w.bounds()) >= 3
    got, want = w.collect(verb), jw.collect(verb)
    assert got.bounds == want.bounds and got.by == "groups"
    _same(got.results, want.results, f"windows/{verb}")
    _reports_equal(got.report, want.report)
    spec = tengine.kernel_spec(verb)
    kern = spec.make(tengine.Dims(N_ACTS, N_CASES))
    units, _ = w._units(spec.columns)
    for (lo, hi), res in zip(got.bounds, got.results):
        state, carry = kern.init("cpu")
        for ch in _unit_chunks(units[lo:hi], "cpu"):
            if ch.nrows:
                state, carry = kern.update(state, carry, ch)
        _same(res, kern.finalize(state, carry), f"{verb} scratch {lo}:{hi}")


def test_group_windows_reuse_cached_states(twofiles):
    """A slide re-merges cached states: after the first windowed collect,
    the next one over the same dataset decodes nothing — as in JAX."""
    _, paths = twofiles
    _fresh()
    r1 = _open(paths).window(by="groups", size=3, step=2).collect("dfg")
    jr1 = _jopen(paths).window(by="groups", size=3, step=2).collect("dfg")
    assert r1.report.groups_folded > 0
    _reports_equal(r1.report, jr1.report)
    r2 = _open(paths).window(by="groups", size=4, step=3).collect("dfg")
    jr2 = _jopen(paths).window(by="groups", size=4, step=3).collect("dfg")
    assert r2.report.groups_read == 0
    assert r2.report.groups_cached == r1.report.groups_folded
    _reports_equal(r2.report, jr2.report)
    _same(r2.results, jr2.results, "second sweep")


def test_windowed_collect_many_matches_jax(twofiles):
    _, paths = twofiles
    _fresh()
    w = _open(paths).window(by="groups", size=2, step=2)
    cm = w.collect_many(["dfg", "case_sizes"])
    jcm = _jopen(paths).window(by="groups", size=2,
                               step=2).collect_many(["dfg", "case_sizes"])
    assert cm.bounds == jcm.bounds
    _same(cm.results, jcm.results, "windowed collect_many")
    singles = {v: w.collect(v) for v in ("dfg", "case_sizes")}
    for i in range(len(cm.bounds)):
        for v in ("dfg", "case_sizes"):
            _same(cm.results[i][v], singles[v].results[i], f"{v}[{i}]")


# --------------------------------------------------------------- by time
@pytest.mark.parametrize("verb", ["dfg", "stats", "variants"])
def test_time_windows_match_jax_and_filter_collect(twofiles, verb):
    """Time windows == JAX's time windows == filter(between) + collect,
    bitwise, for mergeable and order-sensitive verbs."""
    _, paths = twofiles
    _fresh()
    ds = _open(paths)
    wt = ds.window(by="time", size=30.0, step=15.0)
    jwt = _jopen(paths).window(by="time", size=30.0, step=15.0)
    got, want = wt.collect(verb), jwt.collect(verb)
    assert got.bounds == want.bounds and len(got.bounds) >= 3
    _same(got.results, want.results, f"time/{verb}")
    _reports_equal(got.report, want.report)
    for (tlo, thi), res in zip(got.bounds, got.results):
        ref = ds.filter(repro_torch.col(TIMESTAMP).between(tlo, thi)).collect(
            verb, engine="eager").result
        _same(res, ref, f"{verb} {tlo}..{thi}")
    if verb == "dfg":
        assert wt.collect("dfg").report.groups_cached > 0


def test_drift_and_conformance_match_jax(twofiles):
    _, paths = twofiles
    _fresh()
    ds, jds = _open(paths), _jopen(paths)
    wt = ds.window(by="time", size=30.0, step=15.0)
    jwt = jds.window(by="time", size=30.0, step=15.0)
    d = wt.drift()
    assert d == jwt.drift() and d[0] == 1.0
    assert all(0.0 <= x <= 1.0 for x in d)
    assert wt.drift(reference=ds.dfg()) == jwt.drift(reference=jds.dfg())
    assert wt.drift(min_count=2) == jwt.drift(min_count=2)
    for model, jmodel in ((ds.alpha(), jds.alpha()),
                          (ds.heuristics(), jds.heuristics())):
        assert wt.conformance(model) == jwt.conformance(jmodel)
    allowed = np.ones((N_ACTS, N_ACTS), bool)
    assert wt.conformance(allowed) == jwt.conformance(allowed)


# ----------------------------------------------------------- incremental
def test_streaming_report_folds_then_caches(twofiles):
    _, paths = twofiles
    ds = _open(paths)
    _fresh()
    rep1 = ds.collect("dfg", engine="streaming").report
    assert rep1.groups_folded == rep1.groups_read > 0
    assert rep1.groups_cached == 0
    tengines.clear_result_cache()       # keep the state cache warm
    rep2 = ds.collect("dfg", engine="streaming").report
    assert rep2.groups_read == 0 and rep2.groups_folded == 0
    assert rep2.groups_cached == rep1.groups_folded
    assert rep2.bytes_read == 0


@pytest.mark.parametrize("verb", [v for v in VERBS if v not in
                                  ("stats", "sojourn_times",
                                   "performance_dfg")])
def test_incremental_append_decodes_only_fresh_groups(twofiles, verb):
    """After adding a file, collect re-decodes only its groups; the result
    stays bitwise the scratch mine (and JAX's within ``flow``'s 1e-6)."""
    _, paths = twofiles
    _fresh()
    r1 = _open(paths[:1]).collect(verb, engine="streaming")
    old = r1.report.groups_folded
    assert old == r1.report.groups_read > 0
    tengines.clear_result_cache()
    r2 = _open(paths).collect(verb, engine="streaming")
    assert r2.report.groups_cached == old
    assert r2.report.groups_read == r2.report.groups_total - old > 0
    _fresh()
    _same(r2.result, _open(paths).collect(verb, engine="eager").result, verb)
    _same(r2.result, _jopen(paths).collect(verb, engine="eager").result,
          f"{verb} vs JAX")


def test_result_memo_zero_reads_until_touch(twofiles, monkeypatch):
    _, paths = twofiles
    ds = _open(paths)
    _fresh()
    calls = {"n": 0}
    orig = EDFReader.read_group_numpy

    def counting(self, *a, **k):
        calls["n"] += 1
        return orig(self, *a, **k)

    monkeypatch.setattr(EDFReader, "read_group_numpy", counting)
    a = ds.collect("dfg", engine="streaming")
    assert calls["n"] > 0
    before = calls["n"]
    b = ds.collect("dfg", engine="streaming")
    assert b is a and calls["n"] == before
    os.utime(paths[0])                    # st_mtime_ns changes
    c = ds.collect("dfg", engine="streaming")
    assert c is not a
    _same(c.result, a.result, "recollect")


def test_memo_disabled_by_env(twofiles, monkeypatch):
    _, paths = twofiles
    ds = _open(paths)
    _fresh()
    monkeypatch.setenv(tengines.RESULT_CACHE_ENV, "0")
    a = ds.collect("dfg", engine="streaming")
    b = ds.collect("dfg", engine="streaming")
    assert b is not a
    _same(b.result, a.result, "memo off")


def test_explain_prints_state_cache_accounting(twofiles):
    _, paths = twofiles
    ds = _open(paths)
    _fresh()
    assert "state-cache" in ds.explain("dfg")
    probe = tengines.cache_probe(ds, "dfg")
    assert probe == jengines.cache_probe(_jopen(paths), "dfg")
    assert probe["cached"] == 0 and probe["fresh"] == probe["units"] > 0
    ds.collect("dfg", engine="streaming")
    warm = tengines.cache_probe(ds, "dfg")
    assert warm["cached"] == probe["units"] and warm["fresh"] == 0
    assert "0 freshly decoded" in ds.explain("dfg")


def test_window_argument_validation(twofiles):
    frame, paths = twofiles
    ds = _open(paths)
    for kw in ({"by": "cases", "size": 2}, {"by": "groups", "size": 0},
               {"by": "groups", "size": 2, "step": -1},
               {"by": "groups", "size": 2.5}):
        with pytest.raises(ValueError):
            ds.window(**kw)
    with pytest.raises(ValueError):
        ds.filter(repro_torch.cases_containing(2)).window(by="groups",
                                                          size=2)
    mem = repro_torch.open(repro_torch.dataset.engines.to_frame(ds),
                           num_activities=N_ACTS, num_cases=N_CASES,
                           device="cpu")
    with pytest.raises(ValueError):
        mem.window(by="groups", size=2)
    # an in-memory frame windows by time, like the files
    got = mem.window(by="time", size=30.0, step=15.0).collect(
        "dfg", engine="eager")
    want = ds.window(by="time", size=30.0, step=15.0).collect(
        "dfg", engine="eager")
    assert got.bounds == want.bounds
    _same(got.results, want.results, "in-memory time windows")
