"""PyTorch port, the ``Dataset`` facade (``repro_torch.open``) and its
engines, held on the CPU against the JAX package's ``repro.open`` over the
same EDF files (written by the JAX package's ``edf.write``, int32 ids).

For every registered verb, under ``engine="eager"`` and ``"streaming"``,
filtered and not: the port's result equals JAX's bitwise (fingerprints as
uint32; centrality ``flow`` within 1e-6), equals the port's own eager
filter chain, and its ``ScanReport`` equals JAX's field by field.  Plus
``collect_many`` / ``profile``, ``explain()``, the calibrated ``auto``
dispatch, the result memo keyed by device, ``sharded`` running with JAX's
error texts, and the JAX package's own facade cases
(``tests/test_dataset.py``, ``tests/test_fusion.py``) minus the sharded
ones (``tests/test_torch_distributed.py`` holds those).
"""
import dataclasses
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_scan_helpers import scan_reports_equal as _reports_equal  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.dataset import engines as jengines  # noqa: E402
from repro.storage import edf as jedf  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import filtering as tfilt  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402
from repro_torch.dataset import engines as tengines  # noqa: E402
from repro_torch.query import exec as texec  # noqa: E402
from repro_torch.storage import edf as tedf  # noqa: E402

A = 7          # activities in the shared fixture
NC = 240       # cases in the shared fixture
FLOW_ATOL = 1e-6
VERBS = sorted(tengine.kernel_specs())
REPORT_VERBS = ("dfg", "variants", "stats", "eventually_follows")


def _split_paths(frame, tables, tmpdir, case_cuts, versions=None,
                 row_group_rows=97):
    """Write the (case,time)-sorted JAX frame as consecutive case-range
    files with the JAX package's writer."""
    case = np.asarray(frame[CASE])
    bounds = [0] + [int(np.searchsorted(case, c)) for c in case_cuts] \
        + [frame.nrows]
    paths = []
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        version = versions[i] if versions else 3
        kw = {} if version == 1 else {"row_group_rows": row_group_rows}
        p = str(tmpdir / f"part{i}_v{version}.edf")
        jedf.write(p, frame.take(jnp.arange(lo, hi)), tables,
                   version=version, **kw)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def logset(tmp_path_factory):
    """Three v3 files partitioning one sorted log, and the port's whole
    frame of it on the CPU."""
    frame, tables = jsyn.generate(num_cases=NC, num_activities=A, seed=3)
    d = tmp_path_factory.mktemp("tds")
    paths = _split_paths(frame, tables, d, case_cuts=[80, 160])
    whole = repro_torch.open(paths, device="cpu").to_frame()
    return paths, whole, tables


@pytest.fixture(autouse=True)
def _fresh_caches():
    from repro.query.statecache import state_cache as jcache
    from repro_torch.query.statecache import state_cache as tcache

    jengines.clear_result_cache()
    tengines.clear_result_cache()
    jcache().clear()
    tcache().clear()
    yield


def _open(src, **kw):
    return repro_torch.open(src, device="cpu", **kw)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, path="result"):
    """A port result against a JAX (or port) result: bitwise, fingerprints
    as uint32, centrality ``flow`` within ``FLOW_ATOL`` of JAX."""
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
            assert g.min(initial=0) >= 0 and g.max(initial=0) < 2**32, path
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (path, g.dtype, w.dtype, g.shape, w.shape)
        if path.endswith(".flow") and not isinstance(want, torch.Tensor):
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOW_ATOL,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _filtered(pkg, ds, name):
    """The same filter chain in either package (``pkg`` is ``repro`` or
    ``repro_torch``)."""
    col = pkg.col
    if name == "none":
        return ds
    if name == "band":
        return ds.filter((col(CASE) >= 50) & (col(CASE) <= 170))
    if name == "isin":
        return ds.filter(col(ACTIVITY).isin([2, 5]))
    if name == "chain":
        return ds.filter(col(ACTIVITY).isin([1, 2, 4])).filter(
            pkg.cases_containing(3))
    raise KeyError(name)


def _ref_frame(whole, name):
    """The port's eager reference chain each filter must match bitwise."""
    c, a = whole[CASE], whole[ACTIVITY]
    if name == "none":
        return whole
    if name == "band":
        return tops.proj(whole, (c >= 50) & (c <= 170))
    if name == "isin":
        return tops.proj(whole, tfilt.isin_mask(a, np.array([2, 5])))
    if name == "chain":
        f = tops.proj(whole, tfilt.isin_mask(a, np.array([1, 2, 4])))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return tfilt.filter_cases_containing(f, 3, NC)
    raise KeyError(name)


# ------------------------------------------------------- every verb vs JAX
@pytest.mark.parametrize("engine", ["eager", "streaming"])
@pytest.mark.parametrize("pred", ["none", "band", "isin", "chain"])
def test_every_verb_matches_jax_and_the_eager_chain(logset, pred, engine):
    """The acceptance bar, held against JAX: ``D.filter(F).K()`` equals
    JAX's ``repro.open(files).filter(F).K()`` and the port's
    ``K(filter(concat(files)))``, for every registered verb; the
    streaming ``ScanReport`` equals JAX's field by field.  JAX's streaming
    engine (bitwise its eager one, by its own tests) runs the verbs of
    ``REPORT_VERBS`` — a grouped fold, the ghost-sketch one, the
    sequential scan, the (N, 26) scan — whose reports are compared; the
    rest hold against its eager engine (JAX compiles each verb per chunk
    shape)."""
    paths, whole, _ = logset
    tds = _filtered(repro_torch, _open(paths), pred)
    jds = _filtered(repro, repro.open(paths), pred)
    ref_frame = _ref_frame(whole, pred)
    dims = tengine.Dims(A, NC)
    for verb in VERBS:
        got = tds.collect(verb, engine=engine)
        jax_engine = engine if verb in REPORT_VERBS else "eager"
        want = jds.collect(verb, engine=jax_engine)
        assert got.engine == engine and want.engine == jax_engine
        _same(got.result, want.result, f"{pred}/{verb}/{engine}")
        if jax_engine == engine:
            _reports_equal(got.report, want.report)
        ref = tengine.run_single(tengine.kernel_spec(verb).make(dims),
                                 ref_frame)
        _same(got.result, ref, f"{pred}/{verb}/{engine} vs eager chain")


def test_named_verbs_match_jax(logset):
    """The sugar verbs: ``dfg``, ``stats``, ``variants`` (counts dict),
    ``alpha``, ``heuristics``, ``graph`` (labels attached),
    ``reachability``, ``bottlenecks``, ``centrality``, ``conformance``."""
    paths, _, _ = logset
    tds, jds = _open(paths), repro.open(paths)
    for eng in ("eager", "streaming"):
        _same(tds.dfg(engine=eng), jds.dfg(engine=eng), "dfg")
        _same(tds.stats(engine=eng), jds.stats(engine=eng), "stats")
        assert tds.variants(engine=eng) == jds.variants(engine=eng)
        _same(tds.alpha(engine=eng, min_count=2),
              jds.alpha(engine=eng, min_count=2), "alpha")
        _same(tds.heuristics(engine=eng), jds.heuristics(engine=eng),
              "heuristics")
        g, jg = tds.graph(engine=eng), jds.graph(engine=eng)
        _same(g, jg, "graph")
        assert g.node_labels() == jg.node_labels()
        _same(tds.reachability(3, engine=eng),
              jds.reachability(3, engine=eng), "reachability k=3")
        _same(tds.bottlenecks(engine=eng), jds.bottlenecks(engine=eng),
              "bottlenecks")
        _same(tds.centrality(engine=eng), jds.centrality(engine=eng),
              "centrality")
    for tm, jm in ((tds.alpha(), jds.alpha()),
                   (tds.heuristics(), jds.heuristics())):
        _same(tds.conformance(tm), jds.conformance(jm), "conformance")
    allowed = np.eye(A, dtype=bool) | np.eye(A, k=1, dtype=bool)
    _same(tds.conformance(allowed), jds.conformance(allowed),
          "footprint conformance")


def test_multi_file_plan_prunes_cold_groups(logset):
    """A selective multi-log query skips whole row groups across the file
    set — entire files outside the case band — like JAX's, bit for bit."""
    paths, whole, _ = logset
    band = (CASE, 90, 110)
    tds = _open(paths).filter((repro_torch.col(CASE) >= band[1])
                              & (repro_torch.col(CASE) <= band[2]))
    jds = repro.open(paths).filter((repro.col(CASE) >= band[1])
                                   & (repro.col(CASE) <= band[2]))
    r = tds.collect("dfg", engine="streaming")
    assert r.report.groups_skipped > 0
    assert r.report.bytes_read < 0.5 * r.report.bytes_total
    assert len(r.report.per_file) == 3
    assert r.report.per_file[0].groups_read == 0
    assert r.report.per_file[2].groups_read == 0
    jr = jds.collect("dfg", engine="streaming")
    _reports_equal(r.report, jr.report)
    _same(r.result, jr.result, "pruned multi-file")


def test_union_matches_list_open_and_is_immutable(logset):
    paths, _, _ = logset
    u = _open(paths[0]).union(_open(paths[1])).union(_open(paths[2]))
    assert u.paths == tuple(paths)
    base = _open(paths)
    flt = base.filter(repro_torch.col(CASE) <= 100)
    assert base.steps == ()            # immutable: filter returned a copy
    _same(u.filter(repro_torch.col(CASE) <= 100).dfg(engine="streaming"),
          flt.dfg(engine="streaming"), "union == list open")
    with pytest.raises(ValueError):
        flt.union(base)                # differing filter state
    with pytest.raises(TypeError):
        base.filter("not a predicate")
    # capacity hints never leak across a union
    hinted = _open(paths[0], num_cases=80).union(_open(paths[1]))
    assert hinted.num_cases == 160


def test_shape_accessors_match_jax(logset):
    paths, _, tables = logset
    tds, jds = _open(paths), repro.open(paths)
    assert tds.num_cases == jds.num_cases == NC
    assert tds.num_activities == jds.num_activities == A
    assert tds.tables == jds.tables
    assert tds.schema == jds.schema
    assert tds.file_sizes() == jds.file_sizes()
    assert tds.describe() == jds.describe()
    flt = tds.filter(repro_torch.col(CASE) >= 3).project([CASE, ACTIVITY])
    jflt = jds.filter(repro.col(CASE) >= 3).project([CASE, ACTIVITY])
    assert flt.describe() == jflt.describe()


def test_case_predicates_spanning_files(logset):
    """cases_containing / case_size keep masks are global across files."""
    paths, _, _ = logset
    tds = _open(paths).filter(repro_torch.case_size(3, 7))
    jds = repro.open(paths).filter(repro.case_size(3, 7))
    for eng in ("eager", "streaming"):
        got = tds.collect("stats", engine=eng)
        want = jds.collect("stats", engine=eng)
        _same(got.result, want.result, eng)
        _reports_equal(got.report, want.report)


def test_case_straddling_file_boundary(tmp_path):
    """A case split across two files is still one case: the carry flows
    over the boundary and the segment offsets back up by one."""
    frame, tables = jsyn.generate(num_cases=60, num_activities=5, seed=11)
    case = np.asarray(frame[CASE])
    mid = int(np.searchsorted(case, 30)) + 2   # cut INSIDE case 30
    assert case[mid - 1] == case[mid] == 30
    p0, p1 = str(tmp_path / "a.edf"), str(tmp_path / "b.edf")
    jedf.write(p0, frame.take(jnp.arange(0, mid)), tables, row_group_rows=97)
    jedf.write(p1, frame.take(jnp.arange(mid, frame.nrows)), tables,
               row_group_rows=97)
    tds, jds = _open([p0, p1]), repro.open([p0, p1])
    assert tds.num_cases == 60                  # not 61
    want = jds.collect("stats", engine="eager").result
    for eng in ("eager", "streaming"):
        _same(tds.collect("stats", engine=eng).result, want, eng)
    _same(tds.filter(repro_torch.cases_containing(2)).dfg(engine="streaming"),
          jds.filter(repro.cases_containing(2)).dfg(engine="eager"),
          "contains across boundary")


def test_mixed_version_multi_log(tmp_path):
    """A Dataset over one v1, one v2 and one v3 file mines like JAX's."""
    frame, tables = jsyn.generate(num_cases=90, num_activities=6, seed=7)
    paths = _split_paths(frame, tables, tmp_path, case_cuts=[30, 60],
                         versions=[1, 2, 3])
    tds, jds = _open(paths), repro.open(paths)
    assert tds.num_cases == 90 and tds.num_activities == 6
    tflt = tds.filter(repro_torch.col(ACTIVITY).isin([0, 2, 3]))
    jflt = jds.filter(repro.col(ACTIVITY).isin([0, 2, 3]))
    for verb in ("dfg", "variants"):
        want = jflt.collect(verb, engine="eager").result
        for eng in ("eager", "streaming"):
            _same(tflt.collect(verb, engine=eng).result, want,
                  f"v123/{verb}/{eng}")
    r = tds.filter((repro_torch.col(CASE) >= 61)
                   & (repro_torch.col(CASE) <= 75)).collect(
        "dfg", engine="streaming")
    assert r.report.groups_skipped > 0


# ----------------------------------------------------------------- engines
def test_engines_and_sharded_raises(logset):
    """``ENGINES`` keeps JAX's four names; ``sharded`` runs (equal to the
    eager engine, as JAX's is) and keeps JAX's ``ValueError`` texts for an
    in-memory dataset and a verb with no exact distributed lowering."""
    paths, whole, tables = logset
    assert tengines.ENGINES == jengines.ENGINES
    ds = _open(paths)
    jds = repro.open(paths)
    for got in (ds.collect("dfg", engine="sharded").result,
                ds.collect_many(["dfg"], engine="sharded")["dfg"],
                ds.dfg(engine="sharded", num_shards=2)):
        _same(got, jds.collect("dfg", engine="eager").result, "sharded dfg")
    mem = _open(whole, tables=tables)
    for tcall, jcall in (
            (lambda: mem.collect("dfg", engine="sharded"),
             lambda: repro.open(jedf.read(paths[0])[0], tables=tables)
             .collect("dfg", engine="sharded")),
            (lambda: ds.collect("stats", engine="sharded"),
             lambda: jds.collect("stats", engine="sharded"))):
        with pytest.raises(ValueError) as je:
            jcall()
        with pytest.raises(ValueError, match=re.escape(str(je.value))):
            tcall()
    with pytest.raises(ValueError, match="unknown engine"):
        ds.collect("dfg", engine="warp")


def test_engine_auto_is_cost_based(logset, monkeypatch):
    """auto switches engines as the fitted costs move, as JAX's does."""
    paths, _, tables = logset
    ds = _open(paths)
    monkeypatch.setattr(tengines, "_CALIBRATION",
                        tengines.Calibration(0.0, 1.0, 0.0, 1.2, 0.0, "test"))
    r = ds.collect("dfg")
    assert r.engine == "eager" and r.estimate is not None
    assert r.estimate.selectivity == 1.0
    sel = ds.filter((repro_torch.col(CASE) >= 90)
                    & (repro_torch.col(CASE) <= 110))
    r2 = sel.collect("dfg")
    assert r2.engine == "streaming" and r2.estimate.selectivity < 0.5
    jsel = repro.open(paths).filter((repro.col(CASE) >= 90)
                                    & (repro.col(CASE) <= 110))
    assert dataclasses.asdict(r2.estimate) == dataclasses.asdict(
        jengines.estimate(jsel))
    monkeypatch.setattr(tengines, "_CALIBRATION",
                        tengines.Calibration(0.0, 1e9, 0.0, 1.2, 0.0, "test"))
    assert ds.collect("dfg").engine == "streaming"
    # in-memory datasets always run eagerly
    frame, _ = jsyn.generate(num_cases=30, num_activities=5, seed=1)
    mem = _open(tedf.read(paths[0], device="cpu")[0], tables=tables)
    assert mem.collect("dfg").engine == "eager"


def test_fit_calibration_matches_jax_and_choose_counts_devices(logset,
                                                              monkeypatch):
    """The least-squares fit is JAX's on the same sweep points; ``auto``
    picks ``sharded`` where JAX's does: a spec with a distributed lowering,
    more than one device and at least ``SHARD_ROWS`` surviving rows."""
    sweep = {"sweep": [
        {"bytes_total": 1000, "bytes_read": b, "groups_total": 14,
         "groups_skipped": 14 - g, "us_eager": 500.0 + 0.01 * b,
         "us_streaming": 80.0 + 0.4 * b + 3.0 * g}
        for b, g in ((70, 1), (140, 2), (290, 4), (500, 7), (1000, 14))]}
    got, want = tengines.fit_calibration(sweep), jengines.fit_calibration(
        sweep)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    paths, _, _ = logset
    ds, jds = _open(paths), repro.open(paths)
    rows = tengines.estimate(ds).rows_est
    for verb in ("dfg", "variants", "stats"):
        spec, jspec = tengine.kernel_spec(verb), jengines.spec_for(verb)
        for n_devices, shard_rows in ((8, rows), (8, rows + 1), (1, rows)):
            monkeypatch.setattr(tengines, "SHARD_ROWS", shard_rows)
            monkeypatch.setattr(jengines, "SHARD_ROWS", shard_rows)
            got = tengines.choose(ds, spec, None, n_devices=n_devices)
            assert got == jengines.choose(jds, jspec, None,
                                          n_devices=n_devices)
            assert (got == "sharded") == (verb != "stats" and n_devices > 1
                                          and shard_rows <= rows)
    with pytest.raises(ValueError, match="no usable sweep points"):
        tengines.fit_calibration({"sweep": []})


def test_result_memo_is_keyed_by_device(logset):
    """A memoized CPU result is never served to a CUDA collect: the key
    holds the device type and the lowering it resolves to."""
    paths, _, _ = logset
    cpu = _open(paths)
    first = cpu.collect("dfg", engine="streaming")
    assert cpu.collect("dfg", engine="streaming") is first
    cuda = repro_torch.open(paths)             # the default: the card
    assert cuda.device == "cuda"
    extra = ("collect", "dfg", "streaming", None, None, ())
    k_cpu = tengines._memo_key(cpu, extra)
    k_cuda = tengines._memo_key(cuda, extra)
    assert k_cpu != k_cuda
    assert k_cpu[-2] == ("cpu", "ref") and k_cuda[-2] == ("cuda", "cuda")
    assert tengines._memo_get(k_cpu) is first
    assert tengines._memo_get(k_cuda) is None


def test_in_memory_dataset_matches_files(logset):
    paths, whole, tables = logset
    mem = _open(whole, tables=tables)
    assert mem.num_activities == A and mem.num_cases == NC
    assert mem.frame.device.type == "cpu"
    f = (repro_torch.col(CASE) >= 50) & (repro_torch.col(CASE) <= 170)
    _same(mem.filter(f).dfg(), _open(paths).filter(f).dfg(
        engine="streaming"), "memory == files")
    tf = mem.filter(f).project([CASE, ACTIVITY]).to_frame()
    ref = tops.proj(whole, (whole[CASE] >= 50) & (whole[CASE] <= 170))
    ref = ref.select([CASE, ACTIVITY]).compact()
    np.testing.assert_array_equal(_host(tf[CASE]), _host(ref[CASE]))
    assert set(tf.names) == {CASE, ACTIVITY}
    assert mem.schema == {k: {"dtype": v["dtype"]}
                          for k, v in _open(paths).schema.items()}


def test_frame_union_preserves_masks(logset):
    paths, whole, tables = logset
    half = whole.nrows // 2
    a = whole.take(torch.arange(0, half))
    b = whole.take(torch.arange(half, whole.nrows))
    a = tops.proj(a, a[ACTIVITY] >= 0)       # attach a row_valid mask
    u = _open(a, tables=tables).union(_open(b, tables=tables))
    np.testing.assert_array_equal(_host(u.frame.rows_valid()),
                                  np.ones(whole.nrows, bool))
    _same(u.dfg(), _open(whole, tables=tables).dfg(), "frame union")
    with pytest.raises(ValueError):
        _open(a, tables=tables).union(_open(paths[0]))


def test_to_frame_matches_jax(logset):
    paths, _, _ = logset
    got = _open(paths).filter(repro_torch.col(ACTIVITY) == 2).to_frame()
    want = repro.open(paths).filter(repro.col(ACTIVITY) == 2).to_frame()
    assert set(got.names) == set(want.names)
    for k in want.names:
        np.testing.assert_array_equal(_host(got[k]), np.asarray(want[k]))


def test_deprecation_shims_point_at_the_facade(logset):
    """The old eager entry points still work bitwise, and name the facade
    that now exists."""
    paths, whole, _ = logset
    ds = _open(paths)
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.open"):
        old = tfilt.filter_attr_values(whole, ACTIVITY, [2, 5])
    new = ds.filter(repro_torch.col(ACTIVITY).isin([2, 5])).collect(
        "activity_counts", engine="streaming").result
    ref = tengine.run_single(tengine.kernel_spec("activity_counts").make(
        tengine.Dims(A, NC)), old)
    np.testing.assert_array_equal(_host(new), _host(ref))
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.open"):
        old_c = tfilt.filter_cases_containing(whole, 3, NC)
    _same(ds.filter(repro_torch.cases_containing(3)).dfg(engine="streaming"),
          tengine.run_single(tengine.kernel_spec("dfg").make(
              tengine.Dims(A, NC)), old_c), "contains")
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.open"):
        from repro_torch.query import scan

        scan(paths[0])


def test_lazy_exports_match_jax():
    assert repro_torch.__all__ == repro.__all__
    assert repro_torch.open is repro_torch.dataset.open_dataset
    assert set(dir(repro_torch)) >= set(repro_torch.__all__)
    with pytest.raises(AttributeError):
        repro_torch.nope  # noqa: B018


# ------------------------------------------------------------------ fusion
@pytest.mark.parametrize("engine", ["eager", "streaming"])
def test_collect_many_matches_jax_and_separate_collects(logset, engine):
    """One fused pass == JAX's fused pass == N separate collects."""
    paths, _, _ = logset
    verbs = ("dfg", "stats", "variants", "alpha", "heuristics")
    tds = _open(paths).filter(repro_torch.col(ACTIVITY) != 2)
    jds = repro.open(paths).filter(repro.col(ACTIVITY) != 2)
    res = tds.collect_many(verbs, engine=engine)
    jres = jds.collect_many(verbs, engine=engine)
    assert res.engine == engine and res.verbs == verbs
    _same(res.results, jres.results, f"collect_many/{engine}")
    _reports_equal(res.report, jres.report)
    for verb in verbs:
        _same(res[verb], tds.collect(verb, engine=engine).result, verb)
    vk = {"alpha": {"min_count": 2}}
    _same(tds.collect_many(["dfg", "alpha"], engine=engine,
                           verb_kwargs=vk).results,
          jds.collect_many(["dfg", "alpha"], engine=engine,
                           verb_kwargs=vk).results, "verb_kwargs")
    with pytest.raises(ValueError):
        tds.collect_many(["dfg", "dfg"])


@pytest.mark.parametrize("engine", ["eager", "streaming"])
def test_profile_matches_jax(logset, engine):
    """Every registered verb in one pass, equal to JAX's profile."""
    paths, _, _ = logset
    prof = _open(paths).profile(engine=engine)
    jprof = repro.open(paths).profile(engine=engine)
    assert prof.verbs == jprof.verbs and set(prof.verbs) == set(VERBS)
    _same(prof.results, jprof.results, f"profile/{engine}")
    _reports_equal(prof.report, jprof.report)


def test_collect_many_case_predicate_and_variants_pruning(logset):
    paths, _, _ = logset
    tds = _open(paths).filter(repro_torch.cases_containing(1))
    res = tds.collect_many(["dfg", "stats"], engine="streaming")
    for verb in ("dfg", "stats"):
        _same(res[verb], tds.collect(verb, engine="streaming").result, verb)
    band = _open(paths).filter((repro_torch.col(CASE) >= 20)
                               & (repro_torch.col(CASE) <= 45))
    pruned = band.collect_many(["dfg", "stats"], engine="streaming")
    fused = band.collect_many(["dfg", "stats", "variants"],
                              engine="streaming")
    assert fused.report.groups_skipped == pruned.report.groups_skipped > 0
    _same(fused.results["variants"],
          band.collect("variants", engine="eager").result, "variants")


def test_fused_projection_carries_member_columns(logset):
    paths, _, _ = logset
    ds = _open(paths)
    res = ds.collect_many(["stats", "performance_dfg"], engine="streaming")
    assert TIMESTAMP in res.report.columns
    for verb in ("stats", "performance_dfg"):
        _same(res[verb], ds.collect(verb, engine="streaming").result, verb)
    with pytest.raises(ValueError):
        ds.project([CASE, ACTIVITY]).collect_many(["dfg", "stats"],
                                                  engine="streaming")


# ----------------------------------------------------------------- explain
def _strip(text, *prefixes):
    return "\n".join(line for line in text.splitlines()
                     if not line.strip().startswith(prefixes))


PREFETCH_LINE = re.compile(r"^  prefetch (\d+) group\(s\) ahead$", re.M)


def _fused_explains_equal(got, want):
    """A fused ``explain()`` of the port against JAX's: every line equal
    but the read-ahead window's, which shows the port's own resolved
    ``prefetch_depth()`` (its default is the decode pool's size, JAX's 1)."""
    assert len(PREFETCH_LINE.findall(want)) == 1
    assert PREFETCH_LINE.findall(got) == [str(texec.prefetch_depth())]
    assert PREFETCH_LINE.sub("", got) == PREFETCH_LINE.sub("", want)


def test_explain_matches_jax(logset, monkeypatch):
    """``explain()`` prints JAX's plan text: line for line without the
    engine and cost lines under each package's own calibration, and every
    line under one pinned calibration (the state-cache KiB aside: the
    port's per-case states hold int64 fingerprints and case ids)."""
    paths, _, _ = logset
    band = (CASE, 20, 120)
    tds = _open(paths).filter((repro_torch.col(CASE) >= band[1])
                              & (repro_torch.col(CASE) <= band[2]))
    jds = repro.open(paths).filter((repro.col(CASE) >= band[1])
                                   & (repro.col(CASE) <= band[2]))
    kib = re.compile(r"\(\d+ KiB resident\)")
    for verb in ("dfg", "graph"):
        assert _strip(tds.explain(verb), "engine", "cost") == \
            _strip(jds.explain(verb), "engine", "cost")
    fused = ["dfg", "stats", "variants"]
    _fused_explains_equal(_strip(tds.explain(verbs=fused), "engine", "cost"),
                          _strip(jds.explain(verbs=fused), "engine", "cost"))
    pinned = dict(eager_a=5.0, eager_b=0.5, stream_a=50.0, stream_b=0.25,
                  stream_g=10.0, source="pinned")
    monkeypatch.setattr(tengines, "_CALIBRATION",
                        tengines.Calibration(**pinned))
    monkeypatch.setattr(jengines, "_CALIBRATION",
                        jengines.Calibration(**pinned))
    tds.collect("dfg", engine="streaming")
    jds.collect("dfg", engine="streaming")
    assert kib.sub("", tds.explain("dfg")) == kib.sub("", jds.explain("dfg"))
    assert "0 freshly decoded" in tds.explain("dfg")
    _fused_explains_equal(tds.explain(verbs=fused), jds.explain(verbs=fused))
    sk = _open(paths).filter(repro_torch.variant_of([0, 1]))
    jsk = repro.open(paths).filter(repro.variant_of([0, 1]))
    assert kib.sub("", sk.explain("dfg")) == kib.sub("", jsk.explain("dfg"))


# ------------------------------------ the JAX package's fusion + pool cases
def test_compose_unions_member_columns():
    """A fused kernel reads the union of its members' columns; a member
    with unknown requirements makes it read everything."""
    from repro_torch.core.performance import performance_dfg_kernel
    from repro_torch.core.stats import sojourn_times_kernel

    soj, perf = sojourn_times_kernel(A), performance_dfg_kernel(A)
    assert TIMESTAMP in soj.columns and TIMESTAMP in perf.columns
    fused = tengine.compose({"sojourn_times": soj, "performance_dfg": perf})
    assert set(fused.columns) == set(soj.columns) | set(perf.columns)
    blind = dataclasses.replace(soj, columns=())
    assert tengine.compose({"a": soj, "b": blind}).columns == ()
    spec = tengine.compose_specs({v: tengine.kernel_spec(v)
                                  for v in ("dfg", "alpha")})
    assert spec.members == ("dfg", "alpha")
    assert set(spec.columns) == {CASE, ACTIVITY}
    with pytest.raises(KeyError):
        spec.make(tengine.Dims(A, NC), verb_kwargs={"nope": {}})


def test_collect_many_chunk_invariance(tmp_path):
    """Fused results do not depend on the row-group size the files were
    written with (the carry crosses group boundaries, fused or not)."""
    frame, tables = jsyn.generate(num_cases=80, num_activities=5, seed=11)
    verbs = ("dfg", "stats", "variants", "alpha", "heuristics")
    results = []
    for rg in (37, 97, 10_000):
        d = tmp_path / f"rg{rg}"
        d.mkdir()
        paths = _split_paths(frame, tables, d, case_cuts=[40],
                             row_group_rows=rg)
        ds = _open(paths).filter(repro_torch.col(CASE) >= 10)
        results.append(ds.collect_many(verbs, engine="streaming").results)
    for other in results[1:]:
        _same(other, results[0], "chunk invariance")


def test_pruned_source_survives_reader_close(logset):
    """Closing the pooled reader between iterations (or mid-stream under
    the prefetch thread) does not break a re-iterable pruned source."""
    from repro_torch import query

    paths, _, _ = logset
    plan = query.Plan(paths[0]).filter(query.col(CASE) <= 75)
    kernel = tengine.kernel_spec("dfg").make(tengine.Dims(A, NC))
    src, _ = query.pruned_source(plan, device="cpu")
    first = tengine.run_streaming(kernel, src)
    reader = tedf.pooled_reader(paths[0])
    assert not reader.closed
    reader.close()
    _same(tengine.run_streaming(kernel, src), first, "after close")
    src2, _ = query.pruned_source(_open(paths).plan(
        columns=(CASE, ACTIVITY, TIMESTAMP)), prefetch=2, device="cpu")
    chunks = []
    for i, chunk in enumerate(src2):
        if i == 1:
            for p in paths:
                tedf.pooled_reader(p).close()
        chunks.append(chunk)
    _same(tengine.run_streaming(kernel, chunks),
          _open(paths).dfg(engine="eager"), "close mid-stream")
    pool = tedf.ReaderPool(capacity=1)
    r0 = pool.get(paths[0])
    pool.get(paths[1])                      # evicts r0 -> closed
    assert r0.closed and r0.read_group(0, device="cpu").nrows > 0
    assert tedf.pooled_reader(paths[0]) is tedf.pooled_reader(paths[0])


def test_closed_reader_refuses_rewritten_file(tmp_path):
    import os

    frame, tables = jsyn.generate(num_cases=20, num_activities=4, seed=2)
    p = str(tmp_path / "mut.edf")
    jedf.write(p, frame, tables, row_group_rows=31)
    reader = tedf.pooled_reader(p)
    assert reader.read_group(0, device="cpu").nrows > 0
    reader.close()
    os.utime(p, ns=(1, 1))              # an in-place rewrite
    with pytest.raises(tedf.StaleFileError, match="changed on disk"):
        reader.read_group(0, device="cpu")
    fresh = tedf.pooled_reader(p)
    assert fresh is not reader and fresh.read_group(0, device="cpu").nrows > 0


def test_reader_pool_threaded_stress(tmp_path):
    """One pooled reader hammered by concurrent readers and closers:
    every thread decodes every group bitwise."""
    import sys
    import threading

    frame, tables = jsyn.generate(num_cases=60, num_activities=5, seed=23)
    p = str(tmp_path / "stress.edf")
    jedf.write(p, frame, tables, version=3, row_group_rows=53)
    ref = tedf.EDFReader(p)
    expected = [ref.read_group_numpy(g)[0] for g in range(ref.num_groups)]
    ref.close()
    errors, stop = [], threading.Event()

    def hammer():
        try:
            r = tedf.pooled_reader(p)
            for _ in range(20):
                for g in range(r.num_groups):
                    cols, _ = r.read_group_numpy(g)
                    for k, v in cols.items():
                        if not np.array_equal(v, expected[g][k]):
                            raise AssertionError(f"group {g} col {k}")
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    def closer():
        while not stop.is_set():
            tedf.pooled_reader(p).close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        chaos = threading.Thread(target=closer, daemon=True)
        for t in threads:
            t.start()
        chaos.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        stop.set()
        chaos.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]


def test_group_meta_synthesis_thread_safe(tmp_path):
    """Two threads synthesizing a v2 file's zone metadata agree on one
    cached dict per group."""
    import threading

    frame, tables = jsyn.generate(num_cases=40, num_activities=5, seed=29)
    p = str(tmp_path / "v2.edf")
    jedf.write(p, frame, tables, version=2, row_group_rows=41)
    reader = tedf.EDFReader(p)
    out = [None, None]

    def grab(slot):
        out[slot] = [reader.group_meta(g) for g in range(reader.num_groups)]

    ts = [threading.Thread(target=grab, args=(i,)) for i in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    for m0, m1 in zip(*out):
        assert m0 is m1
    reader.close()
