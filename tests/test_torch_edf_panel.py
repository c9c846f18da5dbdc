"""PyTorch port, the paper's columnar deployment on the CPU: a small log of
``table6-L5``'s shape (``pmbench``'s generator, 3,000 cases) kept in EDF
files of 1,024-row groups, as one file and as two, mined through the
file-backed ``Dataset`` and held against the benchmark's plain reference
(``pmbench.reference``, ``pmbench/verbs``) by the benchmark's own check:
integers exactly, floats within ``pmbench/limits.json``'s ``float_err``.

* the panel's eight verbs in one ``collect_many``, behind case bands whose
  edges fall inside row groups and on group boundaries, and behind none,
  on the streaming engine and on ``auto``;
* the panel's stitching members on the grouped path twice in a row: the
  second call comes from the group-state cache, its answers identical;
* a group-state cache too small for one group's state, and one too small
  for two (every fold evicts the one before);
* the scan keeps no chunk its consumer has dropped (a ghost chunk held to
  the scan's end raised the cell's ``peak_device_gib``).
"""
import dataclasses
import sys
import weakref
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import repro_torch  # noqa: E402
from repro_torch import col  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.eventframe import EventFrame  # noqa: E402
from repro_torch.dataset import engines  # noqa: E402
from repro_torch.query import statecache  # noqa: E402
from repro_torch.query.exec import pruned_source  # noqa: E402
from repro_torch.storage import edf  # noqa: E402

from pmbench import gen, harness, traffic  # noqa: E402

NC = 3000
GROUP_ROWS = 1024
SEED = 2**31 + 35
CFG = dict(harness.load_config(ROOT, "table6-L5"), num_cases=NC)
PANEL = tuple(traffic.load(ROOT, "panel")["collect_many"])
LIMITS = harness.load_json(ROOT / "pmbench" / "limits.json")
# the panel's members that define a stitch: the grouped path's verbs
STITCHED = tuple(v for v in PANEL if engine.mergeable(
    engine.kernel_spec(v).make(engine.Dims(CFG["num_activities"], NC))))


@pytest.fixture(scope="module")
def cols():
    return gen.generate(CFG, SEED, torch.device("cpu"))


@pytest.fixture(scope="module")
def files(cols, tmp_path_factory):
    """{number of files: their paths}: the log in (case, time) order, as
    one file and as two of contiguous case ranges."""
    d = tmp_path_factory.mktemp("edf")
    cut = int(torch.searchsorted(cols[gen.CASE], torch.tensor(NC // 2)))
    out = {}
    for n, bounds in ((1, [0, None]), (2, [0, cut, None])):
        paths = []
        for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            path = str(d / f"log{n}-{i}.edf")
            edf.write(path, EventFrame({k: v[lo:hi] for k, v in cols.items()}),
                      tables=gen.tables(CFG), codec="zlib1",
                      row_group_rows=GROUP_ROWS, version=3)
            paths.append(path)
        out[n] = paths
    return out


def group_cases(path) -> list[tuple[int, int]]:
    """(first case, last case) of each row group of a file."""
    reader = edf.EDFReader(path)
    return [(int(z["min"]), int(z["max"])) for z in
            (reader.group_meta(g)["zones"][gen.CASE]
             for g in range(reader.num_groups))]


def band(files, where: str) -> tuple:
    """``(kind, params)`` of a request: no filter, or a case band whose
    edges fall inside row groups or on group boundaries of the one-file
    log."""
    if where == "none":
        return "none", ()
    groups = group_cases(files[1][0])
    if where == "inside":
        return "case_band", (sum(groups[2]) // 2, sum(groups[-3]) // 2)
    return "case_band", (groups[3][0], groups[-4][1])


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    """No answer from the memo, no state from another test's cache."""
    engines.clear_result_cache()
    monkeypatch.setattr(statecache, "_CACHE", None)
    yield
    engines.clear_result_cache()


def ask(paths, kind, params, verbs, **kwargs):
    ds = repro_torch.open(paths, device="cpu")
    if kind == "case_band":
        ds = ds.filter(col(gen.CASE).between(*params))
    return ds.collect_many(verbs, **kwargs)


def check(cols, kind, params, verbs, res) -> dict:
    """The benchmark's check of one answer against the reference."""
    req = traffic.Request(0, kind, params, tuple(verbs), True)
    numbers = harness.check(cols, CFG, [
        (req, harness.program_answers(req, harness.to_host(res.results)))])
    assert numbers["checked"] == 1
    assert numbers["int_mismatches"] == 0, numbers
    assert numbers["float_err"] <= LIMITS["float_err"], numbers
    return numbers


def leaves(x) -> list:
    """An answer's values in a fixed order, tensors as bytes."""
    if isinstance(x, torch.Tensor):
        return [(str(x.dtype), tuple(x.shape), x.numpy().tobytes())]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [v for f in dataclasses.fields(x)
                for v in leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in [k] + leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in leaves(y)]
    return [x]


@pytest.mark.parametrize("where", ["inside", "boundary", "none"])
@pytest.mark.parametrize("engine_name", ["streaming", "auto"])
@pytest.mark.parametrize("nfiles", [1, 2])
def test_the_panel_over_files_matches_the_reference(cols, files, nfiles,
                                                     engine_name, where):
    kind, params = band(files, where)
    res = ask(files[nfiles], kind, params, PANEL, engine=engine_name)
    check(cols, kind, params, PANEL, res)
    if res.engine == "streaming":
        r = res.report
        assert r.groups_read + r.groups_cached + r.groups_skipped \
            == r.groups_total
        # a band skips the groups outside it; none skips nothing
        assert (r.groups_skipped > 0) == (kind == "case_band")


@pytest.mark.parametrize("where", ["inside", "none"])
@pytest.mark.parametrize("nfiles", [1, 2])
def test_the_grouped_path_twice_serves_the_state_cache(cols, files, nfiles,
                                                       where):
    kind, params = band(files, where)
    first = ask(files[nfiles], kind, params, STITCHED, engine="streaming")
    engines.clear_result_cache()
    second = ask(files[nfiles], kind, params, STITCHED, engine="streaming")
    assert first.report.groups_read > 0 and first.report.groups_cached == 0
    assert (second.report.groups_read, second.report.groups_cached) == \
        (0, first.report.groups_read)
    assert leaves(second.results) == leaves(first.results)
    check(cols, kind, params, STITCHED, second)


def state_bytes(paths, kind, params) -> list[int]:
    """The cached size of each group state of the grouped path."""
    ask(paths, kind, params, STITCHED, engine="streaming")
    return [n for _, n in statecache.state_cache()._entries.values()]


@pytest.mark.parametrize("room", ["under_one_state", "under_two_states"])
def test_a_state_cache_too_small_still_answers(cols, files, monkeypatch,
                                               room):
    kind, params = band(files, "inside")
    sizes = state_bytes(files[1], kind, params)
    cap = min(sizes) - 1 if room == "under_one_state" else \
        (max(sizes) + 2 * min(sizes)) // 2
    assert room == "under_one_state" or max(sizes) <= cap < 2 * min(sizes)
    monkeypatch.setenv(statecache.ENV_VAR, str(cap))
    monkeypatch.setattr(statecache, "_CACHE", None)
    before = dict(statecache.TOTALS)
    for _ in range(2):
        engines.clear_result_cache()
        res = ask(files[1], kind, params, STITCHED, engine="streaming")
        check(cols, kind, params, STITCHED, res)
    cache = statecache.state_cache()
    evicted = statecache.TOTALS["evictions"] - before["evictions"]
    if room == "under_one_state":
        # a state larger than the whole cache is never kept
        assert len(cache) == 0 and evicted == 0
        assert res.report.groups_cached == 0
    else:
        # each fold evicts the one before, so the second call finds none
        # of the first's: 2 x (groups read) - 1 evictions
        assert len(cache) == 1 and cache.evictions == evicted
        assert res.report.groups_cached == 0
        assert evicted == 2 * res.report.groups_read - 1


@pytest.mark.parametrize("prefetch", [0, 1])
def test_the_scan_keeps_no_chunk_its_consumer_dropped(files, prefetch):
    kind, params = band(files, "inside")
    ds = repro_torch.open(files[1], device="cpu").filter(
        col(gen.CASE).between(*params))
    src, _ = pruned_source(ds.plan(columns=(gen.CASE, gen.ACTIVITY)),
                           sketch=True, prefetch=prefetch, device="cpu")
    chunks = iter(src)
    alive = []
    for _ in range(3):      # the leading ghost chunk, then two read groups
        chunk = next(chunks)
        alive.append(weakref.ref(chunk[gen.CASE]))
        del chunk
    assert not alive[0]() and not alive[1]()
    chunks.close()
