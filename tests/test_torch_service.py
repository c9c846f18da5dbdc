"""PyTorch port, the live mining service: ``edf.append``, the ``Ingestor``
and the ``MiningService`` / HTTP layer, held on the CPU against the JAX
package's ``repro`` on the same files.

Mirrors the JAX package's ``tests/test_service.py``: the port's
``append`` writes the bytes JAX's writes and rejects each bad input with
JAX's error; the ``Ingestor`` writes JAX's partitions and skip-index, byte
for byte, and resumes both crash windows; ``MiningService`` answers with
JAX's JSON (apart from ``elapsed_us``, and ``engine`` where ``auto`` may
choose differently: the port's cost model is fitted on the card), also
over a real ``ThreadingHTTPServer`` on port 0; and every result mined
while an ingest thread appends equals re-mining the snapshot it claims.
"""
import dataclasses
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import random_log, sorted_frame  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.dataset import engines as jengines  # noqa: E402
from repro.query.statecache import state_cache as jcache  # noqa: E402
from repro.service import Ingestor as JIngestor  # noqa: E402
from repro.service import MiningService as JService  # noqa: E402
from repro.service import to_jsonable as jjson  # noqa: E402
from repro.storage import edf as jedf  # noqa: E402
from repro_torch.core.eventframe import (ACTIVITY, CASE, TIMESTAMP,  # noqa: E402
                                         EventFrame)
from repro_torch.dataset import engines as tengines  # noqa: E402
from repro_torch.query.exec import prefetch_depth  # noqa: E402
from repro_torch.query.statecache import state_cache as tcache  # noqa: E402
from repro_torch.service import (Ingestor, MiningService,  # noqa: E402
                                 ServiceError, serve, to_jsonable)
from repro_torch.service import ingest as ingest_mod  # noqa: E402
from repro_torch.storage import edf  # noqa: E402
from repro_torch.storage import rowlog  # noqa: E402

N_ACTS, N_CASES = 5, 40


def _fresh():
    tcache().clear()
    jcache().clear()
    tengines.clear_result_cache()
    jengines.clear_result_cache()


def _jslice(frame, a, b):
    """Rows [a, b) of a JAX frame."""
    return type(frame)({k: v[a:b] for k, v in frame.columns.items()},
                       {k: v[a:b] for k, v in frame.valid.items()},
                       frame.rows_valid()[a:b])


def _port(jframe):
    """The port's CPU frame of a JAX frame (same numpy columns)."""
    return EventFrame.from_numpy(
        {k: np.asarray(v) for k, v in jframe.columns.items()},
        {k: np.asarray(v) for k, v in jframe.valid.items()}, device="cpu")


def _case_cuts(frame, per):
    case = np.asarray(frame.columns[CASE])
    bounds = np.flatnonzero(case[1:] != case[:-1]) + 1
    cuts = [0] + [int(bounds[i]) for i in range(per - 1, len(bounds), per)]
    if cuts[-1] != frame.nrows:
        cuts.append(frame.nrows)
    return cuts


@pytest.fixture()
def log():
    """A JAX frame (int32 ids) and its tables."""
    rng = np.random.default_rng(11)
    return sorted_frame(random_log(rng, n_cases=N_CASES, n_acts=N_ACTS,
                                   max_len=8))


def _dumps(obj):
    return json.dumps(to_jsonable(obj))


def _json_same(got, want, path="json"):
    """Two JSON payloads equal value for value (so their dumps are equal),
    centrality ``flow`` within 1e-6 of JAX's (summation order), and a scan
    report's read-ahead window ``prefetch`` the port's own resolved
    ``prefetch_depth()`` where JAX's scan read ahead (the port's default is
    its decode pool's size, JAX's 1)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k == "flow":
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-6, err_msg=path)
            elif k == "prefetch" and "per_file" in want:
                assert got[k] == (prefetch_depth() if want[k] else 0), \
                    (path, got[k], want[k])
            else:
                _json_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _json_same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and json.dumps(got) == json.dumps(
            want), (path, got, want)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------ append path
@pytest.mark.parametrize("row_group_rows", [None, 17, 5])
def test_append_bytes_equal_jax(tmp_path, log, row_group_rows):
    """The port's append writes JAX's bytes, and the grown file reads back
    the whole frame with old groups' signatures untouched."""
    frame, tables = log
    cuts = _case_cuts(frame, N_CASES // 4)
    pj, pt = str(tmp_path / "j.edf"), str(tmp_path / "t.edf")
    jedf.write(pj, _jslice(frame, 0, cuts[1]), tables, version=3,
               row_group_rows=17)
    shutil.copyfile(pj, pt)
    r0 = edf.EDFReader(pt)
    sigs0 = [r0.group_signature(g) for g in range(r0.num_groups)]
    for lo, hi in zip(cuts[1:-1], cuts[2:]):
        want = jedf.append(pj, _jslice(frame, lo, hi), tables,
                           row_group_rows=row_group_rows)
        got = edf.append(pt, _port(_jslice(frame, lo, hi)), tables,
                         row_group_rows=row_group_rows)
        assert json.dumps(got) == json.dumps(want)
        assert _bytes(pt) == _bytes(pj)
    r1 = edf.EDFReader(pt)
    assert [r1.group_signature(g) for g in range(len(sigs0))] == sigs0
    assert r1._sig[2] != r0._sig[2]
    got, got_tables = edf.read(pt, device="cpu")
    for name in frame.names:
        np.testing.assert_array_equal(got.columns[name].numpy(),
                                      np.asarray(frame.columns[name]))
    assert got_tables == {k: list(v) for k, v in tables.items()}


def test_append_on_v2_and_extended_tables_equal_jax(tmp_path, log):
    frame, tables = log
    cut = _case_cuts(frame, N_CASES // 2)[1]
    for version in (2, 3):
        pj = str(tmp_path / f"j{version}.edf")
        pt = str(tmp_path / f"t{version}.edf")
        jedf.write(pj, _jslice(frame, 0, cut), tables, version=version,
                   row_group_rows=13)
        shutil.copyfile(pj, pt)
        grown = {k: list(v) + ["zz"] for k, v in tables.items()}
        jedf.append(pj, _jslice(frame, cut, frame.nrows), grown,
                    row_group_rows=13)
        edf.append(pt, _port(_jslice(frame, cut, frame.nrows)), grown,
                   row_group_rows=13)
        assert _bytes(pt) == _bytes(pj), version


def test_append_rejections_match_jax(tmp_path, log):
    """Every rejected input raises JAX's error, and leaves the file as it
    was; a zero-row append is a no-op."""
    frame, tables = log
    p = str(tmp_path / "log.edf")
    cut = _case_cuts(frame, N_CASES // 2)[1]
    jedf.write(p, _jslice(frame, 0, cut), tables, version=3)
    before = _bytes(p)
    tail = _jslice(frame, cut, frame.nrows)
    f64 = type(tail)({**{k: np.asarray(v) for k, v in tail.columns.items()},
                      TIMESTAMP: np.asarray(tail.columns[TIMESTAMP],
                                            np.float64)}, dict(tail.valid))
    unsorted = type(tail)({k: np.asarray(v)[::-1].copy()
                           for k, v in tail.columns.items()},
                          {k: np.asarray(v)[::-1].copy()
                           for k, v in tail.valid.items()})
    valid = type(tail)({k: np.asarray(v) for k, v in tail.columns.items()},
                       {ACTIVITY: np.ones(tail.nrows, bool)})
    cases = [
        (_jslice(frame, 0, cut), tables, None),          # reopens case 0
        (tail.select([CASE, ACTIVITY]), tables, None),   # columns
        (f64, tables, None),                             # dtype
        (valid, tables, None),                           # validity flags
        (unsorted, tables, None),                        # not case-sorted
        (tail, {ACTIVITY: ["x", "y"]}, None),            # table not extended
        (tail, tables, 0),                               # row_group_rows
    ]
    for jf, tb, rgr in cases:
        with pytest.raises(ValueError) as want:
            jedf.append(p, jf, tb, row_group_rows=rgr)
        with pytest.raises(ValueError) as got:
            edf.append(p, _port(jf), tb, row_group_rows=rgr)
        assert str(got.value) == str(want.value)
        assert _bytes(p) == before
    p1 = str(tmp_path / "v1.edf")
    jedf.write(p1, _jslice(frame, 0, cut), tables, version=1)
    with pytest.raises(ValueError, match="v1"):
        edf.append(p1, _port(tail), tables)
    edf.append(p, _port(_jslice(frame, 0, 0)), tables)
    assert _bytes(p) == before


def test_append_atomic_when_replace_fails(tmp_path, log, monkeypatch):
    frame, tables = log
    p = str(tmp_path / "log.edf")
    cut = _case_cuts(frame, N_CASES // 2)[1]
    jedf.write(p, _jslice(frame, 0, cut), tables, version=3,
               row_group_rows=17)
    before = _bytes(p)

    def boom(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(edf.os, "replace", boom)
    with pytest.raises(OSError):
        edf.append(p, _port(_jslice(frame, cut, frame.nrows)), tables)
    monkeypatch.undo()
    assert _bytes(p) == before
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []
    assert edf.read(p, device="cpu")[0].nrows == cut


def test_append_lock_is_per_path(tmp_path):
    a, b = str(tmp_path / "a.edf"), str(tmp_path / "b.edf")
    assert edf._append_lock(a) is edf._append_lock(a)
    assert edf._append_lock(a) is edf._append_lock(
        os.path.join(str(tmp_path), ".", "a.edf"))
    assert edf._append_lock(a) is not edf._append_lock(b)


def test_append_keeps_state_cache_hot_and_second_collect_sees_it(tmp_path,
                                                                 log):
    frame, tables = log
    _fresh()
    p = str(tmp_path / "log.edf")
    cut = _case_cuts(frame, N_CASES // 2)[1]
    jedf.write(p, _jslice(frame, 0, cut), tables, version=3,
               row_group_rows=17)
    old_groups = edf.num_row_groups(p)
    pinned = repro_torch.open(p, num_cases=N_CASES, device="cpu")
    live = repro_torch.open(p, device="cpu")
    pinned.collect("dfg", engine="streaming")
    first = live.collect("activity_counts", engine="streaming")
    edf.append(p, _port(_jslice(frame, cut, frame.nrows)), tables,
               row_group_rows=17)
    res = pinned.collect("dfg", engine="streaming")
    assert res.report.groups_cached == old_groups
    assert res.report.groups_folded == edf.num_row_groups(p) - old_groups
    scratch = repro_torch.open(_port(frame), tables=tables,
                               num_cases=N_CASES, device="cpu")
    assert _dumps(res.result) == _dumps(scratch.collect(
        "dfg", engine="eager").result)
    second = live.collect("activity_counts", engine="streaming")
    assert second.report.groups_total > first.report.groups_total
    assert _dumps(second.result) == json.dumps(jjson(repro.open(
        frame, tables=tables).collect("activity_counts",
                                      engine="eager").result))


def test_stale_reader_fails_loudly_and_pin_holds_snapshot(tmp_path, log):
    frame, tables = log
    p = str(tmp_path / "log.edf")
    cut = _case_cuts(frame, N_CASES // 2)[1]
    jedf.write(p, _jslice(frame, 0, cut), tables, version=3,
               row_group_rows=17)
    stale = edf.EDFReader(p)
    stale.read_group(0, device="cpu")
    pinned = edf.EDFReader(p)
    with pinned.pin():
        edf.append(p, _port(_jslice(frame, cut, frame.nrows)), tables)
        stale.close()
        with pytest.raises(edf.StaleFileError):
            stale.read_group(0, device="cpu")
        pinned.close()
        total = sum(pinned.read_group(g, device="cpu").nrows
                    for g in range(pinned.num_groups))
        assert total == cut
    assert pinned.closed
    assert edf.pooled_reader(p).nrows == frame.nrows


def test_dataset_append_api(tmp_path, log):
    frame, tables = log
    _fresh()
    cuts = _case_cuts(frame, 15)
    p1, p2 = str(tmp_path / "a.edf"), str(tmp_path / "b.edf")
    jedf.write(p1, _jslice(frame, 0, cuts[1]), tables, version=3)
    jedf.write(p2, _jslice(frame, cuts[1], cuts[2]), tables, version=3)
    ds = repro_torch.open([p1, p2], device="cpu")
    out = ds.append(_port(_jslice(frame, cuts[2], frame.nrows)),
                    row_group_rows=17)
    assert isinstance(out, repro_torch.Dataset) and out.paths == ds.paths
    assert ds.num_cases == N_CASES
    want = repro.open(frame, tables=tables).collect("dfg", engine="eager")
    assert _dumps(ds.collect("dfg", engine="streaming").result) == \
        json.dumps(jjson(want.result))
    with pytest.raises(ValueError, match="last file"):
        ds.append(_port(_jslice(frame, 0, cuts[1])), path=p1)
    with pytest.raises(ValueError, match="file-backed"):
        repro_torch.open(_port(frame), tables=tables,
                         device="cpu").append(_port(frame))


def test_rowlog_bytes_equal_jax(tmp_path):
    from repro.core.classic_log import make_classic_log as jmake
    from repro.storage import rowlog as jrowlog
    from repro_torch.core.classic_log import make_classic_log

    cases = [(c, [(a, float(t)) for t, a in enumerate("abca"[:c + 1])])
             for c in range(4)]
    for compress in (False, True):
        pj, pt = str(tmp_path / f"j{compress}"), str(tmp_path / f"t{compress}")
        jrowlog.write(pj, jmake(cases), compress=compress)
        rowlog.write(pt, make_classic_log(cases), compress=compress)
        assert rowlog.read(pt, compress).events == \
            jrowlog.read(pj, compress).events
        if not compress:
            assert _bytes(pt) == _bytes(pj)


# --------------------------------------------------------------- ingestor
def _write_batches(bdir, frame, tables, per=8):
    cuts = _case_cuts(frame, per)
    for i in range(len(cuts) - 1):
        jedf.write(os.path.join(bdir, f"batch_{i:04d}.edf"),
                   _jslice(frame, cuts[i], cuts[i + 1]), tables, version=3)
    return len(cuts) - 1


def test_ingestor_partitions_and_index_equal_jax(tmp_path, log):
    """Same batches, same knobs: the port's partitions and skip-index are
    JAX's, byte for byte; re-runs redo nothing."""
    frame, tables = log
    bdir = str(tmp_path / "in")
    os.makedirs(bdir)
    n = _write_batches(bdir, frame, tables)
    kw = dict(partition_rows=frame.nrows // 3, row_group_rows=16)
    ing = Ingestor(str(tmp_path / "t"), bdir, **kw)
    jing = JIngestor(str(tmp_path / "j"), bdir, **kw)
    assert ing.run_once() == jing.run_once() == n
    assert ing.run_once() == 0
    assert len(ing.paths) >= 2
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert _bytes(tmp_path / "t" / name) == _bytes(tmp_path / "j" / name)
    got = [edf.read(p, device="cpu")[0] for p in ing.paths]
    joined = np.concatenate([g.columns[CASE].numpy() for g in got])
    np.testing.assert_array_equal(joined, np.asarray(frame.columns[CASE]))
    assert Ingestor(str(tmp_path / "t"), bdir).run_once() == 0


def test_ingestor_env_knobs(tmp_path, log, monkeypatch):
    monkeypatch.setenv("REPRO_SERVICE_PARTITION_ROWS", "123")
    monkeypatch.setenv("REPRO_SERVICE_ROW_GROUP_ROWS", "7")
    monkeypatch.setenv("REPRO_SERVICE_RETRIES", "2")
    monkeypatch.setenv("REPRO_SERVICE_BACKOFF", "0.5")
    ing = Ingestor(str(tmp_path / "o"), str(tmp_path / "in"))
    assert (ing.partition_rows, ing.row_group_rows, ing.max_retries,
            ing.backoff) == (123, 7, 2, 0.5)
    assert ing.run_once() == 0              # a missing source is empty


def test_ingestor_crash_resume_both_windows(tmp_path, log):
    frame, tables = log
    bdir, pdir = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(bdir)
    cuts = _case_cuts(frame, 10)
    batches = [(f"batch_{i:04d}.edf", _jslice(frame, cuts[i], cuts[i + 1]))
               for i in range(len(cuts) - 1)]
    for name, fr in batches:
        jedf.write(os.path.join(bdir, name), fr, tables, version=3)
    kw = dict(partition_rows=10**9, row_group_rows=16)
    ing = Ingestor(pdir, bdir, **kw)
    ing.run_once(limit=1)
    part = os.path.basename(ing.paths[0])
    rows0 = edf.read_header(ing.paths[0])[0]["nrows"]
    # window A: pending recorded, apply never ran -> the batch is redone
    ing._index["pending"] = {"batch": batches[1][0], "partition": part,
                             "rows": batches[1][1].nrows,
                             "nrows_before": rows0}
    ing._save_index()
    resumed = Ingestor(pdir, bdir, **kw)
    assert batches[1][0] not in resumed.done_ids
    resumed.run_once(limit=1)
    rows1 = edf.read_header(resumed.paths[0])[0]["nrows"]
    assert rows1 == rows0 + batches[1][1].nrows
    # window B: apply landed, done never recorded -> acknowledged only
    edf.append(resumed.paths[0], _port(batches[2][1]), tables,
               row_group_rows=16)
    resumed._index["pending"] = {"batch": batches[2][0], "partition": part,
                                 "rows": batches[2][1].nrows,
                                 "nrows_before": rows1}
    resumed._save_index()
    final = Ingestor(pdir, bdir, **kw)
    assert batches[2][0] in final.done_ids
    final.run_once()
    got, _ = edf.read(final.paths[0], device="cpu")
    assert got.nrows == frame.nrows
    np.testing.assert_array_equal(got.columns[CASE].numpy(),
                                  np.asarray(frame.columns[CASE]))
    # the same drill through JAX's Ingestor leaves the same bytes
    jdir = str(tmp_path / "jout")
    assert JIngestor(jdir, bdir, **kw).run_once() == len(batches)
    assert _bytes(final.paths[0]) == _bytes(os.path.join(jdir, part))


def test_ingestor_retries_transient_write_failures(tmp_path, log,
                                                   monkeypatch):
    frame, tables = log
    bdir, pdir = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(bdir)
    _write_batches(bdir, frame, tables, per=N_CASES // 2)
    real_append, fails = edf.append, {"left": 2}

    def flaky(path, fr, tb=None, row_group_rows=None):
        if fails["left"]:
            fails["left"] -= 1
            raise OSError("transient")
        return real_append(path, fr, tb, row_group_rows)

    monkeypatch.setattr(ingest_mod.edf, "append", flaky)
    ing = Ingestor(pdir, bdir, partition_rows=10**9, row_group_rows=16,
                   max_retries=5, backoff=0.001)
    assert ing.run_once() == 2
    assert ing.retried == 2
    assert edf.read(ing.paths[0], device="cpu")[0].nrows == frame.nrows


# ---------------------------------------------------------- query service
def _pdir(tmp_path, frame, tables, name="parts"):
    pdir = str(tmp_path / name)
    os.makedirs(pdir)
    jedf.write(os.path.join(pdir, "part_00000.edf"), frame, tables,
               version=3, row_group_rows=16)
    return pdir


def _without(out, *keys):
    return {k: v for k, v in out.items() if k not in keys}


def test_service_matches_jax(tmp_path, log, monkeypatch):
    """Every request of the service equals JAX's response (engine fixed;
    ``auto`` compared on its result)."""
    frame, tables = log
    _fresh()
    pdir = _pdir(tmp_path, frame, tables)
    svc = MiningService(pdir, case_capacity=64, device="cpu")
    jsvc = JService(pdir, case_capacity=64)
    for verb in ("dfg", "variants", "stats", "alpha", "heuristics",
                 "node_centrality"):
        got = svc.collect(verb, engine="streaming")
        want = jsvc.collect(verb, engine="streaming")
        assert got["engine"] == want["engine"] == "streaming"
        _json_same(got, want, verb)
    claim = svc.collect("dfg", engine="eager")["snapshot"]
    assert claim == jsvc.collect("dfg", engine="eager")["snapshot"]
    assert claim["rows"] == frame.nrows and claim["num_cases"] == 64
    assert claim["files"][0]["tag"] == edf.header_tag(
        os.path.join(pdir, "part_00000.edf"))
    got, want = svc.collect("dfg"), jsvc.collect("dfg")
    assert got["result"] == want["result"]
    for eng in ("eager", "streaming"):
        _json_same(svc.profile(engine=eng), jsvc.profile(engine=eng),
                   f"profile/{eng}")
    for kw in ({"by": "groups", "size": 2, "step": 2},
               {"by": "time", "size": 30.0, "step": 15.0}):
        assert json.dumps(svc.window("dfg", **kw)) == json.dumps(
            jsvc.window("dfg", **kw))
    for q in (None, "reachability", "bottleneck_paths"):
        assert json.dumps(svc.graph(q, engine="streaming")) == json.dumps(
            jsvc.graph(q, engine="streaming"))
    pinned = dict(eager_a=5.0, eager_b=0.5, stream_a=50.0, stream_b=0.25,
                  stream_g=10.0, source="pinned")
    monkeypatch.setattr(tengines, "_CALIBRATION",
                        tengines.Calibration(**pinned))
    monkeypatch.setattr(jengines, "_CALIBRATION",
                        jengines.Calibration(**pinned))
    _fresh()
    assert svc.explain("dfg") == jsvc.explain("dfg")
    health, jhealth = svc.health(), jsvc.health()
    assert _without(health, "uptime_s", "state_cache") == \
        _without(jhealth, "uptime_s", "state_cache")
    with pytest.raises(ServiceError):
        svc.collect(None)
    with pytest.raises(ServiceError) as e503:
        MiningService(str(tmp_path / "empty"), device="cpu").collect("dfg")
    assert e503.value.status == 503


def test_service_defaults_to_the_card_and_env_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_SERVICE_CASE_CAPACITY", "2048")
    monkeypatch.setenv("REPRO_SERVICE_ATTEMPTS", "2")
    svc = MiningService(str(tmp_path))
    assert svc.device == "cuda"
    assert (svc.case_floor, svc.max_attempts) == (2048, 2)
    with pytest.raises(ValueError):
        MiningService(str(tmp_path), max_attempts=0)
    from repro.service.server import _round_capacity as jround
    from repro_torch.service.server import _round_capacity

    for n in (0, 1, 1024, 1025, 10**6):
        assert _round_capacity(n) == jround(n)


def test_to_jsonable_matches_jax(log):
    """Tensors (any dtype, 0-d too) give the JSON numpy arrays give."""
    import jax.numpy as jnp

    frame, tables = log
    arrays = [np.arange(5, dtype=np.int32), np.linspace(0, 1, 7, dtype=np.float32),
              np.array([True, False]), np.array(3.25, np.float32),
              np.arange(4, dtype=np.uint32) * 1_000_000_000]
    for a in arrays:
        t = torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                             else a)
        assert json.dumps(to_jsonable(t)) == json.dumps(jjson(jnp.asarray(a)))
        assert json.dumps(to_jsonable({"x": (a, t)})) == json.dumps(
            jjson({"x": (a, a)}))
    got = repro_torch.open(_port(frame), tables=tables, device="cpu")
    want = repro.open(frame, tables=tables)
    for verb in ("variants", "stats", "discovery", "graph"):
        assert _dumps(got.collect(verb).result) == json.dumps(
            jjson(want.collect(verb).result)), verb


def test_mined_while_ingesting_bitwise_parity(tmp_path):
    """An ingest thread appends case-aligned batches while client threads
    collect; every returned result equals re-mining the exact snapshot
    its claim names (a row prefix of the master log), by the port and by
    JAX."""
    rng = np.random.default_rng(23)
    frame, tables = sorted_frame(random_log(rng, n_cases=60, n_acts=N_ACTS,
                                            max_len=7))
    _fresh()
    bdir, pdir = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(bdir)
    cuts = _case_cuts(frame, 6)
    ing = Ingestor(pdir, bdir, partition_rows=frame.nrows // 2,
                   row_group_rows=16, poll_interval=0.01)
    svc = MiningService(ing, case_capacity=64, max_attempts=6, device="cpu")

    def produce():
        for i in range(len(cuts) - 1):
            jedf.write(os.path.join(bdir, f"batch_{i:04d}.edf"),
                       _jslice(frame, cuts[i], cuts[i + 1]), tables,
                       version=3)
            time.sleep(0.02)

    collected, errors = [], []

    def client():
        verbs = ("dfg", "activity_counts", "case_sizes")
        done, deadline = 0, time.monotonic() + 30
        while done < 6 and time.monotonic() < deadline:
            try:
                out = svc.collect(verbs[done % len(verbs)],
                                  engine="streaming")
                collected.append((out["verb"], out["snapshot"],
                                  json.dumps(out["result"])))
                done += 1
                time.sleep(0.01)
            except ServiceError:
                time.sleep(0.03)
            except Exception as e:              # pragma: no cover
                errors.append(e)
                return

    producer = threading.Thread(target=produce)
    producer.start()
    ing.start()
    time.sleep(0.05)
    clients = [threading.Thread(target=client) for _ in range(3)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=60)
        assert not c.is_alive()
    producer.join(timeout=60)
    assert not producer.is_alive()
    while ing.run_once():
        pass
    ing.stop()
    assert not errors
    assert collected
    for verb, claim, result_json in collected:
        rows = claim["rows"]
        ref = repro_torch.open(_port(_jslice(frame, 0, rows)), tables=tables,
                               num_cases=claim["num_cases"],
                               device="cpu").collect(verb, engine="eager")
        assert result_json == _dumps(ref.result), f"{verb} at {rows} rows"
        jref = repro.open(_jslice(frame, 0, rows), tables=tables,
                          num_cases=claim["num_cases"]).collect(
                              verb, engine="eager")
        assert result_json == json.dumps(jjson(jref.result))
    assert svc.collect("dfg", engine="streaming")["snapshot"]["rows"] == \
        frame.nrows


def test_http_endpoints_match_jax(tmp_path, log, monkeypatch):
    """Both services behind real ``ThreadingHTTPServer`` s on port 0
    answer every endpoint with the same JSON, apart from ``elapsed_us``."""
    frame, tables = log
    _fresh()
    pdir = _pdir(tmp_path, frame, tables)
    pinned = dict(eager_a=5.0, eager_b=0.5, stream_a=50.0, stream_b=0.25,
                  stream_g=10.0, source="pinned")
    monkeypatch.setattr(tengines, "_CALIBRATION",
                        tengines.Calibration(**pinned))
    monkeypatch.setattr(jengines, "_CALIBRATION",
                        jengines.Calibration(**pinned))
    from repro.service import serve as jserve

    servers = [serve(pdir, port=0, case_capacity=64, device="cpu"),
               jserve(pdir, port=0, case_capacity=64)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        def get(server, path, body=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}{path}",
                data=None if body is None else json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            out.pop("elapsed_us", None)
            return out

        port, jax_ = servers
        for path in ("/collect?verb=dfg&engine=streaming",
                     "/collect?verb=variants&engine=eager",
                     "/collect?verb=dfg",
                     "/profile?engine=streaming",
                     "/window?verb=dfg&by=groups&size=2&step=2",
                     "/graph?query=reachability&engine=streaming",
                     "/collect?verb=dfg&engine=sharded",
                     "/explain?verb=dfg"):
            _fresh()
            _json_same(get(port, path), get(jax_, path), path)
        body = {"verb": "alpha", "min_count": 2, "engine": "streaming"}
        alpha = get(port, "/collect", body)
        assert alpha == get(jax_, "/collect", body)
        assert alpha["result"]["_type"] == "AlphaModel"
        health = get(port, "/health")
        assert health["ok"] and health["rows"] == frame.nrows
        for bad, code in (("/nope", 404), ("/collect", 400),
                          ("/collect?verb=nope", 400),
                          ("/collect?verb=stats&engine=sharded", 400)):
            with pytest.raises(urllib.error.HTTPError) as err:
                get(port, bad)
            assert err.value.code == code, bad
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
