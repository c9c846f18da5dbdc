"""PyTorch port, the pruned query layer (``repro_torch.query`` over
``storage.edf.EDFReader``), held on the CPU against the JAX package's
``repro.query`` on files the JAX package writes (v1, v2, v3, and v3 grown
by ``edf.append``).

For every predicate of the JAX package's ``tests/test_query.py``: the
port's ``execute`` equals the port's eager filter-then-mine and JAX's
``execute``, bitwise (fingerprints compared as uint32), and its
``ScanReport`` equals JAX's field by field.  Plus ghost chunks with and
without sketches, ``execute_grouped`` with its state-cache hits, the
read-ahead pool (the stream is bitwise the same at any window, a decode's
error reaches the consumer in order, a closed scan leaves no decode
running, the default window follows the host's cores),
``StaleFileError`` after an append, and ``execute_frame``.
"""
import dataclasses
import os
import sys
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_scan_helpers import scan_reports_equal as _reports_equal  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.query as jq  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.query import exec as jexec  # noqa: E402
from repro.query import statecache as jstatecache  # noqa: E402
from repro.storage import edf as jedf  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.query as tq  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import filtering as tfilt  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402
from repro_torch.query import exec as texec  # noqa: E402
from repro_torch.query.optimize import GhostItem, ReadItem  # noqa: E402
from repro_torch.query import statecache as tstatecache  # noqa: E402
from repro_torch.storage import edf as tedf  # noqa: E402

A = 8
TS_LO, TS_HI = 3e5, 7e5


@pytest.fixture(scope="module")
def log(tmp_path_factory):
    """One v3 file written by the JAX package, the port's whole frame of it
    on the CPU, and its case count."""
    frame, tables = jsyn.generate(num_cases=300, num_activities=A, seed=21)
    path = str(tmp_path_factory.mktemp("tq") / "log.edf")
    jedf.write(path, frame, tables, row_group_rows=199)
    whole, _ = tedf.read(path, device="cpu")
    ncases = tq.compile_plan(tq.Plan(path)).num_cases
    assert ncases == jq.compile_plan(jq.Plan(path)).num_cases
    return path, whole, ncases


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _leaves(y)]
    return [_host(x)]


def _same(got, want, msg=""):
    """Bitwise; a port int64 fingerprint against a JAX uint32 one as uint32."""
    lg, lw = _leaves(got), _leaves(want)
    assert len(lg) == len(lw), msg
    for g, w in zip(lg, lw):
        if w.dtype == np.uint32 and g.dtype == np.int64:
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=msg)


def _port_reference(whole, ncases, name):
    """The port's eager filter chain each plan must match bitwise."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        c, a = whole[CASE], whole[ACTIVITY]
        if name == "isin":
            return tfilt.filter_attr_values(whole, ACTIVITY, [2, 5])
        if name == "not_isin":
            return tfilt.filter_attr_values(whole, ACTIVITY, [2, 5], keep=False)
        if name == "eq_case_band":
            return tops.proj(whole, (c >= 90) & (c <= 140))
        if name == "time_range":
            return tfilt.filter_time_range(whole, TIMESTAMP, TS_LO, TS_HI)
        if name == "bool_combo":
            return tops.proj(whole, ((c <= 60) | (c >= 250)) & ~(a == 3))
        if name == "contains":
            return tfilt.filter_cases_containing(whole, 4, ncases)
        if name == "case_size":
            return tfilt.filter_case_size(whole, 3, 7, ncases)
        if name == "chain":
            f = tfilt.filter_attr_values(whole, ACTIVITY, [1, 2, 4, 6])
            f = tfilt.filter_cases_containing(f, 4, ncases)
            return tfilt.filter_time_range(f, TIMESTAMP, TS_LO, TS_HI)
    raise KeyError(name)


def _plan(q, path, name):
    """The same logical plan in either package (``q`` is its query module)."""
    p, col = q.Plan(path), q.col
    if name == "isin":
        return p.filter(col(ACTIVITY).isin([2, 5]))
    if name == "not_isin":
        return p.filter(~col(ACTIVITY).isin([2, 5]))
    if name == "eq_case_band":
        return p.filter((col(CASE) >= 90) & (col(CASE) <= 140))
    if name == "time_range":
        return p.filter(col(TIMESTAMP).between(TS_LO, TS_HI))
    if name == "bool_combo":
        return p.filter(((col(CASE) <= 60) | (col(CASE) >= 250))
                        & ~(col(ACTIVITY) == 3))
    if name == "contains":
        return p.filter(q.cases_containing(4))
    if name == "case_size":
        return p.filter(q.case_size(3, 7))
    if name == "chain":
        return (p.filter(col(ACTIVITY).isin([1, 2, 4, 6]))
                .filter(q.cases_containing(4))
                .filter(col(TIMESTAMP).between(TS_LO, TS_HI)))
    raise KeyError(name)


PREDICATES = ["isin", "not_isin", "eq_case_band", "time_range", "bool_combo",
              "contains", "case_size", "chain"]
VERBS = ["dfg", "activity_counts", "case_sizes", "case_durations",
         "sojourn_times", "eventually_follows", "discovery", "variants"]


def _kernels(engine, ncases):
    dims = engine.Dims(A, ncases)
    return {v: engine.kernel_spec(v).make(dims) for v in VERBS}


@pytest.mark.parametrize("pred", PREDICATES)
def test_execute_matches_filter_then_mine_and_jax(log, pred):
    """Every verb alone: port execute == port filter-then-mine; the fused
    pass of all eight: port == JAX per verb, ScanReport field by field."""
    path, whole, ncases = log
    ref_frame = _port_reference(whole, ncases, pred)
    tks = _kernels(tengine, ncases)
    for verb, kernel in tks.items():
        got, report = tq.execute(_plan(tq, path, pred), mine=kernel,
                                 device="cpu")
        _same(got, tengine.run_single(kernel, ref_frame), f"{pred}/{verb}")
        assert report.bytes_read <= report.bytes_total
    fused_t = tengine.compose(tks)
    fused_j = jengine.compose(_kernels(jengine, ncases))
    got, t_rep = tq.execute(_plan(tq, path, pred), mine=fused_t, device="cpu")
    want, j_rep = jq.execute(_plan(jq, path, pred), mine=fused_j)
    for verb in VERBS:
        _same(got[verb], want[verb], f"{pred}/{verb} vs jax")
    _reports_equal(t_rep, j_rep)


def test_selective_predicate_skips_bytes(log):
    path, whole, ncases = log
    plan = tq.Plan(path).filter(tq.col(CASE).between(90, 140))
    pruned, rep = tq.execute(plan, mine=tcore.dfg_kernel(A), device="cpu")
    full, rep_full = tq.execute(plan, mine=tcore.dfg_kernel(A), prune=False,
                                device="cpu")
    _same(pruned, full, "pruned vs full")
    assert rep.groups_skipped > 0 and rep_full.groups_skipped == 0
    assert rep.bytes_read < rep_full.bytes_read
    assert rep.bytes_total == rep_full.bytes_read
    _reports_equal(rep, jq.execute(jq.Plan(path).filter(
        jq.col(CASE).between(90, 140)), mine=jcore.dfg_kernel(A))[1])


@pytest.mark.parametrize("verb", ["dfg", "variants"])
def test_ghost_chunks_with_and_without_sketches(log, verb):
    """The ghost chunks a pruned scan synthesizes equal JAX's (columns,
    epsilon flags, all-masked rows; the sketch maps only for the variants
    kernel), and the results over them equal the eager ones."""
    path, whole, ncases = log
    kernel = tengine.kernel_spec(verb).make(tengine.Dims(A, ncases))
    sketch = kernel.ghost_sketch
    assert sketch == (verb == "variants")
    t_ph = tq.compile_plan(tq.Plan(path).filter(tq.col(CASE).between(90, 140)))
    j_ph = jq.compile_plan(jq.Plan(path).filter(jq.col(CASE).between(90, 140)))
    t_ghosts = [it for it in t_ph.final_schedule({}, sketch=sketch)
                if isinstance(it, texec.GhostItem)]
    j_ghosts = [it for it in j_ph.final_schedule({}, sketch=sketch)
                if isinstance(it, jexec.GhostItem)]
    assert len(t_ghosts) == len(j_ghosts) >= 2
    for ti, ji in zip(t_ghosts, j_ghosts):
        assert (ti.indices, ti.segments, ti.first_case) == \
            (ji.indices, ji.segments, ji.first_case)
        tg = texec._ghost_chunk(ti, t_ph.read_columns, t_ph.reader, "cpu")
        jg = jexec._ghost_chunk(ji, j_ph.read_columns, j_ph.reader)
        assert set(tg.names) == set(jg.names)
        assert any(n.startswith("__sk_") for n in tg.names) == sketch
        # one row a segment: JAX's rows up to its power-of-two padding
        d = ti.segments
        assert tg.nrows == d <= jg.nrows
        for k in jg.names:
            np.testing.assert_array_equal(_host(tg[k]), np.asarray(jg[k])[:d], k)
        for k in jg.valid:
            np.testing.assert_array_equal(_host(tg.valid[k]),
                                          np.asarray(jg.valid[k])[:d], k)
        assert not tg.rows_valid().any()
    got, rep = tq.execute(t_ph.plan, mine=kernel, device="cpu")
    assert rep.groups_skipped > 0
    c = whole[CASE]
    _same(got, tengine.run_single(kernel, tops.proj(whole, (c >= 90) & (c <= 140))))


def _spec_fp(verb, ncases):
    return tstatecache.spec_fingerprint(verb, tengine.Dims(A, ncases))


@pytest.mark.parametrize("verb", ["dfg", "variants", "discovery"])
def test_execute_grouped_equals_execute_with_cache_hits(log, verb):
    """execute_grouped == execute (bitwise); the second call reads nothing
    and serves every read unit from the state cache, with JAX's report."""
    path, whole, ncases = log
    tstatecache.state_cache().clear()
    jstatecache.state_cache().clear()
    # proved interior groups, residual edge groups, refuted (ghost) groups
    plan_t = tq.Plan(path).filter(tq.col(CASE).between(60, 200))
    plan_j = jq.Plan(path).filter(jq.col(CASE).between(60, 200))
    tk = tengine.kernel_spec(verb).make(tengine.Dims(A, ncases))
    jk = jengine.kernel_spec(verb).make(jengine.Dims(A, ncases))
    j_fp = jstatecache.spec_fingerprint(verb, jengine.Dims(A, ncases))
    want, _ = tq.execute(plan_t, mine=tk, device="cpu")
    first, rep1 = texec.execute_grouped(plan_t, tk, _spec_fp(verb, ncases),
                                        device="cpu")
    second, rep2 = texec.execute_grouped(plan_t, tk, _spec_fp(verb, ncases),
                                         device="cpu")
    _same(first, want, "grouped vs execute")
    _same(second, first, "cache hit vs fold")
    assert rep1.groups_folded == rep1.groups_read > 0 and rep1.groups_cached == 0
    assert rep2.groups_read == 0 and rep2.groups_cached == rep1.groups_read
    assert rep1.groups_skipped == rep2.groups_skipped > 0
    assert rep1.groups_proved > 0 and rep1.groups_read > rep1.groups_proved
    j1 = jexec.execute_grouped(plan_j, jk, j_fp)
    j2 = jexec.execute_grouped(plan_j, jk, j_fp)
    _same(first, j1[0], "grouped vs jax")
    _reports_equal(rep1, j1[1])
    _reports_equal(rep2, j2[1])
    assert texec.grouped_cache_probe(plan_t, tk, _spec_fp(verb, ncases),
                                     device="cpu")["fresh"] == 0


def test_state_cache_key_holds_the_device(log):
    """A state folded for one device type is never served to a collect on
    another: each unit's key carries the device type and its lowering, and
    the spec fingerprint has JAX's signature and shape."""
    path, whole, ncases = log
    fp = _spec_fp("dfg", ncases)
    j_fp = jstatecache.spec_fingerprint("dfg", jengine.Dims(A, ncases))
    assert fp == j_fp[:-1]              # JAX's minus its resolved lowering
    ph = tq.compile_plan(tq.Plan(path))
    item = ph.unit_schedule()[0]
    on_cpu = texec._unit_key(ph, item, fp, "cpu")
    on_card = texec._unit_key(ph, item, fp, "cuda")
    assert on_cpu != on_card
    assert on_cpu[1:3] == ("cpu", "ref") and on_card[1:3] == ("cuda", "cuda")


def _stream(src):
    out = []
    for ch in src:
        out.append(({k: _host(v) for k, v in ch.columns.items()},
                    {k: _host(v) for k, v in ch.valid.items()},
                    _host(ch.rows_valid())))
    return out


@pytest.mark.parametrize("pred", ["time_range", "variant_in"])
def test_prefetch_stream_is_bitwise_the_same(log, pred):
    """The chunk stream (every column, epsilon flag and row mask) is the
    same with the read-ahead off, 1, 2 or 4 groups ahead and at the default
    window, over a file of more groups than the window."""
    path, whole, ncases = log
    plan = _plan(tq, path, "time_range")
    if pred == "variant_in":
        fps = tcore.variants.variant_fingerprints(whole)
        pairs = {(int(fps[0][i]), int(fps[1][i])) for i in (3, 40, 41)}
        plan = tq.Plan(path).filter(tq.col(ACTIVITY) != 7).filter(
            tq.variant_in(pairs))
    streams = []
    for depth in (0, 1, 2, 4, None):
        src, rep = tq.pruned_source(plan, sketch=True, prefetch=depth,
                                    device="cpu")
        assert rep.prefetch == texec.prefetch_depth(depth)
        assert rep.groups_read > rep.prefetch
        streams.append(_stream(src))
    assert len(streams[0]) >= 3
    for other in streams[1:]:
        assert len(other) == len(streams[0])
        for (c0, v0, r0), (c1, v1, r1) in zip(streams[0], other):
            assert set(c0) == set(c1) and set(v0) == set(v1)
            for k in c0:
                np.testing.assert_array_equal(c0[k], c1[k])
            for k in v0:
                np.testing.assert_array_equal(v0[k], v1[k])
            np.testing.assert_array_equal(r0, r1)


def _tracked(reader, monkeypatch, slow=None, fail=None):
    """Wrap ``reader.read_group_numpy``: the decodes running now and the
    groups started, group ``fail`` raising, group ``g`` taking
    ``slow(g)`` seconds first."""
    real = reader.read_group_numpy
    lock = threading.Lock()
    state = {"running": 0, "started": []}

    def read(index, columns=None):
        with lock:
            state["running"] += 1
            state["started"].append(index)
        try:
            if slow is not None:
                time.sleep(slow(index))
            if index == fail:
                raise OSError("disk gone")
            return real(index, columns)
        finally:
            with lock:
                state["running"] -= 1

    monkeypatch.setattr(reader, "read_group_numpy", read)
    return state


@pytest.mark.parametrize("workers", [1, 4])
def test_prefetch_worker_error_reaches_the_consumer(log, monkeypatch,
                                                    workers):
    """A decode failing at group 3 raises at the consumer's group 3, after
    groups 0..2 arrived as they do without the read-ahead; no decode is
    left running when the error reaches the consumer."""
    path, _, _ = log
    plan = tq.Plan(path)
    want = _stream(tq.pruned_source(plan, prefetch=0, device="cpu")[0])
    pool = ThreadPoolExecutor(workers, thread_name_prefix="test-decode")
    monkeypatch.setattr(texec, "_pool", (os.getpid(), pool))
    try:
        state = _tracked(tedf.pooled_reader(path), monkeypatch,
                         slow=lambda g: 0.02 * (g > 3), fail=3)
        src, _ = tq.pruned_source(plan, prefetch=workers, device="cpu")
        got = []
        with pytest.raises(OSError, match="disk gone"):
            for ch in src:
                got.append(ch)
        assert state["running"] == 0
    finally:
        pool.shutdown()
    got = _stream(got)
    assert len(got) == 3
    for (c0, _, r0), (c1, _, r1) in zip(want, got):
        for k in c0:
            np.testing.assert_array_equal(c0[k], c1[k])
        np.testing.assert_array_equal(r0, r1)


def test_an_abandoned_scan_leaves_no_decode_running(log, monkeypatch):
    """A consumer that takes one chunk of four groups ahead and closes the
    stream: ``close()`` returns with no decode running and none starts
    after it, and the process's pool has no more threads than its size."""
    path, _, _ = log
    state = _tracked(tedf.pooled_reader(path), monkeypatch,
                     slow=lambda g: 0.3 * (g > 0))
    src, _ = tq.pruned_source(tq.Plan(path), prefetch=4, device="cpu")
    stream = iter(src)
    next(stream)
    stream.close()
    assert state["running"] == 0
    started = list(state["started"])
    assert started[0] == 0 and len(started) <= 1 + 4 + 1
    time.sleep(0.1)
    assert state["started"] == started
    pool = texec._decode_pool()
    threads = [t for t in threading.enumerate()
               if t.name.startswith("repro-decode")]
    assert 0 < len(threads) <= pool._max_workers == texec._pool_size()


class _Refusing:
    """A pool that takes ``n`` submissions and then refuses, as one does
    once the interpreter shuts down."""

    def __init__(self, pool, n):
        self.pool, self.n = pool, n

    def submit(self, fn, *args):
        if self.n == 0:
            raise RuntimeError("cannot schedule new futures")
        self.n -= 1
        return self.pool.submit(fn, *args)


def test_a_refused_submit_leaves_no_decode_running(log, monkeypatch):
    """The pool refusing group 2's submission while group 0 still decodes:
    the error reaches the consumer, and no decode is running by then —
    group 0's among them, though it was the one being taken."""
    path, _, _ = log
    state = _tracked(tedf.pooled_reader(path), monkeypatch,
                     slow=lambda g: 0.3 * (g == 0))
    pool = ThreadPoolExecutor(2, thread_name_prefix="test-decode")
    monkeypatch.setattr(texec, "_decode_pool", lambda: _Refusing(pool, 2))
    try:
        src, _ = tq.pruned_source(tq.Plan(path), prefetch=2, device="cpu")
        with pytest.raises(RuntimeError, match="cannot schedule"):
            for _ in src:
                pass
        assert state["running"] == 0
        assert sorted(state["started"]) == [0, 1]
    finally:
        pool.shutdown()


class _Decoded:
    """A reader whose group ``g`` decodes to ``g``."""

    @staticmethod
    def read_group_numpy(index, columns=None):
        return index


class _RunAtOnce:
    """A pool that decodes each group when it is submitted, and records it."""

    def __init__(self):
        self.submitted = []

    def submit(self, fn, *args):
        self.submitted.append(args[0])
        fut = Future()
        fut.set_result(fn(*args))
        return fut


@pytest.mark.parametrize("reads", [3, 12])
@pytest.mark.parametrize("cores,window", [(1, 1), (4, 3), (64, 8)])
def test_the_default_window_follows_the_host_cores(monkeypatch, cores,
                                                   window, reads):
    """The default window is the cores the process may use less one, 1 to
    8; the env var and an explicit argument win, and 0 disables.  Taking
    read group *k* leaves the next ``window`` groups submitted, bounded by
    the groups the schedule reads; ghosts pass through on the consumer."""
    monkeypatch.delenv("REPRO_QUERY_PREFETCH", raising=False)
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    assert texec.prefetch_depth() == window
    assert (texec.prefetch_depth(5), texec.prefetch_depth(0)) == (5, 0)
    monkeypatch.setenv("REPRO_QUERY_PREFETCH", "2")
    assert (texec.prefetch_depth(), texec.prefetch_depth(3)) == (2, 3)
    monkeypatch.setenv("REPRO_QUERY_PREFETCH", "0")
    assert texec.prefetch_depth() == 0
    monkeypatch.delenv("REPRO_QUERY_PREFETCH")

    pool = _RunAtOnce()
    monkeypatch.setattr(texec, "_decode_pool", lambda: pool)
    ghost = GhostItem((99,), 1, 0, {})
    schedule = [ReadItem(g, (), ()) for g in range(reads)]
    schedule.insert(1, ghost)
    ready = texec._read_ahead.ready
    taken = []
    for item, host in texec._read_ahead(_Decoded, schedule, (),
                                        texec.prefetch_depth()):
        if item is ghost:
            assert host is None
            continue
        taken.append(host)
        assert len(pool.submitted) == min(window + len(taken), reads)
    assert taken == pool.submitted == list(range(reads))
    assert texec._read_ahead.ready - ready == reads


@pytest.mark.parametrize("cpus,window", [(None, 1), (1, 1), (4, 3),
                                         (64, 8)])
def test_the_default_window_without_an_affinity_call(monkeypatch, cpus,
                                                     window):
    """Where the platform has no ``os.sched_getaffinity``, the default
    window counts every core ``os.cpu_count`` sees (none known: one)."""
    monkeypatch.delenv("REPRO_QUERY_PREFETCH", raising=False)
    monkeypatch.delattr(os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    assert texec._pool_size() == texec.prefetch_depth() == window


def test_concurrent_scans_share_the_pool(log):
    """Twelve scans at once, the interpreter switching threads every 10
    microseconds: each stream is the serial one, the read-ahead counted
    every group once, and the pool's threads stay at its size."""
    path, _, _ = log
    plan = tq.Plan(path)
    src, rep = tq.pruned_source(plan, prefetch=0, device="cpu")
    want = _stream(src)
    before = trace.counters()
    got, errors = {}, []

    def scan(i):
        try:
            got[i] = _stream(tq.pruned_source(plan, device="cpu")[0])
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=scan, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    after = trace.counters()
    assert (after["scan_ahead_ready"] + after["scan_ahead_waited"]
            - before["scan_ahead_ready"] - before["scan_ahead_waited"]) \
        == 12 * rep.groups_read
    for i in range(12):
        assert len(got[i]) == len(want)
        for (c0, v0, r0), (c1, v1, r1) in zip(want, got[i]):
            for k in c0:
                np.testing.assert_array_equal(c0[k], c1[k])
            np.testing.assert_array_equal(r0, r1)
    pool = texec._decode_pool()
    assert len([t for t in threading.enumerate()
                if t.name.startswith("repro-decode")]) <= pool._max_workers


def test_variant_in_resolves_from_header_sketches(log):
    """variant_in decides its keep mask with no phase-one I/O; the result
    equals the eager mask broadcast, and JAX's."""
    path, whole, ncases = log
    fp1, fp2, seg = tcore.variants.variant_fingerprints(whole)
    pairs = [(int(fp1[i]), int(fp2[i])) for i in (0, 7, 99)]
    got, rep = tq.execute(tq.Plan(path).filter(tq.variant_in(pairs)),
                          mine=tcore.dfg_kernel(A), device="cpu")
    want, j_rep = jq.execute(jq.Plan(path).filter(jq.variant_in(pairs)),
                             mine=jcore.dfg_kernel(A))
    assert rep.phase1_groups_read == 0 and rep.groups_skipped >= 0
    _same(got, want, "variant_in vs jax")
    _reports_equal(rep, j_rep)
    keep_case = np.zeros(ncases, bool)
    for a, b in pairs:
        keep_case |= (_host(fp1)[:ncases] == a) & (_host(fp2)[:ncases] == b)
    rows = torch.from_numpy(keep_case[_host(seg)])
    _same(got, tengine.run_single(tcore.dfg_kernel(A), tops.proj(whole, rows)))


def test_execute_frame_matches_compact(log):
    path, whole, ncases = log
    plan = (tq.Plan(path).filter(tq.col(CASE).between(90, 140))
            .project([CASE, ACTIVITY]))
    frame, tables, rep = tq.execute_frame(plan, device="cpu")
    c = whole[CASE]
    ref = tops.proj(whole, (c >= 90) & (c <= 140)).compact()
    assert set(frame.names) == {CASE, ACTIVITY}
    for k in frame.names:
        np.testing.assert_array_equal(_host(frame[k]), _host(ref[k]))
    jframe, jtables, jrep = jq.execute_frame(
        jq.Plan(path).filter(jq.col(CASE).between(90, 140))
        .project([CASE, ACTIVITY]))
    assert tables == jtables and ACTIVITY in tables
    _reports_equal(rep, jrep)
    empty, etables, erep = tq.execute_frame(
        tq.Plan(path).filter(tq.col(ACTIVITY) >= 100).project([CASE]),
        device="cpu")
    assert empty.nrows == 0 and set(empty.names) == {CASE}
    assert erep.groups_read == 0 and ACTIVITY not in etables


@pytest.mark.parametrize("version", [1, 2])
def test_older_versions_prune_via_synthesized_zones(tmp_path, log, version):
    path, whole, ncases = log
    jwhole, jtables = jedf.read(path)
    p = str(tmp_path / f"old{version}.edf")
    kw = {"row_group_rows": 199} if version == 2 else {}
    jedf.write(p, jwhole, jtables, version=version, **kw)
    c = whole[CASE]
    ref_frame = tops.proj(whole, (c >= 90) & (c <= 140))
    for verb in ("dfg", "variants"):
        kernel = tengine.kernel_spec(verb).make(tengine.Dims(A, ncases))
        got, rep = tq.execute(tq.Plan(p).filter(tq.col(CASE).between(90, 140)),
                              mine=kernel, device="cpu")
        _same(got, tengine.run_single(kernel, ref_frame), f"v{version} {verb}")
        _, j_rep = jq.execute(jq.Plan(p).filter(jq.col(CASE).between(90, 140)),
                              mine=jengine.kernel_spec(verb).make(
                                  jengine.Dims(A, ncases)))
        _reports_equal(rep, j_rep)
        if version == 2:
            assert rep.groups_skipped > 0


def test_multi_file_plan_matches_jax(tmp_path, log):
    """scan_many over two files split inside a case: one kernel across both
    pruned scans == JAX, report (with its per-file parts) == JAX's."""
    path, whole, ncases = log
    jwhole, jtables = jedf.read(path)
    case = np.asarray(jwhole[CASE])
    cut = next(i for i in range(case.size // 2, case.size)
               if case[i - 1] == case[i])
    paths = [str(tmp_path / f"{k}.edf") for k in "ab"]
    for p, (lo, hi) in zip(paths, ((0, cut), (cut, case.size))):
        part = jcore.EventFrame({k: v[lo:hi] for k, v in jwhole.columns.items()},
                                {k: v[lo:hi] for k, v in jwhole.valid.items()})
        jedf.write(p, part, jtables, row_group_rows=97)
    for name in ("eq_case_band", "contains"):
        tplan = _plan(tq, paths[0], name)
        tplan = tq.MultiPlan(tuple(paths), tplan.steps)
        jplan = jq.MultiPlan(tuple(paths), _plan(jq, paths[0], name).steps)
        assert tq.count_cases(tplan) == jq.count_cases(jplan) == ncases
        for verb in ("dfg", "variants", "case_sizes"):
            got, rep = tq.execute(tplan, mine=tengine.kernel_spec(verb).make(
                tengine.Dims(A, ncases)), device="cpu")
            want, j_rep = jq.execute(jplan, mine=jengine.kernel_spec(verb).make(
                jengine.Dims(A, ncases)))
            _same(got, want, f"{name}/{verb}")
            _reports_equal(rep, j_rep)


def test_reader_pool_and_stale_file_after_append(tmp_path):
    """An append replaces the file: a reader that cached the old header
    raises StaleFileError when it reopens, the pool hands out a fresh one,
    and the old groups keep their content signatures."""
    frame, tables = jsyn.generate(num_cases=40, num_activities=5, seed=3)
    p = str(tmp_path / "grow.edf")
    jedf.write(p, frame, tables, row_group_rows=64)
    reader = tedf.pooled_reader(p)
    assert tedf.pooled_reader(p) is reader
    sigs = [reader.group_signature(g) for g in range(reader.num_groups)]
    before = reader.read_group(0, device="cpu")
    sig0 = tedf.file_sig(p)
    assert sig0[2] == tedf.header_tag(p) == reader.header["stamp"]
    more, _ = jsyn.generate(num_cases=10, num_activities=5, seed=4)
    more = jcore.EventFrame(
        {k: (v + 40 if k == CASE else v) for k, v in more.columns.items()},
        more.valid)
    jedf.append(p, more, row_group_rows=64)
    assert tedf.file_sig(p) != sig0
    reader.close()
    with pytest.raises(tedf.StaleFileError):
        reader.read_group(0, device="cpu")
    fresh = tedf.pooled_reader(p)
    assert fresh is not reader and fresh.num_groups > len(sigs)
    assert [fresh.group_signature(g) for g in range(len(sigs))] == sigs
    again = fresh.read_group(0, device="cpu")
    for k in before.names:
        assert torch.equal(again[k], before[k])
    jw, _ = jedf.read(p)
    got, _ = tq.execute(tq.Plan(p).filter(tq.col(CASE) >= 30),
                        mine=tcore.dfg_kernel(5), device="cpu")
    want, _ = jq.execute(jq.Plan(p).filter(jq.col(CASE) >= 30),
                         mine=jcore.dfg_kernel(5))
    _same(got, want, "after append")
    with fresh.pin():
        fresh.close()
        assert not fresh.closed         # close deferred while pinned
    assert fresh.closed


def test_plan_surface(log):
    path, _, _ = log
    plan = tq.Plan(path).filter(tq.col(ACTIVITY) == 1).project([CASE, ACTIVITY])
    assert "scan" in plan.describe() and "project" in plan.describe()
    with pytest.raises(KeyError):
        tq.execute(tq.Plan(path).filter(tq.col("nope") == 1),
                   mine=tcore.dfg_kernel(A), device="cpu")
    with pytest.raises(TypeError):
        tq.Plan(path).filter("not a predicate")
    with pytest.warns(DeprecationWarning):
        assert tq.scan(path) == tq.Plan(path)
    assert tq.scan_many([path, path]).paths == (path, path)
    assert sorted(tq.__all__) == sorted(jq.__all__)
    assert os.path.getsize(path) == tedf.file_sizes(path)["total"]
