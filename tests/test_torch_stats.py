"""PyTorch port, statistics path: each stats kernel, the fused
``stats_kernel``, the whole-log entry points and the streaming front doors,
held bitwise (tolerance 0) against ``repro.core.stats`` on the same numpy
logs.  The values are integer counts, float32 min/max and float32 sums
folded in row order, so no comparison needs a tolerance: the sojourn
totals are folded onto the running state one row at a time in both
packages, whatever the chunking."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402

import jax.numpy as jnp  # noqa: E402

A = 7
STATS = ("activity_counts", "case_sizes", "case_durations", "sojourn_times")


def _log(seed, n_cases=30, max_len=11, masked=0.0):
    """A (case, time)-sorted log; each case starts near 0 and its gaps span
    four decades, so the float32 sojourn totals round and any regrouping of
    the additions shows."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64), lens)
    act = rng.integers(0, A, case.size).astype(np.int32)
    gaps = rng.exponential(3.7, case.size) * 10.0 ** rng.integers(-2, 3, case.size)
    first = np.cumsum(lens) - lens
    within = np.cumsum(gaps) - np.repeat(np.cumsum(gaps)[first] - gaps[first], lens)
    ts = (rng.random(n_cases)[case] * 10 + within).astype(np.float32)
    rv = rng.random(case.size) >= masked if masked else None
    return {CASE: case, ACTIVITY: act, TIMESTAMP: ts}, rv, n_cases


def _frames(cols, rv):
    jf = jcore.EventFrame.from_numpy(cols)
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    if rv is not None:
        jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
        tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _eq(got, want, msg=""):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor), msg
    got = got.cpu().numpy()
    assert got.dtype == want.dtype, f"{msg}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _eq_stats(got: dict, want: dict, msg=""):
    assert set(got) == set(want) == set(STATS)
    for k in STATS:
        _eq(got[k], want[k], f"{msg}:{k}")


@pytest.mark.parametrize("masked", [0.0, 0.3])
@pytest.mark.parametrize("backend", [None, "ref", "cuda"])
def test_whole_log_entry_points_match_jax(masked, backend):
    cols, rv, nc = _log(1, masked=masked)
    jf, tf = _frames(cols, rv)
    # "cuda" on CPU tensors: the kernels' wrappers take the plain versions
    for name, arg in (("case_sizes", nc + 3), ("case_durations", nc + 3),
                      ("activity_counts", A), ("sojourn_times", A)):
        got = getattr(tstats, name)(tf, arg, backend)
        _eq(got, getattr(jstats, name)(jf, arg), f"{name} backend={backend}")


@pytest.mark.parametrize("num_cases", [1, 17, 30])
def test_case_kernels_drop_segments_past_num_cases(num_cases):
    cols, rv, _ = _log(2, masked=0.2)
    jf, tf = _frames(cols, rv)
    _eq(tstats.case_sizes(tf, num_cases), jstats.case_sizes(jf, num_cases))
    _eq(tstats.case_durations(tf, num_cases), jstats.case_durations(jf, num_cases))


def test_each_kernel_update_and_state_match_jax():
    cols, rv, nc = _log(3, masked=0.25)
    jf, tf = _frames(cols, rv)
    for name, arg in (("case_sizes", nc), ("case_durations", nc),
                      ("activity_counts", A), ("sojourn_times", A)):
        tk = getattr(tstats, name + "_kernel")(arg)
        jk = getattr(jstats, name + "_kernel")(arg)
        ts_, tc = tk.init("cpu")
        js_, jc = jk.init()
        ts_, tc = tk.update(ts_, tc, tf)
        js_, jc = jk.update(js_, jc, jf)
        tleaves = ts_ if isinstance(ts_, tuple) else (ts_,)
        jleaves = js_ if isinstance(js_, tuple) else (js_,)
        for t, j in zip(tleaves, jleaves):
            _eq(t, j, f"{name} state")
        for key in ("case", "act", "ts", "rv", "exists") + (
                ("seg",) if "seg" in jc else ()):
            assert tc[key].item() == np.asarray(jc[key]).item(), (name, key)
        _eq(tk.finalize(ts_, tc), jk.finalize(js_, jc), f"{name} finalize")


def _chunkings(cols, n):
    case = cols[CASE]
    _, starts, counts = np.unique(case, return_index=True, return_counts=True)
    k = int(np.argmax(counts))
    lo, ln = int(starts[k]), int(counts[k])
    assert ln >= 4
    return {
        "rows1": ("rows", 1), "rows7": ("rows", 7), "rows13": ("rows", 13),
        # the longest case in 4 pieces: it straddles 3 chunk boundaries
        "straddle3": ("cuts", [lo + 1, lo + ln // 2, lo + ln - 1]),
        "random": ("cuts", sorted(np.random.default_rng(9).integers(1, n, 6).tolist())),
    }


def _source(pkg, frame, how):
    kind, arg = how
    if kind == "rows":
        return pkg.ChunkedEventFrame.from_frame(frame, arg)
    return pkg.ChunkedEventFrame.from_cuts(frame, arg)


@pytest.mark.parametrize("chunking", ["rows1", "rows7", "rows13", "straddle3", "random"])
@pytest.mark.parametrize("masked", [0.0, 0.3])
def test_streamed_stats_equal_whole_log(chunking, masked):
    cols, rv, nc = _log(5, n_cases=20, max_len=12, masked=masked)
    jf, tf = _frames(cols, rv)
    how = _chunkings(cols, tf.nrows)[chunking]
    whole = jengine.run_single(jstats.stats_kernel(A, nc), jf)
    got = tcore.run_streaming(tstats.stats_kernel(A, nc), _source(tcore, tf, how))
    _eq_stats(got, whole, f"stream {chunking} vs jax whole-log")
    _eq_stats(got, tengine.run_single(tstats.stats_kernel(A, nc), tf),
              "stream vs port whole-log")
    if chunking in ("rows7", "straddle3"):   # one JAX compile per chunk shape
        jgot = jcore.run_streaming(jstats.stats_kernel(A, nc),
                                   _source(jcore, jf, how))
        _eq_stats(got, jgot, f"stream {chunking} vs jax stream")


@pytest.mark.parametrize("chunk_rows", [1, 4, 9])
def test_streaming_front_doors_match_jax(chunk_rows):
    cols, rv, nc = _log(6, n_cases=12, masked=0.1)
    jf, tf = _frames(cols, rv)
    src = tcore.ChunkedEventFrame.from_frame(tf, chunk_rows)
    for name, arg in (("activity_counts", A), ("case_sizes", nc),
                      ("case_durations", nc), ("sojourn_times", A)):
        got = getattr(tengine, "streaming_" + name)(src, arg)
        _eq(got, getattr(jstats, name)(jf, arg), f"streaming_{name}")


def test_sojourn_stream_is_the_row_order_fold():
    """The streamed sojourn totals equal the numpy row-order fold (np.add.at
    in float32), and differ from summing each chunk first."""
    cols, _, nc = _log(7, n_cases=400, max_len=15)
    _, tf = _frames(cols, None)
    n = tf.nrows
    case, act, ts = cols[CASE], cols[ACTIVITY], cols[TIMESTAMP]
    pair = np.concatenate([[False], case[1:] == case[:-1]])
    prev = np.concatenate([[0], act[:-1]]).astype(np.int64)
    dt = np.where(pair, ts - np.concatenate([[0], ts[:-1]]).astype(np.float32),
                  np.float32(0)).astype(np.float32)
    tot = np.zeros(A, np.float32)
    np.add.at(tot, prev, dt)
    cnt = np.bincount(prev[pair], minlength=A).astype(np.int32)
    want = tot / np.maximum(cnt, 1).astype(np.float32)
    kern = tstats.sojourn_times_kernel(A)
    for rows in (3, 50, n):
        got = tcore.run_streaming(kern, tcore.ChunkedEventFrame.from_frame(tf, rows))
        np.testing.assert_array_equal(got.numpy(), want)
    # the chunk-first sum (the fold this kernel must not do) differs
    state, carry = kern.init("cpu")
    chunk_first = torch.zeros(A, dtype=torch.float32)
    for chunk in tcore.ChunkedEventFrame.from_frame(tf, 7):
        (part, _), carry = kern.update((torch.zeros(A), state[1]), carry, chunk)
        chunk_first = chunk_first + part
    assert not torch.equal(chunk_first, torch.from_numpy(tot))


def test_stats_kernel_columns_registry_and_compose():
    cols, rv, nc = _log(8, masked=0.2)
    jf, tf = _frames(cols, rv)
    kern = tstats.stats_kernel(A, nc)
    assert kern.columns == jstats.stats_kernel(A, nc).columns
    assert kern.mask_exact
    for name in STATS + ("stats",):
        spec, jspec = tengine.kernel_spec(name), jengine.kernel_spec(name)
        assert spec.columns == jspec.columns, name
        got = tengine.run_single(spec.make(tengine.Dims(A, nc)), tf)
        want = jengine.run_single(jspec.make(jengine.Dims(A, nc)), jf)
        if name == "stats":
            _eq_stats(got, want, "spec stats")
        else:
            _eq(got, want, f"spec {name}")
    # compose of two members == each alone; merge is the members' merges
    fused = tengine.compose({"a": tstats.activity_counts_kernel(A),
                             "s": tstats.case_sizes_kernel(nc)})
    assert fused.columns == tengine.union_columns(
        [(ACTIVITY, CASE), (ACTIVITY, CASE)]) == (ACTIVITY, CASE)
    assert tengine.union_columns([(ACTIVITY,), ()]) == ()
    out = tengine.run_single(fused, tf)
    _eq(out["a"], jstats.activity_counts(jf, A))
    _eq(out["s"], jstats.case_sizes(jf, nc))
    s1, _ = fused.update(*fused.init("cpu"), tf)
    merged = fused.merge(s1, s1)
    _eq(merged["a"], 2 * np.asarray(jstats.activity_counts(jf, A)))
    # the JAX package's backend names carry over ("pallas": the kernels,
    # their plain versions on a CPU tensor); an unknown name still raises
    _eq(tengine.run_single(tstats.case_sizes_kernel(nc, "pallas"), tf),
        jstats.case_sizes(jf, nc, "pallas"))
    with pytest.raises(ValueError):
        tstats.case_sizes_kernel(nc, "tpu")


def test_durations_of_masked_and_single_event_cases():
    cols = {CASE: np.array([0, 0, 1, 2, 2, 2], np.int64),
            ACTIVITY: np.array([0, 1, 2, 0, 0, 1], np.int32),
            TIMESTAMP: np.array([1.5, 4.0, 7.0, 9.0, 9.5, 30.25], np.float32)}
    rv = np.array([True, True, True, False, False, False])
    jf, tf = _frames(cols, rv)
    got = tstats.case_durations(tf, 4)
    _eq(got, jstats.case_durations(jf, 4))
    np.testing.assert_array_equal(got.numpy(), np.array([2.5, 0, 0, 0], np.float32))
    _eq(tstats.case_sizes(tf, 4), jstats.case_sizes(jf, 4))


def _empty_frames():
    cols = {CASE: np.zeros(0, np.int64), ACTIVITY: np.zeros(0, np.int32),
            TIMESTAMP: np.zeros(0, np.float32)}
    return _frames(cols, None)


@pytest.mark.parametrize("name", STATS + ("stats",))
def test_zero_row_frame_raises_like_jax(name):
    """On a 0-row frame JAX's whole-log statistics raise (its carry update
    reads row -1); the port raises too, with its own exception type."""
    jf, tf = _empty_frames()
    arg = 4 if name in ("case_sizes", "case_durations") else A
    if name == "stats":
        jcall = lambda: jengine.run_single(jstats.stats_kernel(A, 4), jf)  # noqa: E731
        tcall = lambda: tengine.run_single(tstats.stats_kernel(A, 4), tf)  # noqa: E731
    else:
        jcall = lambda: getattr(jstats, name)(jf, arg)  # noqa: E731
        tcall = lambda: getattr(tstats, name)(tf, arg)  # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(Exception):
            jcall()
    with pytest.raises((RuntimeError, IndexError)):
        tcall()
    # a stream skips empty chunks: an empty source with a device gives the
    # kernel's initial state, finalized
    src = tcore.ChunkedEventFrame.from_frame(tf, 3)
    kern = (tstats.stats_kernel(A, 4) if name == "stats"
            else getattr(tstats, name + "_kernel")(arg))
    out = tcore.run_streaming(kern, src)
    first = out["activity_counts"] if name == "stats" else out
    assert first.device.type == "cpu"
