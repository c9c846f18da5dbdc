"""PyTorch port, performance overlays: ``performance_dfg``,
``eventually_follows`` and ``remaining_time_targets`` whole-log and
streamed (each kernel alone and the two composed in one pass), with
masked rows, held against ``repro.core.performance`` on the same numpy
logs with both of its lowerings (``impl="xla"`` and the Pallas kernels in
interpret mode).  Tolerance 0: edge and EFG counts are integers (the EFG
prefix counts integer-valued float32 below 2^24), the float32 wait totals
are folded onto the running state in row order in both packages, and
``remaining_time_targets`` is a float32 max and one subtraction."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import performance as jperf  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import performance as tperf  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402

A = 6


def _log(seed, n_cases=30, max_len=11, masked=0.0):
    """A (case, time)-sorted log whose gaps span four decades, so the
    float32 wait totals round and any regrouping of the additions shows."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64), lens)
    act = rng.integers(0, A, case.size).astype(np.int32)
    gaps = rng.exponential(3.7, case.size) * 10.0 ** rng.integers(-2, 3, case.size)
    first = np.cumsum(lens) - lens
    within = np.cumsum(gaps) - np.repeat(np.cumsum(gaps)[first] - gaps[first], lens)
    ts = (rng.random(n_cases)[case] * 10 + within).astype(np.float32)
    rv = rng.random(case.size) >= masked if masked else None
    return {CASE: case, ACTIVITY: act, TIMESTAMP: ts}, rv


def _frames(cols, rv):
    jf = jcore.EventFrame.from_numpy(cols)
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    if rv is not None:
        jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
        tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _eq(got, want, msg=""):
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype, f"{msg}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("masked", [0.0, 0.3])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_whole_log_entry_points_match_jax(masked, impl):
    cols, rv = _log(1, masked=masked)
    jf, tf = _frames(cols, rv)
    for g, w, nm in zip(tperf.performance_dfg(tf, A), jperf.performance_dfg(jf, A, impl),
                        ("counts", "mean_wait")):
        _eq(g, w, nm)
    _eq(tperf.eventually_follows(tf, A), jperf.eventually_follows(jf, A, impl), "efg")
    _eq(tperf.remaining_time_targets(tf), jperf.remaining_time_targets(jf, impl),
        "remaining")


def _cuts(n, chunking):
    rng = np.random.default_rng(n)
    return {"one_row": list(range(1, n)),
            "random": sorted(rng.integers(1, n, 5).tolist()),
            "halves": [n // 2]}[chunking]


@pytest.mark.parametrize("chunking", ["one_row", "random", "halves"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_streamed_kernels_match_jax(chunking, impl):
    cols, rv = _log(2, n_cases=10 if chunking == "one_row" else 30, masked=0.2)
    jf, tf = _frames(cols, rv)
    cuts = _cuts(tf.nrows, chunking)
    jk = jcore.compose({"p": jperf.performance_dfg_kernel(A, impl),
                        "e": jperf.eventually_follows_kernel(A, impl)})
    tk = tengine.compose({"p": tperf.performance_dfg_kernel(A),
                          "e": tperf.eventually_follows_kernel(A)})
    want = jcore.run_streaming(jk, jcore.ChunkedEventFrame.from_cuts(jf, cuts))
    got = tcore.run_streaming(tk, tcore.ChunkedEventFrame.from_cuts(tf, cuts))
    for g, w, nm in zip(got["p"], want["p"], ("counts", "mean_wait")):
        _eq(g, w, f"{chunking}:{nm}")
    _eq(got["e"], want["e"], f"{chunking}:efg")
    # streaming == whole-log, in the port alone
    for g, w in zip(got["p"], tperf.performance_dfg(tf, A)):
        _eq(g, w.numpy())
    _eq(got["e"], tperf.eventually_follows(tf, A).numpy())


def test_efg_counts_equal_a_case_by_case_count():
    cols, rv = _log(3, masked=0.25)
    _, tf = _frames(cols, rv)
    case, act = cols[CASE], cols[ACTIVITY]
    want = np.zeros((A, A), np.int32)
    for c in np.unique(case):
        a = act[(case == c) & rv]
        for i in range(a.size):
            np.add.at(want[a[i]], a[i + 1:], 1)
    _eq(tperf.eventually_follows(tf, A), want)


def test_registry_and_front_doors():
    cols, _ = _log(4)
    jf, tf = _frames(cols, None)
    src = tcore.ChunkedEventFrame.from_frame(tf, 17)
    jsrc = jcore.ChunkedEventFrame.from_frame(jf, 17)
    for g, w in zip(tengine.streaming_performance_dfg(src, A),
                    jcore.engine.streaming_performance_dfg(jsrc, A)):
        _eq(g, w)
    _eq(tengine.streaming_eventually_follows(src, A),
        jcore.engine.streaming_eventually_follows(jsrc, A))
    for name, cols_ in (("performance_dfg", (ACTIVITY, CASE, TIMESTAMP)),
                        ("eventually_follows", (ACTIVITY, CASE))):
        spec = tengine.kernel_spec(name)
        assert spec.columns == cols_
        assert spec.make(tengine.Dims(A, 30)).columns == cols_
