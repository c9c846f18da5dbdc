"""PyTorch port, filtering path: membership and time-range masks, the
event- and case-level filters, the two-pass streaming case filter (and the
DFG of what it keeps), and the most common activity, held bitwise
(tolerance 0: boolean masks and integer counts) against
``repro.core.filtering`` on the same numpy logs."""
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import filtering as jfilt  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import filtering as tfilt  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402

jdfg = importlib.import_module("repro.core.dfg")
tdfg = importlib.import_module("repro_torch.core.dfg")

A = 6


def _log(seed, n_cases=30, max_len=9, masked=0.0, ts_missing=0.0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64) * 2 + 1, lens)
    act = rng.integers(0, A, case.size).astype(np.int32)
    ts = np.round(rng.random(case.size) * 100, 2).astype(np.float32)
    cols = {CASE: case, ACTIVITY: act, TIMESTAMP: ts,
            "attr0": rng.integers(0, 4, case.size).astype(np.int32)}
    valid = {TIMESTAMP: rng.random(case.size) >= ts_missing} if ts_missing else None
    rv = rng.random(case.size) >= masked if masked else None
    return cols, valid, rv


def _frames(cols, valid=None, rv=None):
    jf = jcore.EventFrame.from_numpy(cols, valid)
    tf = tcore.EventFrame.from_numpy(cols, valid, device="cpu")
    if rv is not None:
        jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
        tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _eq(got, want, msg=""):
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype, f"{msg}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _quiet(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args)


# ------------------------------------------------------------- masks
@pytest.mark.parametrize("values", [[2], [5, 0, 0, 3], [], [9, -1], list(range(A)),
                                    np.array([1, 4], np.int32)])
def test_isin_mask_matches_jax(values):
    col = np.random.default_rng(1).integers(-1, A + 2, 500).astype(np.int32)
    got = tfilt.isin_mask(torch.from_numpy(col), values)
    _eq(got, jfilt.isin_mask(jnp.asarray(col), jnp.asarray(values, jnp.int32)))
    np.testing.assert_array_equal(got.numpy(), np.isin(col, values))


def test_isin_mask_on_int64_and_float_columns():
    case = np.arange(0, 40, 3, dtype=np.int64)
    np.testing.assert_array_equal(
        tfilt.isin_mask(torch.from_numpy(case), [3, 4, 39]).numpy(),
        np.isin(case, [3, 4, 39]))
    ts = np.array([0.5, 1.0, 2.25, 3.0], np.float32)
    _eq(tfilt.isin_mask(torch.from_numpy(ts), [1.0, 2.25]),
        jfilt.isin_mask(jnp.asarray(ts), [1.0, 2.25]))


@pytest.mark.parametrize("lo,hi", [(10.0, 60.0), (0.0, 0.0), (99.0, 5.0), (-1, 200)])
@pytest.mark.parametrize("missing,masked", [(0.0, 0.0), (0.3, 0.0), (0.3, 0.2)])
def test_time_range_mask_matches_jax(lo, hi, missing, masked):
    cols, valid, rv = _log(2, masked=masked, ts_missing=missing)
    jf, tf = _frames(cols, valid, rv)
    _eq(tfilt.time_range_mask(tf, TIMESTAMP, lo, hi),
        jfilt.time_range_mask(jf, TIMESTAMP, lo, hi))


# ------------------------------------------------------ event level
@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("masked", [0.0, 0.25])
def test_event_level_filters_match_jax(keep, masked):
    cols, valid, rv = _log(3, masked=masked, ts_missing=0.2)
    jf, tf = _frames(cols, valid, rv)
    with pytest.warns(DeprecationWarning, match="filter_attr_values"):
        got = tfilt.filter_attr_values(tf, ACTIVITY, [1, 3], keep)
    want = _quiet(jfilt.filter_attr_values, jf, ACTIVITY, [1, 3], keep)
    _eq(got.rows_valid(), want.rows_valid())
    assert got[ACTIVITY] is tf[ACTIVITY]            # lazy: columns shared
    with pytest.warns(DeprecationWarning, match="filter_time_range"):
        got = tfilt.filter_time_range(tf, TIMESTAMP, 20.0, 70.0)
    want = _quiet(jfilt.filter_time_range, jf, TIMESTAMP, 20.0, 70.0)
    _eq(got.rows_valid(), want.rows_valid())


# ------------------------------------------------------- case level
@pytest.mark.parametrize("activity", [0, 3, 5, 9])
@pytest.mark.parametrize("masked", [0.0, 0.3])
def test_filter_cases_containing_matches_jax(activity, masked):
    cols, _, rv = _log(4, masked=masked)
    jf, tf = _frames(cols, None, rv)
    with pytest.warns(DeprecationWarning, match="filter_cases_containing"):
        got = tfilt.filter_cases_containing(tf, activity, 30)
    want = _quiet(jfilt.filter_cases_containing, jf, activity, 30)
    _eq(got.rows_valid(), want.rows_valid())
    # a keep mask shorter than the number of cases reads its last entry
    got = _quiet(tfilt.filter_cases_containing, tf, activity, 11)
    _eq(got.rows_valid(),
        _quiet(jfilt.filter_cases_containing, jf, activity, 11).rows_valid())


@pytest.mark.parametrize("lo,hi", [(1, 3), (4, 9), (0, 0), (2, 2)])
@pytest.mark.parametrize("masked", [0.0, 0.3])
def test_filter_case_size_matches_jax(lo, hi, masked):
    cols, _, rv = _log(5, masked=masked)
    jf, tf = _frames(cols, None, rv)
    with pytest.warns(DeprecationWarning, match="filter_case_size"):
        got = tfilt.filter_case_size(tf, lo, hi, 30)
    _eq(got.rows_valid(), _quiet(jfilt.filter_case_size, jf, lo, hi, 30).rows_valid())
    _eq(_quiet(tfilt.filter_case_size, tf, lo, hi, 20).rows_valid(),
        _quiet(jfilt.filter_case_size, jf, lo, hi, 20).rows_valid())


@pytest.mark.parametrize("column,value", [(ACTIVITY, 2), ("attr0", 3), ("attr0", 7)])
def test_cases_with_value_kernel_matches_jax(column, value):
    cols, _, rv = _log(6, masked=0.2)
    jf, tf = _frames(cols, None, rv)
    tk = tfilt.cases_with_value_kernel(column, value, 32)
    jk = jfilt.cases_with_value_kernel(column, value, 32)
    ts, tc = tk.update(*tk.init("cpu"), tf)
    js, _ = jk.update(*jk.init(), jf)
    _eq(ts, js)
    assert tc["seg"].item() == 29
    got = tcore.run_streaming(tk, tcore.ChunkedEventFrame.from_frame(tf, 4))
    _eq(got, js)
    _eq(tk.merge(ts, torch.zeros_like(ts)), js)


def _chunk_source(pkg, frame, chunking, cols):
    if chunking.startswith("rows"):
        return pkg.ChunkedEventFrame.from_frame(frame, int(chunking[4:]))
    _, starts, counts = np.unique(cols[CASE], return_index=True, return_counts=True)
    k = int(np.argmax(counts))
    lo, ln = int(starts[k]), int(counts[k])
    return pkg.ChunkedEventFrame.from_cuts(frame, [lo + 1, lo + ln // 2, lo + ln - 1])


@pytest.mark.parametrize("chunking", ["rows1", "rows5", "rows13", "straddle3"])
@pytest.mark.parametrize("masked", [0.0, 0.25])
def test_two_pass_streaming_case_filter_matches_jax(chunking, masked):
    cols, _, rv = _log(7, n_cases=25, max_len=12, masked=masked)
    jf, tf = _frames(cols, None, rv)
    src = _chunk_source(tcore, tf, chunking, cols)
    act = tfilt.streaming_most_common_activity(src, A)
    assert act == int(jfilt.most_common_activity(jf, A))
    keep = tfilt.streaming_cases_containing(src, act, 25)
    jkeep = jfilt.streaming_cases_containing(
        jcore.ChunkedEventFrame.from_frame(jf, jf.nrows), act, 25)
    _eq(keep, jkeep)
    parts = list(tfilt.stream_apply_case_mask(src, keep))
    assert len(parts) == len(list(src))
    rows = torch.cat([p.rows_valid() for p in parts])
    want = _quiet(jfilt.filter_cases_containing, jf, act, 25)
    _eq(rows, want.rows_valid())
    # the DFG of what the second pass keeps == JAX's DFG of the filtered log
    got = tcore.run_streaming(tdfg.dfg_kernel(A),
                              tfilt.stream_apply_case_mask(src, keep), device="cpu")
    jd = jdfg.dfg(want, A)
    for nm in ("counts", "starts", "ends"):
        _eq(getattr(got, nm), getattr(jd, nm), nm)
    # and a size-based keep mask through the same second pass
    skeep = tfilt.streaming_case_size_keep(src, 3, 8, 25)
    _eq(skeep, jfilt.streaming_case_size_keep(
        jcore.ChunkedEventFrame.from_frame(jf, jf.nrows), 3, 8, 25))
    rows = torch.cat([p.rows_valid() for p in tfilt.stream_apply_case_mask(src, skeep)])
    _eq(rows, _quiet(jfilt.filter_case_size, jf, 3, 8, 25).rows_valid())


def test_stream_apply_case_mask_passes_empty_chunks_and_short_masks():
    cols, _, _ = _log(8, n_cases=6)
    _, tf = _frames(cols)
    n = tf.nrows
    empty = tcore.EventFrame({k: v[:0] for k, v in tf.columns.items()})
    chunks = [empty, *tcore.ChunkedEventFrame.from_frame(tf, 4), empty]
    keep = torch.tensor([True, False, True])       # cases 3..5 lie past it
    out = list(tfilt.stream_apply_case_mask(chunks, keep))
    assert out[0] is empty and out[-1] is empty
    rows = torch.cat([p.rows_valid() for p in out[1:-1]])
    seg = np.cumsum(np.concatenate([[True], cols[CASE][1:] != cols[CASE][:-1]])) - 1
    np.testing.assert_array_equal(rows.numpy(), (seg < 3) & np.array([True, False, True])[np.minimum(seg, 2)])
    assert rows.shape == (n,)


# --------------------------------------------------- most common activity
def test_most_common_activity_matches_jax_and_breaks_ties_low():
    cols, _, rv = _log(9, masked=0.3)
    jf, tf = _frames(cols, None, rv)
    got = tfilt.most_common_activity(tf, A)
    want = np.asarray(jfilt.most_common_activity(jf, A))
    assert got.dim() == 0 and int(got) == int(want)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == "int32"
    tie = {CASE: np.array([0, 0, 1, 1], np.int64),
           ACTIVITY: np.array([4, 2, 2, 4], np.int32),
           TIMESTAMP: np.zeros(4, np.float32)}
    jt, tt = _frames(tie)
    assert int(tfilt.most_common_activity(tt, A)) == int(
        jfilt.most_common_activity(jt, A)) == 2
    src = tcore.ChunkedEventFrame.from_frame(tt, 1)
    assert tfilt.streaming_most_common_activity(src, A) == 2


# ------------------------------------------------------- 0-row frames
def _empty():
    cols = {CASE: np.zeros(0, np.int64), ACTIVITY: np.zeros(0, np.int32),
            TIMESTAMP: np.zeros(0, np.float32)}
    return _frames(cols)


def test_zero_row_frame_results_match_jax():
    """Where JAX returns a result on a 0-row frame, the port returns the
    same; where JAX raises (the case-level filters: its carry update reads
    row -1), the port raises too."""
    jf, tf = _empty()
    assert int(tfilt.most_common_activity(tf, A)) == int(
        jfilt.most_common_activity(jf, A)) == 0
    _eq(_quiet(tfilt.filter_attr_values, tf, ACTIVITY, [1]).rows_valid(),
        _quiet(jfilt.filter_attr_values, jf, ACTIVITY, [1]).rows_valid())
    _eq(_quiet(tfilt.filter_time_range, tf, TIMESTAMP, 0, 1).rows_valid(),
        _quiet(jfilt.filter_time_range, jf, TIMESTAMP, 0, 1).rows_valid())
    _eq(tfilt.isin_mask(tf[ACTIVITY], [1, 2]),
        jfilt.isin_mask(jf[ACTIVITY], jnp.asarray([1, 2], jnp.int32)))
    for fn, args in ((jfilt.filter_cases_containing, (1, 4)),
                     (jfilt.filter_case_size, (1, 3, 4))):
        with pytest.raises(Exception):
            _quiet(fn, jf, *args)
    for fn, args in ((tfilt.filter_cases_containing, (1, 4)),
                     (tfilt.filter_case_size, (1, 3, 4))):
        with pytest.raises((RuntimeError, IndexError)):
            _quiet(fn, tf, *args)
