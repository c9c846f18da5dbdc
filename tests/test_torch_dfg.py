"""PyTorch port, DFG main path: every method, every chunking, masked rows,
the boundary stitch, and a JAX -> port hand-over of state and carry mid
stream, all held bitwise (tolerance 0: integer counts) against the JAX
package on the same numpy logs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import ops as jops  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402

# the packages re-export the ``dfg`` function under the module's name
jdfg = importlib.import_module("repro.core.dfg")
tdfg = importlib.import_module("repro_torch.core.dfg")

METHODS = ("auto", "shift", "segment", "matmul", "kernel")


def _log(seed, n_cases=30, n_acts=6, max_len=9, masked=0.0):
    """A (case, time)-sorted log as numpy columns (+ an optional row mask)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64) * 3 + 5, lens)
    act = rng.integers(0, n_acts, case.size).astype(np.int32)
    ts = np.arange(case.size, dtype=np.float32)
    rv = rng.random(case.size) >= masked if masked else None
    return {CASE: case, ACTIVITY: act, TIMESTAMP: ts}, rv


def _frames(cols, rv):
    jf = jcore.EventFrame.from_numpy(cols)
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    if rv is not None:
        jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
        tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _assert_dfg(t, j, msg=""):
    for nm in ("counts", "starts", "ends"):
        got = getattr(t, nm)
        assert got.dtype == torch.int32, nm
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, nm)),
                                      err_msg=f"{msg}:{nm}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("masked", [0.0, 0.25])
def test_methods_match_jax(method, masked):
    cols, rv = _log(3, masked=masked)
    jf, tf = _frames(cols, rv)
    want = jdfg.dfg(jf, 6, method)
    _assert_dfg(tdfg.dfg(tf, 6, method), want, method)
    _assert_dfg(tdfg.dfg(tf, 6, method), jdfg.dfg_segment(jf, 6), method)


@pytest.mark.parametrize("chunking", ["rows1", "rows7", "straddle3", "random"])
@pytest.mark.parametrize("masked", [0.0, 0.3])
def test_streaming_matches_jax(chunking, masked):
    cols, rv = _log(5, n_cases=20, masked=masked, max_len=12)
    jf, tf = _frames(cols, rv)
    n = tf.nrows
    if chunking == "rows1":
        tsrc = tcore.ChunkedEventFrame.from_frame(tf, 1)
        jsrc = jcore.ChunkedEventFrame.from_frame(jf, 1)
    elif chunking == "rows7":
        tsrc = tcore.ChunkedEventFrame.from_frame(tf, 7)
        jsrc = jcore.ChunkedEventFrame.from_frame(jf, 7)
    else:
        if chunking == "straddle3":
            # cut the longest case into 4 pieces: it straddles 3 boundaries
            case = cols[CASE]
            ids, starts, counts = np.unique(case, return_index=True,
                                            return_counts=True)
            k = int(np.argmax(counts))
            lo, ln = int(starts[k]), int(counts[k])
            assert ln >= 4
            cuts = [lo + 1, lo + ln // 2, lo + ln - 1]
        else:
            cuts = sorted(np.random.default_rng(9).integers(1, n, 6).tolist())
        tsrc = tcore.ChunkedEventFrame.from_cuts(tf, cuts)
        jsrc = jcore.ChunkedEventFrame.from_cuts(jf, cuts)
    got = tcore.run_streaming(tdfg.dfg_kernel(6), tsrc)
    if chunking != "random":    # (JAX compiles its update once per chunk shape)
        _assert_dfg(got, jcore.run_streaming(jdfg.dfg_kernel(6), jsrc),
                    "jax stream")
    _assert_dfg(got, jdfg.dfg(jf, 6), "jax whole-log")
    assert got.counts.device == tsrc.device
    moved = tcore.ChunkedEventFrame.from_frame(tf, 7, device="cpu")
    _assert_dfg(tcore.run_streaming(tdfg.dfg_kernel(6), moved), jdfg.dfg(jf, 6))


def test_stitch_matches_jax():
    cols, rv = _log(8, n_cases=12, masked=0.2)
    jf, tf = _frames(cols, rv)
    n = tf.nrows
    for cut in (1, n // 2, n - 1):
        tk, jk = tdfg.dfg_kernel(6), jdfg.dfg_kernel(6)

        def fold(k, frame, lo, hi, t):
            state, carry = k.init("cpu") if t else k.init()
            chunk = (tcore.ChunkedEventFrame if t else jcore.ChunkedEventFrame
                     ).from_cuts(frame, [lo, hi])
            parts = list(chunk)
            piece = parts[0] if lo == 0 else parts[1]
            return k.update(state, carry, piece)

        ta, _ = fold(tk, tf, 0, cut, True)
        tb, tcarry = fold(tk, tf, cut, n, True)
        ja, _ = fold(jk, jf, 0, cut, False)
        jb, _ = fold(jk, jf, cut, n, False)
        rvn = rv if rv is not None else np.ones(n, bool)
        a_tail = {"act": int(cols[ACTIVITY][cut - 1]), "rv": bool(rvn[cut - 1])}
        b_row0 = {"act": int(cols[ACTIVITY][cut]), "rv": bool(rvn[cut])}
        straddle = bool(cols[CASE][cut - 1] == cols[CASE][cut])
        got = tdfg.stitch_dfg_state(ta, tb, a_tail, b_row0, straddle)
        _assert_dfg(got, jdfg.stitch_dfg_state(ja, jb, a_tail, b_row0, straddle),
                    f"stitch cut={cut}")
        _assert_dfg(tk.finalize(got, tcarry), jdfg.dfg(jf, 6), f"final cut={cut}")


@pytest.mark.parametrize("k", [1, 3, 6])
def test_state_handover_jax_to_port(k):
    """Fold the first k chunks in JAX, hand state + carry over as numpy, fold
    the rest in the port: bitwise the JAX whole-log DFG."""
    cols, rv = _log(12, n_cases=25, masked=0.1)
    jf, tf = _frames(cols, rv)
    cuts = sorted(np.random.default_rng(0).integers(1, tf.nrows, 8).tolist())
    jchunks = list(jcore.ChunkedEventFrame.from_cuts(jf, cuts))
    tchunks = list(tcore.ChunkedEventFrame.from_cuts(tf, cuts))
    jk = jdfg.dfg_kernel(6)
    state, carry = jk.init()
    for ch in jchunks[:k]:
        state, carry = jk.update(state, carry, ch)
    tk = tdfg.dfg_kernel(6)
    tstate = tdfg.DFG.from_numpy({nm: np.asarray(getattr(state, nm))
                                  for nm in ("counts", "starts", "ends")}, "cpu")
    tcarry = tengine.carry_from_numpy({c: np.asarray(v) for c, v in carry.items()},
                                      "cpu")
    assert tcarry["case"].dtype == torch.int64
    for ch in tchunks[k:]:
        tstate, tcarry = tk.update(tstate, tcarry, ch)
    got = tk.finalize(tstate, tcarry)
    _assert_dfg(got, jdfg.dfg(jf, 6))
    # and back: the port's carry as numpy is what the JAX kernel consumes
    back = tengine.carry_to_numpy(tcarry)
    assert int(back["case"]) == int(cols[CASE][-1])
    assert int(back["act"]) == int(cols[ACTIVITY][-1])
    np.testing.assert_array_equal(got.to_numpy()["counts"],
                                  np.asarray(jdfg.dfg(jf, 6).counts))


def test_adjacent_matches_jax():
    cols, rv = _log(2, masked=0.3)
    jf, tf = _frames(cols, rv)
    jcarry = jengine.init_row_carry()
    tcarry = tengine.init_row_carry("cpu")
    ja = jengine.adjacent(jf, jcarry)
    ta = tengine.adjacent(tf, tcarry)
    for field in ta._fields:
        np.testing.assert_array_equal(getattr(ta, field).numpy(),
                                      np.asarray(getattr(ja, field)), err_msg=field)
    tcarry["seg"] = torch.tensor(-1, dtype=torch.int32)
    jcarry["seg"] = jnp.int32(-1)
    np.testing.assert_array_equal(tengine.global_segments(ta, tcarry).numpy(),
                                  np.asarray(jengine.global_segments(ja, jcarry)))
    nxt = tengine.next_row_carry(tcarry, tf)
    jn = jengine.next_row_carry(jcarry, jf)
    for key in ("case", "act", "ts", "rv", "exists"):
        assert nxt[key].dim() == 0 and nxt[key].device == tf.device
        assert nxt[key].item() == np.asarray(jn[key]).item(), key


def test_registry_and_streaming_front_door():
    spec = tengine.kernel_spec("dfg")
    assert spec.columns == (CASE, ACTIVITY)
    kern = spec.make(tengine.Dims(6, 30))
    cols, _ = _log(4)
    jf, tf = _frames(cols, None)
    _assert_dfg(tengine.run_single(kern, tf), jdfg.dfg(jf, 6))
    _assert_dfg(tengine.streaming_dfg(tcore.ChunkedEventFrame.from_frame(tf, 5), 6),
                jdfg.dfg(jf, 6))
    with pytest.raises(KeyError, match="did you mean"):
        tengine.kernel_spec("dgf")
    with pytest.raises(ValueError):
        tdfg.dfg_kernel(6, "bogus")
    assert "dfg" in tengine.kernel_specs()


def test_edges_and_numpy_roundtrip():
    cols, _ = _log(6)
    jf, tf = _frames(cols, None)
    d = tdfg.dfg(tf, 6)
    assert d.edges() == jdfg.dfg(jf, 6).edges()
    again = tdfg.DFG.from_numpy(d.to_numpy(), "cpu")
    _assert_dfg(again, jdfg.dfg(jf, 6))
    assert again.num_activities == 6


# ------------------------------------------------------------ core ops
def test_ops_match_jax():
    rng = np.random.default_rng(4)
    cols = {CASE: rng.integers(0, 9, 120).astype(np.int64),
            ACTIVITY: rng.integers(0, 5, 120).astype(np.int32),
            TIMESTAMP: rng.integers(0, 50, 120).astype(np.float32)}
    jf, tf = _frames(cols, None)
    js = jops.sort(jf, (TIMESTAMP, CASE))
    ts = tops.sort(tf, (TIMESTAMP, CASE))
    for k in cols:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
    jg, jids, jst = jops.group_segments(jf, CASE)
    tg, tids, tst = tops.group_segments(tf, CASE)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert tids.dtype == torch.int32
    sh_j, sh_t = jops.shift(js), tops.shift(ts)
    both_j = jops.concat(js, sh_j)
    both_t = tops.concat(ts, sh_t)
    both_j = jops.proj(both_j, both_j[CASE] == both_j[CASE + ".2"])
    both_t = tops.proj(both_t, both_t[CASE] == both_t[CASE + ".2"])
    np.testing.assert_array_equal(both_t.rows_valid().numpy(),
                                  np.asarray(both_j.rows_valid()))
    mj = jops.mergstrv(both_j, "p", ACTIVITY, ACTIVITY + ".2", 5)
    mt = tops.mergstrv(both_t, "p", ACTIVITY, ACTIVITY + ".2", 5)
    np.testing.assert_array_equal(mt["p"].numpy(), np.asarray(mj["p"]))
    np.testing.assert_array_equal(
        tops.value_counts(ts[ACTIVITY], 5).numpy(),
        np.asarray(jops.value_counts(js[ACTIVITY], 5)))
    keep = tf.compact() if tf.row_valid is not None else tf
    assert keep.nrows == tf.nrows
    sel = tops.proj(tf, tf[ACTIVITY] > 2).compact()
    assert sel.nrows == int((cols[ACTIVITY] > 2).sum())


def test_mergstrv_overflow_guard():
    cols = {CASE: np.zeros(2, np.int64),
            ACTIVITY: np.array([2**20, 3], np.int32), "b": np.array([1, 2], np.int32)}
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    with pytest.raises(OverflowError):
        tops.mergstrv(tf, "p", ACTIVITY, "b", 2**12)
