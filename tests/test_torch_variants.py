"""PyTorch port, variants: ``variants_kernel`` streamed under adversarial
chunkings, the whole-log ``variant_fingerprints`` / ``variant_counts``,
hand-built ghost chunks (a skipped row range replaced by one row per case
segment carrying its composed affine sketch maps) and a carry handed over
from the JAX kernel, all held against ``repro.core.variants`` on the same
numpy logs with both of its lowerings (``impl="xla"`` and the Pallas
kernels in interpret mode).  Tolerance 0: the fingerprints are uint32
hashes mod 2^32 (the port returns them as int64 values in [0, 2^32), and
the comparisons are on those values as uint32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import polyhash as jpolyhash  # noqa: E402
from repro.core import variants as jvariants  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import polyhash as tpolyhash  # noqa: E402
from repro_torch.core import variants as tvariants  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE  # noqa: E402

A = 5


def _log(seed, n_cases=30, max_len=11, masked=0.0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64), lens)
    act = rng.integers(0, A, case.size).astype(np.int32)
    rv = rng.random(case.size) >= masked if masked else None
    return {CASE: case, ACTIVITY: act}, rv


def _frames(cols, rv):
    jf = jcore.EventFrame.from_numpy(cols)
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    if rv is not None:
        jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
        tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _eq_u32(got, want, msg=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  np.asarray(want).astype(np.uint32), err_msg=msg)


@pytest.mark.parametrize("masked", [0.0, 0.3])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_whole_log_fingerprints_match_jax(masked, impl):
    cols, rv = _log(1, masked=masked)
    jf, tf = _frames(cols, rv)
    want = jvariants.variant_fingerprints(jf, impl)
    got = tvariants.variant_fingerprints(tf)
    assert got[0].dtype == got[1].dtype == torch.int64
    assert int(got[0].min()) >= 0 and int(got[0].max()) < 2**32
    for g, w, nm in zip(got, want, ("fp1", "fp2", "seg")):
        _eq_u32(g, w, nm)
    assert tvariants.variant_counts(tf) == jvariants.variant_counts(jf)


def _chunkings(n):
    rng = np.random.default_rng(n)
    return {
        "one_row": list(range(1, n)),
        "random": sorted(rng.integers(1, n, 5).tolist()),
        "halves": [n // 2],
    }


@pytest.mark.parametrize("chunking", ["one_row", "random", "halves"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_streamed_kernel_matches_jax(chunking, impl):
    cols, rv = _log(2, n_cases=12 if chunking == "one_row" else 30, masked=0.2)
    jf, tf = _frames(cols, rv)
    cuts = _chunkings(tf.nrows)[chunking]
    want = jcore.run_streaming(jvariants.variants_kernel(40, impl),
                               jcore.ChunkedEventFrame.from_cuts(jf, cuts))
    got = tcore.run_streaming(tvariants.variants_kernel(40),
                              tcore.ChunkedEventFrame.from_cuts(tf, cuts))
    for g, w, nm in zip(got, want, ("fp1", "fp2", "ncases")):
        _eq_u32(g, w, f"{chunking}:{nm}")
    # and the whole-log form, case by case
    whole = jvariants.variant_fingerprints(jf, impl)
    nc = int(got[2])
    for g, w in zip(got[:2], whole[:2]):
        _eq_u32(g[:nc], np.asarray(w)[:nc])


def _ghost(pkg_polyhash, case, act, lo, hi):
    """The ghost chunk of rows [lo, hi): one all-masked row per case segment
    (case id; activity 0 except the tail row's, which keeps the halo), padded
    to a power of two with the tail case, and the segments' composed affine
    maps in the sketch columns (identity maps on padding) — as the JAX query
    executor builds it for a refuted row group."""
    c, a = case[lo:hi], act[lo:hi]
    seg_cases = c[np.flatnonzero(np.concatenate([[True], c[1:] != c[:-1]]))]
    d = seg_cases.size
    m = 1 << (d - 1).bit_length()
    cc = np.full(m, c[-1], case.dtype)
    cc[:d - 1] = seg_cases[:d - 1]
    aa = np.zeros(m, act.dtype)
    aa[d - 1:] = a[-1]
    cols = {CASE: cc, ACTIVITY: aa}
    cols.update(pkg_polyhash.sketch_columns(pkg_polyhash.segment_sketch(a, c), d, m))
    return cols, m


@pytest.mark.parametrize("ghost_ranges", [[(5, 40)], [(0, 17)], [(10, 30), (60, 61)],
                                          [(33, 90), (90, 140)]])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ghost_chunks_match_jax_and_the_rows_they_replace(ghost_ranges, impl):
    cols, rv = _log(3, n_cases=30, masked=0.2)
    case, act = cols[CASE], cols[ACTIVITY]
    n = case.size
    jf, tf = _frames(cols, rv)
    edges = sorted({0, n, *[e for r in ghost_ranges for e in r]})
    ghosts = dict(ghost_ranges)
    jchunks = list(jcore.ChunkedEventFrame.from_cuts(jf, edges))
    tchunks = list(tcore.ChunkedEventFrame.from_cuts(tf, edges))
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        if lo in ghosts:
            gj, m = _ghost(jpolyhash, case, act, lo, hi)
            gt, _ = _ghost(tpolyhash, case, act, lo, hi)
            f = jcore.EventFrame.from_numpy(gj)
            jchunks[i] = jcore.EventFrame(f.columns, f.valid, jnp.zeros(m, bool))
            f = tcore.EventFrame.from_numpy(gt, device="cpu")
            assert f[tpolyhash.SK_MUL1].dtype == torch.uint32
            tchunks[i] = tcore.EventFrame(f.columns, f.valid,
                                          torch.zeros(m, dtype=torch.bool))
    jk, tk = jvariants.variants_kernel(40, impl), tvariants.variants_kernel(40)
    js, jc = jk.init()
    ts, tc = tk.init("cpu")
    for jch, tch in zip(jchunks, tchunks):
        js, jc = jk.update(js, jc, jch)
        ts, tc = tk.update(ts, tc, tch)
        _eq_u32(tc["h1"], jc["h1"])
        _eq_u32(tc["h2"], jc["h2"])
        assert int(tc["seg"]) == int(jc["seg"])
    got, want = tk.finalize(ts, tc), jk.finalize(js, jc)
    for g, w in zip(got, want):
        _eq_u32(g, w)
    # the ghost rows reproduce the skipped rows' hashes bitwise
    plain = jvariants.variant_fingerprints(jf, impl)
    for g, w in zip(got[:2], plain[:2]):
        _eq_u32(g[:int(got[2])], np.asarray(w)[:int(got[2])])


@pytest.mark.parametrize("k", [1, 3, 6])
def test_carry_handover_jax_to_port(k):
    """Fold the first k chunks in JAX, hand state + carry (uint32 ``h1`` /
    ``h2``) over as numpy, fold the rest in the port."""
    cols, rv = _log(4, masked=0.1)
    jf, tf = _frames(cols, rv)
    cuts = sorted(np.random.default_rng(0).integers(1, tf.nrows, 8).tolist())
    jk, tk = jvariants.variants_kernel(40, "xla"), tvariants.variants_kernel(40)
    state, carry = jk.init()
    for ch in list(jcore.ChunkedEventFrame.from_cuts(jf, cuts))[:k]:
        state, carry = jk.update(state, carry, ch)
    tcarry = tengine.carry_from_numpy({c: np.asarray(v) for c, v in carry.items()},
                                      "cpu")
    assert tcarry["h1"].dtype == torch.int32
    tstate = tuple(torch.from_numpy(np.asarray(s).view(np.int32).copy()) for s in state)
    for ch in list(tcore.ChunkedEventFrame.from_cuts(tf, cuts))[k:]:
        tstate, tcarry = tk.update(tstate, tcarry, ch)
    for ch in list(jcore.ChunkedEventFrame.from_cuts(jf, cuts))[k:]:
        state, carry = jk.update(state, carry, ch)
    for g, w in zip(tk.finalize(tstate, tcarry), jk.finalize(state, carry)):
        _eq_u32(g, w)
    back = tengine.carry_to_numpy(tcarry)
    for h in ("h1", "h2"):
        assert back[h].view(np.uint32) == np.asarray(carry[h])


def test_registry_and_front_doors():
    cols, _ = _log(5)
    jf, tf = _frames(cols, None)
    spec = tengine.kernel_spec("variants")
    assert spec.columns == (ACTIVITY, CASE)
    src = tcore.ChunkedEventFrame.from_frame(tf, 13)
    jsrc = jcore.ChunkedEventFrame.from_frame(jf, 13)
    got = tengine.streaming_variant_fingerprints(src, 40)
    want = jcore.engine.streaming_variant_fingerprints(jsrc, 40)
    for g, w in zip(got, want):
        _eq_u32(g, w)
    k = spec.make(tengine.Dims(A, 40))
    for g, w in zip(tcore.run_streaming(k, src), want):
        _eq_u32(g, w)
    assert (tengine.streaming_variant_counts(src, 40)
            == jcore.engine.streaming_variant_counts(jsrc, 40)
            == jvariants.variant_counts(jf))


def test_unsigned_max_helpers():
    a = torch.tensor([0, -1, 5, -2**31, 2**31 - 1], dtype=torch.int32)
    b = torch.tensor([-1, 0, 7, 2**31 - 1, -2**31], dtype=torch.int32)
    want = np.maximum(a.numpy().view(np.uint32), b.numpy().view(np.uint32))
    np.testing.assert_array_equal(tvariants._umax(a, b).numpy().view(np.uint32), want)
    vec = torch.tensor([3, 9, -5], dtype=torch.int32)
    for idx, val, expect in ((-1, -7, [3, 9, -5]), (3, -7, [3, 9, -5]),
                             (2, -7, [3, 9, -5]), (2, -4, [3, 9, -4]),
                             (0, -1, [-1, 9, -5])):
        got = tvariants._umax_at_(vec.clone(), torch.tensor(idx, dtype=torch.int32),
                                  torch.tensor(val, dtype=torch.int32))
        assert got.tolist() == expect, (idx, val)
