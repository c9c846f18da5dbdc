"""PyTorch port, segmented primitives: the plain versions that every CPU
tensor takes are held bitwise (tolerance 0: integer counts, float32
min/max, row-order float32 sums) against the JAX package's Pallas kernels
(interpret mode) and its XLA references, on the same numpy inputs; plus
the port's device-driven dispatch rules."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import segment_ops as jso  # noqa: E402
from repro.kernels.dfg_count import dfg_count_pallas  # noqa: E402
from repro.kernels.dfg_count import dfg_count_ref as jax_dfg_count_ref  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import segment_ops as tso  # noqa: E402
from repro_torch.kernels.dfg_count import dfg_count_cuda, dfg_count_ref  # noqa: E402

rng = np.random.default_rng(11)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x)


# ----------------------------------------------------------- histogram
@pytest.mark.parametrize("nbins,n", [(5, 1000), (48, 777), (300, 1000), (7, 1),
                                     (1, 200), (26, 0)])
def test_histogram_matches_pallas_and_xla(nbins, n):
    v = rng.integers(-2, nbins + 3, n).astype(np.int32)
    w = rng.integers(-3, 5, n).astype(np.int32)          # negative int weights
    for weights in (None, w, w > 0):
        jw = None if weights is None else jnp.asarray(weights)
        xla = _np(jso.histogram(jnp.asarray(v), nbins, jw, impl="xla"))
        pw = (np.ones(n, np.int32) if weights is None
              else np.asarray(weights).astype(np.int32))
        pallas = _np(jso.histogram_pallas(jnp.asarray(v), jnp.asarray(pw), nbins,
                                          block_e=256, interpret=True))
        got = tso.histogram(T(v), nbins, None if weights is None else T(weights))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), xla)
        np.testing.assert_array_equal(got.numpy(), pallas)
        # the kernel's wrapper takes the plain version on a CPU tensor
        np.testing.assert_array_equal(
            tso.histogram_cuda(T(v), T(pw), nbins).numpy(), pallas)


def test_histogram_into_matches_jax():
    v = rng.integers(-1, 7, 300).astype(np.int32)
    prev = rng.integers(0, 9, 6).astype(np.int32)
    want = _np(jso.histogram(jnp.asarray(v), 6, into=jnp.asarray(prev), impl="xla"))
    into = T(prev.copy())
    got = tso.histogram(T(v), 6, into=into)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(into.numpy(), prev)      # not modified


# ---------------------------------------------------------- pair_count
@pytest.mark.parametrize("ns,nd,n", [(11, 7, 1000), (130, 130, 2000),
                                     (3, 200, 500), (1, 1, 50), (26, 26, 0)])
def test_pair_count_matches_pallas_xla_matmul(ns, nd, n):
    s = rng.integers(-1, ns + 2, n).astype(np.int32)
    d = rng.integers(-1, nd + 2, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    signed = rng.integers(-3, 4, n).astype(np.int32)
    for weights in (mask, signed, None):
        jw = None if weights is None else jnp.asarray(weights)
        xla = _np(jso.pair_count(jnp.asarray(s), jnp.asarray(d), ns, nd, jw,
                                 impl="xla"))
        pw = (np.ones(n, np.float32) if weights is None
              else weights.astype(np.float32))
        pallas = _np(jso.pair_count_pallas(jnp.asarray(s), jnp.asarray(d),
                                           jnp.asarray(pw), ns, nd,
                                           block_e=256, interpret=True))
        tw = None if weights is None else T(weights)
        got = tso.pair_count(T(s), T(d), ns, nd, tw)
        assert got.dtype == torch.int32 and got.shape == (ns, nd)
        np.testing.assert_array_equal(got.numpy(), xla)
        np.testing.assert_array_equal(got.numpy(), pallas.astype(np.int32))
        np.testing.assert_array_equal(
            tso.pair_count(T(s), T(d), ns, nd, tw, impl="matmul").numpy(), xla)
        np.testing.assert_array_equal(
            tso.pair_count_cuda(T(s), T(d), T(pw.astype(np.int32)), ns, nd).numpy(),
            pallas.astype(np.int32))
    jm = _np(jso.pair_count_matmul(jnp.asarray(s), jnp.asarray(d), ns, nd))
    np.testing.assert_array_equal(tso.pair_count_matmul(T(s), T(d), ns, nd).numpy(), jm)


def test_pair_count_into_matches_jax():
    s = rng.integers(0, 5, 400).astype(np.int32)
    d = rng.integers(0, 5, 400).astype(np.int32)
    prev = rng.integers(0, 9, (5, 5)).astype(np.int32)
    want = _np(jso.pair_count(jnp.asarray(s), jnp.asarray(d), 5,
                              into=jnp.asarray(prev), impl="xla"))
    np.testing.assert_array_equal(
        tso.pair_count(T(s), T(d), 5, into=T(prev)).numpy(), want)


def test_float_weights_follow_jax_on_cpu():
    v = rng.integers(0, 6, 200).astype(np.int32)
    w = rng.integers(0, 4, 200).astype(np.float32)
    want = _np(jso.histogram(jnp.asarray(v), 6, jnp.asarray(w), impl="xla"))
    got = tso.histogram(T(v), 6, T(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- dfg_count
@pytest.mark.parametrize("a,e", [(4, 100), (11, 1000), (42, 4096), (130, 2000),
                                 (256, 512), (11, 1)])
def test_dfg_count_matches_pallas_and_ref(a, e):
    src = rng.integers(0, a, e).astype(np.int32)
    dst = rng.integers(0, a, e).astype(np.int32)
    w = (rng.random(e) < 0.7).astype(np.float32)
    pallas = _np(dfg_count_pallas(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(w), a, interpret=True))
    jref = _np(jax_dfg_count_ref(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w), a))
    np.testing.assert_array_equal(pallas, jref)
    got = dfg_count_cuda(T(src), T(dst), T(w), a)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(dfg_count_ref(T(src), T(dst), T(w), a).numpy(), jref)


def test_dfg_count_rejects_non_mask_weights():
    # float weights other than 0/1 are accepted, as by dfg_count_pallas:
    # summed in float32 and truncated to int32 (no host read of the mask)
    src = np.array([0, 1, 2, 1, 1], np.int32)
    w = np.array([1.0, 2.0, 0.0, 2.5, 0.75], np.float32)
    want = _np(dfg_count_pallas(jnp.asarray(src), jnp.asarray(src),
                                jnp.asarray(w), 4, interpret=True))
    got = dfg_count_cuda(T(src), T(src), T(w), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[1, 1]) == 5


@pytest.mark.parametrize("kind", ["bool", "int", "float01", "float_int"])
def test_dfg_count_weight_kinds_match_pallas(kind):
    a, e = 26, 3000
    src = rng.integers(-1, a + 1, e).astype(np.int32)
    dst = rng.integers(-1, a + 1, e).astype(np.int32)
    w = {"bool": rng.random(e) < 0.6,
         "int": rng.integers(0, 4, e).astype(np.int32),
         "float01": (rng.random(e) < 0.6).astype(np.float32),
         "float_int": rng.integers(0, 4, e).astype(np.float32)}[kind]
    want = _np(dfg_count_pallas(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(w.astype(np.float32)), a,
                                interpret=True))
    got = dfg_count_cuda(T(src), T(dst), T(w), a)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ dispatch
def test_resolution_by_device():
    assert backend.resolve(torch.device("cuda")) == "cuda"
    assert backend.resolve(torch.device("cuda", 0), "auto") == "cuda"
    assert backend.resolve(torch.device("cpu")) == "ref"
    assert backend.resolve("cuda", "ref") == "ref"
    assert backend.resolve("cpu", "cuda") == "cuda"
    # the JAX package's names carry over: "xla" is the plain version,
    # "pallas" the kernel
    assert backend.resolve("cpu", "pallas") == "cuda"
    assert backend.resolve("cuda", "xla") == "ref"
    with pytest.raises(ValueError):
        backend.resolve("cpu", "tpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_jax_impl_names_carry_over(impl):
    """Both packages called with the JAX package's ``impl`` names give the
    same bits (on a CPU tensor the port's wrappers run their plain
    versions, so "pallas" reaches the kernel wrapper and its CPU route)."""
    e, s = 500, 37
    ids = np.sort(rng.integers(0, s, e)).astype(np.int32)
    vals = rng.integers(-50, 50, e).astype(np.int32)
    want = _np(jso.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), s,
                                  "sum", impl=impl))
    got = tso.segment_reduce(T(vals), T(ids), s, "sum", impl=impl)
    np.testing.assert_array_equal(got.numpy(), want)
    src = rng.integers(0, 9, e).astype(np.int32)
    dst = rng.integers(0, 9, e).astype(np.int32)
    w = rng.random(e) < 0.5
    want = _np(jso.pair_count(jnp.asarray(src), jnp.asarray(dst), 9,
                              weights=jnp.asarray(w), impl=impl))
    got = tso.pair_count(T(src), T(dst), 9, weights=T(w), impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["xla", "pallas", "ref", None])
def test_dfg_count_ops_matches_jax(impl):
    """``kernels.dfg_count.ops.dfg_count`` is bitwise JAX's under its own
    ``impl`` names (and the port's ``None`` / ``"ref"``)."""
    from repro.kernels.dfg_count import ops as jops
    from repro_torch.kernels.dfg_count import ops as tops

    a, e = 13, 2000
    src = rng.integers(-1, a + 1, e).astype(np.int32)
    dst = rng.integers(-1, a + 1, e).astype(np.int32)
    w = (rng.random(e) < 0.6).astype(np.float32)
    want = _np(jops.dfg_count(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(w), a, impl=impl))
    got = tops.dfg_count(T(src), T(dst), T(w), a, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_weights_refused_on_the_kernel_path():
    # float weights on the kernel path are no longer refused: they take the
    # row-order fold (its wrapper runs the plain version on a CPU tensor),
    # bitwise the JAX package's row-order scatter, into= included
    v = np.array([0, 1, 1, -1, 2, 1, 3], np.int32)
    w = np.array([0.5, 1e8, 1.0, 7.0, 2.0, -1e8, 0.25], np.float32)
    into = np.array([0.1, 3.0, -0.0], np.float32)
    want = _np(jso.histogram_ref(jnp.asarray(v), 3, jnp.asarray(w),
                                 jnp.asarray(into)))
    before = tso.ordered_histogram_cuda.launches
    got = tso.histogram(T(v), 3, T(w), into=T(into), impl="cuda")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got = tso.pair_count(T(v), T(v), 3, weights=T(w), impl="cuda")
    np.testing.assert_array_equal(
        got.numpy(), _np(jso.pair_count_ref(jnp.asarray(v), jnp.asarray(v),
                                            jnp.asarray(w), 3, 3)))
    assert tso.ordered_histogram_cuda.launches == before   # no card, no launch


def test_kernel_wrappers_check_inputs():
    i32 = T(np.array([0, 1, 2], np.int32))
    with pytest.raises(TypeError):
        tso.pair_count_cuda(i32.long(), i32, i32, 3, 3)
    with pytest.raises(ValueError):
        tso.pair_count_cuda(i32, i32[:2], i32, 3, 3)
    with pytest.raises(ValueError):
        tso.histogram_cuda(T(np.zeros((2, 2), np.int32)), T(np.zeros((2, 2), np.int32)), 3)
    with pytest.raises(ValueError):
        tso.histogram_cuda(T(np.arange(6, dtype=np.int32))[::2],
                           T(np.ones(3, np.int32)), 3)
    # weights: int32 or bool only (float weights take the row-order fold in
    # ops, wider integers a cast there)
    for bad in (i32.float(), i32.long(), i32.to(torch.uint8)):
        with pytest.raises(TypeError):
            tso.histogram_cuda(i32, bad, 3)
        with pytest.raises(TypeError):
            tso.pair_count_cuda(i32, i32, bad, 3, 3)
    # into: int32, the output's shape, contiguous, on the inputs' device
    with pytest.raises(TypeError):
        tso.histogram_cuda(i32, i32, 3, into=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        tso.pair_count_cuda(i32, i32, i32, 3, 3, into=torch.zeros((3, 3)))
    with pytest.raises(ValueError):
        tso.histogram_cuda(i32, i32, 3, into=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tso.pair_count_cuda(i32, i32, i32, 3, 3,
                            into=torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        tso.pair_count_cuda(i32, i32, i32, 3, 3,
                            into=torch.zeros((3, 3), dtype=torch.int32).T)
    with pytest.raises(ValueError):
        tso.histogram_cuda(i32, i32, 3,
                           into=torch.zeros(3, dtype=torch.int32, device="meta"))


# ------------------------------------------------------ segment_reduce
def _sorted_ids(gen, s, n, long_run=0):
    """Sorted ids as the engine makes them: a few -1s first, consecutive
    segments with some ids skipped (empty segments), ids >= s at the end,
    and optionally one run of ``long_run`` rows."""
    if n == 0:
        return np.zeros(0, np.int32)
    lens = gen.integers(0, 6, s + 4)
    lens[0] = 3                      # three -1 rows
    if long_run:
        lens[s // 2] = long_run
    ids = np.repeat(np.arange(-1, s + 3, dtype=np.int32), lens)
    return ids[:n] if ids.size >= n else np.concatenate(
        [ids, np.full(n - ids.size, s + 3, np.int32)])


def _values(gen, n, dtype, integral=False):
    if dtype == "bool":
        return gen.random(n) < 0.4
    if dtype == "int32":
        return gen.integers(-50, 50, n).astype(np.int32)
    if integral:
        return gen.integers(-50, 50, n).astype(np.float32)
    return (gen.standard_normal(n) * 1e3).astype(np.float32)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int32", "float32", "bool"])
@pytest.mark.parametrize("s,n,long_run", [(40, 150, 0), (7, 1, 0), (7, 0, 0),
                                          (30, 2000, 1500), (300, 1300, 0)])
def test_segment_reduce_matches_xla_and_pallas(op, dtype, s, n, long_run):
    gen = np.random.default_rng(s * 1009 + n + len(op))
    seg = _sorted_ids(gen, s, n, long_run)
    n = seg.size
    vals = _values(gen, n, dtype)
    xla = _np(jso.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), s, op,
                                 impl="xla"))
    got = tso.segment_reduce(T(vals), T(seg), s, op)
    want_dtype = torch.bool if dtype == "bool" and op != "sum" else (
        torch.float32 if dtype == "float32" else torch.int32)
    assert got.dtype == want_dtype and got.shape == (s,)
    np.testing.assert_array_equal(got.numpy(), xla)
    # the kernel's dispatch and wrapper take the plain version on a CPU tensor
    np.testing.assert_array_equal(
        tso.segment_reduce(T(vals), T(seg), s, op, impl="cuda").numpy(), xla)
    # the Pallas kernel (interpret mode) through the JAX dispatch; its float
    # sum adds a tile through a one-hot window, not in row order, so it is
    # held bitwise on integer-valued floats (exact in any order)
    pv = _values(gen, n, dtype, integral=True) if dtype == "float32" else vals
    pallas = _np(jso.segment_reduce(jnp.asarray(pv), jnp.asarray(seg), s, op,
                                    impl="pallas"))
    np.testing.assert_array_equal(
        tso.segment_reduce(T(pv), T(seg), s, op).numpy(), pallas)
    iv = pv.astype(np.int32) if dtype == "bool" else pv
    direct = _np(jso.segment_reduce_pallas(jnp.asarray(iv), jnp.asarray(seg), s,
                                           op, interpret=True))
    np.testing.assert_array_equal(
        tso.segment_reduce_cuda(T(iv), T(seg), s, op).numpy(), direct)


def test_segment_reduce_identity_matches_jax():
    for op in ("sum", "min", "max"):
        for tdt, jdt in ((torch.int32, jnp.int32), (torch.float32, jnp.float32)):
            got = tso.reduce_identity(op, tdt)
            want = _np(jso.ops.reduce_identity(op, jdt))
            assert got.dtype == tdt and got.item() == want.item()
    with pytest.raises(ValueError):
        tso.reduce_identity("mean", torch.int32)


def test_segment_reduce_single_run_over_everything():
    n = 5000
    vals = (np.random.default_rng(1).standard_normal(n) * 7).astype(np.float32)
    seg = np.zeros(n, np.int32)
    for op in ("sum", "min", "max"):
        want = _np(jso.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), 3, op,
                                      impl="xla"))
        np.testing.assert_array_equal(
            tso.segment_reduce_cuda(T(vals), T(seg), 3, op).numpy(), want)


def test_segment_reduce_wrapper_checks_inputs():
    i32 = T(np.array([0, 1, 2], np.int32))
    with pytest.raises(TypeError):
        tso.segment_reduce_cuda(i32.long(), i32, 3)
    with pytest.raises(TypeError):
        tso.segment_reduce_cuda(i32, i32.long(), 3)
    with pytest.raises(ValueError):
        tso.segment_reduce_cuda(i32, i32[:2], 3)
    with pytest.raises(ValueError):
        tso.segment_reduce_cuda(i32, i32, 3, "mean")
    with pytest.raises(ValueError):
        tso.segment_reduce_cuda(T(np.arange(6, dtype=np.int32))[::2], i32, 3)


# ------------------------------------------------ the row-order float fold
@pytest.mark.parametrize("nbins,n", [(26, 3000), (1, 500), (676, 4000), (5, 1),
                                     (9, 0)])
@pytest.mark.parametrize("with_into", [False, True])
def test_float_histogram_into_matches_jax_bitwise(nbins, n, with_into):
    gen = np.random.default_rng(nbins * 31 + n)
    v = gen.integers(-2, nbins + 2, n).astype(np.int32)
    # magnitudes far apart, so any regrouping of the additions shows
    w = (gen.standard_normal(n) * 10.0 ** gen.integers(-3, 7, n)).astype(np.float32)
    into = ((gen.standard_normal(nbins) * 1e4).astype(np.float32)
            if with_into else None)
    jinto = None if into is None else jnp.asarray(into)
    want = _np(jso.histogram_ref(jnp.asarray(v), nbins, jnp.asarray(w), jinto))
    tinto = None if into is None else T(into.copy())
    for got in (tso.histogram(T(v), nbins, T(w), into=tinto),
                tso.ordered_histogram_cuda(T(v), T(w), nbins, tinto),
                tso.ordered_histogram_ref(T(v), T(w), nbins, tinto)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    if into is not None:
        np.testing.assert_array_equal(tinto.numpy(), into)    # not modified
        # summing the chunk first and then adding is not the same fold
        chunk_first = into + _np(jso.histogram_ref(jnp.asarray(v), nbins,
                                                   jnp.asarray(w)))
        if n > 1000:
            assert not np.array_equal(chunk_first, want)


@pytest.mark.parametrize("ns,nd", [(26, 26), (3, 11), (1, 1)])
def test_float_pair_count_into_matches_jax_bitwise(ns, nd):
    gen = np.random.default_rng(ns + nd)
    n = 2500
    s = gen.integers(-1, ns + 1, n).astype(np.int32)
    d = gen.integers(-1, nd + 1, n).astype(np.int32)
    w = (gen.standard_normal(n) * 1e5).astype(np.float32)
    into = (gen.standard_normal((ns, nd)) * 1e3).astype(np.float32)
    want = _np(jso.pair_count_ref(jnp.asarray(s), jnp.asarray(d), jnp.asarray(w),
                                  ns, nd, jnp.asarray(into)))
    got = tso.pair_count(T(s), T(d), ns, nd, T(w), into=T(into))
    assert got.dtype == torch.float32 and got.shape == (ns, nd)
    np.testing.assert_array_equal(got.numpy(), want)
    got = tso.pair_count(T(s), T(d), ns, nd, T(w), into=T(into), impl="cuda")
    np.testing.assert_array_equal(got.numpy(), want)


def _fold_plan(values, num_bins, tile):
    """The counting sort's offsets as the kernel's first three passes
    compute them: ``offsets`` (B, tiles), the exclusive prefix over tiles of
    each bin's per-tile count, and ``bin_start`` (B + 1,), each bin's first
    place in the sorted order, the in-range total last."""
    n = values.shape[0]
    tiles = -(-n // tile)
    ok = (values >= 0) & (values < num_bins)
    counts = np.zeros((num_bins, tiles), np.int64)
    np.add.at(counts, (values[ok], np.arange(n)[ok] // tile), 1)
    totals = counts.sum(1)
    return counts.cumsum(1) - counts, np.concatenate([[0], totals.cumsum()])


@pytest.mark.parametrize("nbins,n", [(26, 9000), (1, 1025), (676, 12_288), (7, 1),
                                     (3, 0), (5000, 4097)])
@pytest.mark.parametrize("with_into", [False, True])
def test_ordered_fold_counting_sort_plan(nbins, n, with_into):
    """The kernel's counting sort, replayed on the CPU at the wrapper's tile
    and scratch shapes: each tile's rows placed at ``bin_start[b] +
    offsets[b, t] + rank`` form the stable sort by bin (row order kept
    within each bin), and folding each bin's segment left to right onto
    ``into`` gives the JAX package's row-order scatter bitwise; ``n`` not a
    multiple of the tile, one bin (the longest chain) and both tile sizes
    included."""
    from repro_torch.kernels.segment_ops import ordered_histogram as oh

    gen = np.random.default_rng(nbins * 7 + n)
    v = gen.integers(-2, nbins + 2, n).astype(np.int32)
    w = (gen.standard_normal(n) * 10.0 ** gen.integers(-3, 7, n)).astype(np.float32)
    into = (gen.standard_normal(nbins) * 1e4).astype(np.float32) if with_into else None
    shapes = oh.scratch_shapes(n, nbins)
    tile = oh.tile_rows(nbins)
    assert tile == (1024 if nbins <= 3072 else 4096)
    tiles = -(-n // tile)
    assert shapes == {"counts": (nbins, tiles), "bin_start": (nbins + 1,),
                      "sorted": (n,)}
    offsets, bin_start = _fold_plan(v, nbins, tile)
    assert offsets.shape == shapes["counts"] and bin_start.shape == shapes["bin_start"]
    ok = (v >= 0) & (v < nbins)
    assert bin_start[-1] == ok.sum()
    # the scatter, one tile at a time in row order
    place = np.full(n, -1, np.int64)
    for t in range(tiles):
        seen = {}
        for i in range(t * tile, min(n, (t + 1) * tile)):
            if ok[i]:
                b = int(v[i])
                place[i] = bin_start[b] + offsets[b, t] + seen.get(b, 0)
                seen[b] = seen.get(b, 0) + 1
    order = np.flatnonzero(ok)[np.argsort(v[ok], kind="stable")]
    ordered = np.empty(int(ok.sum()), np.float32)
    ordered[place[ok]] = w[ok]
    np.testing.assert_array_equal(np.sort(place[ok]), np.arange(ok.sum()))
    np.testing.assert_array_equal(ordered, w[order])
    # the fold: one chain per bin, left to right
    out = np.zeros(nbins, np.float32) if into is None else into.copy()
    for b in range(nbins):
        acc = out[b]
        for x in ordered[bin_start[b]:bin_start[b + 1]]:
            acc = np.float32(acc + x)
        out[b] = acc
    jinto = None if into is None else jnp.asarray(into)
    want = _np(jso.histogram_ref(jnp.asarray(v), nbins, jnp.asarray(w), jinto))
    np.testing.assert_array_equal(out, want)


def test_ordered_fold_wrapper_checks_inputs():
    v = T(np.array([0, 1, 2], np.int32))
    w = T(np.ones(3, np.float32))
    with pytest.raises(TypeError):
        tso.ordered_histogram_cuda(v, w.double(), 3)
    with pytest.raises(TypeError):
        tso.ordered_histogram_cuda(v.long(), w, 3)
    with pytest.raises(ValueError):
        tso.ordered_histogram_cuda(v, w, 3, into=T(np.zeros(4, np.float32)))
    with pytest.raises(ValueError):
        tso.ordered_histogram_cuda(v, w[:2], 3)


def test_build_paths_hash_the_sources():
    for name in _build.SOURCES:
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
        assert p.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert {"segment_reduce", "ordered_histogram"} <= set(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# -------------------------------- segment_reduce's one-pass scheme, replayed
def _combine(op, acc, v):
    """The kernel's combine: float32 / int32 arithmetic, NaN propagating."""
    if op == "sum":
        return acc + v
    if op == "min":
        return v if (v < acc or v != v) else acc
    return v if (v > acc or v != v) else acc


def _replay_segment_reduce(vals, seg, s, op, tile, halo, fill_slots):
    """``segment_reduce_tiles`` of ``kernels/csrc/segment_reduce.cu`` on the
    CPU: per tile, the heads among its own rows fold their runs left to
    right from the staged rows (tile + halo) and store them, each head also
    writing the identity into the ids skipped before it; a run that outlasts
    the staged rows is continued window by window; every block writes its
    share of the identity below ``seg[0]`` and above ``seg[n - 1]``.  Every
    store is counted: each slot must be written exactly once."""
    n = seg.size
    ident = np.asarray(tso.reduce_identity(op, torch.from_numpy(vals[:0]).dtype))
    ident = ident.astype(vals.dtype)
    out = np.full(s, 0x5A5A5A5A, np.uint32).view(vals.dtype)
    writes = np.zeros(s, np.int64)

    def store(slot, v):
        out[slot] = v
        writes[slot] += 1

    def fold(lo, lim, sid, acc):
        j = lo
        while j < lim and seg[j] == sid:
            acc = _combine(op, acc, vals[j])
            j += 1
        return j, acc

    window = tile + halo
    for row0 in range(0, n, tile):
        lim, own = min(window, n - row0), min(tile, n - row0)
        cont = None
        for r in range(own):
            i = row0 + r
            sid = int(seg[i])
            if i > 0 and sid == seg[i - 1]:
                continue
            if i > 0:
                for g in range(max(int(seg[i - 1]) + 1, 0), min(sid, s)):
                    store(g, ident)
            if not 0 <= sid < s:
                continue
            end, acc = fold(i, row0 + lim, sid, ident)
            if end == row0 + lim and end < n:
                assert cont is None            # one run a tile crosses out
                cont = (end, sid, acc)
            else:
                store(sid, acc)
        if cont is not None:
            pos, sid, acc = cont
            while True:
                lim2 = min(window, n - pos)
                end, acc = fold(pos, pos + lim2, sid, acc)
                if end < pos + lim2 or pos + lim2 == n:
                    store(sid, acc)
                    break
                pos += lim2
    # every block writes its share of the stripes: one block a tile, and
    # at least one a ``fill_slots`` slots of the output
    blocks = max(-(-n // tile), -(-s // fill_slots))
    share = -(-(-(-s // blocks)) // 4) * 4
    lo, hi = min(int(seg[0]), s), max(int(seg[-1]) + 1, 0)
    for b in range(blocks):
        slots = np.arange(b * share, min((b + 1) * share, s))
        for g in slots[(slots < lo) | (slots >= hi)]:
            store(g, ident)
    np.testing.assert_array_equal(writes, np.ones(s, np.int64))
    return out


def _reduce_ids(case, gen):
    """(ids, S) for the scheme's edge cases."""
    if case == "leading_minus_ones":
        return np.repeat(np.arange(-1, 300, dtype=np.int32),
                         np.r_[70, gen.integers(1, 9, 300)]), 400
    if case == "tail_past_s":
        return np.repeat(np.arange(0, 260, dtype=np.int32), gen.integers(1, 9, 260)), 200
    if case == "skipped_ids":      # gaps of 1-5 ids, within the Pallas window
        ids = np.cumsum((gen.integers(0, 4, 3000) == 0) * gen.integers(1, 6, 3000))
        return (ids + 5).astype(np.int32), int(ids[-1]) + 40
    if case == "runs_across_tiles":     # 1,000-row runs cross tiles and halos
        return np.repeat(np.arange(1, 5, dtype=np.int32), [1500, 1000, 190, 1313]), 9
    if case == "one_run":
        return np.full(2600, 3, np.int32), 7
    if case == "one_row":
        return np.array([2], np.int32), 5
    # "ragged": 2,500 rows, no multiple of the tile, ~7 rows a run
    return np.sort(gen.integers(-3, 400, 2500)).astype(np.int32), 380


REDUCE_CASES = ["leading_minus_ones", "tail_past_s", "skipped_ids", "runs_across_tiles",
                "one_run", "one_row", "ragged"]


@pytest.mark.parametrize("case", REDUCE_CASES)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_segment_reduce_one_pass_scheme_matches_pallas_and_xla(case, dtype):
    """The kernel's one-pass scheme at its own geometry (1,024-row tiles, a
    64-row halo, a block at least every 4,096 output slots) and on small
    tiles (8 rows, a 4-row halo, 16 slots), so every run crosses tiles:
    each slot written once, bitwise the XLA reference (float32 sums in row
    order) and the Pallas kernel in interpret mode (on integer-valued
    values, where its one-hot sums are exact), for sum, min and max."""
    gen = np.random.default_rng(len(case) * 7 + len(dtype))
    seg, s = _reduce_ids(case, gen)
    n = seg.size
    if dtype == "int32":
        vals = gen.integers(-1000, 1000, n).astype(np.int32)
        exact = vals
    else:
        vals = (gen.standard_normal(n) * 10.0 ** gen.integers(-3, 5, n)).astype(np.float32)
        exact = gen.integers(-50, 50, n).astype(np.float32)
    for op in ("sum", "min", "max"):
        xla = _np(jso.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), s, op, impl="xla"))
        pallas = _np(jso.segment_reduce_pallas(jnp.asarray(exact), jnp.asarray(seg), s, op,
                                               interpret=True))
        for geometry in ((1024, 64, 4096), (8, 4, 16)):
            np.testing.assert_array_equal(
                _replay_segment_reduce(vals, seg, s, op, *geometry), xla)
            np.testing.assert_array_equal(
                _replay_segment_reduce(exact, seg, s, op, *geometry), pallas)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_reduce_float_sums_take_the_row_order_fold(monkeypatch, dtype):
    """With the kernels chosen (``backend.resolve`` forced to ``"cuda"``), a
    float sum without ``impl`` or ``assume_exact`` goes to the row-order fold,
    as the JAX package sends it to XLA; an explicit ``impl="cuda"`` or
    ``assume_exact=True``, and every integer sum or min / max, go to the
    sorted-id kernel.  The wrappers run their plain versions on these CPU
    tensors, so the fold's result is held bitwise against the JAX package's
    own dispatch on unsorted ids."""
    monkeypatch.setattr(backend, "resolve", lambda device, impl=None: "cuda")
    calls = []
    for name in ("ordered_histogram_cuda", "segment_reduce_cuda"):
        real = getattr(tso.ops, name)
        monkeypatch.setattr(tso.ops, name,
                            lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    gen = np.random.default_rng(18)
    ids = gen.integers(-2, 45, 3000).astype(np.int32)            # unsorted
    if dtype == "float32":
        vals = (gen.standard_normal(3000) * 10.0 ** gen.integers(-3, 5, 3000)).astype(np.float32)
    else:
        vals = gen.integers(-9, 9, 3000).astype(np.int32)
    want = _np(jso.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), 40, "sum"))
    got = tso.segment_reduce(T(vals), T(ids), 40, "sum")
    np.testing.assert_array_equal(got.numpy(), want)
    fold = dtype == "float32"
    assert calls == ["ordered_histogram_cuda" if fold else "segment_reduce_cuda"]
    calls.clear()
    srt = np.sort(ids)
    tso.segment_reduce(T(vals), T(srt), 40, "sum", assume_exact=True)
    tso.segment_reduce(T(vals), T(srt), 40, "sum", impl="cuda")
    tso.segment_reduce(T(vals), T(srt), 40, "max")
    assert calls == ["segment_reduce_cuda"] * 3


# ------------------------------- the counting kernels' plan, replayed
def _replay_counting(keys, w, num_bins, into, plan):
    """``count_rows`` then ``count_finish`` as the plan lays them out: block
    g adds the rows of its ``per_block`` 4-row groups (and block 0 the head
    and tail rows) into its bins, stored as ``partials[g, b]``; then each
    bin is ``into[b] + sum_g partials[g, b]``, wrapped to int32.  Also
    returns how many blocks read each row (every row exactly once)."""
    n = keys.shape[0]
    ok = (keys >= 0) & (keys < num_bins) & (w != 0)
    partials = np.zeros((plan.grid, num_bins), np.int64)
    reads = np.zeros(n, np.int64)
    edge = np.r_[0:plan.head, plan.head + 4 * plan.groups:n]
    for g in range(plan.grid):
        g0 = g * plan.per_block
        g1 = min(plan.groups, g0 + plan.per_block)
        rows = np.arange(plan.head + 4 * g0, plan.head + 4 * max(g0, g1))
        if g == 0:
            rows = np.concatenate([rows, edge])
        reads[rows] += 1
        r = rows[ok[rows]]
        np.add.at(partials[g], keys[r], w[r].astype(np.int64))
    out = partials.sum(0) + (0 if into is None else into.astype(np.int64))
    wrapped = ((out + 2**31) % 2**32 - 2**31).astype(np.int32)
    return wrapped, reads


COUNT_CASES = [  # (kind, bins or (S, D), n, sms)
    ("histogram", 1, 5001, 3), ("histogram", 26, 20_003, 2),
    ("histogram", 26, 1, 132), ("histogram", 26, 0, 132),
    ("histogram", 676, 9_999, 4), ("pair_count", (3, 200), 7_777, 2),
    ("pair_count", (26, 26), 20_001, 2), ("pair_count", (26, 26), 6, 132)]


@pytest.mark.parametrize("case", COUNT_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
@pytest.mark.parametrize("wkind", ["bool", "signed"])
@pytest.mark.parametrize("with_into", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_counting_plan_replays_pallas_and_xla(case, wkind, with_into, offset):
    """The counting kernels' plan (``counting.count_plan``), replayed on the
    CPU at the wrapper's grid and head for a card of ``sms`` SMs:
    every row is read by exactly one block, and the per-block partials plus
    the finishing sum onto ``into`` give the JAX package's Pallas kernel
    (interpret mode) and XLA reference bitwise; bool and signed int32
    weights, ids of -1 and past the bound, sizes no multiple of 4 or of a
    block's share, and a slice that starts off a 16-byte boundary."""
    from repro_torch.kernels.segment_ops import counting

    kind, bins, n, sms = case
    s, d = (bins, 1) if kind == "histogram" else bins
    nb = s * d
    gen = np.random.default_rng(nb + n + offset)
    src = gen.integers(-1, s + 2, n + offset).astype(np.int32)
    dst = gen.integers(-1, d + 2, n + offset).astype(np.int32)
    w = (gen.random(n + offset) < 0.6 if wkind == "bool"
         else gen.integers(-3, 4, n + offset).astype(np.int32))
    into = gen.integers(-2**31, 2**31 - 1, nb).astype(np.int32) if with_into else None
    # the tensors the wrapper sees: slices starting ``offset`` rows in
    ts, td, tw = (T(x)[offset:] for x in (src, dst, w))
    src, dst, w = src[offset:], dst[offset:], w[offset:]
    ids = (ts,) if kind == "histogram" else (ts, td)
    head = counting.head_rows(*ids, tw)
    assert head == (4 - offset) % 4 or n == 0        # an empty slice: no launch
    plan = counting.count_plan(n, nb, sms, head)
    assert counting.shared_route(nb) and plan.vec
    assert plan.head == min(head, n) and plan.tail < 4 or n < 4
    assert 1 <= plan.grid <= 2 * sms
    keys = (src if kind == "histogram"
            else np.where((src >= 0) & (src < s) & (dst >= 0) & (dst < d),
                          src * d + dst, -1))
    got, reads = _replay_counting(keys, w.astype(np.int32), nb, into, plan)
    np.testing.assert_array_equal(reads, np.ones(n, np.int64))
    jw = jnp.asarray(w)
    jinto = None if into is None else jnp.asarray(into if kind == "histogram"
                                                   else into.reshape(s, d))
    wi = jnp.asarray(w.astype(np.int32))
    if kind == "histogram":
        pallas = _np(jso.histogram_pallas(jnp.asarray(src), wi, nb, block_e=256,
                                          interpret=True))
        xla = _np(jso.histogram(jnp.asarray(src), nb, jw, into=jinto, impl="xla"))
    else:
        pallas = _np(jso.pair_count_pallas(
            jnp.asarray(src), jnp.asarray(dst), wi.astype(jnp.float32), s, d,
            block_e=256, interpret=True)).astype(np.int32).reshape(-1)
        xla = _np(jso.pair_count(jnp.asarray(src), jnp.asarray(dst), s, d, jw,
                                 into=jinto, impl="xla")).reshape(-1)
    if into is not None:
        pallas = (pallas.astype(np.int64) + into).astype(np.int64)
        pallas = ((pallas + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    # the wrapper on these CPU tensors (its plain version) agrees too
    tinto = None if into is None else T(into).reshape((s,) if kind == "histogram" else (s, d))
    if kind == "histogram":
        wrapped = tso.histogram_cuda(ts, tw, nb, tinto)
    else:
        wrapped = tso.pair_count_cuda(ts, td, tw, s, d, tinto)
    np.testing.assert_array_equal(wrapped.numpy().reshape(-1), xla)


@pytest.mark.parametrize("n,sms", [(0, 132), (3, 132), (524_288, 132),
                                   (7_003_349, 132), (10_000, 1)])
@pytest.mark.parametrize("bins", [1, 26, 676, 241 * 241])
def test_counting_plan_geometry(n, sms, bins):
    """The grid covers the 4-row groups once at about one group a thread, at
    most two blocks an SM while two blocks' bins fit an SM's shared memory;
    misaligned inputs read every group as scalars; 242^2 bins take the
    global route."""
    from repro_torch.kernels.segment_ops import counting

    for head in (0, 3, None):
        p = counting.count_plan(n, bins, sms, head)
        assert p.vec == (head is not None)
        assert p.head + 4 * p.groups + p.tail == n and 0 <= p.tail < 4
        assert p.grid * p.per_block >= p.groups > (p.grid - 1) * p.per_block or p.groups == 0
        two = 4 * bins <= counting.SHARED_BYTES // 2 - 1024
        assert p.grid <= (2 if two else 1) * sms
        assert p.grid == max(1, min(-(-p.groups // counting.THREADS), (2 if two else 1) * sms))
    assert counting.shared_route(241 * 241) and not counting.shared_route(242 * 242)


def test_ops_pass_bool_masks_and_int32_into_to_the_kernels(monkeypatch):
    """With the kernels chosen (``backend.resolve`` forced to ``"cuda"``),
    ``ops.histogram`` / ``ops.pair_count`` hand a bool mask and an int32
    ``into`` to the kernels' wrappers as they are (no cast, no add after),
    while an int64 ``into`` still takes JAX's ``into + out`` (int64); the
    wrappers run their plain versions on these CPU tensors, and every result
    equals the JAX package's ``ops`` bitwise."""
    monkeypatch.setattr(backend, "resolve", lambda device, impl=None: "cuda")
    calls = []
    for name in ("histogram_cuda", "pair_count_cuda"):
        real = getattr(tso.ops, name)
        monkeypatch.setattr(tso.ops, name,
                            lambda *a, _real=real, _name=name: calls.append((_name, a))
                            or _real(*a))
    gen = np.random.default_rng(19)
    n, a = 5000, 26
    src = gen.integers(-1, a + 1, n).astype(np.int32)
    dst = gen.integers(-1, a + 1, n).astype(np.int32)
    mask = gen.random(n) < 0.6
    h_into = gen.integers(0, 1000, a).astype(np.int32)
    p_into = gen.integers(0, 1000, (a, a)).astype(np.int32)
    tmask = T(mask)
    for into_np, dtype in ((h_into, np.int32), (h_into, np.int64), (None, None)):
        tinto = None if into_np is None else T(into_np.astype(dtype))
        jinto = None if into_np is None else jnp.asarray(into_np.astype(dtype))
        got = tso.histogram(T(src), a, tmask, into=tinto)
        want = _np(jso.histogram(jnp.asarray(src), a, jnp.asarray(mask), into=jinto,
                                 impl="xla"))
        assert got.dtype == (torch.int64 if dtype == np.int64 else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)
        (name, args), = calls
        calls.clear()
        assert name == "histogram_cuda" and args[1] is tmask      # uncast
        assert args[3] is (tinto if dtype == np.int32 else None)
    for into_np, dtype in ((p_into, np.int32), (p_into, np.int64), (None, None)):
        tinto = None if into_np is None else T(into_np.astype(dtype))
        jinto = None if into_np is None else jnp.asarray(into_np.astype(dtype))
        got = tso.pair_count(T(src), T(dst), a, weights=tmask, into=tinto)
        want = _np(jso.pair_count(jnp.asarray(src), jnp.asarray(dst), a,
                                  weights=jnp.asarray(mask), into=jinto, impl="xla"))
        assert got.dtype == (torch.int64 if dtype == np.int64 else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)
        (name, args), = calls
        calls.clear()
        assert name == "pair_count_cuda" and args[2] is tmask
        assert args[5] is (tinto if dtype == np.int32 else None)
    # int8 weights still become int32 (JAX's astype), counts unchanged
    w8 = gen.integers(-3, 4, n).astype(np.int8)
    got = tso.histogram(T(src), a, T(w8), into=T(h_into))
    (name, args), = calls
    assert args[1].dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(jso.histogram(
        jnp.asarray(src), a, jnp.asarray(w8), into=jnp.asarray(h_into), impl="xla")))


def test_dfg_update_hands_the_state_to_the_kernels(monkeypatch):
    """``dfg_kernel``'s update passes each bool mask and its int32 state to
    the counting kernels as ``into`` (three calls, no add after them), and a
    streamed DFG through that path equals the JAX package's bitwise."""
    import importlib

    from repro_torch.core import ChunkedEventFrame, run_streaming
    from repro_torch.data import synthetic

    dfg_mod = importlib.import_module("repro_torch.core.dfg")
    monkeypatch.setattr(backend, "resolve", lambda device, impl=None: "cuda")
    calls = []
    for name in ("histogram_cuda", "pair_count_cuda"):
        real = getattr(tso.ops, name)
        monkeypatch.setattr(tso.ops, name,
                            lambda *a, _real=real, _name=name: calls.append((_name, a))
                            or _real(*a))
    frame, _ = synthetic.generate(num_cases=300, num_activities=9, seed=4, device="cpu")
    dfg_mod._dfg_kernel.cache_clear()
    try:
        got = run_streaming(dfg_mod.dfg_kernel(9), ChunkedEventFrame.from_frame(frame, 257))
    finally:
        dfg_mod._dfg_kernel.cache_clear()
    chunks = -(-frame.nrows // 257)
    assert [c[0] for c in calls] == ["pair_count_cuda", "histogram_cuda",
                                     "histogram_cuda"] * chunks
    for name, args in calls:
        w, into = (args[2], args[5]) if name == "pair_count_cuda" else (args[1], args[3])
        assert w.dtype == torch.bool and into is not None and into.dtype == torch.int32
    want = dfg_mod.dfg(frame, 9)
    for nm in ("counts", "starts", "ends"):
        assert torch.equal(getattr(got, nm), getattr(want, nm))
