"""PyTorch port, segmented scans: the plain versions that every CPU tensor
takes (and the CUDA wrappers, which take them on CPU tensors) held against
the JAX package's Pallas kernels (interpret mode) and XLA folds on the same
numpy inputs.  Tolerance 0 everywhere: the polyhash and affine scans are
uint32 mod 2^32, the one-hot prefix sums are integer-valued float32, and
the non-integer float32 sums are added in row order in both packages (the
JAX side runs its sequential ``impl="xla"`` fold for those).  Also the
unsigned ``segment_reduce`` route the variants take."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import segment_ops as jso  # noqa: E402
from repro_torch.kernels import segment_ops as tso  # noqa: E402

rng = np.random.default_rng(13)
BASES = (1_000_003, 16_777_619)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x: np.ndarray) -> torch.Tensor:
    """uint32 numpy values as the port's int32 bit patterns."""
    return T(np.asarray(x, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _starts(n, p, flag0):
    s = rng.random(n) < p
    if n:
        s[0] = flag0
    return s


@pytest.mark.parametrize("n,block", [(1, 128), (64, 64), (513, 256), (1000, 64)])
@pytest.mark.parametrize("flag0", [True, False])
def test_polyhash_and_affine_match_jax(n, block, flag0):
    starts = _starts(n, 0.2, flag0)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    mul = rng.integers(0, 2**32, n, dtype=np.uint32)
    carry = np.uint32(rng.integers(0, 2**32))
    js = jnp.asarray(starts)
    for base in BASES:
        want = [jso.segmented_scan(jnp.asarray(vals), js, jnp.uint32(carry),
                                   "polyhash", base=base, impl=impl, block_e=block)
                for impl in ("xla", "pallas")]
        got_w = tso.segmented_polyhash_cuda(_bits(vals), T(starts),
                                            _bits(carry).reshape(()), base)
        got_o = tso.segmented_scan(T(vals), T(starts), int(carry), "polyhash",
                                   base=base)
        assert got_o[0].dtype == got_o[1].dtype == torch.uint32
        for ys, c in want:
            np.testing.assert_array_equal(_u32(got_w[0]), np.asarray(ys))
            assert int(_u32(got_w[1])) == int(c)
            np.testing.assert_array_equal(got_o[0].view(torch.int32).numpy(),
                                          got_w[0].numpy())
    want = [jso.segmented_affine(jnp.asarray(mul), jnp.asarray(vals), js,
                                 jnp.uint32(carry), impl=impl, block_e=block)
            for impl in ("xla", "pallas")]
    got = tso.segmented_affine_cuda(_bits(mul), _bits(vals), T(starts),
                                    _bits(carry).reshape(()))
    got_o = tso.segmented_affine(_bits(mul), _bits(vals), T(starts), int(carry))
    assert got_o[0].dtype == torch.int32
    for ys, c in want:
        np.testing.assert_array_equal(_u32(got[0]), np.asarray(ys))
        np.testing.assert_array_equal(_u32(got_o[0]), np.asarray(ys))
        assert int(_u32(got[1])) == int(c) == int(_u32(got_o[1]))


@pytest.mark.parametrize("k", [1, 6, 26])
@pytest.mark.parametrize("flag0", [True, False])
def test_one_hot_sum_scan_matches_jax(k, flag0):
    n = 700
    x = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    x = x[:, 0].copy() if k == 1 else x
    starts = _starts(n, 0.15, flag0)
    carry = rng.integers(0, 4, k).astype(np.float32)
    carry = carry[0] if k == 1 else carry
    tc = torch.tensor(carry)
    for impl in ("xla", "pallas"):
        ys, c = jso.segmented_scan(jnp.asarray(x), jnp.asarray(starts),
                                   jnp.asarray(carry), "sum", impl=impl,
                                   block_e=128)
        for got in (tso.segmented_scan(T(x), T(starts), tc, "sum"),
                    tso.segmented_sum_scan_cuda(T(x), T(starts), tc)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ys))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(c))
            assert got[1].shape == np.asarray(c).shape


@pytest.mark.parametrize("k", [1, 26])
@pytest.mark.parametrize("flag0", [True, False])
def test_float_sum_scan_in_row_order(k, flag0):
    """Non-integer float32 rows across eight decades: every partial sum
    rounds, so only the row-order fold matches the sequential XLA scan."""
    n = 900
    shape = (n, k) if k > 1 else (n,)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 5, shape)
         ).astype(np.float32)
    carry = rng.standard_normal(shape[1:]).astype(np.float32)
    starts = _starts(n, 0.1, flag0)
    ys, c = jso.segmented_scan(jnp.asarray(x), jnp.asarray(starts),
                               jnp.asarray(carry), "sum", impl="xla")
    got = tso.segmented_scan(T(x), T(starts), T(carry), "sum")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ys))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(c))


@pytest.mark.parametrize("cuts", [[391], [1, 2, 3], list(range(1, 40)), [0, 899]])
def test_scan_carries_chain_across_chunks(cuts):
    """Seeding each piece with the previous piece's carry_out reproduces the
    whole-stream scan — chunk splits, 1-row chunks and a split inside a
    segment — for both uint32 scans and the float sum."""
    n = 900
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    x = (rng.standard_normal((n, 4)) * 100).astype(np.float32)
    starts = _starts(n, 0.2, True)
    whole_h, _ = jso.segmented_scan(jnp.asarray(vals), jnp.asarray(starts),
                                    jnp.uint32(0), "polyhash", base=BASES[0],
                                    impl="xla")
    whole_x, _ = jso.segmented_scan(jnp.asarray(x), jnp.asarray(starts),
                                    jnp.zeros(4, jnp.float32), "sum", impl="xla")
    edges = sorted(set([0, n] + [c for c in cuts if 0 < c < n]))
    ch = torch.tensor(0, dtype=torch.int32)
    cx = torch.zeros(4)
    hs, xs = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        y, ch = tso.segmented_scan(_bits(vals[lo:hi]), T(starts[lo:hi]), ch,
                                   "polyhash", base=BASES[0])
        hs.append(y)
        y, cx = tso.segmented_scan(T(x[lo:hi]), T(starts[lo:hi]), cx, "sum")
        xs.append(y)
    np.testing.assert_array_equal(_u32(torch.cat(hs)), np.asarray(whole_h))
    np.testing.assert_array_equal(torch.cat(xs).numpy(), np.asarray(whole_x))


def test_empty_scans_return_the_carry():
    e32 = torch.zeros(0, dtype=torch.int32)
    f = torch.zeros(0, dtype=torch.bool)
    c = torch.tensor(7, dtype=torch.int32)
    for ys, out in (tso.segmented_scan(e32, f, c, "polyhash", base=3),
                    tso.segmented_affine(e32, e32, f, c),
                    tso.segmented_polyhash_cuda(e32, f, c, 3)):
        assert ys.numel() == 0 and int(out) == 7
    ys, out = tso.segmented_scan(torch.zeros((0, 3)), f, torch.ones(3), "sum")
    assert ys.shape == (0, 3) and torch.equal(out, torch.ones(3))


def test_scan_argument_checks():
    v = torch.zeros(4, dtype=torch.int32)
    f = torch.zeros(4, dtype=torch.bool)
    c = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        tso.segmented_scan(v, f, c, "polyhash")               # no base
    with pytest.raises(ValueError):
        tso.segmented_scan(v, f, c, "prod")
    with pytest.raises(TypeError):
        tso.segmented_scan(v.float(), f, c, "polyhash", base=3)
    with pytest.raises(TypeError):
        tso.segmented_polyhash_cuda(v, f.to(torch.int32), c, 3)
    with pytest.raises(ValueError):
        tso.segmented_sum_scan_cuda(torch.zeros(4, 2), f, torch.zeros(3))


@pytest.mark.parametrize("n,s", [(0, 5), (1, 4), (300, 40), (1000, 1000)])
def test_uint32_segment_reduce_matches_jax(n, s):
    """uint32 values at and above 2^31 reduce unsigned (a signed max would
    lose them to the identity 0).  Every op against the XLA scatter; max,
    the op the variants take, against the Pallas kernel too (its uint32 sum
    goes through float32 and its uint32 min cannot pad with 2^32 - 1)."""
    # sorted, consecutive ids from -1 (the primitive's contract), some >= s
    step = rng.random(n) < min(1.0, 1.1 * s / max(n, 1))
    ids = (np.cumsum(step) - 1).astype(np.int32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals[rng.random(n) < 0.3] = 0xFFFFFFFF
    for op in ("sum", "min", "max"):
        impls = ("xla", "pallas") if op == "max" else ("xla",)
        want = [np.asarray(jso.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), s,
                                              op, impl=impl, block_e=128))
                for impl in impls]
        got_o = tso.segment_reduce(T(vals), T(ids), s, op)
        got_w = tso.segment_reduce_cuda(T(vals), T(ids), s, op)
        assert got_o.dtype == got_w.dtype == torch.uint32
        for w in want:
            assert w.dtype == np.uint32
            np.testing.assert_array_equal(_u32(got_o.view(torch.int32)), w)
            np.testing.assert_array_equal(_u32(got_w.view(torch.int32)), w)
