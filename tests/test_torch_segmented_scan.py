"""PyTorch port, segmented scans: the plain versions that every CPU tensor
takes (and the CUDA wrappers, which take them on CPU tensors) held against
the JAX package's Pallas kernels (interpret mode) and XLA folds on the same
numpy inputs.  Tolerance 0 everywhere: the polyhash and affine scans are
uint32 mod 2^32, the one-hot prefix sums are integer-valued float32, and
the non-integer float32 sums are added in row order in both packages (the
JAX side runs its sequential ``impl="xla"`` fold for those).  Also the
unsigned ``segment_reduce`` route the variants take."""
import importlib

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


# ------------------------------------- the single-pass scan's scheme, replayed
M32 = np.uint64(0xFFFFFFFF)
IDENTITY = (np.uint64(1), np.uint64(0))


def _compose(f, g):
    """The map of f then g, ``h -> h*m + a`` on uint32 (uint64 arithmetic
    wraps mod 2^64, so the & keeps it exact mod 2^32)."""
    with np.errstate(over="ignore"):
        return (f[0] * g[0]) & M32, (f[1] * g[0] + g[1]) & M32


def _look_back(status, tile, lanes, per_lane):
    """The state entering ``tile``: warp 0 reads ``lanes * per_lane``
    predecessors a round (lane l the tiles hi - per_lane l - i, nearest
    first), each lane composes back to its nearest inclusive state, lanes
    past the nearest lane with one count as the identity, and a shuffle-down
    tree composes the window; windows repeat until one holds an inclusive
    state.  ``status[j]`` is ``(kind, (m, a))``, kind 2 inclusive."""
    acc = IDENTITY
    hi = tile - 1
    while True:
        maps, found = [], []
        for lane in range(lanes):
            f, inc = IDENTITY, False
            for i in range(per_lane):
                j = hi - per_lane * lane - i
                kind, g = status[j] if j >= 0 else (2, (np.uint64(0), np.uint64(0)))
                f = _compose(g, f)
                if kind == 2:
                    inc = True
                    break
            maps.append(f)
            found.append(inc)
        first = found.index(True) if any(found) else lanes
        maps = [f if lane <= first else IDENTITY for lane, f in enumerate(maps)]
        d = 1
        while d < lanes:
            maps = [_compose(maps[lane + d], maps[lane]) if lane + d < lanes else maps[lane]
                    for lane in range(lanes)]
            d *= 2
        acc = _compose(maps[0], acc)
        if any(found):
            return acc[1]          # acc starts with an inclusive state: m = 0
        hi -= lanes * per_lane


def _replay_affine_scan(mul, add, starts, carry, threads, items, per_lane, seed):
    """``affine_scan`` of ``kernels/csrc/segmented_scan.cu`` on the CPU:
    row maps (0, add) at flagged rows and (mul, add) elsewhere, identity past
    n; per tile a serial compose of each thread's ``items`` rows, a
    Hillis-Steele warp scan of the threads' maps and a block compose of the
    warps'; then, in a random completion order (all aggregates published
    first), each tile's decoupled look-back for the state entering it,
    the carry as the constant map (0, carry) in front of tile 0."""
    n = len(add)
    rows = threads * items
    tiles = -(-n // rows)
    pad = tiles * rows - n
    m = np.concatenate([np.where(starts, 0, mul).astype(np.uint64),
                        np.ones(pad, np.uint64)]).reshape(tiles, threads, items)
    a = np.concatenate([add.astype(np.uint64),
                        np.zeros(pad, np.uint64)]).reshape(tiles, threads, items)
    t_map = (np.ones((tiles, threads), np.uint64), np.zeros((tiles, threads), np.uint64))
    for k in range(items):
        t_map = _compose(t_map, (m[..., k], a[..., k]))
    warps = threads // 32
    inc = tuple(x.reshape(tiles, warps, 32) for x in t_map)
    d = 1
    while d < 32:
        shifted = _compose((inc[0][..., :-d], inc[1][..., :-d]), (inc[0][..., d:], inc[1][..., d:]))
        inc = tuple(np.concatenate([x[..., :d], s], axis=-1) for x, s in zip(inc, shifted))
        d *= 2
    excl = tuple(np.concatenate([np.full((tiles, warps, 1), v, np.uint64), x[..., :-1]], axis=-1)
                 for x, v in zip(inc, IDENTITY))
    w_agg = (inc[0][..., -1], inc[1][..., -1])
    tile_agg = IDENTITY
    w_pre = [IDENTITY]
    for w in range(warps):
        tile_agg = _compose(tile_agg, (w_agg[0][:, w], w_agg[1][:, w]))
        w_pre.append(tile_agg)
    status = [(1, (tile_agg[0][t], tile_agg[1][t])) for t in range(tiles)]
    state_in = np.zeros(tiles, np.uint64)
    c = np.uint64(int(carry))
    state_in[0] = c
    status[0] = (2, (np.uint64(0), _compose((np.uint64(0), c), status[0][1])[1]))
    for t in np.random.default_rng(seed).permutation(np.arange(1, tiles)):
        state_in[t] = _look_back(status, t, 32, per_lane)
        status[t] = (2, (np.uint64(0), _compose((np.uint64(0), state_in[t]), status[t][1])[1]))
    # each thread's rows from the state entering it
    h = np.broadcast_to(state_in[:, None, None], (tiles, warps, 32)).copy()
    for_warp = (np.stack([np.broadcast_to(w_pre[w][0], (tiles,)) for w in range(warps)], 1),
                np.stack([np.broadcast_to(w_pre[w][1], (tiles,)) for w in range(warps)], 1))
    with np.errstate(over="ignore"):
        h = (h * for_warp[0][..., None] + for_warp[1][..., None]) & M32
        h = (h * excl[0] + excl[1]) & M32
        h = h.reshape(tiles, threads)
        ys = np.empty((tiles, threads, items), np.uint64)
        for k in range(items):
            h = (h * m[..., k] + a[..., k]) & M32
            ys[..., k] = h
    return ys.reshape(-1)[:n].astype(np.uint32)


def _fold(mul, add, starts, carry):
    h, out = int(carry), np.empty(len(add), np.uint32)
    for i, (mi, ai, fi) in enumerate(zip(mul.tolist(), add.tolist(), starts.tolist())):
        h = ((0 if fi else h) * mi + ai) & 0xFFFFFFFF
        out[i] = h
    return out


def _ghost_starts(n_segments):
    """A ghost chunk's start flags as the JAX query executor pads one
    (``query/exec.py`` ``_ghost_chunk``): one row per case segment, the tail
    case repeated up to the next power of two, so rows d-1 .. 2^k - 1 are
    one unflagged run; the maps on the padding are the identity."""
    m = 1 << (n_segments - 1).bit_length()
    starts = np.zeros(m, bool)
    starts[:n_segments] = True
    return starts, m


SCHEME_CASES = {
    # name: (n, flag probability, row 0 flagged, carry)
    "one_row": (1, 0.2, False, 0x9E3779B9),
    "tile_minus_one": (4095, 0.2, True, 0),
    "one_tile": (4096, 0.15, False, 7),
    "tile_plus_one": (4097, 0.15, False, 0xFFFFFFFF),
    "runs_across_tiles": (3 * 4096 + 5, 0.0005, True, 0),
    "one_run_over_every_tile": (5 * 4096 + 3, 0.0, False, 0x12345678),
    "one_run_flagged_row0": (5 * 4096 + 3, 0.0, True, 0x12345678),
}


@pytest.mark.parametrize("name", sorted(SCHEME_CASES) + ["ghost_chunk"])
def test_single_pass_scan_scheme_matches_pallas_and_fold(name):
    """The kernel's single-pass scheme at its own geometry (256 threads x 16
    rows a tile, 4 tiles a lane of the look-back), replayed on the CPU,
    equals the sequential fold and the Pallas kernels (interpret mode),
    bitwise, ``carry_out`` included: runs crossing tile edges, one run over
    every tile, row 0 flagged and not, nonzero carries, n not a multiple of
    the tile, and a ghost chunk of 2^14 rows whose last 7,384 are one run."""
    # the module, not the package's segmented_scan function of that name
    ss = importlib.import_module("repro_torch.kernels.segment_ops.segmented_scan")
    gen = np.random.default_rng(len(name) * 31 + 5)
    if name == "ghost_chunk":
        starts, n = _ghost_starts(9001)
        flag0, carry = True, np.uint32(0xDEADBEEF)
    else:
        n, p, flag0, carry = SCHEME_CASES[name]
        carry = np.uint32(carry)
        starts = gen.random(n) < p
        starts[0] = flag0
    mul = gen.integers(0, 2**32, n, dtype=np.uint32)
    add = gen.integers(0, 2**32, n, dtype=np.uint32)
    if name == "ghost_chunk":
        d = int(starts.sum())
        mul[d:], add[d:] = 1, 0
    assert ss.TILE_ROWS == 256 * 16
    assert ss.scratch_shape(n) == (1 + -(-n // ss.TILE_ROWS), 32)
    want = _fold(mul, add, starts, carry)
    for base in (None, BASES[1]):
        m = mul if base is None else np.full(n, base, np.uint32)
        fold = want if base is None else _fold(m, add, starts, carry)
        got = _replay_affine_scan(m, add, starts, carry, 256, 16, 4, seed=n)
        np.testing.assert_array_equal(got, fold)
        if base is None:
            ys, c = jso.segmented_affine(jnp.asarray(m), jnp.asarray(add), jnp.asarray(starts),
                                         jnp.uint32(carry), impl="pallas", block_e=4096)
        else:
            ys, c = jso.segmented_scan(jnp.asarray(add), jnp.asarray(starts), jnp.uint32(carry),
                                       "polyhash", base=base, impl="pallas", block_e=4096)
        np.testing.assert_array_equal(np.asarray(ys), got)
        assert int(c) == int(got[-1])


@pytest.mark.parametrize("per_lane", [1, 4])
@pytest.mark.parametrize("p", [0.0, 0.01])
def test_single_pass_scan_scheme_over_many_windows(per_lane, p):
    """The same scheme on small tiles (32 threads x 2 rows), so 20,000 rows
    make 313 tiles and a look-back crosses several windows of
    32 x ``per_lane`` tiles; equal to the sequential fold bitwise."""
    gen = np.random.default_rng(int(p * 100) + per_lane)
    n = 20_000
    starts = gen.random(n) < p
    starts[0] = False
    mul = gen.integers(0, 2**32, n, dtype=np.uint32)
    add = gen.integers(0, 2**32, n, dtype=np.uint32)
    carry = np.uint32(0xCAFEF00D)
    got = _replay_affine_scan(mul, add, starts, carry, 32, 2, per_lane, seed=7)
    np.testing.assert_array_equal(got, _fold(mul, add, starts, carry))


# ------------------------------- the tile-staged sum scan's scheme, replayed
def _replay_sum_scan(x, starts, carry, rows, halo):
    """``sum_scan`` of ``kernels/csrc/segmented_scan.cu`` on the CPU: tile t
    stages rows [t rows, (t + 1) rows + halo), owns the runs whose heads
    (row 0, or a flagged row) lie in its first ``rows`` rows, folds each in
    row order from the staged rows (row 0 unflagged from the carry, a
    flagged head from 0), and stores rows [first head, end of its last run);
    a last run that outlasts the staged rows is continued window by window.
    The row that is stored last at n - 1 gives ``carry_out``.  Every row is
    written exactly once."""
    n = x.shape[0]
    ys = np.full(x.shape, 0x5A5A5A5A, np.uint32).view(x.dtype)
    writes = np.zeros(n, np.int64)
    carry_out = None
    win = rows + halo
    for row0 in range(0, n, rows):
        lim, own = min(win, n - row0), min(rows, n - row0)
        sx = x[row0:row0 + lim].copy()
        heads = [r for r in range(own) if row0 + r == 0 or starts[row0 + r]]
        in_halo = [r for r in range(own, lim) if starts[row0 + r]]
        stop = in_halo[0] if in_halo else lim
        if not heads:
            continue
        more = stop == lim and row0 + lim < n
        for h, r0 in enumerate(heads):
            r1 = heads[h + 1] if h + 1 < len(heads) else stop
            acc = carry.copy() if row0 + r0 == 0 and not starts[0] else np.zeros_like(carry)
            for r in range(r0, r1):
                acc = acc + sx[r]
                sx[r] = acc
        ys[row0 + heads[0]:row0 + stop] = sx[heads[0]:stop]
        writes[row0 + heads[0]:row0 + stop] += 1
        if row0 + stop == n:
            carry_out = sx[stop - 1]
        pos = row0 + lim
        while more:
            lim2 = min(win, n - pos)
            flagged = np.flatnonzero(starts[pos:pos + lim2])
            end = int(flagged[0]) if flagged.size else lim2
            for r in range(end):
                acc = acc + x[pos + r]
                ys[pos + r] = acc
            writes[pos:pos + end] += 1
            if pos + end == n:
                carry_out = acc
            more = end == lim2 and pos + lim2 < n
            pos += lim2
    np.testing.assert_array_equal(writes, np.ones(n, np.int64))
    return ys, carry_out


SUM_SCHEME_CASES = {
    # name: (n, flag probability, row 0 flagged)
    "row0_from_carry": (700, 1 / 7, False),
    "row0_flagged": (700, 1 / 7, True),
    "runs_across_tiles": (1500, 1 / 150, False),
    "tiles_without_heads": (2000, 1 / 900, True),
    "one_run": (1300, 0.0, False),
    "one_row": (1, 0.0, False),
}


@pytest.mark.parametrize("name", sorted(SUM_SCHEME_CASES))
@pytest.mark.parametrize("k", [1, 26])
def test_sum_scan_tile_scheme_matches_pallas_and_fold(name, k):
    """The kernel's tile-staged scheme at its own geometry (``sum_tile_rows``
    rows a tile, a 16-row halo) and on small tiles (8 rows, a 4-row halo,
    so runs cross tiles and halos), replayed on the CPU: bitwise the
    sequential XLA fold on non-integer float32 rows and the Pallas kernel
    (interpret mode) on integer-valued rows, ``carry_out`` included; K = 1
    is (N,) rows with a 0-d carry."""
    ss = importlib.import_module("repro_torch.kernels.segment_ops.segmented_scan")
    n, p, flag0 = SUM_SCHEME_CASES[name]
    gen = np.random.default_rng(len(name) * 3 + k)
    starts = gen.random(n) < p
    starts[0] = flag0
    if name == "tiles_without_heads":
        starts[:] = False
        starts[[0, 5, 1400]] = True
    shape = (n, k) if k > 1 else (n,)
    x = (gen.standard_normal(shape) * 10.0 ** gen.integers(-3, 5, shape)).astype(np.float32)
    xi = gen.integers(-9, 9, shape).astype(np.float32)
    carry = gen.standard_normal(shape[1:]).astype(np.float32)
    ci = gen.integers(-9, 9, shape[1:]).astype(np.float32)
    assert ss.sum_tile_rows(k) == 256 and ss.sum_tile_rows(300) == 16
    for rows, halo in ((ss.sum_tile_rows(k), 16), (8, 4)):
        for vals, c, impl in ((x, carry, "xla"), (xi, ci, "pallas")):
            ys, out = jso.segmented_scan(jnp.asarray(vals), jnp.asarray(starts), jnp.asarray(c),
                                         "sum", impl=impl, block_e=128)
            got, got_c = _replay_sum_scan(vals.reshape(n, -1), starts, c.reshape(-1),
                                          rows, halo)
            np.testing.assert_array_equal(got.reshape(shape), np.asarray(ys))
            np.testing.assert_array_equal(got_c.reshape(c.shape), np.asarray(out))
