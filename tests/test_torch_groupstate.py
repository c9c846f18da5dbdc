"""PyTorch port, the group-state algebra (``engine.fold_group`` /
``merge_group_states`` / ``merge_tree`` / ``finalize_group`` and every
registered verb's ``stitch``), held on the CPU against the port's own
``run_streaming`` and against the JAX package's
``finalize_group(merge_tree(...))`` over the same numpy logs and cuts.

The JAX side runs its ``"xla"`` lowering; one case runs the variants
straddle through its Pallas kernels in interpret mode.  Tolerance 0
everywhere except centrality ``flow``, which is held within 1e-6 of JAX
(16 float32 products, summation order; ROADMAP Queue 3) and bitwise
against the port's own sequential fold.  Fingerprints (JAX: uint32, the
port: int64 in [0, 2^32)) are compared as uint32.  Fixed parametrised
seeds take the place of the JAX package's hypothesis searches.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import backend as jbackend  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import polyhash as jpolyhash  # noqa: E402
from repro.storage import edf as jedf  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402
from repro_torch.storage import edf as tedf  # noqa: E402

A, C = 5, 24
DIMS = (A, C)
FLOW_ATOL = 1e-6


def _mergeable(engine, dims):
    return sorted(n for n, s in engine.kernel_specs().items()
                  if engine.mergeable(s.make(dims)))


MERGEABLE = _mergeable(tengine, tengine.Dims(*DIMS))


def _log(seed, n_cases=C, max_len=7, masked=0.2):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64) * 3 + 5, lens)
    act = rng.integers(0, A, case.size).astype(np.int32)
    ts = np.cumsum(rng.random(case.size)).astype(np.float32)
    rv = rng.random(case.size) >= masked
    return {CASE: case, ACTIVITY: act, TIMESTAMP: ts}, rv


def _frames(cols, rv):
    jf = jcore.EventFrame.from_numpy(cols)
    jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _slice(frame, a, b):
    return type(frame)({k: v[a:b] for k, v in frame.columns.items()},
                       {k: v[a:b] for k, v in frame.valid.items()},
                       frame.row_valid[a:b])


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, path="result"):
    """A port result against a JAX (or port) result: bitwise, fingerprints
    as uint32, centrality ``flow`` within ``FLOW_ATOL`` of JAX."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (int, float, str, frozenset)):
        assert got == want, path
    else:
        g, w = _host(got), _host(want)
        if w.dtype == np.uint32 and g.dtype == np.int64:
            assert g.min(initial=0) >= 0 and g.max(initial=0) < 2**32, path
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        jax_side = not isinstance(want, torch.Tensor)
        if path.endswith(".flow") and jax_side:
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOW_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _fold(engine, kernel, frame, bounds, device=None):
    kw = {} if device is None else {"device": device}
    return [engine.fold_group(kernel, [_slice(frame, a, b)] if b > a else [],
                              **kw) for a, b in bounds]


def _both(name, bounds, cols, rv, tree="balanced"):
    """(port merged result, port streamed result, JAX merged result)."""
    jf, tf = _frames(cols, rv)
    tk = tengine.kernel_spec(name).make(tengine.Dims(*DIMS))
    jk = jengine.kernel_spec(name).make(jengine.Dims(*DIMS))
    t_states = _fold(tengine, tk, tf, bounds, "cpu")
    j_states = _fold(jengine, jk, jf, bounds)
    got = tengine.finalize_group(tk, tengine.merge_tree(tk, t_states))
    streamed = tengine.run_streaming(
        tk, tcore.ChunkedEventFrame.from_cuts(tf, [a for a, _ in bounds]))
    want = jengine.finalize_group(jk, jengine.merge_tree(jk, j_states))
    return got, streamed, want


def test_mergeable_specs_match_jax():
    """The port's mergeable registered verbs are exactly JAX's."""
    with jbackend.use_backend("xla"):
        want = _mergeable(jengine, jengine.Dims(*DIMS))
    assert MERGEABLE == want
    assert {"sojourn_times", "performance_dfg", "stats"}.isdisjoint(MERGEABLE)
    for name in MERGEABLE:
        assert tengine.kernel_spec(name).make(tengine.Dims(*DIMS)).stitch
    assert tcore.variants_kernel(4).ghost_sketch


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_associativity_and_identity(seed):
    """merge(merge(a,b),c) == merge(a,merge(b,c)) == the whole fold == JAX;
    the empty fold is the identity on either side.  Cut points are
    arbitrary row offsets (straddling cases, empty slices)."""
    cols, rv = _log(seed, n_cases=10, max_len=6)
    jf, tf = _frames(cols, rv)
    n = tf.nrows
    rng = np.random.default_rng(100 + seed)
    i, j = sorted(int(x) for x in rng.integers(0, n + 1, 2))
    if seed == 3:
        i, j = 0, 0                 # two empty units on the left
    bounds = [(0, i), (i, j), (j, n)]
    with jbackend.use_backend("xla"):
        for name in MERGEABLE:
            tk = tengine.kernel_spec(name).make(tengine.Dims(A, 10))
            jk = jengine.kernel_spec(name).make(jengine.Dims(A, 10))
            a, b, c = _fold(tengine, tk, tf, bounds, "cpu")
            left = tengine.merge_group_states(
                tk, tengine.merge_group_states(tk, a, b), c)
            right = tengine.merge_group_states(
                tk, a, tengine.merge_group_states(tk, b, c))
            whole = tengine.fold_group(tk, [tf])
            r_left = tengine.finalize_group(tk, left)
            _same(r_left, tengine.finalize_group(tk, right), name)
            _same(r_left, tengine.finalize_group(tk, whole), name)
            ja, jb, jc = _fold(jengine, jk, jf, bounds)
            _same(r_left, jengine.finalize_group(jk, jengine.merge_group_states(
                jk, jengine.merge_group_states(jk, ja, jb), jc)), name)
            empty = tengine.empty_group_state(tk, "cpu")
            assert empty.rows == 0 and empty.head is None
            for s in (a, b, c):
                if s.rows:
                    assert tengine.merge_group_states(tk, empty, s) is s
                    assert tengine.merge_group_states(tk, s, empty) is s


def test_single_row_units_merge_to_whole():
    """Every physical row its own unit — every merge is a boundary stitch —
    still reduces to the whole-log bits, in the port and in JAX."""
    cols, rv = _log(5, n_cases=8, max_len=6)
    bounds = [(r, r + 1) for r in range(cols[CASE].size)]
    with jbackend.use_backend("xla"):
        for name in MERGEABLE:
            got, streamed, want = _both(name, bounds, cols, rv)
            _same(got, streamed, f"{name} vs port stream")
            _same(got, want, f"{name} vs jax")


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_merge_tree_shape_free(seed):
    """Balanced tree == left-to-right fold of merges == JAX."""
    cols, rv = _log(seed, n_cases=8, max_len=5)
    jf, tf = _frames(cols, rv)
    rng = np.random.default_rng(seed)
    cuts = sorted(int(x) for x in rng.integers(0, tf.nrows + 1, seed - 2))
    bounds = list(zip([0] + cuts, cuts + [tf.nrows]))
    with jbackend.use_backend("xla"):
        for name in ("dfg", "variants", "discovery", "eventually_follows",
                     "case_durations"):
            tk = tengine.kernel_spec(name).make(tengine.Dims(A, 8))
            states = _fold(tengine, tk, tf, bounds, "cpu")
            tree = tengine.merge_tree(tk, states)
            linear = tengine.empty_group_state(tk, "cpu")
            for s in states:
                linear = tengine.merge_group_states(tk, linear, s)
            got = tengine.finalize_group(tk, tree)
            _same(got, tengine.finalize_group(tk, linear), name)
            jk = jengine.kernel_spec(name).make(jengine.Dims(A, 8))
            _same(got, jengine.finalize_group(jk, jengine.merge_tree(
                jk, _fold(jengine, jk, jf, bounds))), name)


def test_empty_merge_tree_takes_its_device():
    tk = tcore.dfg_kernel(A)
    gs = tengine.merge_tree(tk, [], "cpu")
    assert gs.rows == 0 and gs.state.counts.device.type == "cpu"
    empty = tengine.fold_group(tk, [], device="cpu")
    assert tengine.merge_tree(tk, [empty]).state.counts.device.type == "cpu"
    with pytest.raises(ValueError):
        tengine.merge_tree(tk, [])


@pytest.mark.parametrize("version", [2, 3])
def test_states_straddle_group_and_file_boundaries(tmp_path, version):
    """Group states folded from the row groups of two files (written by the
    JAX package) — cases straddling both row-group and file boundaries —
    re-merge to the port's whole-log stream and to JAX's merge of the same
    units."""
    cols, rv = _log(11)
    jf, tf = _frames(cols, rv)
    n = tf.nrows
    case = cols[CASE]
    # a cut inside a case, near two thirds of the log: the file boundary
    # splits that case
    cut = next(i for i in range(2 * n // 3, n) if case[i - 1] == case[i])
    paths = [str(tmp_path / f"{k}.edf") for k in "ab"]
    for p, (lo, hi) in zip(paths, ((0, cut), (cut, n))):
        jedf.write(p, _slice(jf, lo, hi), {}, version=version,
                   row_group_rows=13)
    # the row mask is not a column: carry it as one through the file
    units_t, units_j = [], []
    offset = 0
    for p in paths:
        reader = tedf.EDFReader(p)
        assert reader.num_groups >= 2
        for g in range(reader.num_groups):
            fr = reader.read_group(g, device="cpu")
            m = fr.nrows
            units_t.append(tcore.EventFrame(
                fr.columns, fr.valid, torch.from_numpy(rv[offset:offset + m])))
            jfr = jedf.read_group(p, g)[0]
            units_j.append(jcore.EventFrame(jfr.columns, jfr.valid,
                                            jnp.asarray(rv[offset:offset + m])))
            offset += m
    assert offset == n
    with jbackend.use_backend("xla"):
        for name in MERGEABLE:
            tk = tengine.kernel_spec(name).make(tengine.Dims(*DIMS))
            jk = jengine.kernel_spec(name).make(jengine.Dims(*DIMS))
            got = tengine.finalize_group(tk, tengine.merge_tree(
                tk, [tengine.fold_group(tk, [u]) for u in units_t]))
            _same(got, tengine.run_streaming(tk, units_t), name)
            _same(got, tengine.run_single(tk, tf), name)
            _same(got, jengine.finalize_group(jk, jengine.merge_tree(
                jk, [jengine.fold_group(jk, [u]) for u in units_j])), name)


def _snapshot(gs):
    return [t.clone() for t in tengine.tensor_leaves((gs.state, gs.carry))]


def test_merging_cached_states_twice_gives_same_bits():
    """Merges and stitches never write into a GroupState: merging the same
    (cached) states again gives the same bits, and every input tensor is
    unchanged."""
    cols, rv = _log(21, n_cases=12, max_len=6)
    _, tf = _frames(cols, rv)
    bounds = [(r, min(r + 3, tf.nrows)) for r in range(0, tf.nrows, 3)]
    for name in MERGEABLE:
        tk = tengine.kernel_spec(name).make(tengine.Dims(A, 12))
        states = _fold(tengine, tk, tf, bounds, "cpu")
        before = [_snapshot(s) for s in states]
        first = tengine.finalize_group(tk, tengine.merge_tree(tk, states))
        second = tengine.finalize_group(tk, tengine.merge_tree(tk, states))
        _same(first, second, name)
        for s, snap in zip(states, before):
            for x, y in zip(tengine.tensor_leaves((s.state, s.carry)), snap):
                assert torch.equal(x, y), name


def _high_hash_log():
    """Cases whose rolling hashes (and the open carry at every cut) reach
    2^31 and beyond: the unsigned order of the fingerprints matters."""
    rng = np.random.default_rng(3)
    seqs = []
    while len(seqs) < 6:
        seq = rng.integers(0, A, int(rng.integers(2, 6))).tolist()
        h1, h2 = jpolyhash.sequence_fingerprint(seq)
        if h1 >= 2**31 and h2 >= 2**31:
            seqs.append(seq)
    case = np.repeat(np.arange(len(seqs), dtype=np.int64),
                     [len(s) for s in seqs])
    act = np.concatenate(seqs).astype(np.int32)
    ts = np.arange(case.size, dtype=np.float32)
    return {CASE: case, ACTIVITY: act, TIMESTAMP: ts}, np.ones(case.size, bool)


@pytest.mark.parametrize("lowering", ["xla", "pallas"])
def test_variants_unsigned_max_across_straddles(lowering):
    """Fingerprints >= 2^31 across every kind of unit boundary (single-row
    units: straddles and clean cuts, the open-case carry override): the
    port's unsigned max and slot rewrite against JAX's uint32 state, with
    JAX on its XLA lowering and on its Pallas kernels (interpret mode)."""
    cols, rv = _high_hash_log()
    n = cols[CASE].size
    for bounds in ([(r, r + 1) for r in range(n)],
                   [(0, 3), (3, 4), (4, n)]):
        with jbackend.use_backend(lowering):
            got, streamed, want = _both("variants", bounds, cols, rv)
        fp1 = _host(got[0])
        assert (fp1[:6] >= 2**31).all()
        _same(got, streamed, "variants vs port stream")
        _same(got, want, f"variants vs jax {lowering}")
