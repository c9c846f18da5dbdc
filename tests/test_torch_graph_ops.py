"""PyTorch port, graph semiring primitive: ``semiring_matmul`` (the plain
version a CPU tensor takes) and the three closures, held against the JAX
package's XLA reference and its Pallas kernel in interpret mode on the same
numpy operands, and against host Floyd–Warshall / BFS oracles.

Tolerance 0 everywhere: the tropical products are single-op candidates
reduced by min/max (order-insensitive), and the ``plus_times`` operands are
integer-valued, so every partial sum is exact below 2^24 in any order.
The closures run with ``impl="ref"`` and with the default dispatch (the
plain version on a CPU tensor), and the closure kernel's schedule
(``closure_plan``) is replayed with plain products against the loop.
The CUDA kernels themselves run only on a card (``test_torch_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import graph_ops as jg  # noqa: E402
from repro_torch.kernels import graph_ops as tg  # noqa: E402

SHAPES = [(4, 4, 4), (17, 9, 23), (130, 7, 131), (1, 28, 28), (1, 9, 5)]


def _operands(semiring, shape, seed, integer=True):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    if integer:
        a = rng.integers(0, 50, (m, k)).astype(np.float32)
        b = rng.integers(0, 50, (k, n)).astype(np.float32)
    else:
        a = (rng.standard_normal((m, k)) * 10.0 ** rng.integers(-3, 4, (m, k))
             ).astype(np.float32)
        b = (rng.standard_normal((k, n)) * 10.0 ** rng.integers(-3, 4, (k, n))
             ).astype(np.float32)
    hole = {"min_plus": np.inf, "max_min": -np.inf}.get(semiring)
    if hole is not None:
        a[rng.random((m, k)) < 0.4] = hole
        b[rng.random((k, n)) < 0.4] = hole
    return a, b


def _jax(a, b, semiring):
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    return (np.asarray(jg.semiring_matmul_ref(ja, jb, semiring)),
            np.asarray(jg.semiring_matmul_pallas(ja, jb, semiring,
                                                 interpret=True)))


def _eq(got, want, msg=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "max_min"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_semiring_matmul_matches_jax_bitwise(semiring, shape):
    a, b = _operands(semiring, shape, hash((semiring, shape)) % 2**31)
    got = tg.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring)
    want_xla, want_pallas = _jax(a, b, semiring)
    _eq(got, want_xla, "xla")
    _eq(got, want_pallas, "pallas")
    _eq(tg.semiring_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                               semiring), want_xla, "ref")


@pytest.mark.parametrize("semiring", ["min_plus", "max_min"])
def test_tropical_products_are_bitwise_for_any_floats(semiring):
    """Non-integer weights over seven decades: each candidate is one
    operation and min/max do not depend on order, so still bitwise."""
    a, b = _operands(semiring, (33, 40, 29), 5, integer=False)
    got = tg.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring)
    want_xla, want_pallas = _jax(a, b, semiring)
    _eq(got, want_xla, "xla")
    _eq(got, want_pallas, "pallas")


def test_dispatch_and_contract():
    a = torch.ones((3, 4))
    b = torch.ones((4, 2), dtype=torch.int32)          # converted to float32
    before = tg.semiring_matmul_cuda.launches
    out = tg.semiring_matmul_cuda(a, b, "plus_times")  # CPU: the plain version
    assert tg.semiring_matmul_cuda.launches == before
    _eq(out, np.full((3, 2), 4.0, np.float32))
    _eq(tg.semiring_matmul(a, b, impl="ref"), out.numpy())
    # K = 0: every output is the semiring's identity
    for s, ident in tg.IDENTITY.items():
        _eq(tg.semiring_matmul(torch.ones((2, 0)), torch.ones((0, 3)), s),
            np.full((2, 3), ident, np.float32))
    with pytest.raises(ValueError, match="unknown semiring"):
        tg.semiring_matmul(a, a.T, "max_plus")
    with pytest.raises(ValueError, match="do not chain"):
        tg.semiring_matmul_cuda(a, a, "min_plus")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_semiring_matmul_takes_jax_names_and_block_sizes(impl):
    """JAX's call ``semiring_matmul(a, b, s, impl=..., block_m=...,
    block_n=..., block_k=...)`` carries over: the port takes its lowering
    names and ignores its block sizes (the CUDA tile is fixed), and the
    result is unchanged and bitwise JAX's."""
    from repro.kernels.graph_ops import ops as jops

    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, (19, 23)).astype(np.float32)
    b = rng.integers(0, 4, (23, 9)).astype(np.float32)
    for semiring in ("plus_times", "min_plus", "max_min"):
        blocks = {"block_m": 8, "block_n": 8, "block_k": 8}
        want = np.asarray(jops.semiring_matmul(jnp.asarray(a), jnp.asarray(b),
                                               semiring, impl=impl, **blocks))
        got = tg.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                 semiring, impl=impl, **blocks)
        _eq(got, want, f"{semiring}/{impl}")
        _eq(got, tg.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                    semiring).numpy(), "blocks change nothing")
    with pytest.raises(TypeError):
        tg.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                           block_q=8)


def _host_oracles(w, adj):
    """Floyd–Warshall min-plus / max-min and BFS horizons (numpy)."""
    n = w.shape[0]
    eye = np.eye(n, dtype=bool)
    dist = np.where(eye, 0.0, w)
    cap = np.where(adj, w, -np.inf)
    wide = np.where(eye, np.inf, cap)
    for mid in range(n):
        dist = np.minimum(dist, dist[:, mid:mid + 1] + dist[mid:mid + 1, :])
        wide = np.maximum(wide, np.minimum(wide[:, mid:mid + 1],
                                           wide[mid:mid + 1, :]))
    reach_k = [eye]
    while len(reach_k) <= n:
        reach_k.append(reach_k[-1] | (reach_k[-1].astype(np.float32)
                                      @ adj.astype(np.float32) > 0))
    return dist.astype(np.float32), wide.astype(np.float32), cap, reach_k


@pytest.mark.parametrize("n,density", [(11, 0.4), (28, 0.15), (2, 0.5), (1, 1.0)])
def test_closures_match_jax_and_host_oracles(n, density):
    rng = np.random.default_rng(17 + n)
    w = rng.integers(1, 9, (n, n)).astype(np.float32)
    w[rng.random((n, n)) >= density] = np.inf
    adj = np.isfinite(w)
    dist, wide, cap, reach_k = _host_oracles(w, adj)
    wt = torch.from_numpy(np.where(adj, w, np.inf).astype(np.float32))
    d = tg.minplus_closure(wt)
    c = tg.maxmin_closure(torch.from_numpy(cap.astype(np.float32)))
    _eq(d, dist, "minplus vs Floyd-Warshall")
    _eq(c, wide, "maxmin vs Floyd-Warshall")
    for impl in ("xla", "pallas"):
        _eq(d, np.asarray(jg.minplus_closure(jnp.asarray(wt.numpy()), impl=impl)),
            impl)
        _eq(c, np.asarray(jg.maxmin_closure(jnp.asarray(cap.astype(np.float32)),
                                            impl=impl)), impl)
    for k in (0, 1, 2, 3, 5, None):
        got = tg.bool_closure(torch.from_numpy(adj), k)
        want = reach_k[-1] if k is None else reach_k[min(k, max(n - 1, 1))]
        _eq(got, want, f"k={k} vs BFS")
        _eq(got, np.asarray(jg.bool_closure(jnp.asarray(adj), k, impl="xla")),
            f"k={k} vs jax")


CLOSURE_NS = [1, 2, 11, 28, 48, tg.CLOSURE_MAX_N, tg.CLOSURE_MAX_N + 1]


def _closure_graph(n, seed):
    """Adjacency at ~3 edges a node, non-integer weights (+inf / -inf holes)."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < min(1.0, 3.0 / n)
    w = (rng.random((n, n)) * 7.3 + 0.01).astype(np.float32)
    return (adj, np.where(adj, w, np.inf).astype(np.float32),
            np.where(adj, w, -np.inf).astype(np.float32))


@pytest.mark.parametrize("n", CLOSURE_NS)
def test_closures_with_impl_match_jax(n):
    """The three closures with ``impl="ref"`` and with the default dispatch,
    against JAX's ``impl="xla"`` and ``"pallas"`` (interpret mode), bitwise:
    k = 0, 1, 3, 5 and None for the boolean one, non-integer weights for
    the tropical ones."""
    adj, cost, cap = _closure_graph(n, 40 + n)
    for impl in ("ref", None):
        kw = {} if impl is None else {"impl": impl}
        d = tg.minplus_closure(torch.from_numpy(cost), **kw)
        c = tg.maxmin_closure(torch.from_numpy(cap), **kw)
        for jimpl in ("xla", "pallas"):
            _eq(d, np.asarray(jg.minplus_closure(jnp.asarray(cost), impl=jimpl)),
                f"min_plus {impl} {jimpl}")
            _eq(c, np.asarray(jg.maxmin_closure(jnp.asarray(cap), impl=jimpl)),
                f"max_min {impl} {jimpl}")
        for k in (0, 1, 3, 5, None):
            got = tg.bool_closure(torch.from_numpy(adj), k, **kw)
            for jimpl in ("xla", "pallas"):
                _eq(got, np.asarray(jg.bool_closure(jnp.asarray(adj), k, impl=jimpl)),
                    f"bool k={k} {impl} {jimpl}")


def _replay(plan, seed, eye, product):
    """The closure kernel's schedule run with ``product``: acc starts as the
    seed or as I, sq as the seed; the result is acc."""
    from repro_torch.kernels.graph_ops import semiring as sm

    from_seed, steps = plan
    acc, sq = (seed if from_seed else eye), seed
    for op in steps:
        if op == sm.SQUARE_ACC:
            acc = product(acc, acc)
        elif op == sm.ACC_TIMES_SQ:
            acc = product(acc, sq)
        else:
            assert op == sm.SQUARE_SQ
            sq = product(sq, sq)
    return acc


def test_closure_plan_reaches_the_loops_horizon_at_every_n_and_k():
    """For every N up to 200 and every k <= N - 1 (and None), the kernel's
    schedule replayed with plain products of 1 x 1 min-plus matrices (whose
    product adds the exponents of I | A) reaches the loop's horizon: k
    clamped to [0, N - 1] edges for a finite k (at least 1 when N <= 2),
    2^ceil(log2(N - 1)) squarings' worth for None, in at most 16 steps (the
    kernel's 2-bit fields in 32 bits)."""
    from repro_torch.kernels.graph_ops import ref

    def product(p, q):
        return tg.semiring_matmul_ref(p, q, "min_plus")

    one, zero = torch.ones((1, 1)), torch.zeros((1, 1))
    cache = {}
    for n in range(1, 201):
        for k in [None, *range(n)]:
            plan = tg.closure_plan(n, k)
            assert len(plan[1]) <= 16
            if plan not in cache:
                cache[plan] = int(_replay(plan, one, zero, product).item())
            want = (2 ** ref.closure_steps(n, n - 1) if k is None
                    else min(max(k, 0), max(n - 1, 1)))
            assert cache[plan] == want, (n, k)
            if k is None:
                assert plan[0] and set(plan[1]) <= {0}


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 17, 28, 33, 64, 97, 129, 168, 200])
def test_closure_plan_replayed_with_plain_products_equals_the_loop(n):
    """The schedule the wrapper hands the closure kernel, replayed with plain
    products on the graph itself, equals the loop of plain products
    bitwise: the boolean closure at every k <= N - 1 and None, the tropical
    ones (squarings only) with non-integer weights."""
    from repro_torch.kernels.graph_ops import ref

    adj, cost, cap = _closure_graph(n, n)
    t_adj = torch.from_numpy(adj)
    seed = ref.closure_seed(t_adj, "bool")
    eye = torch.eye(n, dtype=torch.bool)

    def or_and(p, q):
        return tg.semiring_matmul_ref(p.float(), q.float(), "plus_times") > 0

    for k in [None, *range(n)]:
        got = _replay(tg.closure_plan(n, k), seed, eye, or_and)
        _eq(got, tg.bool_closure(t_adj, k, impl="ref").numpy(), f"bool k={k}")
    for kind, w in (("min_plus", cost), ("max_min", cap)):
        x = torch.from_numpy(w)
        got = _replay(tg.closure_plan(n), ref.closure_seed(x, kind), None,
                      lambda p, q, kind=kind: tg.semiring_matmul_ref(p, q, kind))
        _eq(got, tg.semiring_closure_ref(x, kind).numpy(), kind)


def test_closure_dispatch(monkeypatch):
    """With the kernels chosen (``backend.resolve`` forced to ``"cuda"``) a
    closure of at most ``CLOSURE_MAX_N`` nodes is one call of the closure
    kernel's wrapper and no product; one node more, the loop of tiled
    products; ``impl="ref"`` calls neither.  The wrappers run their plain
    versions on these CPU tensors, so every result is the plain one."""
    from repro_torch.core import backend
    from repro_torch.kernels.graph_ops import ops

    monkeypatch.setattr(backend, "resolve",
                        lambda device, impl=None: "ref" if impl == "ref" else "cuda")
    calls = []
    for name in ("semiring_closure_cuda", "semiring_matmul_cuda"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _real=real, _name=name:
                            calls.append(_name) or _real(*a))
    for n in (28, tg.CLOSURE_MAX_N, tg.CLOSURE_MAX_N + 1):
        adj, cost, _ = _closure_graph(n, n)
        x = torch.from_numpy(cost)
        for impl in (None, "ref"):
            calls.clear()
            got = tg.minplus_closure(x, impl=impl)
            _eq(got, tg.semiring_closure_ref(x, "min_plus").numpy())
            if impl == "ref":
                assert calls == []
            elif n <= tg.CLOSURE_MAX_N:
                assert calls == ["semiring_closure_cuda"]
            else:
                assert calls == ["semiring_matmul_cuda"] * len(tg.closure_plan(n)[1])
            calls.clear()
            got = tg.bool_closure(torch.from_numpy(adj), 3, impl=impl)
            _eq(got, tg.semiring_closure_ref(torch.from_numpy(adj), "bool", 3).numpy())
            want = ([] if impl == "ref" else ["semiring_closure_cuda"]
                    if n <= tg.CLOSURE_MAX_N else
                    ["semiring_matmul_cuda"] * len(tg.closure_plan(n, 3)[1]))
            assert calls == want
    with pytest.raises(ValueError, match="takes no k"):
        tg.semiring_closure_cuda(torch.zeros((3, 3)), "min_plus", 2)
    with pytest.raises(ValueError, match="unknown closure"):
        tg.semiring_closure_cuda(torch.zeros((3, 3)), "plus_times")
