"""PyTorch port, graph semiring primitive: ``semiring_matmul`` (the plain
version a CPU tensor takes) and the three closures, held against the JAX
package's XLA reference and its Pallas kernel in interpret mode on the same
numpy operands, and against host Floyd–Warshall / BFS oracles.

Tolerance 0 everywhere: the tropical products are single-op candidates
reduced by min/max (order-insensitive), and the ``plus_times`` operands are
integer-valued, so every partial sum is exact below 2^24 in any order.
The CUDA kernel itself runs only on a card (``test_torch_gpu.py``)."""
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
