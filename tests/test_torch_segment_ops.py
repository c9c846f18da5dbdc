"""PyTorch port, segmented primitives: the plain versions that every CPU
tensor takes are held bitwise (tolerance 0: integer counts) against the JAX
package's Pallas kernels (interpret mode) and its XLA references, on the
same numpy inputs; plus the port's device-driven dispatch rules."""
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
    src = T(np.array([0, 1, 2], np.int32))
    with pytest.raises(ValueError, match="0/1"):
        dfg_count_cuda(src, src, T(np.array([1.0, 2.0, 0.0], np.float32)), 4)


# ------------------------------------------------------------ dispatch
def test_resolution_by_device():
    assert backend.resolve(torch.device("cuda")) == "cuda"
    assert backend.resolve(torch.device("cuda", 0), "auto") == "cuda"
    assert backend.resolve(torch.device("cpu")) == "ref"
    assert backend.resolve("cuda", "ref") == "ref"
    assert backend.resolve("cpu", "cuda") == "cuda"
    with pytest.raises(ValueError):
        backend.resolve("cpu", "pallas")


def test_float_weights_refused_on_the_kernel_path():
    v = T(np.array([0, 1, 1], np.int32))
    w = T(np.array([0.5, 1.0, 2.0], np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tso.histogram(v, 3, w, impl="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tso.pair_count(v, v, 3, weights=w, impl="cuda")


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


def test_build_paths_hash_the_sources():
    for name in _build.SOURCES:
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
        assert p.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
