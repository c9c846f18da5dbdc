"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version on the card, bitwise (integer counts), and the DFG path
through the kernels.

The machine with the card has no JAX, and ``tests/conftest.py`` imports
JAX, so this file imports only torch, numpy, pytest and ``repro_torch`` and
runs there as::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips (decided in a fixture, never at import).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

SIZES = (1, 26, 129, 241, 242, 300)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _ids(gen, n, hi, device):
    return torch.randint(-1, hi + 2, (n,), generator=gen, device=device,
                         dtype=torch.int32)


def _weights(gen, n, device, signed):
    lo, hi = (-3, 4) if signed else (0, 2)
    return torch.randint(lo, hi, (n,), generator=gen, device=device,
                         dtype=torch.int32)


@pytest.mark.parametrize("a", SIZES)
@pytest.mark.parametrize("e", [0, 1, 511, 524_288])
def test_pair_count_kernel_equals_plain(cuda, a, e):
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(a * 7919 + e)
    for signed in (False, True):
        src, dst = _ids(gen, e, a, cuda), _ids(gen, e, a, cuda)
        w = _weights(gen, e, cuda, signed)
        before = so.pair_count_cuda.launches
        got = so.pair_count_cuda(src, dst, w, a, a)
        torch.cuda.synchronize()
        assert so.pair_count_cuda.launches == before + (1 if e else 0)
        assert torch.equal(got, so.pair_count_ref(src, dst, w, a, a))


@pytest.mark.parametrize("b", SIZES + (676, 241 * 241, 242 * 242))
@pytest.mark.parametrize("e", [0, 1, 511, 524_288])
def test_histogram_kernel_equals_plain(cuda, b, e):
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(b * 104729 + e)
    for signed in (False, True):
        v, w = _ids(gen, e, b, cuda), _weights(gen, e, cuda, signed)
        got = so.histogram_cuda(v, w, b)
        torch.cuda.synchronize()
        assert torch.equal(got, so.histogram_ref(v, b, w))


def test_dfg_count_on_card(cuda):
    from repro_torch.kernels.dfg_count import dfg_count_cuda, dfg_count_ref

    gen = torch.Generator(device=cuda).manual_seed(5)
    src = torch.randint(0, 26, (10_000,), generator=gen, device=cuda, dtype=torch.int32)
    dst = torch.randint(0, 26, (10_000,), generator=gen, device=cuda, dtype=torch.int32)
    w = (torch.rand(10_000, generator=gen, device=cuda) < 0.7).float()
    assert torch.equal(dfg_count_cuda(src, dst, w, 26), dfg_count_ref(src, dst, w, 26))


def test_float_weights_raise_on_card(cuda):
    from repro_torch.kernels import segment_ops as so

    v = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError):
        so.histogram(v, 3, torch.ones(4, device=cuda))
    with pytest.raises(NotImplementedError):
        so.pair_count(v, v, 3, weights=torch.ones(4, device=cuda))


def test_wrappers_refuse_mixed_devices(cuda):
    from repro_torch.kernels import segment_ops as so

    v = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        so.histogram_cuda(v, v.cpu(), 3)


@pytest.mark.parametrize("chunk_rows", [1, 1000, 100_000])
def test_streamed_dfg_on_card_equals_cpu(cuda, chunk_rows):
    from repro_torch.core import ChunkedEventFrame, run_streaming
    from repro_torch.data import synthetic
    from repro_torch.kernels import segment_ops as so

    dfg_mod = importlib.import_module("repro_torch.core.dfg")
    n_cases = 200 if chunk_rows == 1 else 20_000
    frame, _ = synthetic.generate(num_cases=n_cases, num_activities=26, seed=2,
                                  device="cpu")
    gpu = frame.to(cuda)
    before = (so.pair_count_cuda.launches, so.histogram_cuda.launches)
    # a host-resident frame streamed to the card chunk by chunk
    src = ChunkedEventFrame.from_frame(frame, chunk_rows, device=cuda)
    assert src.device.type == "cuda"
    got = run_streaming(dfg_mod.dfg_kernel(26), src)
    chunks = -(-frame.nrows // chunk_rows)
    assert so.pair_count_cuda.launches - before[0] == chunks
    assert so.histogram_cuda.launches - before[1] == 2 * chunks
    want = dfg_mod.dfg(frame, 26)
    for method in ("auto", "shift", "kernel"):
        other = dfg_mod.dfg(gpu, 26, method)
        for nm in ("counts", "starts", "ends"):
            assert torch.equal(getattr(other, nm).cpu(), getattr(want, nm))
    for nm in ("counts", "starts", "ends"):
        assert getattr(got, nm).device.type == "cuda"
        assert torch.equal(getattr(got, nm).cpu(), getattr(want, nm))
    cases = np.unique(frame.to_numpy()["case:concept:name"]).size
    assert int(got.starts.sum()) == int(got.ends.sum()) == cases
