"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version, bitwise (integer counts, float32 min/max, row-order
float32 sums), and the DFG and statistics paths through the kernels.  The
row-order float fold has no plain version on a card (CUDA ``index_add_``
adds in no fixed order), so it is held against the plain fold run on CPU
copies of its inputs.

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


def _float_weights(gen, n, device):
    # magnitudes across eight decades, so any regrouping of the sums shows
    mag = 10.0 ** torch.randint(-3, 5, (n,), generator=gen, device=device)
    return (torch.randn(n, generator=gen, device=device) * mag).float()


@pytest.mark.parametrize("b", [1, 26, 676])
@pytest.mark.parametrize("e", [0, 1, 511, 524_288])
def test_ordered_fold_equals_cpu_plain_fold(cuda, b, e):
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(b * 31 + e)
    v = _ids(gen, e, b, cuda)
    w = _float_weights(gen, e, cuda)
    for into in (None, _float_weights(gen, b, cuda)):
        before = so.ordered_histogram_cuda.launches
        got = so.ordered_histogram_cuda(v, w, b, into)
        torch.cuda.synchronize()
        assert so.ordered_histogram_cuda.launches == before + (1 if e else 0)
        want = so.ordered_histogram_ref(v.cpu(), w.cpu(), b,
                                        None if into is None else into.cpu())
        assert got.device == v.device and torch.equal(got.cpu(), want)


def test_float_weights_launch_the_ordered_fold(cuda):
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(3)
    v = _ids(gen, 100_000, 26, cuda)
    d = _ids(gen, 100_000, 26, cuda)
    w = _float_weights(gen, 100_000, cuda)
    into = _float_weights(gen, 26, cuda)
    before = so.ordered_histogram_cuda.launches
    got = so.histogram(v, 26, w, into=into)
    assert so.ordered_histogram_cuda.launches == before + 1
    assert torch.equal(got.cpu(), so.histogram(v.cpu(), 26, w.cpu(), into=into.cpu()))
    got = so.pair_count(v, d, 26, 26, w, into=into.repeat(26).reshape(26, 26))
    assert so.ordered_histogram_cuda.launches == before + 2
    want = so.pair_count(v.cpu(), d.cpu(), 26, 26, w.cpu(),
                         into=into.cpu().repeat(26).reshape(26, 26))
    assert torch.equal(got.cpu(), want)


def _sorted_segments(gen, n, s, device, single_run=False):
    """Sorted int32 ids, about n / s rows a segment: leading ids below 0,
    some ids skipped (empty segments), ids >= s at the tail when n > s; or
    one run over everything."""
    if single_run:
        return torch.full((n,), s // 2, dtype=torch.int32, device=device)
    p = min(1.0, (s + 3) / max(n, 1))
    step = (torch.rand(n, generator=gen, device=device) < p).to(torch.int32)
    step[torch.rand(n, generator=gen, device=device) < 0.01] = 3
    return (torch.cumsum(step, 0) - 2).to(torch.int32)


def _segment_values(gen, n, dtype, device):
    if dtype == "bool":
        return torch.rand(n, generator=gen, device=device) < 0.3
    if dtype == "int32":
        return torch.randint(-1000, 1000, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    return _float_weights(gen, n, device)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bool"])
@pytest.mark.parametrize("n,s,single", [(0, 10, False), (1, 10, False),
                                        (511, 300, False), (524_288, 1_000_000, False),
                                        (524_288, 75_000, False),
                                        (524_288, 1_000_000, True)])
def test_segment_reduce_kernel_equals_plain(cuda, dtype, n, s, single):
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(n + s + len(dtype))
    seg = _sorted_segments(gen, n, s, cuda, single)
    vals = _segment_values(gen, n, dtype, cuda)
    for op in ("sum", "min", "max"):
        before = so.segment_reduce_cuda.launches
        got = so.segment_reduce(vals, seg, s, op)
        torch.cuda.synchronize()
        assert so.segment_reduce_cuda.launches == before + (1 if n else 0)
        iv = vals.to(torch.int32) if dtype == "bool" else vals
        plain = so.segment_reduce_ref(iv, seg, s, op)
        if dtype == "bool" and op != "sum":
            plain = plain > 0
        if dtype == "float32" and op == "sum":
            # the plain version's CUDA index_add_ adds in no fixed order:
            # the row-order reference is the plain version on the CPU
            plain = so.segment_reduce_ref(vals.cpu(), seg.cpu(), s, op)
        assert torch.equal(got.cpu(), plain.cpu()), op


def test_wrappers_refuse_mixed_devices(cuda):
    from repro_torch.kernels import segment_ops as so

    v = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        so.histogram_cuda(v, v.cpu(), 3)


def test_dfg_count_float_weights_on_card(cuda):
    from repro_torch.kernels import segment_ops as so
    from repro_torch.kernels.dfg_count import dfg_count_cuda

    gen = torch.Generator(device=cuda).manual_seed(6)
    src = torch.randint(0, 26, (10_000,), generator=gen, device=cuda, dtype=torch.int32)
    dst = torch.randint(0, 26, (10_000,), generator=gen, device=cuda, dtype=torch.int32)
    w = torch.randint(0, 4, (10_000,), generator=gen, device=cuda).float()
    before = so.ordered_histogram_cuda.launches
    got = dfg_count_cuda(src, dst, w, 26)
    assert so.ordered_histogram_cuda.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), dfg_count_cuda(src.cpu(), dst.cpu(), w.cpu(), 26))


@pytest.mark.parametrize("chunk_rows", [1, 1000, 100_000])
def test_streamed_stats_on_card_equal_cpu(cuda, chunk_rows):
    from repro_torch.core import ChunkedEventFrame, run_streaming, stats_kernel
    from repro_torch.data import synthetic
    from repro_torch.kernels import segment_ops as so

    n_cases = 200 if chunk_rows == 1 else 20_000
    frame, _ = synthetic.generate(num_cases=n_cases, num_activities=26, seed=4,
                                  device="cpu")
    before = (so.segment_reduce_cuda.launches, so.ordered_histogram_cuda.launches)
    got = run_streaming(stats_kernel(26, n_cases),
                        ChunkedEventFrame.from_frame(frame, chunk_rows, device=cuda))
    chunks = -(-frame.nrows // chunk_rows)
    assert so.segment_reduce_cuda.launches - before[0] == 3 * chunks
    assert so.ordered_histogram_cuda.launches - before[1] == chunks
    want = run_streaming(stats_kernel(26, n_cases),
                         ChunkedEventFrame.from_frame(frame, chunk_rows))
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), v), k


def test_filter_path_on_card_equals_cpu(cuda):
    from repro_torch.core import ChunkedEventFrame, dfg_kernel, filtering, run_streaming
    from repro_torch.data import synthetic

    frame, _ = synthetic.generate(num_cases=20_000, num_activities=26, seed=5,
                                  device="cpu")
    results = {}
    for dev in (cuda, torch.device("cpu")):
        src = ChunkedEventFrame.from_frame(frame, 7_777, device=dev)
        act = filtering.streaming_most_common_activity(src, 26)
        keep = filtering.streaming_cases_containing(src, act, 20_000)
        d = run_streaming(dfg_kernel(26), filtering.stream_apply_case_mask(src, keep),
                          device=dev)
        results[dev.type] = (act, keep.cpu(), d.counts.cpu(), d.starts.cpu())
    assert results["cuda"][0] == results["cpu"][0]
    for x, y in zip(results["cuda"][1:], results["cpu"][1:]):
        assert torch.equal(x, y)


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
