"""PyTorch port on a CUDA card: each hand-written kernel against its plain
PyTorch version, bitwise (integer counts, float32 min/max, row-order
float32 sums, uint32 hashes, tropical and integer-valued semiring
products and whole closures; random-float ``plus_times`` within its
rounding bound of ``torch.matmul`` and bitwise the k-order ``fmaf`` chain
(an exact-rounding oracle, itself checked on the CPU); flash
attention within 2e-5 in float32, 2e-2 in bf16), and the DFG, statistics,
filter, variants, performance, graph and discovery paths, the sharded
engine at 8 shards on the one card (its shard updates never reading back to
the host), and the reduced EventLM served through the kernels (graph centrality ``flow`` within 1e-6
of the CPU, greedy tokens equal to the CPU's).
The row-order float fold has no plain version on a card (CUDA
``index_add_`` adds in no fixed order), so it is held against the plain
fold run on CPU copies of its inputs; so are the float32 segmented sums.
A scan over one run of a whole chunk is held against a sequential oracle
(the plain scans step once per row of the longest run).

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


def _count_inputs(gen, e, ids_hi, nbins, device):
    """The counting kernels' input variants: (what, ids, weights, into) with
    0/1, signed and bool weights, into absent and given, each with every
    column sliced one row in (off a 16-byte boundary) or not."""
    for kind in ("mask", "signed", "bool"):
        for with_into in (False, True):
            for offset in (0, 1):
                ids = [_ids(gen, e + offset, hi, device)[offset:] for hi in ids_hi]
                if kind == "bool":
                    w = (torch.rand(e + offset, generator=gen, device=device)
                         < 0.6)[offset:]
                else:
                    w = _weights(gen, e + offset, device, kind == "signed")[offset:]
                into = (torch.randint(-2**31, 2**31 - 1, nbins, generator=gen,
                                      device=device, dtype=torch.int32)
                        if with_into else None)
                yield f"{kind} into={with_into} offset={offset}", ids, w, into


def _poison_counting(device, nbins, tensors):
    """Fill freed blocks of the sizes of a counting call's output and
    partials with 0x5A (both held at once, so each allocation finds one):
    a bin the kernels leave unwritten then shows."""
    from repro_torch.kernels.segment_ops import counting

    sizes = [4 * nbins]
    if counting.shared_route(nbins) and tensors[0].shape[0]:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = counting.count_plan(tensors[0].shape[0], nbins, sms,
                                   counting.head_rows(*tensors))
        sizes.append(4 * nbins * plan.grid)
    blocks = [torch.empty(nb, dtype=torch.uint8, device=device).fill_(0x5A)
              for nb in sizes]
    del blocks


@pytest.mark.parametrize("a", SIZES)
@pytest.mark.parametrize("e", [0, 1, 511, 524_288])
def test_pair_count_kernel_equals_plain(cuda, a, e):
    """Bitwise the plain version with 0/1, signed and bool weights, into
    absent and given, aligned and misaligned columns; the output and the
    partials' blocks were filled with 0x5A first, so a cell the kernels
    leave unwritten shows."""
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(a * 7919 + e)
    for what, (src, dst), w, into in _count_inputs(gen, e, (a, a), (a, a), cuda):
        _poison_counting(cuda, a * a, (src, dst, w))
        before = so.pair_count_cuda.launches
        got = so.pair_count_cuda(src, dst, w, a, a, into)
        torch.cuda.synchronize()
        assert so.pair_count_cuda.launches == before + (1 if e else 0), what
        want = so.pair_count_ref(src, dst, w.to(torch.int32), a, a, into)
        assert torch.equal(got, want), what


@pytest.mark.parametrize("b", SIZES + (676, 241 * 241, 242 * 242))
@pytest.mark.parametrize("e", [0, 1, 511, 524_288])
def test_histogram_kernel_equals_plain(cuda, b, e):
    """As the pair-count test: weights, into, misaligned slices, poisoned
    output and partials; 242^2 bins take the global route."""
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(b * 104729 + e)
    for what, (v,), w, into in _count_inputs(gen, e, (b,), (b,), cuda):
        _poison_counting(cuda, b, (v, w))
        before = so.histogram_cuda.launches
        got = so.histogram_cuda(v, w, b, into)
        torch.cuda.synchronize()
        assert so.histogram_cuda.launches == before + (1 if e else 0), what
        assert torch.equal(got, so.histogram_ref(v, b, w.to(torch.int32), into)), what


def _device_events(fn):
    """Device events (kernels, fills, copies) of one call of ``fn``, counted
    by name, from a ``torch.profiler`` trace.  The program's spans
    (``repro_torch.*``), which the profiler also draws on the device's
    timeline around the kernels they launched, are not device events."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.key.startswith(trace.PREFIX)})


def test_dfg_update_counts_in_six_kernel_nodes(cuda):
    """One ``dfg_kernel`` update on a card makes one ``pair_count`` and two
    ``histogram`` launches, and its counting is exactly 6 device events
    (``count_rows`` and ``count_finish`` for each call) beyond those of
    ``engine.adjacent`` and ``next_row_carry``: no cast of a mask, no zero
    fill and no add of the counts (the parent's 12: cast, fill, kernel and
    add per call).  The state it returns equals the plain update's."""
    from repro_torch.core import ChunkedEventFrame, dfg_kernel, engine
    from repro_torch.data import synthetic
    from repro_torch.kernels import segment_ops as so

    frame, _ = synthetic.generate(num_cases=20_000, num_activities=26, seed=3,
                                  device="cpu")
    chunk = next(iter(ChunkedEventFrame.from_frame(frame, 100_000, device=cuda)))
    kernel = dfg_kernel(26)
    state, carry = kernel.init(cuda)
    state, carry = kernel.update(state, carry, chunk)      # a non-zero state
    kernel.update(state, carry, chunk)                     # warm-up
    torch.cuda.synchronize()
    before = (so.pair_count_cuda.launches, so.histogram_cuda.launches)
    full = _device_events(lambda: kernel.update(state, carry, chunk))
    assert (so.pair_count_cuda.launches - before[0],
            so.histogram_cuda.launches - before[1]) == (1, 2)
    rest = _device_events(lambda: (engine.adjacent(chunk, carry),
                                   engine.next_row_carry(carry, chunk)))
    extra = full - rest
    assert sum(full.values()) - sum(rest.values()) == 6, (full, rest)
    assert sum(extra.values()) == 6 and all(
        "count_rows" in name or "count_finish" in name for name in extra), extra
    assert sum(c for name, c in extra.items() if "count_rows" in name) == 3
    got, _ = kernel.update(state, carry, chunk)
    want, _ = dfg_kernel(26, "segment").update(state, carry, chunk)   # plain
    for nm in ("counts", "starts", "ends"):
        assert torch.equal(getattr(got, nm), getattr(want, nm))


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


@pytest.mark.parametrize("b", [1, 26, 676, 5000])
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


@pytest.mark.parametrize("b", [1, 26, 676])
@pytest.mark.parametrize("case", ["one_bin", "ragged_tile"])
def test_ordered_fold_counting_sort_edges(cuda, b, case):
    """The counting sort's edges, bitwise against the CPU plain fold, with
    and without ``into``: every row in one bin (the longest chain, 524,288
    adds) and a row count that is no multiple of the tile (1,024 rows here)."""
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(b * 17 + len(case))
    if case == "one_bin":
        v = torch.full((524_288,), b - 1, dtype=torch.int32, device=cuda)
    else:
        v = _ids(gen, 3 * 4096 + 77, b, cuda)
    w = _float_weights(gen, v.shape[0], cuda)
    for into in (None, _float_weights(gen, b, cuda)):
        got = so.ordered_histogram_cuda(v, w, b, into)
        torch.cuda.synchronize()
        want = so.ordered_histogram_ref(v.cpu(), w.cpu(), b,
                                        None if into is None else into.cpu())
        assert torch.equal(got.cpu(), want)


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
    one run over everything (``single_run=True``, a fill stripe on both
    sides); or ``"gaps"``: ids from 1,000 on, each run skipping 0 to 40 ids
    and lasting 1 to 127 rows, so runs cross the kernel's tiles and halos
    and the heads write the skipped ids."""
    if single_run == "gaps":
        step = torch.randint(0, 128, (n,), generator=gen, device=device) == 0
        skip = torch.randint(1, 42, (n,), generator=gen, device=device)
        return (1_000 + torch.cumsum(step * skip, 0)).to(torch.int32)
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


def _poison(nbytes, device):
    """Fill a freed block of ``nbytes`` with the byte 0x5A, so the caching
    allocator hands it to the next allocation of that size: a slot the
    kernel leaves unwritten then shows."""
    torch.empty(nbytes, dtype=torch.uint8, device=device).fill_(0x5A)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bool"])
@pytest.mark.parametrize("n,s,single", [(0, 10, False), (1, 10, False),
                                        (511, 300, False), (524_288, 1_000_000, False),
                                        (524_288, 75_000, False),
                                        (524_288, 1_000_000, True),
                                        (300_001, 1_000_000, "gaps")])
def test_segment_reduce_kernel_equals_plain(cuda, dtype, n, s, single):
    """Every slot of the output is written by the kernel: the block it gets
    was filled with 0x5A first.  Sorted ids, so the float32 sum is taken on
    the kernel (``assume_exact=True``), in row order."""
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(n + s + len(dtype))
    seg = _sorted_segments(gen, n, s, cuda, single)
    vals = _segment_values(gen, n, dtype, cuda)
    for op in ("sum", "min", "max"):
        before = so.segment_reduce_cuda.launches
        _poison(4 * s, cuda)
        got = so.segment_reduce(vals, seg, s, op, assume_exact=True)
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


@pytest.mark.parametrize("n,s,single", [(0, 10, False), (1, 10, False),
                                        (511, 300, False), (524_288, 1_000_000, False),
                                        (524_288, 1_000_000, True),
                                        (300_001, 1_000_000, "gaps")])
def test_segment_reduce_uint32_equals_plain(cuda, n, s, single):
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(n + s + 32)
    seg = _sorted_segments(gen, n, s, cuda, single)
    bits = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    vals = bits.view(torch.uint32)
    for op in ("sum", "min", "max"):
        before = so.segment_reduce_cuda.launches
        _poison(4 * s, cuda)
        got = so.segment_reduce(vals, seg, s, op)
        torch.cuda.synchronize()
        assert so.segment_reduce_cuda.launches == before + (1 if n else 0)
        assert got.dtype == torch.uint32
        want = so.segment_reduce_ref(vals, seg, s, op)
        assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32).cpu()), op


def _scan_inputs(gen, n, runs, flag0, device):
    """Start flags for runs of one row, ~7 rows, 64 rows, or one run over
    everything; row 0 flagged or not (then it continues the carry)."""
    if runs == "one":
        starts = torch.ones(n, dtype=torch.bool, device=device)
    elif runs == "short":
        starts = torch.rand(n, generator=gen, device=device) < 1 / 7
    elif runs == "64":
        starts = torch.arange(n, device=device) % 64 == 0
    else:
        starts = torch.zeros(n, dtype=torch.bool, device=device)
    if n:
        starts[0] = flag0
    return starts


def _u32(gen, shape, device):
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=device,
                         dtype=torch.int32)


def _oracle_affine(mul, add, starts, carry):
    """The sequential fold in Python integers (for one run over everything,
    where the plain version would take one step per row)."""
    m = mul.cpu().numpy().view(np.uint32).tolist()
    b = add.cpu().numpy().view(np.uint32).tolist()
    f = starts.cpu().numpy().tolist()
    h = int(carry.cpu().numpy().view(np.uint32))
    out = []
    for mi, bi, fi in zip(m, b, f):
        h = ((0 if fi else h) * mi + bi) & 0xFFFFFFFF
        out.append(h)
    return torch.from_numpy(np.array(out, np.uint32).view(np.int32))


def _oracle_sum(x, starts, carry):
    """Row-order float32 prefix sums run by run (``np.add.accumulate`` is
    sequential)."""
    xs, f, c = x.cpu().numpy(), starts.cpu().numpy(), carry.cpu().numpy()
    out = np.empty_like(xs)
    heads = np.flatnonzero(f | (np.arange(len(f)) == 0))
    for lo, hi in zip(heads, list(heads[1:]) + [len(f)]):
        seed = np.zeros_like(c) if f[lo] else c
        out[lo:hi] = np.add.accumulate(np.concatenate([seed[None], xs[lo:hi]]),
                                       axis=0)[1:]
    return torch.from_numpy(out)


@pytest.mark.parametrize("n", [0, 1, 511, 524_288])
@pytest.mark.parametrize("runs", ["one", "short", "64", "whole"])
@pytest.mark.parametrize("flag0", [True, False])
def test_segmented_scans_equal_plain(cuda, n, runs, flag0):
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(n * 8 + len(runs) * 2 + flag0)
    starts = _scan_inputs(gen, n, runs, flag0, cuda)
    serial = runs == "whole" and n > 511
    for c in (0, 0x9E3779B9 - 2**32):
        carry = torch.tensor(c, dtype=torch.int32, device=cuda)
        vals, mul = _u32(gen, (n,), cuda), _u32(gen, (n,), cuda)
        before = (so.segmented_polyhash_cuda.launches,
                  so.segmented_affine_cuda.launches)
        ys, out = so.segmented_polyhash_cuda(vals, starts, carry, 1_000_003)
        ya, oa = so.segmented_affine_cuda(mul, vals, starts, carry)
        torch.cuda.synchronize()
        assert so.segmented_polyhash_cuda.launches == before[0] + (1 if n else 0)
        assert so.segmented_affine_cuda.launches == before[1] + (1 if n else 0)
        assert out.device == ys.device and out.device.type == "cuda" and out.shape == ()
        if serial:
            want = _oracle_affine(torch.full_like(vals, 1_000_003), vals, starts, carry)
            want_a = _oracle_affine(mul, vals, starts, carry)
        else:
            want, _ = so.segmented_scan_ref(vals, starts, carry, "polyhash", 1_000_003)
            want_a, _ = so.segmented_affine_ref(mul, vals, starts, carry)
        assert torch.equal(ys.cpu(), want.cpu())
        assert torch.equal(ya.cpu(), want_a.cpu())
        if n:
            assert int(out) == int(ys[-1]) and int(oa) == int(ya[-1])
    # non-integer float32 rows, (N, 26) and (N,), against the CPU fold
    for k in (26, 1):
        shape = (n, k) if k > 1 else (n,)
        mag = 10.0 ** torch.randint(-3, 5, shape, generator=gen, device=cuda)
        x = (torch.randn(shape, generator=gen, device=cuda) * mag).float()
        carry = torch.randn(shape[1:], generator=gen, device=cuda)
        before = so.segmented_sum_scan_cuda.launches
        ys, out = so.segmented_sum_scan_cuda(x, starts, carry)
        torch.cuda.synchronize()
        assert so.segmented_sum_scan_cuda.launches == before + (1 if n else 0)
        assert out.shape == carry.shape
        if serial:
            want = _oracle_sum(x.reshape(n, -1), starts, carry.reshape(-1)).reshape(shape)
        else:
            want, _ = so.segmented_scan_ref(x.cpu(), starts.cpu(), carry.cpu(), "sum")
        assert torch.equal(ys.cpu(), want)
        if n:
            assert torch.equal(out.cpu(), ys[-1].cpu())


@pytest.mark.parametrize("case", ["ghost_2^17", "one_run_2^20", "one_run_2^20_flagged",
                                  "unaligned_views", "ragged_tail"])
def test_affine_scan_long_runs_equal_sequential_fold(cuda, case):
    """The single-pass scan where the head-of-run design was serial: a
    ghost-shaped chunk (2^17 rows, one row per case segment, the tail case
    padding the last ~56,000 rows into one run, identity maps there) and one
    run over 2^20 rows, row 0 flagged and not; views one element off
    16-byte alignment (the one-row-a-load path) and a ragged last tile.
    polyhash and affine, bitwise against the sequential fold, carry_out
    included, one launch each."""
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(len(case))
    n = 1 << 20 if case.startswith("one_run") else 1 << 17
    off = 1 if case == "unaligned_views" else 0
    if case == "ragged_tail":
        n = 3 * 4096 * 7 + 1234
    starts = torch.zeros(n + off, dtype=torch.bool, device=cuda)
    vals, mul = _u32(gen, (n + off,), cuda), _u32(gen, (n + off,), cuda)
    if case == "ghost_2^17":
        d = n - 56_000 + 1
        starts[:d] = True
        mul[d:], vals[d:] = 1, 0
    elif case != "one_run_2^20":
        starts[off:] = torch.rand(n, generator=gen, device=cuda) < 1 / 7
    starts[off] = case in ("ghost_2^17", "one_run_2^20_flagged")
    starts, vals, mul = starts[off:], vals[off:], mul[off:]
    carry = torch.tensor(0x9E3779B9 - 2**32, dtype=torch.int32, device=cuda)
    before = (so.segmented_polyhash_cuda.launches, so.segmented_affine_cuda.launches)
    ys, out = so.segmented_polyhash_cuda(vals, starts, carry, 1_000_003)
    ya, oa = so.segmented_affine_cuda(mul, vals, starts, carry)
    torch.cuda.synchronize()
    assert (so.segmented_polyhash_cuda.launches, so.segmented_affine_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want = _oracle_affine(torch.full_like(vals, 1_000_003), vals, starts, carry)
    want_a = _oracle_affine(mul, vals, starts, carry)
    assert torch.equal(ys.cpu(), want) and torch.equal(ya.cpu(), want_a)
    assert int(out) == int(want[-1]) and int(oa) == int(want_a[-1])
    assert out.shape == () and out.device.type == "cuda"


@pytest.mark.parametrize("k", [26, 1, 300])
@pytest.mark.parametrize("case", ["crossing_runs", "odd_row_offset", "one_run_2^19",
                                  "tile_without_head"])
def test_sum_scan_tiles_equal_sequential_fold(cuda, k, case):
    """The tile-staged sum scan where its tiles meet: runs of 200-400 rows
    (past a tile and its halo, so the block continues them window by
    window), (N, 26) rows viewed at an odd row offset (104-byte rows off
    16-byte alignment: the 4-byte copies), one unflagged run over 2^19
    rows from the carry, and tiles holding no head; K = 1 ((N,) rows, a
    0-d carry) and K = 300 (two column slices).  Bitwise against the
    sequential float32 fold, ``carry_out`` equal to the last row, one
    launch."""
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(k * 7 + len(case))
    n = 1 << 19 if case == "one_run_2^19" else 100_003
    off = 1 if case == "odd_row_offset" else 0
    starts = torch.zeros(n + off, dtype=torch.bool, device=cuda)
    if case == "crossing_runs":
        starts[torch.cumsum(torch.randint(200, 400, (n // 200,), generator=gen,
                                          device=cuda), 0)[:-1].clamp(max=n - 1)] = True
    elif case == "odd_row_offset":
        starts = torch.rand(n + off, generator=gen, device=cuda) < 1 / 7
    elif case == "tile_without_head":
        starts[::5_000] = True
    starts[off] = case == "tile_without_head"
    rows = (n + off, k) if k > 1 else (n + off,)
    mag = 10.0 ** torch.randint(-3, 5, rows, generator=gen, device=cuda)
    x = (torch.randn(rows, generator=gen, device=cuda) * mag).float()
    starts, x = starts[off:], x[off:]
    carry = torch.randn(rows[1:], generator=gen, device=cuda)
    before = so.segmented_sum_scan_cuda.launches
    ys, out = so.segmented_sum_scan_cuda(x, starts, carry)
    torch.cuda.synchronize()
    assert so.segmented_sum_scan_cuda.launches == before + 1
    want = _oracle_sum(x.reshape(n, -1), starts, carry.reshape(-1)).reshape(x.shape)
    assert torch.equal(ys.cpu(), want)
    assert out.shape == carry.shape and torch.equal(out.cpu(), want[-1])


def test_unsorted_float_sum_takes_the_row_order_fold(cuda):
    """A float32 sum through ``segment_reduce`` with unsorted ids (and ids
    out of range) takes the row-order fold, not the sorted-id kernel, and
    equals the CPU plain version bitwise; integer sums and an explicit
    ``assume_exact=True`` take the kernel."""
    from repro_torch.kernels import segment_ops as so

    gen = torch.Generator(device=cuda).manual_seed(18)
    ids = torch.randint(-2, 1_002, (200_000,), generator=gen, device=cuda,
                        dtype=torch.int32)
    vals = _float_weights(gen, 200_000, cuda)
    before = (so.ordered_histogram_cuda.launches, so.segment_reduce_cuda.launches)
    got = so.segment_reduce(vals, ids, 1_000, "sum")
    torch.cuda.synchronize()
    assert (so.ordered_histogram_cuda.launches, so.segment_reduce_cuda.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got.cpu(), so.segment_reduce(vals.cpu(), ids.cpu(), 1_000, "sum"))
    seg = torch.sort(ids).values
    so.segment_reduce(vals, seg, 1_000, "sum", assume_exact=True)
    so.segment_reduce(vals.to(torch.int32), ids, 1_000, "sum")
    assert (so.ordered_histogram_cuda.launches, so.segment_reduce_cuda.launches) == (
        before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("chunk_rows", [1, 1000, 100_000])
def test_streamed_variants_on_card_equal_cpu(cuda, chunk_rows):
    from repro_torch.core import ChunkedEventFrame, run_streaming, variants
    from repro_torch.data import synthetic
    from repro_torch.kernels import segment_ops as so

    n_cases = 200 if chunk_rows == 1 else 20_000
    frame, _ = synthetic.generate(num_cases=n_cases, num_activities=26, seed=6,
                                  device="cpu")
    before = (so.segmented_polyhash_cuda.launches, so.segment_reduce_cuda.launches)
    got = run_streaming(variants.variants_kernel(n_cases),
                        ChunkedEventFrame.from_frame(frame, chunk_rows, device=cuda))
    chunks = -(-frame.nrows // chunk_rows)
    assert so.segmented_polyhash_cuda.launches - before[0] == 2 * chunks
    assert so.segment_reduce_cuda.launches - before[1] == 2 * chunks
    want = run_streaming(variants.variants_kernel(n_cases),
                         ChunkedEventFrame.from_frame(frame, chunk_rows))
    whole = variants.variant_fingerprints(frame.to(cuda))
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    for g, h in zip(got[:2], whole[:2]):
        assert torch.equal(g.cpu(), h.cpu()[:n_cases])


@pytest.mark.parametrize("chunk_rows", [1, 1000, 100_000])
def test_streamed_performance_on_card_equal_cpu(cuda, chunk_rows):
    from repro_torch.core import ChunkedEventFrame, engine, performance, run_streaming
    from repro_torch.data import synthetic
    from repro_torch.kernels import segment_ops as so

    n_cases = 200 if chunk_rows == 1 else 20_000
    frame, _ = synthetic.generate(num_cases=n_cases, num_activities=26, seed=7,
                                  device="cpu")
    kernel = engine.compose({
        "performance_dfg": performance.performance_dfg_kernel(26),
        "eventually_follows": performance.eventually_follows_kernel(26)})
    before = (so.segmented_sum_scan_cuda.launches, so.ordered_histogram_cuda.launches)
    got = run_streaming(kernel, ChunkedEventFrame.from_frame(frame, chunk_rows,
                                                             device=cuda))
    chunks = -(-frame.nrows // chunk_rows)
    assert so.segmented_sum_scan_cuda.launches - before[0] == chunks
    assert so.ordered_histogram_cuda.launches - before[1] == chunks
    want = run_streaming(kernel, ChunkedEventFrame.from_frame(frame, chunk_rows))
    for g, w in zip(got["performance_dfg"], want["performance_dfg"]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got["eventually_follows"].cpu(), want["eventually_follows"])
    rt = performance.remaining_time_targets(frame.to(cuda))
    assert torch.equal(rt.cpu(), performance.remaining_time_targets(frame))


SEMIRING_SHAPES = [(1, 28, 28), (28, 28, 28), (17, 9, 23), (130, 7, 131),
                   (384, 384, 384), (1, 384, 384), (33, 0, 5), (0, 4, 4),
                   (129, 384, 257), (384, 1, 384)]


def _semiring_operands(gen, shape, semiring, device):
    """Integer-valued operands (exact in any summation order) with the
    graph queries' holes: +inf for min_plus, -inf for max_min."""
    m, k, n = shape
    a = torch.randint(0, 50, (m, k), generator=gen, device=device).float()
    b = torch.randint(0, 50, (k, n), generator=gen, device=device).float()
    hole = {"min_plus": float("inf"), "max_min": float("-inf")}.get(semiring)
    if hole is not None:
        a[torch.rand((m, k), generator=gen, device=device) < 0.4] = hole
        b[torch.rand((k, n), generator=gen, device=device) < 0.4] = hole
    return a, b


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "max_min"])
@pytest.mark.parametrize("shape", SEMIRING_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_semiring_kernel_equals_plain(cuda, semiring, shape):
    """Bitwise: tropical candidates are single ops reduced by min/max, and
    integer-valued plus_times sums are exact below 2^24 in any order."""
    from repro_torch.kernels import graph_ops as go

    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) * 7 + len(semiring))
    a, b = _semiring_operands(gen, shape, semiring, cuda)
    before = go.semiring_matmul_cuda.launches
    got = go.semiring_matmul_cuda(a, b, semiring)
    torch.cuda.synchronize()
    m, _, n = shape
    assert go.semiring_matmul_cuda.launches == before + (1 if m and n else 0)
    want = go.semiring_matmul_ref(a, b, semiring)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), go.semiring_matmul_ref(a.cpu(), b.cpu(), semiring))


@pytest.mark.parametrize("shape", [(28, 28, 28), (384, 384, 384), (1, 384, 384)],
                         ids=lambda s: "x".join(map(str, s)))
def test_semiring_float_plus_times_within_rounding(cuda, shape):
    """Random floats: the kernel's k-order fmaf chain and the plain
    product round differently; each is within K * 2^-24 * (|A| @ |B|) of
    the exact sum, so they differ by at most twice that."""
    from repro_torch.kernels import graph_ops as go

    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(k)
    a = torch.randn((m, k), generator=gen, device=cuda)
    b = torch.randn((k, n), generator=gen, device=cuda)
    got = go.semiring_matmul_cuda(a, b, "plus_times").double()
    want = go.semiring_matmul_ref(a, b, "plus_times").double()
    bound = 2 * k * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    assert bool(((got - want).abs() <= bound).all())


def _fma32(p, c):
    """float32 ``fmaf`` of an exact float64 product ``p`` onto float32 ``c``,
    rounded once: the float64 sum ``s`` plus its exact error ``e`` (TwoSum)
    decides the one case where rounding ``s`` to float32 would round twice,
    ``s`` on a float32 midpoint with ``e != 0``."""
    inf = torch.full_like(c, float("inf"))
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    up, down = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    r64 = r.double()
    d = s - r64
    on_mid_up = (d > 0) & (s == (r64 + up.double()) * 0.5)
    on_mid_down = (d < 0) & (s == (r64 + down.double()) * 0.5)
    r = torch.where(on_mid_up & (e > 0), up, r)
    return torch.where(on_mid_down & (e < 0), down, r)


def _fma_chain(a, b):
    """C[i, j] = fmaf(A[i, K-1], B[K-1, j], ... fmaf(A[i, 0], B[0, j], 0.0)):
    the k-order float32 fma chain, each product exact in float64."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for kk in range(a.shape[1]):
        acc = _fma32(a[:, kk:kk + 1].double() * b[kk:kk + 1, :].double(), acc)
    return acc


def test_fma_chain_oracle_rounds_once():
    """The oracle against exact rationals on the CPU: random floats over
    seven decades, and operands whose float64 sum lands on a float32
    midpoint that the exact sum misses (rounding twice would go wrong)."""
    from fractions import Fraction

    rng = np.random.default_rng(4)
    a = (rng.standard_normal((5, 40)) * 10.0 ** rng.integers(-3, 4, (5, 40))).astype(np.float32)
    b = (rng.standard_normal((40, 6)) * 10.0 ** rng.integers(-3, 4, (40, 6))).astype(np.float32)
    # C = 1 + 2^-23, then A*B = 2^-24 (1 - 2^-36): the float64 sum is the
    # midpoint 1 + 3 * 2^-24, the exact sum lies below it
    a[0, :2] = [1.0, 1.0 + 2.0 ** -18]
    b[:2, 0] = [1.0 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -18)]
    a[0, 2:], b[2:, 0] = 0.0, 0.0
    got = _fma_chain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = np.float32(0.0)
            for kk in range(a.shape[1]):
                exact = Fraction(float(a[i, kk])) * Fraction(float(b[kk, j])) + Fraction(float(acc))
                acc = _round_f32(exact)
            assert got[i, j] == acc, (i, j)
    assert got[0, 0] == np.float32(1.0 + 2.0 ** -23)


def _round_f32(x):
    """Fraction -> nearest float32, ties to even (exact)."""
    from fractions import Fraction

    lo = np.float32(float(x))              # within an ulp of x
    for _ in range(2):
        if Fraction(float(lo)) > x:
            lo = np.nextafter(lo, np.float32(-np.inf))
    while Fraction(float(np.nextafter(lo, np.float32(np.inf)))) <= x:
        lo = np.nextafter(lo, np.float32(np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    dl, dh = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if dl < dh or (dl == dh and int(lo.view(np.int32)) % 2 == 0):
        return lo
    return hi


@pytest.mark.parametrize("shape", [(28, 28, 28), (1, 28, 28), (384, 384, 384),
                                   (1, 384, 384), (129, 384, 257), (17, 9, 23)],
                         ids=lambda s: "x".join(map(str, s)))
def test_semiring_plus_times_is_the_k_order_fma_chain(cuda, shape):
    """Random floats over seven decades: plus_times is one fmaf per k in
    ascending k from 0.0, bitwise (no split, no TF32)."""
    from repro_torch.kernels import graph_ops as go

    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(m + 3 * k + 7 * n)
    a = torch.randn((m, k), generator=gen, device=cuda) * 10.0 ** torch.randint(
        -3, 4, (m, k), generator=gen, device=cuda)
    b = torch.randn((k, n), generator=gen, device=cuda) * 10.0 ** torch.randint(
        -3, 4, (k, n), generator=gen, device=cuda)
    got = go.semiring_matmul_cuda(a, b, "plus_times")
    assert torch.equal(got, _fma_chain(a, b))


@pytest.mark.parametrize("semiring", ["min_plus", "max_min"])
@pytest.mark.parametrize("shape", [(384, 384, 384), (1, 384, 384), (129, 384, 257),
                                   (64, 1000, 70)], ids=lambda s: "x".join(map(str, s)))
def test_semiring_tropical_split_k_is_bitwise_for_any_floats(cuda, semiring, shape):
    """Non-integer weights with holes where the tropical products split K
    across a cluster: still bitwise the plain version."""
    from repro_torch.kernels import graph_ops as go

    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    a = torch.randn((m, k), generator=gen, device=cuda) * 100
    b = torch.randn((k, n), generator=gen, device=cuda) * 100
    hole = float("inf") if semiring == "min_plus" else float("-inf")
    a[torch.rand((m, k), generator=gen, device=cuda) < 0.3] = hole
    b[torch.rand((k, n), generator=gen, device=cuda) < 0.3] = hole
    assert torch.equal(go.semiring_matmul_cuda(a, b, semiring),
                       go.semiring_matmul_ref(a, b, semiring))


def test_semiring_nan_propagates_as_plain(cuda):
    from repro_torch.kernels import graph_ops as go

    gen = torch.Generator(device=cuda).manual_seed(9)
    for semiring in ("min_plus", "max_min"):
        a, b = _semiring_operands(gen, (40, 33, 35), semiring, cuda)
        a[3, 5] = float("nan")
        b[7, 2] = float("nan")
        got = go.semiring_matmul_cuda(a, b, semiring)
        want = go.semiring_matmul_ref(a, b, semiring)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _closure_inputs(gen, kind, n, device, variant):
    """A graph of n nodes for a closure: integer weights with holes,
    non-integer weights with holes, or those with NaN in a few places."""
    if kind == "bool":
        return torch.rand((n, n), generator=gen, device=device) < min(1.0, 3.0 / max(n, 1))
    if variant == "integer":
        w = torch.randint(1, 9, (n, n), generator=gen, device=device).float()
    else:
        w = torch.rand((n, n), generator=gen, device=device) * 7.3 + 0.01
    hole = float("inf") if kind == "min_plus" else float("-inf")
    w[torch.rand((n, n), generator=gen, device=device) < 0.8] = hole
    if variant == "nan" and n > 1:
        w[torch.randint(0, n, (2,), generator=gen, device=device),
          torch.randint(0, n, (2,), generator=gen, device=device)] = float("nan")
    return w


@pytest.mark.parametrize("kind", ["bool", "min_plus", "max_min"])
@pytest.mark.parametrize("n", [1, 2, 11, 28, 40, 48, 80, "max", "capacity"])
def test_semiring_closure_kernel_equals_plain(cuda, kind, n):
    """One launch a closure, bitwise the loop of plain products on the
    card: tropical with integer and non-integer weights, holes and NaN;
    boolean at k = 0, 1, 3, 5, N - 1 and None."""
    from repro_torch.kernels import graph_ops as go

    n = {"max": go.CLOSURE_MAX_N, "capacity": go.CLOSURE_CAPACITY}.get(n, n)
    gen = torch.Generator(device=cuda).manual_seed(31 * n + len(kind))
    cases = ([("integer", None), ("float", None), ("nan", None)] if kind != "bool"
             else [("0/1", k) for k in (0, 1, 3, 5, n - 1, None)])
    for variant, k in cases:
        x = _closure_inputs(gen, kind, n, cuda, variant)
        before = go.semiring_closure_cuda.launches
        got = go.semiring_closure_cuda(x, kind, k)
        torch.cuda.synchronize()
        assert go.semiring_closure_cuda.launches == before + 1
        want = go.semiring_closure_ref(x, kind, k)
        assert got.dtype == want.dtype and got.shape == (n, n)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{kind} n={n} {variant} k={k}")
        assert torch.equal(got.cpu(), go.semiring_closure_ref(x.cpu(), kind, k)) \
            or variant == "nan"


def test_semiring_dispatch_and_closures_on_card(cuda):
    """A closure of at most CLOSURE_MAX_N nodes is one closure launch and no
    product; above it the loop of tiled products; impl="ref" launches
    nothing."""
    from repro_torch.kernels import graph_ops as go

    gen = torch.Generator(device=cuda).manual_seed(11)
    w = torch.randint(1, 9, (28, 28), generator=gen, device=cuda).float()
    w[torch.rand((28, 28), generator=gen, device=cuda) < 0.8] = float("inf")
    adj = torch.isfinite(w)
    cap = torch.where(adj, w, float("-inf"))

    def counts():
        return go.semiring_closure_cuda.launches, go.semiring_matmul_cuda.launches

    before = counts()
    go.semiring_matmul(w, w, "min_plus", impl="ref")
    ref = (go.minplus_closure(w, impl="ref"), go.maxmin_closure(cap, impl="ref"),
           go.bool_closure(adj, impl="ref"), go.bool_closure(adj, 3, impl="ref"))
    assert counts() == before
    got = (go.minplus_closure(w), go.maxmin_closure(cap), go.bool_closure(adj),
           go.bool_closure(adj, 3))
    assert counts() == (before[0] + 4, before[1])
    want = (go.minplus_closure(w.cpu()), go.maxmin_closure(cap.cpu()),
            go.bool_closure(adj.cpu()), go.bool_closure(adj.cpu(), 3))
    for g, r, h in zip(got, ref, want):
        assert g.device.type == "cuda" and torch.equal(g, r) and torch.equal(g.cpu(), h)
    # one node past the kernel's limit: the loop of tiled products
    n = go.CLOSURE_MAX_N + 1
    big = _closure_inputs(gen, "min_plus", n, cuda, "float")
    before = counts()
    got = go.minplus_closure(big)
    steps = len(go.closure_plan(n)[1])
    assert counts() == (before[0], before[1] + steps)
    assert torch.equal(got, go.minplus_closure(big, impl="ref"))
    badj = _closure_inputs(gen, "bool", n, cuda, "0/1")
    before = counts()
    got = go.bool_closure(badj, 5)
    assert counts() == (before[0], before[1] + len(go.closure_plan(n, 5)[1]))
    assert torch.equal(got, go.bool_closure(badj, 5, impl="ref"))
    with pytest.raises(ValueError, match="CLOSURE_CAPACITY"):
        go.semiring_closure_cuda(torch.zeros((go.CLOSURE_CAPACITY + 1,) * 2, device=cuda))


def _same_result(got, want, flow_atol=1e-6, where="cuda"):
    """Card result == CPU result: bitwise, except centrality flow (its
    normalized plus_times matvecs add floats in each lowering's order).
    Each tensor of ``got`` is on the card (``where="cuda"``), or in
    page-locked host memory (``where="pinned"``: a front-door answer)."""
    import dataclasses

    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "flow":
                _on(g, where)
                assert torch.allclose(g.cpu(), w, rtol=0, atol=flow_atol)
            else:
                _same_result(g, w, where=where)
    elif isinstance(want, torch.Tensor):
        _on(got, where)
        assert torch.equal(got.cpu(), want)
    elif isinstance(want, (tuple, list)) and len(want) and \
            isinstance(want[0], torch.Tensor):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_result(g, w, flow_atol, where)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_result(got[k], want[k], flow_atol, where)
    else:
        assert got == want


def _on(t, where):
    if where == "pinned":
        assert t.device.type == "cpu" and (t.is_pinned() or not t.numel())
    else:
        assert t.device.type == "cuda"


@pytest.mark.parametrize("chunk_rows", [1, 1000, 100_000])
def test_streamed_graph_verbs_on_card_equal_cpu(cuda, chunk_rows):
    from repro_torch import graph
    from repro_torch.core import ChunkedEventFrame, run_streaming
    from repro_torch.data import synthetic
    from repro_torch.kernels import graph_ops as go
    from repro_torch.kernels import segment_ops as so

    n_cases = 150 if chunk_rows == 1 else 20_000
    frame, _ = synthetic.generate(num_cases=n_cases, num_activities=26, seed=8,
                                  device="cpu")
    # (kernel, closure launches, product launches): each closure of the
    # 28-node graph is one launch; centrality's 16 matvecs are products
    kernels = {"graph": (graph.graph_kernel(26, timed=True), 0, 0),
               "reach": (graph.reachability_kernel(26), 1, 0),
               "reach3": (graph.reachability_kernel(26, 3), 1, 0),
               "paths": (graph.bottleneck_paths_kernel(26), 2, 0),
               "paths_perf": (graph.bottleneck_paths_kernel(26, "performance"), 2, 0),
               "centrality": (graph.node_centrality_kernel(26), 0, 16)}
    chunks = -(-frame.nrows // chunk_rows)
    for name, (kernel, closures, products) in kernels.items():
        before = (go.semiring_closure_cuda.launches, go.semiring_matmul_cuda.launches,
                  so.pair_count_cuda.launches)
        got = run_streaming(kernel, ChunkedEventFrame.from_frame(
            frame, chunk_rows, device=cuda))
        assert go.semiring_closure_cuda.launches - before[0] == closures, name
        assert go.semiring_matmul_cuda.launches - before[1] == products, name
        assert so.pair_count_cuda.launches - before[2] >= chunks, name
        want = run_streaming(kernel, ChunkedEventFrame.from_frame(frame, chunk_rows))
        _same_result(got, want)


@pytest.mark.parametrize("chunk_rows", [1, 1000, 100_000])
def test_streamed_discovery_on_card_equal_cpu(cuda, chunk_rows):
    from repro_torch.core import (ChunkedEventFrame, conformance, discovery,
                                  run_streaming)
    from repro_torch.data import synthetic
    from repro_torch.kernels import segment_ops as so

    n_cases = 150 if chunk_rows == 1 else 20_000
    frame, _ = synthetic.generate(num_cases=n_cases, num_activities=26, seed=9,
                                  device="cpu")
    chunks = -(-frame.nrows // chunk_rows)
    before = so.pair_count_cuda.launches
    st = run_streaming(discovery.discovery_kernel(26), ChunkedEventFrame.from_frame(
        frame, chunk_rows, device=cuda))
    assert so.pair_count_cuda.launches - before == 2 * chunks
    st_cpu = run_streaming(discovery.discovery_kernel(26),
                           ChunkedEventFrame.from_frame(frame, chunk_rows))
    _same_result(st, st_cpu)
    net, net_cpu = discovery.discover_heuristics(st), discovery.discover_heuristics(st_cpu)
    _same_result(net, net_cpu)
    model = discovery.discover_alpha(st.dfg)
    assert model.places == discovery.discover_alpha(st_cpu.dfg).places
    # the log against its own models: the alpha footprint fits exactly;
    # the heuristics net drops edges below its thresholds
    for score in (conformance.alpha_fitness(st.dfg, model),
                  conformance.footprint_conformance(st.dfg, model)):
        assert score.device.type == "cuda" and float(score) == 1.0
    fit = conformance.heuristics_fitness(st.dfg, net)
    assert torch.equal(fit.cpu(), conformance.heuristics_fitness(st_cpu.dfg, net_cpu))
    assert 0.0 < float(fit) <= 1.0


FLASH_SHAPES = [(1, 4, 2, 128, 128, 64, True, None),
                (2, 8, 2, 256, 256, 64, True, 512),
                (1, 4, 4, 200, 200, 32, True, None),
                (1, 4, 1, 1, 384, 64, False, None),
                (1, 2, 2, 96, 96, 128, True, 32),
                (2, 4, 2, 64, 64, 16, False, None),
                (1, 4, 2, 200, 200, 16, True, None),      # GQA over ragged keys
                (2, 6, 2, 130, 130, 128, True, 48),
                (8, 12, 12, 12, 12, 64, True, None),      # eventlm-100m prefill, (a)
                (8, 12, 12, 1000, 1000, 64, True, None),  # and (b)
                (2, 16, 16, 12, 1500, 64, False, None),   # whisper: cross attention,
                (2, 16, 16, 1, 1500, 64, False, None),    # its decode step
                (2, 16, 16, 1500, 1500, 64, False, None)]  # and the encoder
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(gen, b, h, kvh, sq, sk, d, dtype, device):
    return (torch.randn((b, h, sq, d), generator=gen, device=device).to(dtype),
            torch.randn((b, kvh, sk, d), generator=gen, device=device).to(dtype),
            torch.randn((b, kvh, sk, d), generator=gen, device=device).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_kernel_equals_plain(cuda, dtype, shape):
    """The JAX kernel tests' shapes (``kv_len = sk - 17`` past 64 keys) and
    the serving path's prefill shapes; atol 2e-5 in float32, 2e-2 in bf16."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    assert not torch.backends.cuda.matmul.allow_tf32
    b, h, kvh, sq, sk, d, causal, win = shape
    gen = torch.Generator(device=cuda).manual_seed(sq * 131 + d)
    q, k, v = _flash_inputs(gen, b, h, kvh, sq, sk, d, dtype, cuda)
    kvlen = sk - 17 if sk > 64 and b < 8 else None
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, kvlen, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_ref(q, k, v, kvlen, causal=causal, window=win)
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kv_len_on_the_device(cuda, dtype):
    """``kv_len`` as a 0-d CUDA tensor (int32 or int64), read on the card;
    0 leaves every row with no valid column, which is 0."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref, ops

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = _flash_inputs(gen, 2, 4, 2, 150, 150, 64, dtype, cuda)
    for n in (0, 1, 63, 64, 65, 150, 400):
        for kv_len in (torch.tensor(n, device=cuda, dtype=torch.int32),
                       torch.tensor(n, device=cuda)):
            for causal in (True, False):
                got = ops.flash_attention(q, k, v, kv_len, causal=causal)
                want = flash_attention_ref(q, k, v, kv_len, causal=causal)
                assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL[dtype]
    got = flash_attention_cuda(q, k, v, torch.tensor(0, device=cuda), causal=False)
    assert not bool(got.any())


def test_flash_attention_strided_views_and_dispatch(cuda):
    """The model's (B, S, H, D) buffers viewed as (B, H, S, D) are read in
    place and the output keeps that layout; ``impl="ref"`` launches nothing."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref, ops

    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((2, 77, 6, 32), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((2, 77, 3, 32), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((2, 77, 3, 32), generator=gen, device=cuda).to(torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(qt, kt, vt, window=20)
    assert flash_attention_cuda.launches == before + 1
    assert got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention(qt, kt, vt, window=20, impl="ref")
    assert flash_attention_cuda.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= 2e-2
    assert torch.equal(want, flash_attention_ref(qt.contiguous(), kt.contiguous(),
                                                 vt.contiguous(), window=20))


@pytest.mark.parametrize("d", [16, 32, 64, 96, 112, 128, 256])
def test_flash_attention_bf16_every_head_dim(cuda, d):
    """The tensor-core route at each head dim: GQA over ragged keys (sk =
    150, two full 64-key tiles and a zero-filled tail), causal and not, a
    window, ``kv_len`` as an int, an int32 and an int64 tensor on the card,
    and ``kv_len = 0`` giving zeros; within 2e-2 of the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = _flash_inputs(gen, 2, 6, 2, 150, 150, d, torch.bfloat16, cuda)
    for causal, win in ((True, None), (False, None), (True, 40), (False, 70)):
        for n in (None, 150, 101, 64, 1):
            for kv_len in ((n,) if n is None else
                           (n, torch.tensor(n, device=cuda, dtype=torch.int32),
                            torch.tensor(n, device=cuda))):
                got = flash_attention_cuda(q, k, v, kv_len, causal=causal, window=win)
                want = flash_attention_ref(q, k, v, kv_len, causal=causal, window=win)
                assert got.dtype == torch.bfloat16 and got.shape == want.shape
                assert float((got.float() - want.float()).abs().max()) <= 2e-2
    zero = flash_attention_cuda(q, k, v, torch.tensor(0, device=cuda), causal=True)
    torch.cuda.synchronize()
    assert not bool(zero.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 96, 112, 128, 256])
def test_flash_attention_strided_views_every_head_dim(cuda, d, dtype):
    """(B, S, H, D) buffers viewed as (B, H, S, D) at each head dim, read in
    place (TMA reads the view's strides on the bf16 route), GQA, a window;
    a 16-byte-misaligned view is copied first, not refused."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    q = torch.randn((2, 77, 6, d), generator=gen, device=cuda).to(dtype).transpose(1, 2)
    k = torch.randn((2, 77, 3, d), generator=gen, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn((2, 77, 3, d), generator=gen, device=cuda).to(dtype).transpose(1, 2)
    got = flash_attention_cuda(q, k, v, causal=True, window=20)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_ref(q, k, v, causal=True, window=20)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL[dtype]
    flat = torch.randn(1 + 2 * 6 * 77 * d, generator=gen, device=cuda).to(dtype)
    q1 = flat[1:].view(2, 77, 6, d).transpose(1, 2)        # base off by one element
    got = flash_attention_cuda(q1, k, v, causal=True)
    want = flash_attention_ref(q1, k, v, causal=True)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_cuda_graph_replay(cuda, dtype):
    """A capture of the kernel replays with ``kv_len`` changed on the card:
    no host sync and no per-call host state inside the launch."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = _flash_inputs(gen, 2, 4, 2, 200, 200, 64, dtype, cuda)
    kv_len = torch.tensor(200, device=cuda, dtype=torch.int32)
    flash_attention_cuda(q, k, v, kv_len, causal=True)     # first use, outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = flash_attention_cuda.launches
    with torch.cuda.graph(graph):
        out = flash_attention_cuda(q, k, v, kv_len, causal=True)
    assert flash_attention_cuda.launches == before + 1
    for n in (200, 130, 64, 0):
        kv_len.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, n, causal=True)
        assert float((out.float() - want.float()).abs().max()) <= FLASH_ATOL[dtype]


@pytest.mark.parametrize("d,dtype,exc", [(100, torch.float32, ValueError),
                                         (512, torch.bfloat16, ValueError),
                                         (64, torch.float16, TypeError)])
def test_flash_attention_refuses_unsupported_inputs(cuda, d, dtype, exc):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q = torch.zeros((1, 2, 8, d), dtype=dtype, device=cuda)
    before = flash_attention_cuda.launches
    with pytest.raises(exc):
        flash_attention_cuda(q, q, q)
    assert flash_attention_cuda.launches == before


def test_reduced_engine_on_card_equals_cpu(cuda):
    """The reduced eventlm-100m (f32) served on the card -- prefill through
    the kernel, one launch per layer, none in decode -- gives the CPU plain
    run's greedy tokens."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import model as Mdl
    from repro_torch.models.module import Initializer
    from repro_torch.serve.engine import Engine

    cfg = reduced_config(get_config("eventlm-100m"))

    def model():
        return Mdl.init_params(cfg, Initializer(torch.Generator().manual_seed(0),
                                                cfg.param_dtype))

    prompts = np.random.default_rng(0).integers(3, cfg.vocab_size, (4, 12)).astype(np.int32)
    want = Engine(cfg, model(), max_len=64, device="cpu").generate(prompts, 8)
    card = Engine(cfg, model(), max_len=64, device=cuda)
    before = flash_attention_cuda.launches
    logits, cache = card.prefill(prompts)
    assert flash_attention_cuda.launches == before + cfg.num_layers
    card.decode(cache, logits.argmax(-1)[:, None])
    assert flash_attention_cuda.launches == before + cfg.num_layers
    got = card.generate(prompts, 8)
    assert flash_attention_cuda.launches == before + 2 * cfg.num_layers
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, atol=1e-3)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_reduced_moe_engine_on_card_equals_cpu(cuda, arch):
    """The reduced MoE configs (f32) served on the card -- the kernel once a
    prefill layer, none in decode -- give the CPU run's greedy tokens, and
    expert parallelism over 2 and 4 shards of the card the dense run's."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed.mesh import mesh_for
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import model as Mdl
    from repro_torch.models.module import Initializer
    from repro_torch.serve.engine import Engine

    cfg = reduced_config(get_config(arch))
    model = Mdl.init_params(cfg, Initializer(torch.Generator().manual_seed(0),
                                             cfg.param_dtype))
    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (4, 12)).astype(np.int32)
    want = Engine(cfg, model, max_len=64, device="cpu").generate(prompts, 8)
    card = Engine(cfg, model, max_len=64, device=cuda)
    before = flash_attention_cuda.launches
    got = card.generate(prompts, 8)
    assert flash_attention_cuda.launches == before + cfg.num_layers
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, atol=1e-3)
    ep_cfg = cfg.with_overrides(moe_impl="shard_map")
    for n in (2, 4):
        ep = Engine(ep_cfg, card.model, max_len=64, device=cuda,
                    mesh=mesh_for(n, cuda)).generate(prompts, 8)
        np.testing.assert_array_equal(ep.tokens, got.tokens)
        np.testing.assert_allclose(ep.prefill_logits, got.prefill_logits, atol=1e-4)


FAMILY_LAUNCHES = {"zamba2-7b": (2, 0), "xlstm-1.3b": (0, 0), "whisper-medium": (10, 4),
                   "internvl2-2b": (4, 0)}


@pytest.mark.parametrize("arch", list(FAMILY_LAUNCHES))
def test_reduced_family_engine_on_card_equals_cpu(cuda, arch):
    """The reduced hybrid, ssm, audio and vlm configs (f32) served on the
    card give the CPU run's greedy tokens, with the kernel launched as the
    family says (hybrid once a group, ssm never, audio for the encoder, the
    decoder's self and cross attention a prefill and its cross attention a
    decode step, vlm once a layer), and ``forward`` within 1e-3."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import model as Mdl
    from repro_torch.models.module import Initializer
    from repro_torch.serve.engine import Engine

    cfg = reduced_config(get_config(arch))
    model = Mdl.init_params(cfg, Initializer(torch.Generator().manual_seed(0),
                                             cfg.param_dtype))
    prompts = np.random.default_rng(2).integers(3, cfg.vocab_size, (4, 12)).astype(np.int32)
    n = {"audio": cfg.enc_seq, "vlm": cfg.num_patches}.get(cfg.family)
    fe = (torch.randn((4, n, cfg.d_model), generator=torch.Generator().manual_seed(9)) * 0.1
          if n else None)
    want = Engine(cfg, model, max_len=64, device="cpu").generate(prompts, 8, frontend=fe)
    toks = torch.from_numpy(prompts)
    with torch.inference_mode():
        want_fwd = Mdl.forward(cfg, model, toks, frontend=fe).numpy()
    card = Engine(cfg, model, max_len=64, device=cuda)       # moves model to the card
    per_prefill, per_step = FAMILY_LAUNCHES[arch]
    before = flash_attention_cuda.launches
    logits, cache = card.prefill(prompts, fe)
    assert flash_attention_cuda.launches == before + per_prefill
    card.decode(cache, logits.argmax(-1)[:, None])
    assert flash_attention_cuda.launches == before + per_prefill + per_step
    got = card.generate(prompts, 8, frontend=fe)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prefill_logits, want.prefill_logits, atol=1e-3)
    with torch.inference_mode():
        got_fwd = Mdl.forward(cfg, card.model, toks.to(cuda),
                              frontend=None if fe is None else fe.to(cuda))
    np.testing.assert_allclose(got_fwd.cpu().numpy(), want_fwd, atol=1e-3)


@pytest.mark.parametrize("mixer", ["mamba2", "mlstm", "slstm"])
def test_mixers_on_card_equal_cpu(cuda, mixer):
    """Each recurrent mixer, chunked with its state and then one step, on
    the card within 1e-4 of the CPU (float32, (2, 300) tokens over 16-token
    chunks)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import mamba2 as M
    from repro_torch.models import xlstm as X
    from repro_torch.models.module import Initializer

    arch = "zamba2-7b" if mixer == "mamba2" else "xlstm-1.3b"
    cfg = reduced_config(get_config(arch))
    init, apply, step = {
        "mamba2": (M.mamba2_init, lambda p, u: M.mamba2_apply(p, u, cfg, return_state=True),
                   M.mamba2_step),
        "mlstm": (X.mlstm_init, lambda p, u: X.mlstm_apply(p, u, cfg, return_state=True),
                  X.mlstm_step),
        "slstm": (X.slstm_init, lambda p, u: X.slstm_apply(p, u, cfg), X.slstm_step)}[mixer]
    p = init(Initializer(torch.Generator().manual_seed(1)), cfg)
    gen = torch.Generator().manual_seed(2)
    u = torch.randn((2, 300, cfg.d_model), generator=gen)
    v = torch.randn((2, 1, cfg.d_model), generator=gen)
    pc = {k: t.to(cuda) for k, t in p.items()}
    y, st = apply(p, u)
    z, st2 = step(p, v, st, cfg)
    yc, stc = apply(pc, u.to(cuda))
    zc, st2c = step(pc, v.to(cuda), stc, cfg)
    for got, want in [(yc, y), (zc, z), *((stc[k], st[k]) for k in st),
                      *((st2c[k], st2[k]) for k in st2)]:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


def _query_log(tmp_path, n_cases=20_000, group_rows=8_192):
    from repro_torch.core import ACTIVITY, CASE, TIMESTAMP
    from repro_torch.data import synthetic
    from repro_torch.storage import edf

    frame, tables = synthetic.generate(num_cases=n_cases, num_activities=26,
                                       seed=9, device="cpu")
    frame = frame.select([CASE, ACTIVITY, TIMESTAMP])
    path = str(tmp_path / "q.edf")
    edf.write(path, frame, {ACTIVITY: tables[ACTIVITY]},
              row_group_rows=group_rows)
    return path, frame


def test_pruned_variants_scan_with_ghosts_on_card(cuda, tmp_path):
    """A pruned variants scan on the card: the ghost chunks built from the
    header sketches go through the affine-scan kernel (two launches per
    ghost chunk), and the result equals the plain lowering on the card,
    the CPU scan and the eager filter-then-mine on the card."""
    from repro_torch import query
    from repro_torch.core import CASE, engine, ops, variants
    from repro_torch.kernels import segment_ops as so

    path, frame = _query_log(tmp_path)
    ncases = query.count_cases(query.Plan(path))
    plan = query.Plan(path).filter(query.col(CASE).between(4_000, 9_000))
    ph = query.compile_plan(plan)
    ghosts = [it for it in ph.final_schedule({}, sketch=True)
              if type(it).__name__ == "GhostItem"]
    assert len(ghosts) >= 2
    before = so.segmented_affine_cuda.launches
    got, rep = query.execute(plan, variants.variants_kernel(ncases))
    assert so.segmented_affine_cuda.launches - before >= 2 * len(ghosts)
    assert rep.groups_skipped > 0 and got[0].device.type == "cuda"
    plain, _ = query.execute(plan, variants.variants_kernel(ncases, "ref"))
    before = so.segmented_affine_cuda.launches
    cpu, _ = query.execute(plan, variants.variants_kernel(ncases), device="cpu")
    assert so.segmented_affine_cuda.launches == before
    c = frame[CASE]
    whole = engine.run_single(variants.variants_kernel(ncases),
                              ops.proj(frame, (c >= 4_000) & (c <= 9_000)).to(cuda))
    for g, p, h, w in zip(got, plain, cpu, whole):
        assert torch.equal(g.cpu(), p.cpu())
        assert torch.equal(g.cpu(), h)
        assert torch.equal(g.cpu(), w.cpu())


def test_grouped_collect_and_prefetch_on_card(cuda, tmp_path):
    """execute_grouped on the card == execute (bitwise), the second call
    served from the state cache; the chunk stream is the same with the
    prefetch thread off and on; merge_tree over per-group folds of every
    mergeable spec == run_streaming on the card."""
    from repro_torch import query
    from repro_torch.core import CASE, ChunkedEventFrame, engine, run_streaming
    from repro_torch.query import exec as qexec
    from repro_torch.query import statecache

    path, _ = _query_log(tmp_path, n_cases=8_000, group_rows=4_096)
    ncases = query.count_cases(query.Plan(path))
    dims = engine.Dims(26, ncases)
    plan = query.Plan(path).filter(query.col(CASE).between(1_000, 5_000))
    statecache.state_cache().clear()
    for verb in ("dfg", "variants"):
        kernel = engine.kernel_spec(verb).make(dims)
        fp = statecache.spec_fingerprint(verb, dims)
        want, _ = query.execute(plan, kernel, device="cpu")
        first, rep1 = qexec.execute_grouped(plan, kernel, fp)
        second, rep2 = qexec.execute_grouped(plan, kernel, fp)
        assert rep1.groups_read > 0 and rep2.groups_read == 0
        assert rep2.groups_cached == rep1.groups_read
        _same_result(first, want)
        _same_result(second, want)
    streams = []
    for depth in (0, 1):
        src, _ = query.pruned_source(plan, sketch=True, prefetch=depth)
        streams.append([(ch.columns, ch.rows_valid()) for ch in src])
    for (c0, r0), (c1, r1) in zip(*streams):
        assert torch.equal(r0, r1)
        for k in c0:
            assert torch.equal(c0[k], c1[k])
    src = ChunkedEventFrame.from_edf(path, device=cuda)
    cpu_src = ChunkedEventFrame.from_edf(path, device="cpu")
    for spec in engine.kernel_specs().values():
        kernel = spec.make(dims)
        if engine.mergeable(kernel):
            merged = engine.merge_tree(kernel, [engine.fold_group(kernel, [ch])
                                                for ch in src])
            _same_result(engine.finalize_group(kernel, merged),
                         run_streaming(kernel, cpu_src))


def test_state_cache_never_serves_a_cpu_state_to_a_cuda_collect(cuda, tmp_path):
    from repro_torch import query
    from repro_torch.core import CASE, engine
    from repro_torch.query import exec as qexec
    from repro_torch.query import statecache

    path, _ = _query_log(tmp_path, n_cases=3_000, group_rows=4_096)
    dims = engine.Dims(26, query.count_cases(query.Plan(path)))
    plan = query.Plan(path).filter(query.col(CASE) >= 100)
    kernel = engine.kernel_spec("dfg").make(dims)
    statecache.state_cache().clear()
    fp = statecache.spec_fingerprint("dfg", dims)
    on_cpu, rep_cpu = qexec.execute_grouped(plan, kernel, fp, device="cpu")
    assert rep_cpu.groups_folded > 0
    on_card, rep = qexec.execute_grouped(plan, kernel, fp)
    assert rep.groups_cached == 0 and rep.groups_folded > 0
    assert on_card.counts.device.type == "cuda"
    assert torch.equal(on_card.counts.cpu(), on_cpu.counts)
    again, rep = qexec.execute_grouped(plan, kernel, fp, device="cpu")
    assert rep.groups_cached == rep_cpu.groups_folded and rep.groups_read == 0
    assert torch.equal(again.counts, on_cpu.counts)


def test_dataset_memo_never_serves_a_cpu_result_to_a_cuda_collect(cuda, tmp_path):
    """The result memo's key holds the dataset's device type and lowering:
    a collect on the card after the same collect on the CPU mines again,
    on the card (the counting kernels launch), and each device then hits
    its own entry.  The card's answer is delivered to page-locked host
    memory, the CPU's stays in ordinary memory."""
    import repro_torch
    from repro_torch.dataset import engines
    from repro_torch.kernels import segment_ops as so
    from repro_torch.query import statecache

    path, _ = _query_log(tmp_path, n_cases=3_000, group_rows=4_096)
    engines.clear_result_cache()
    statecache.state_cache().clear()
    for engine in ("eager", "streaming"):
        on_cpu = repro_torch.open(path, device="cpu").collect("dfg", engine=engine)
        assert on_cpu.result.counts.device.type == "cpu"
        assert not on_cpu.result.counts.is_pinned()
        ds = repro_torch.open(path)                  # the default: the card
        before = (so.pair_count_cuda.launches, so.histogram_cuda.launches)
        on_card = ds.collect("dfg", engine=engine)
        assert so.pair_count_cuda.launches > before[0]
        assert so.histogram_cuda.launches > before[1]
        assert on_card is not on_cpu
        assert on_card.result.counts.device.type == "cpu"
        assert on_card.result.counts.is_pinned()
        if engine == "streaming":
            assert on_card.report.groups_cached == 0
            assert on_card.report.groups_folded > 0
        _same_result(on_card.result, on_cpu.result, where="pinned")
        assert ds.collect("dfg", engine=engine) is on_card
        assert repro_torch.open(path, device="cpu").collect(
            "dfg", engine=engine) is on_cpu


def test_eager_engine_at_seven_million_rows_on_card_equals_cpu(cuda):
    """The eager engine folds the whole log as one chunk: every kernel at
    the Table-6 L1 size (7,003,349 rows, 10^6 case segments; the (N, 26)
    sum scan of eventually-follows, the case-indexed segment reductions,
    both hash scans, the fold, the counting kernels) through ``profile()``
    on the card, equal to the same fused pass on the CPU (centrality
    ``flow`` within 1e-6)."""
    import repro_torch
    from repro_torch.core import ACTIVITY, CASE, TIMESTAMP, EventFrame
    from repro_torch.data import synthetic

    cols, tables = synthetic.generate_numpy(**synthetic.paper_table6_config(1))
    assert cols[CASE].shape[0] == 7_003_349
    frame = EventFrame.from_numpy({c: cols[c] for c in (CASE, ACTIVITY, TIMESTAMP)},
                                  device="cpu")
    tab = {ACTIVITY: tables[ACTIVITY]}
    on_card = repro_torch.open(frame, tables=tab).profile(engine="eager")
    on_cpu = repro_torch.open(frame, tables=tab, device="cpu").profile(engine="eager")
    assert on_card.verbs == on_cpu.verbs and len(on_card.verbs) == 16
    for verb in on_card.verbs:
        _same_result(on_card[verb], on_cpu[verb], where="pinned")


def test_mining_service_on_card_equals_cpu(cuda, tmp_path):
    """The service mines on the card by default; each endpoint's JSON
    equals the same service on the CPU (centrality aside)."""
    import json

    from repro_torch.service import MiningService

    path, _ = _query_log(tmp_path, n_cases=3_000, group_rows=4_096)
    pdir = tmp_path / "parts"
    pdir.mkdir()
    (tmp_path / "q.edf").rename(pdir / "part_00000.edf")
    card, cpu = MiningService(str(pdir)), MiningService(str(pdir), device="cpu")
    assert card.device == "cuda"
    for call in (lambda s: s.collect("dfg", engine="streaming"),
                 lambda s: s.collect("variants", engine="eager"),
                 lambda s: s.window("dfg", size=2, step=1),
                 lambda s: s.graph("reachability", engine="streaming")):
        assert json.dumps(call(card)) == json.dumps(call(cpu))


def test_sharded_engine_on_card_equals_streaming_at_8_shards(cuda, tmp_path):
    """``engine="sharded"`` at 8 shards on the card (all on the one card)
    equals the streaming engine on the card and the sharded engine on the
    CPU, for every verb with a distributed state and two merge-tree verbs,
    over a pruned case band; the DFG launches the counting kernels on every
    shard, variants four affine scans and two uint32 ``segment_reduce`` a
    shard."""
    import repro_torch
    from repro_torch.core import CASE
    from repro_torch.dataset import engines
    from repro_torch.kernels import segment_ops as so

    path, _ = _query_log(tmp_path, n_cases=20_000, group_rows=8_192)
    engines.clear_result_cache()

    def band(ds):
        c = repro_torch.col(CASE)
        return ds.filter((c >= 4_000) & (c <= 9_000))

    card, cpu = band(repro_torch.open(path)), band(repro_torch.open(path, device="cpu"))
    wrappers = (so.pair_count_cuda, so.histogram_cuda, so.segmented_affine_cuda,
                so.segment_reduce_cuda)
    for verb in ("dfg", "discovery", "alpha", "heuristics", "variants", "graph",
                 "reachability", "bottleneck_paths", "node_centrality",
                 "case_sizes", "eventually_follows"):
        before = [w.launches for w in wrappers]
        got = card.collect(verb, engine="sharded", num_shards=8)
        d = [w.launches - b for w, b in zip(wrappers, before)]
        assert got.engine == "sharded" and got.report.groups_skipped > 0
        if verb == "dfg":
            assert d[0] >= 8 and d[1] >= 16, d
        if verb == "variants":
            assert d[2] == 32 and d[3] == 16, d
        want = cpu.collect(verb, engine="sharded", num_shards=8).result
        _same_result(got.result, want, where="pinned")
        _same_result(card.collect(verb, engine="streaming").result, want,
                     where="pinned")


def test_shard_updates_never_leave_the_card(cuda, monkeypatch):
    """Once the shards are on the card, the composed DFG + discovery update,
    the halo, the variants lowering and the ``psum`` read nothing back to
    the host (every device-to-host path of a tensor raises), and their
    states equal the same drivers over CPU shards."""
    from repro_torch.core import CASE, ACTIVITY, engine
    from repro_torch.core.dfg import dfg_kernel
    from repro_torch.core.discovery import discovery_kernel
    from repro_torch.core.polyhash import BASE1, BASE2
    from repro_torch.data import synthetic
    from repro_torch.distributed import dfg as ddfg
    from repro_torch.distributed import discovery as ddisc
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed import query as dq
    from repro_torch.distributed.variants import run_sharded_variants

    cols, _ = synthetic.generate_numpy(num_cases=5_000, num_activities=26, seed=3)
    case, act = cols[CASE].astype(np.int64), cols[ACTIVITY].astype(np.int32)
    v = act + 1
    maps = (np.full(v.shape, BASE1, np.int32), v, np.full(v.shape, BASE2, np.int32), v)
    c, a, r, maps = dq._pad_to_shards(case, act, np.ones(case.size, bool), 8, maps)
    host = [torch.from_numpy(x) for x in (c, a, r, *maps, *dq._segment_markers(c))]
    fixes = {"dfg": ddfg.fix_trailing_end, "discovery": ddisc._fix_end}

    def run(device):
        shards = ddfg.shard_columns(dmesh.mesh_for(8, device), *host)
        kernel = engine.compose({"dfg": dfg_kernel(26), "discovery": discovery_kernel(26)})
        return (ddfg.run_sharded_composed(kernel, fixes, *shards[:3])[0],
                run_sharded_variants(*shards[3:], 5_000)[0])

    want = run("cpu")
    shards_on_card = ddfg.shard_columns(dmesh.mesh_for(8, "cuda"), *host)
    assert all(t.is_cuda for col in shards_on_card for t in col)

    def refuse(name):
        inner = getattr(torch.Tensor, name)

        def guarded(self, *args, **kwargs):
            if self.is_cuda:
                raise AssertionError(f"Tensor.{name} on a card tensor")
            return inner(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, guarded)

    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        refuse(name)
    inner_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        out = inner_to(self, *args, **kwargs)
        if self.is_cuda and not out.is_cuda:
            raise AssertionError("Tensor.to moved a card tensor to the host")
        return out
    monkeypatch.setattr(torch.Tensor, "to", to)
    monkeypatch.setattr(ddfg, "shard_columns", lambda mesh, *cols: shards_on_card)
    got = run("cuda")
    torch.cuda.synchronize()
    monkeypatch.undo()
    for g, w in zip(engine.tensor_leaves(got), engine.tensor_leaves(want)):
        assert g.is_cuda and torch.equal(g.cpu(), w)


# ------------------------------------------------- training: the backward
FLASH_LSE_ATOL = 2e-5
# |got - want| <= rtol (1 + |want|) + c A against the plain backward, A the
# magnitude product of the gradient's terms (flash_attention_bwd_magnitudes):
# bf16 rounds P and dS to bf16 (each within 2^-8 of itself) before the
# gradient products; float32 takes every product as 3xTF32 (2^-20), with A
# taken with dp_error: dS = P (dP - Delta) cancels, so dP's and Delta's
# errors reach dQ and dK through P, not through |dS|
FLASH_BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
FLASH_BWD_MAG = {torch.float32: 2.0 ** -19, torch.bfloat16: 2 * 2.0 ** -8}
FLASH_GRAD_RTOL = {torch.float32: 5e-5, torch.bfloat16: 3e-2}


def _rel(got, want):
    return float(((got.float() - want.float()).abs() / (1 + want.float().abs())).max())


def _bwd_ratio(got, want, mag, dtype):
    """max |got - want| over the backward's stated bound: at most 1 within it."""
    want = want.float()
    tol = FLASH_BWD_RTOL[dtype] * (1 + want.abs()) + FLASH_BWD_MAG[dtype] * mag.float()
    return float(((got.float() - want).abs() / tol).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_bwd_kernel_equals_plain(cuda, dtype, shape):
    """The forward's lse within 2e-5 of the plain one (-inf where it is),
    and the backward kernel's (dq, dk, dv) against the plain backward on
    the same inputs, each within rtol (1 + |want|) + c A, A the gradient's
    magnitude product: 1e-5 and 2^-19 in float32 (3xTF32 products, each
    within 2^-20 of its magnitude product; A with dp_error), 2^-7 and 2
    2^-8 in bf16 (P and dS rounded to bf16, each within 2^-8 of itself,
    before the gradient products; both sides round to bf16 at the end);
    ``kv_len`` as an int and as a 0-d tensor, and 0 giving 0 gradients."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_magnitudes,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda,
                                                     flash_attention_lse_ref)

    b, h, kvh, sq, sk, d, causal, win = shape
    gen = torch.Generator(device=cuda).manual_seed(sq * 17 + d)
    q, k, v = _flash_inputs(gen, b, h, kvh, sq, sk, d, dtype, cuda)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    lens = [None] if sk <= 64 or b == 8 else [sk - 17, torch.tensor(sk - 17, device=cuda),
                                              torch.tensor(0, device=cuda, dtype=torch.int32)]
    for kv_len in lens:
        o, lse = flash_attention_cuda(q, k, v, kv_len, causal=causal, window=win,
                                      return_lse=True)
        _, lse_ref = flash_attention_lse_ref(q, k, v, kv_len, causal=causal, window=win)
        fin = torch.isfinite(lse_ref)
        assert torch.equal(torch.isfinite(lse), fin)
        if bool(fin.any()):
            assert float((lse[fin] - lse_ref[fin]).abs().max()) <= FLASH_LSE_ATOL
        before = flash_attention_bwd_cuda.launches
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_len, causal=causal, window=win)
        torch.cuda.synchronize()
        assert flash_attention_bwd_cuda.launches == before + 1
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, kv_len, causal=causal, window=win)
        mag = flash_attention_bwd_magnitudes(q, k, v, o, lse, do, kv_len, causal=causal,
                                             window=win, dp_error=dtype == torch.float32)
        for x, y, m in zip(got, want, mag):
            assert x.dtype == y.dtype == dtype and x.shape == y.shape
            assert _bwd_ratio(x, y, m, dtype) <= 1.0
        if isinstance(kv_len, torch.Tensor) and int(kv_len) == 0:
            assert not any(bool(x.any()) for x in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 96, 112, 128, 256])
def test_flash_attention_function_gradients_on_card(cuda, d, dtype):
    """``FlashAttention`` on (B, S, H, D) views (GQA, a window): gradients
    against autograd through the plain forward within 5e-5 (float32) /
    3e-2 (bf16) relative, in the inputs' layout; one forward with lse and
    one backward launch."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda,
                                                     flash_attention_ref, ops)

    gen = torch.Generator(device=cuda).manual_seed(d + 7)

    def view(heads):
        return torch.randn((2, 77, heads, d), generator=gen, device=cuda).to(dtype).transpose(1, 2)

    q, k, v, do = view(6), view(3), view(3), view(6)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fwd, bwd = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
    ops.flash_attention(*leaves, causal=True, window=20).backward(do)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches - fwd, flash_attention_bwd_cuda.launches - bwd) == (1, 1)
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*plain, causal=True, window=20).backward(do)
    for a, p in zip(leaves, plain):
        assert a.grad.transpose(1, 2).is_contiguous()
        assert _rel(a.grad, p.grad) <= FLASH_GRAD_RTOL[dtype]


@pytest.mark.parametrize("p_dtype,unit", [(torch.bfloat16, 2.0 ** -8),
                                          (torch.float16, 2.0 ** -11)], ids=str)
@pytest.mark.parametrize("d", [64, 96, 256])
def test_flash_attention_p_dtype_on_card(cuda, d, p_dtype, unit):
    """``p_dtype`` on the float32 route: the forward within 2 u max|v| + 2e-5
    of the plain version with the same ``p_dtype`` (both round P, at other
    maxima), the backward within the float32 bound (A with dp_error) with
    2 u added to dV's magnitude term, and the model's chunked attention
    passing it on."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_magnitudes,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda,
                                                     flash_attention_ref)
    from repro_torch.models import attention as A

    gen = torch.Generator(device=cuda).manual_seed(d + 3)
    q, k, v = _flash_inputs(gen, 1, 4, 2, 150, 150, d, torch.float32, cuda)
    got = flash_attention_cuda(q, k, v, causal=True, p_dtype=p_dtype)
    want = flash_attention_ref(q, k, v, causal=True, p_dtype=p_dtype)
    assert float((got - want).abs().max()) <= 2 * unit * float(v.abs().max()) + 2e-5
    o, lse = flash_attention_cuda(q, k, v, causal=True, p_dtype=p_dtype, return_lse=True)
    do = torch.randn(q.shape, generator=gen, device=cuda)
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, p_dtype=p_dtype)
    wants = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, p_dtype=p_dtype)
    mags = flash_attention_bwd_magnitudes(q, k, v, o, lse, do, causal=True, dp_error=True)
    for x, y, m, extra in zip(grads, wants, mags, (0.0, 0.0, 2 * unit)):
        tol = 1e-5 * (1 + y.abs()) + (2.0 ** -19 + extra) * m
        assert bool(((x - y).abs() <= tol).all())
    before = flash_attention_cuda.launches
    qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))
    out = A.attention(qm, km, vm, impl="chunked", p_dtype=p_dtype)
    assert flash_attention_cuda.launches == before + 1
    plain = A.attention_chunked(qm, km, vm, p_dtype=p_dtype)
    assert float((out - plain).abs().max()) <= 2 * unit * float(v.abs().max()) + 2e-5
    with pytest.raises(NotImplementedError):
        A.attention(qm, km, vm, impl="chunked", p_dtype=torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_bwd_is_deterministic(cuda, dtype):
    """No atomics: two backward calls on the same inputs give the same bits
    (GQA, a window, ragged keys, and the training shape's 1,024 rows)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda

    gen = torch.Generator(device=cuda).manual_seed(23)
    for b, h, kvh, s, d, win in ((2, 6, 2, 130, 64, 48), (1, 12, 12, 1024, 64, None)):
        q, k, v = _flash_inputs(gen, b, h, kvh, s, s, d, dtype, cuda)
        do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
        o, lse = flash_attention_cuda(q, k, v, causal=True, window=win, return_lse=True)
        first = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=win)
        second = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=win)
        assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_bwd_cuda_graph_replay(cuda, dtype):
    """The backward captured in a CUDA graph (three kernel nodes, one
    counted launch) and replayed equals the eager call bitwise, also after
    ``kv_len`` and the inputs changed on the card."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda

    gen = torch.Generator(device=cuda).manual_seed(29)
    q, k, v = _flash_inputs(gen, 2, 4, 2, 200, 200, 64, dtype, cuda)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    kv_len = torch.tensor(200, dtype=torch.int32, device=cuda)
    o, lse = flash_attention_cuda(q, k, v, kv_len, causal=True, return_lse=True)
    flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_len, causal=True)   # first use
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    before = flash_attention_bwd_cuda.launches
    with torch.cuda.graph(g):
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_len, causal=True)
    assert flash_attention_bwd_cuda.launches == before + 1
    for n in (200, 77):
        kv_len.fill_(n)
        do.copy_(torch.randn(q.shape, generator=gen, device=cuda).to(dtype))
        o2, lse2 = flash_attention_cuda(q, k, v, kv_len, causal=True, return_lse=True)
        o.copy_(o2)
        lse.copy_(lse2)
        g.replay()
        torch.cuda.synchronize()
        want = flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_len, causal=True)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_flash_attention_bwd_without_rows_is_zero(cuda):
    """No query row: dk and dv are 0 and nothing launches."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 2, 0, 16), dtype=dtype, device=cuda)
        k = torch.ones((1, 1, 5, 16), dtype=dtype, device=cuda)
        before = flash_attention_bwd_cuda.launches
        dq, dk, dv = flash_attention_bwd_cuda(q, k, k, q, torch.zeros((1, 2, 0), device=cuda), q)
        assert flash_attention_bwd_cuda.launches == before
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert not dk.any() and not dv.any()


def test_flash_attention_bwd_refuses_mismatched_inputs(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda

    q = torch.zeros((1, 2, 8, 16), device=cuda)
    lse = torch.zeros((1, 2, 8), device=cuda)
    before = flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, q, q, q, lse[..., :4], q)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, q, q, q.to(torch.bfloat16), lse, q)
    assert flash_attention_bwd_cuda.launches == before


def test_reduced_training_on_card_equals_cpu(cuda):
    """Three train steps of the reduced eventlm-100m (float32) on the card
    against the CPU from the same weights and batches: each step launches
    the forward kernel twice a layer and the backward once (remat "full");
    losses within 1e-5, parameters within 2e-5 (AdamW scales each update to
    about lr = 1e-3, so gradients a few ulps apart near 0 move a parameter
    by a fraction of it)."""
    _train_on_card_against_cpu(cuda, "full")


def test_reduced_training_dots_remat_on_card_equals_cpu(cuda):
    """The same three steps under remat "dots": the selective checkpoint
    keeps the products' outputs, but the attention kernel is no aten op, so
    the recompute launches it again (twice a layer) and the backward kernel
    once a layer; the same bounds against the CPU."""
    _train_on_card_against_cpu(cuda, "dots")


def _train_on_card_against_cpu(cuda, remat):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.models import model as Mdl
    from repro_torch.models.module import Initializer
    from repro_torch.train import trainstep as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = reduced_config(get_config("eventlm-100m")).with_overrides(remat_policy=remat)
    oc = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    states = {dev: TS.init_state(cfg, Mdl.init_params(cfg, Initializer(
        torch.Generator().manual_seed(0), cfg.param_dtype)).to(dev)) for dev in ("cpu", cuda)}
    step = TS.make_train_step(cfg, oc)
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (4, 65)).astype(np.int32))
        losses = {}
        for dev, st in states.items():
            batch = {"tokens": toks[:, :-1].to(dev), "targets": toks[:, 1:].to(dev),
                     "loss_mask": torch.ones((4, 64), device=dev)}
            fwd, bwd = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
            states[dev], m = step(st, batch)
            losses[dev] = float(m["loss"])
            if dev != "cpu":
                assert flash_attention_cuda.launches - fwd == 2 * cfg.num_layers
                assert flash_attention_bwd_cuda.launches - bwd == cfg.num_layers
        assert abs(losses["cpu"] - losses[cuda]) <= 1e-5
    for p, q in zip(states["cpu"]["params"].parameters(), states[cuda]["params"].parameters()):
        assert float((p.detach() - q.detach().cpu()).abs().max()) <= 2e-5


FAMILY_TRAIN_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b", "zamba2-7b", "xlstm-1.3b",
                      "whisper-medium", "internvl2-2b")


def _attention_calls(cfg):
    """Attention calls in one forward pass of ``cfg``'s family."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.num_layers
    return cfg.num_layers


@pytest.mark.parametrize("arch", FAMILY_TRAIN_ARCHS)
def test_family_training_step_on_card_equals_cpu(cuda, arch):
    """One train step of each reduced family (float32, remat "full", a stub
    frontend where the family takes one) on the card against the same step
    on the CPU from the same weights and batch: the loss within 1e-5, every
    gradient within 1e-4 of its leaf's largest magnitude (float32 products
    summed in other orders; the attention kernels' 3xTF32 products within
    2^-20 of themselves), the kernels launched twice an attention call
    forward (the pass and the recompute) and once backward, and the updated
    parameters within 2e-5, or within ``lr`` where AdamW's denominator
    sqrt(v) + eps is below 1e-6 (a gradient near 0, whose last bits move its
    update by a fraction of ``lr``)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.models import model as Mdl
    from repro_torch.models.module import Initializer
    from repro_torch.train import trainstep as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = reduced_config(get_config(arch))
    oc = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (4, 33)).astype(np.int32))
    host = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "loss_mask": torch.ones((4, 32))}
    n = {"audio": cfg.enc_seq, "vlm": cfg.num_patches}.get(cfg.family)
    if n:
        host["frontend"] = torch.from_numpy(
            (rng.standard_normal((4, n, cfg.d_model)) * 0.1).astype(np.float32))
    models, grads, losses = {}, {}, {}
    for dev in ("cpu", cuda):
        models[dev] = Mdl.init_params(cfg, Initializer(
            torch.Generator().manual_seed(0), cfg.param_dtype)).to(dev)
        batch = {k: v.to(dev) for k, v in host.items()}
        fwd, bwd = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
        loss = TS.loss_fn(cfg, models[dev], batch)
        loss.backward()
        losses[dev] = float(loss.detach())
        grads[dev] = {k: p.grad.detach().cpu() for k, p in models[dev].named_parameters()}
        calls = _attention_calls(cfg) if dev != "cpu" else 0
        assert flash_attention_cuda.launches - fwd == 2 * calls
        assert flash_attention_bwd_cuda.launches - bwd == calls
    assert abs(losses["cpu"] - losses[cuda]) <= 1e-5
    for k, want in grads["cpu"].items():
        got = grads[cuda][k]
        assert bool(torch.isfinite(got).all()), k
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), k
    states = {}
    for dev, model in models.items():
        st = TS.init_state(cfg, model)
        states[dev], _ = TS.make_train_step(cfg, oc)(st, {k: v.to(dev) for k, v in host.items()})
    v = states["cpu"]["opt"]["v"]
    bc2 = 1 - oc.beta2
    for (k, p), q in zip(states["cpu"]["params"].named_parameters(),
                         states[cuda]["params"].parameters()):
        denom = (v[k] / bc2).sqrt() + oc.eps
        tol = torch.where(denom > 1e-6, 2e-5, oc.lr)
        assert bool(((p.detach() - q.detach().cpu()).abs() <= tol).all()), k


def test_family_training_moe_second_backward_is_bitwise(cuda):
    """The MoE layer's backward on the card, twice on the same inputs, at
    capacity 0.5 (routes dropped), gives the same bits: every gradient is
    written once a slot or reduced over K in a fixed order."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import layers as L
    from repro_torch.models.module import Initializer

    cfg = reduced_config(get_config("qwen3-moe-30b-a3b")).with_overrides(capacity_factor=0.5)
    p = {k: t.to(cuda) for k, t in L.moe_init(
        Initializer(torch.Generator().manual_seed(1)), cfg).items()}
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 64, cfg.d_model), generator=gen).to(cuda)
    w = torch.randn((4, 64, cfg.d_model), generator=gen).to(cuda)
    runs = []
    for _ in range(2):
        leaves = {k: t.detach().clone().requires_grad_() for k, t in p.items()}
        xl = x.clone().requires_grad_()
        (L.moe_apply_dense(leaves, xl, cfg) * w).sum().backward()
        runs.append([xl.grad, *(leaves[k].grad for k in sorted(leaves))])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------- the collect path's host syncs
TRACE_FILTERS = ("none", "cases_containing", "attr_lt", "case_band")
TRACE_WIDGETS = ("dfg", "variants", "performance_dfg", "activity_counts",
                 "case_durations", "heuristics", "stats")
TRACE_PANEL = ("dfg", "activity_counts", "case_sizes", "case_durations",
               "variants", "performance_dfg", "eventually_follows", "stats")
TRACE_PAIRS = [(k, (v,)) for k in TRACE_FILTERS for v in TRACE_WIDGETS] + \
              [(k, TRACE_PANEL) for k in TRACE_FILTERS]


@pytest.fixture(scope="module")
def small_log_on_card():
    """A 3,000-case log resident on the card, opened with its activity
    table (as a dashboard holds it)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import repro_torch
    from repro_torch.data.synthetic import generate

    frame, tables = generate(3_000, 26, seed=5, device="cuda")
    return repro_torch.open(frame, tables=tables, device="cuda")


def _ask(ds, kind, verbs):
    from repro_torch import cases_containing, col
    from repro_torch.core.eventframe import CASE

    pred = {"none": None, "cases_containing": cases_containing(3),
            "attr_lt": col("attr0") < 500,
            "case_band": col(CASE).between(200, 1_200)}[kind]
    d = ds if pred is None else ds.filter(pred)
    if len(verbs) > 1:
        return d.collect_many(verbs).results
    return d.collect(verbs[0]).result


def _synchronizing_calls(fn) -> list:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``; the
    innermost ``repro_torch`` frame of each synchronizing call PyTorch
    reports.  Other warnings are not counted: among them the prototype
    notice ``set_sync_debug_mode`` gives once a process."""
    import traceback
    import warnings

    sites = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "repro_torch" in f.filename]
        where = frames[-1] if frames else None
        sites.append(f"{where.filename.split('src/')[-1]}:{where.lineno}"
                     if where else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


@pytest.mark.parametrize("kind,verbs", TRACE_PAIRS,
                         ids=[f"{k}-{'+'.join(v) if len(v) == 1 else 'panel'}"
                              for k, v in TRACE_PAIRS])
def test_every_sync_of_a_collect_is_counted(small_log_on_card, kind, verbs):
    """Each synchronizing call PyTorch reports in one request goes through
    ``repro_torch.trace``'s counting helpers, but the one stream sync that
    delivers the answer to the host: the count of the other calls equals
    ``host_syncs``' difference."""
    from collections import Counter

    from repro_torch import trace

    _ask(small_log_on_card, kind, verbs)           # kernels built, warm
    torch.cuda.synchronize()
    before = trace.counters()
    sites = _synchronizing_calls(lambda: _ask(small_log_on_card, kind, verbs))
    counted = trace.counters()["host_syncs"] - before["host_syncs"]
    delivery = [s for s in sites if s.startswith("repro_torch/dataset/engines.py")]
    assert len(delivery) == 1, sorted(Counter(sites).items())
    assert len(sites) - 1 == counted, sorted(Counter(sites).items())


@pytest.mark.parametrize("kind,verbs", [("cases_containing", ("variants",)),
                                        ("case_band", TRACE_PANEL)],
                         ids=["cases_containing-variants", "case_band-panel"])
def test_kernel_spans_sit_in_their_verbs_on_card(small_log_on_card, kind,
                                                 verbs):
    """On the card every hand-written kernel's launch is a ``kernel.*``
    span inside a verb's update or the case filter's phase one, and the
    launch counters moved by as many."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    _ask(small_log_on_card, kind, verbs)
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _ask(small_log_on_card, kind, verbs)
        torch.cuda.synchronize()
    after = trace.counters()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(trace.PREFIX):])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(trace.PREFIX)]
    kernels = 0
    for s, e, name in spans:
        if name.startswith("kernel."):
            holders = [(h1 - h0, n) for h0, h1, n in spans
                       if (h0, h1, n) != (s, e, name) and h0 <= s and e <= h1]
            assert min(holders)[1].startswith(
                ("fold.update.", "fold.finalize.", "filter.case.phase1")), name
            kernels += 1
    launched = sum(after[k] - before[k] for k in after
                   if k.startswith("launches."))
    assert kernels == launched > 0


# ---------------------------------- the answer's delivery to host memory
@pytest.fixture(scope="module")
def l1_on_card():
    """The Table-6 L1 log (10^6 cases, ~7 M rows) resident on the card,
    opened with its activity table, as a dashboard holds it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import repro_torch
    from repro_torch.core import EventFrame
    from repro_torch.data import synthetic

    cols, tables = synthetic.generate_numpy(**synthetic.paper_table6_config(1))
    frame = EventFrame.from_numpy(cols, device="cuda")
    return repro_torch.open(frame, tables=tables, device="cuda")


def _answer_tensors(x) -> list:
    from repro_torch.core.engine import tensor_leaves

    return tensor_leaves(x)


@pytest.mark.parametrize("verbs", [TRACE_PANEL] + [(v,) for v in TRACE_WIDGETS],
                         ids=["panel"] + list(TRACE_WIDGETS))
def test_deliver_puts_every_answer_tensor_in_pinned_host_memory(l1_on_card, verbs):
    """A panel's ``collect_many`` and each widget verb over L1 on the card:
    every tensor of the front door's answer is on the CPU in page-locked
    memory, bitwise the device answer of ``_collect`` / ``_collect_many``,
    and ``x.cpu().numpy()`` wraps its memory without a copy; the counters
    count what was copied."""
    from repro_torch import trace
    from repro_torch.dataset import engines

    ds = l1_on_card
    if len(verbs) > 1:
        got = ds.collect_many(verbs, engine="eager").results
        before = trace.counters()
        got = ds.collect_many(verbs, engine="eager").results
        after = trace.counters()
        want = engines._collect_many(ds, verbs, "eager", None, None, {}, {}).results
    else:
        got = ds.collect(verbs[0], engine="eager").result
        before = trace.counters()
        got = ds.collect(verbs[0], engine="eager").result
        after = trace.counters()
        want = engines._collect(ds, verbs[0], "eager", None, None, {}).result
    host, device = _answer_tensors(got), _answer_tensors(want)
    assert len(host) == len(device) > 0
    for h, d in zip(host, device):
        assert d.device.type == "cuda"
        assert h.device.type == "cpu" and h.is_pinned()
        assert h.dtype == d.dtype and h.shape == d.shape
        assert torch.equal(h, d.cpu())
        if h.numel():
            assert np.shares_memory(h.cpu().numpy(), h.numpy())
            assert h.cpu().numpy().ctypes.data == h.data_ptr()
    assert len({h.data_ptr() for h in host if h.numel()}) == \
        sum(1 for h in host if h.numel())           # nothing aliased
    assert after["answer_tensors"] - before["answer_tensors"] == len(host)
    assert after["answer_d2h_bytes"] - before["answer_d2h_bytes"] == \
        sum(h.numel() * h.element_size() for h in host)


def test_deliver_an_answer_held_while_five_more_run_is_unchanged(l1_on_card):
    """A held panel answer's pinned blocks are not handed to the next
    answers: after five more panels (each dropped) it reads as before."""
    ds = l1_on_card
    held = ds.collect_many(TRACE_PANEL, engine="eager").results
    copies = [t.clone() for t in _answer_tensors(held)]
    ptrs = [t.data_ptr() for t in _answer_tensors(held)]
    for _ in range(5):
        other = ds.collect_many(TRACE_PANEL, engine="eager").results
        assert not {t.data_ptr() for t in _answer_tensors(other) if t.numel()} \
            & {p for p, t in zip(ptrs, copies) if t.numel()}
        del other
    for t, c in zip(_answer_tensors(held), copies):
        assert torch.equal(t, c)


def test_deliver_reuses_cached_pinned_blocks(l1_on_card):
    """Once two panels have run and been dropped, twenty more pin no new
    host block: the caching host allocator serves every copy."""
    from repro_torch import trace

    ds = l1_on_card
    for _ in range(2):
        ds.collect_many(TRACE_PANEL, engine="eager")
    before = trace.counters()
    for _ in range(20):
        ds.collect_many(TRACE_PANEL, engine="eager")
    after = trace.counters()
    assert after["answer_tensors"] - before["answer_tensors"] >= 20 * len(TRACE_PANEL)
    assert after["answer_pinned_new"] == before["answer_pinned_new"]


def test_deliver_copies_a_tensor_held_twice_once(cuda):
    """A tensor that appears twice in one answer gets one pinned copy,
    which both places hold; a view of it is a tensor of its own."""
    from repro_torch import trace
    from repro_torch.dataset import engines

    t = torch.arange(1_000, dtype=torch.int64, device=cuda)
    before = trace.counters()
    out = engines._deliver({"a": t, "b": (t, t[:3])})
    after = trace.counters()
    assert out["a"] is out["b"][0] and out["a"].is_pinned()
    assert out["b"][1].is_pinned() and out["b"][1].data_ptr() != out["a"].data_ptr()
    assert torch.equal(out["a"], t.cpu()) and torch.equal(out["b"][1], t[:3].cpu())
    assert after["answer_tensors"] - before["answer_tensors"] == 2
    assert after["answer_d2h_bytes"] - before["answer_d2h_bytes"] == 1_003 * 8


def test_conformance_and_drift_of_a_card_dataset_take_models_on_the_card(cuda, tmp_path):
    """``Dataset.conformance``, ``Windows.conformance`` and ``Windows.drift``
    of a card dataset (its DFGs delivered to host memory) against models, a
    footprint, a DFG and a relation matrix made on the card by the core
    functions, not the front door: each score equals the CPU dataset's
    against the same models made on the CPU."""
    import repro_torch
    from repro_torch.core import discovery
    from repro_torch.core.dfg import dfg

    a = 26
    path, frame = _query_log(tmp_path, n_cases=3_000, group_rows=4_096)
    card, host = repro_torch.open(path), repro_torch.open(path, device="cpu")

    def models(f):
        d = dfg(f, a)
        return {"alpha": discovery.alpha(f, a), "heuristics": discovery.heuristics(f, a),
                "footprint": discovery.footprint(d), "dfg": d,
                "matrix": d.counts > 0}

    on_card, on_cpu = models(frame.to(cuda)), models(frame)
    assert on_card["dfg"].counts.is_cuda and on_card["heuristics"].graph.is_cuda
    assert on_card["alpha"].footprint.direct.is_cuda
    wc = card.window(by="groups", size=3, step=2)
    wh = host.window(by="groups", size=3, step=2)
    assert len(wc.bounds()) >= 2
    for kind in ("alpha", "heuristics", "matrix"):
        assert float(card.conformance(on_card[kind])) == \
            float(host.conformance(on_cpu[kind])), kind
        assert wc.conformance(on_card[kind]) == wh.conformance(on_cpu[kind]), kind
    for kind in ("alpha", "footprint", "dfg"):
        got = wc.drift(reference=on_card[kind])
        assert got == wh.drift(reference=on_cpu[kind]), kind
        assert all(0.0 <= x <= 1.0 for x in got)
    assert wc.drift() == wh.drift()
