"""Row-order float32 weighted bincount onto a running state: the CUDA
kernel's wrapper.

No Pallas kernel stands behind it: the JAX package leaves float-weighted
``histogram`` / ``pair_count`` with ``into=`` to XLA's row-order scatter,
and that order is what keeps a streamed float sum (the sojourn totals)
bitwise equal to the whole-log one.  The kernel
(``kernels/csrc/ordered_histogram.cu``) sorts the weights by bin with a
stable counting sort over row tiles (count per tile, offsets in
bin-major, tile-minor order, a scatter that keeps row order within each
bin), then folds each bin's contiguous segment one weight at a time onto
``into[b]``: ``out[b] = into[b] (or 0) + w_i + w_j + ...``.

On a CPU tensor the wrapper takes the plain version
(``ref.ordered_histogram_ref``, ``index_add_``, which adds in row order on
the CPU); on CUDA tensors it launches the kernel on the current stream or
raises.  ``ordered_histogram_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ... import trace
from .. import _build
from .ref import ordered_histogram_ref

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 6


def tile_rows(num_bins: int) -> int:
    """Rows per tile of the counting sort, as the source picks them: 1,024
    up to 3,072 bins (more tiles, more warps in the scatter), 4,096 above
    (a smaller (B, tiles) count array)."""
    return 1024 if num_bins <= 3072 else 4096


def _launcher():
    lib = _build.load("ordered_histogram")
    fn = lib.repro_ordered_histogram
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(values, weights, num_bins, into) -> torch.device:
    tensors = {"values": values, "weights": weights}
    if into is not None:
        tensors["into"] = into
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"ordered_histogram: inputs on different devices {devices}")
    if values.dim() != 1 or weights.shape != values.shape:
        raise ValueError(f"ordered_histogram: values and weights must be 1-D of "
                         f"one length, got {tuple(values.shape)} and "
                         f"{tuple(weights.shape)}")
    if into is not None and tuple(into.shape) != (num_bins,):
        raise ValueError(f"ordered_histogram: into must have shape ({num_bins},), "
                         f"got {tuple(into.shape)}")
    want = {"values": torch.int32, "weights": torch.float32, "into": torch.float32}
    for name, t in tensors.items():
        if t.dtype != want[name]:
            raise TypeError(f"ordered_histogram: {name} must be {want[name]}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ordered_histogram: {name} must be contiguous")
    if not 0 <= num_bins < 2**31:
        raise ValueError(f"ordered_histogram: num_bins {num_bins} outside [0, 2^31)")
    if values.shape[0] >= 2**31:
        raise ValueError(f"ordered_histogram: {values.shape[0]} rows; the kernel's "
                         f"int32 offsets take fewer than 2^31")
    return devices.pop()


def scratch_shapes(n: int, num_bins: int) -> dict[str, tuple[int, ...]]:
    """The kernel's scratch for ``n`` rows: per-tile bin counts (then
    offsets), the bins' starts in the sorted order plus the total, and the
    weights sorted by bin."""
    tiles = -(-n // tile_rows(num_bins))
    return {"counts": (num_bins, tiles), "bin_start": (num_bins + 1,),
            "sorted": (n,)}


def ordered_histogram_cuda(values: torch.Tensor, weights: torch.Tensor,
                           num_bins: int,
                           into: torch.Tensor | None = None) -> torch.Tensor:
    """(num_bins,) float32: ``into`` (or zeros) plus the weights of the rows
    hitting each bin, added in row order; out-of-range values dropped.

    ``values`` is 1-D contiguous int32, ``weights`` float32 of the same
    length, ``into`` a (num_bins,) float32 state (not modified).
    """
    device = _check(values, weights, num_bins, into)
    if device.type == "cpu":
        return ordered_histogram_ref(values, weights, num_bins, into)
    if device.type != "cuda":
        raise ValueError(f"ordered_histogram: unsupported device {device}")
    n = values.shape[0]
    if n == 0 or num_bins == 0:
        return (torch.zeros(num_bins, dtype=torch.float32, device=device)
                if into is None else into.clone())
    out = torch.empty(num_bins, dtype=torch.float32, device=device)
    shapes = scratch_shapes(n, num_bins)
    counts = torch.empty(shapes["counts"], dtype=torch.int32, device=device)
    bin_start = torch.empty(shapes["bin_start"], dtype=torch.int32, device=device)
    ordered = torch.empty(shapes["sorted"], dtype=torch.float32, device=device)
    lib, fn = _launcher()
    with trace.span("kernel.ordered_histogram"), torch.cuda.device(device):
        err = fn(values.data_ptr(), weights.data_ptr(), n, num_bins,
                 None if into is None else into.data_ptr(), out.data_ptr(),
                 counts.data_ptr(), bin_start.data_ptr(), ordered.data_ptr(),
                 _build.stream_of(out))
    _build.check(lib, err, "ordered_histogram")
    ordered_histogram_cuda.launches += 1
    return out


ordered_histogram_cuda.launches = 0
