"""Row-order float32 weighted bincount onto a running state: the CUDA
kernel's wrapper.

No Pallas kernel stands behind it: the JAX package leaves float-weighted
``histogram`` / ``pair_count`` with ``into=`` to XLA's row-order scatter,
and that order is what keeps a streamed float sum (the sojourn totals)
bitwise equal to the whole-log one.  The kernel
(``kernels/csrc/ordered_histogram.cu``) gives every bin one block, which
compacts the bin's weights in row order and folds them one at a time onto
``into[b]``: ``out[b] = into[b] (or 0) + w_i + w_j + ...``.

On a CPU tensor the wrapper takes the plain version
(``ref.ordered_histogram_ref``, ``index_add_``, which adds in row order on
the CPU); on CUDA tensors it launches the kernel on the current stream or
raises.  ``ordered_histogram_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ordered_histogram_ref

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 3


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
    return devices.pop()


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
    lib, fn = _launcher()
    with torch.cuda.device(device):
        err = fn(values.data_ptr(), weights.data_ptr(), n, num_bins,
                 None if into is None else into.data_ptr(), out.data_ptr(),
                 _build.stream_of(out))
    _build.check(lib, err, "ordered_histogram")
    ordered_histogram_cuda.launches += 1
    return out


ordered_histogram_cuda.launches = 0
