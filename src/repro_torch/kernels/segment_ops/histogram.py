"""Weighted bincount (the paper's ``c(e)`` counting, §5.4): the CUDA kernel's
wrapper.

The counterpart of the JAX package's ``histogram_pallas``.  The kernel
(``kernels/csrc/histogram.cu``) is a privatized shared-memory histogram with
int32 weights (negative ones included) and int32 bins; integer atomics make
it exact in any order.  Float weights take the row-order fold instead
(``ordered_histogram``, chosen by ``ops.histogram``).

On a CPU tensor the wrapper takes the plain version (``ref.histogram_ref``);
on CUDA tensors it launches the kernel on the current stream or raises.
``histogram_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .pair_count import check_int32_vectors
from .ref import histogram_ref

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2


def _launcher():
    lib = _build.load("histogram")
    fn = lib.repro_histogram
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def histogram_cuda(values: torch.Tensor, weights: torch.Tensor,
                   num_bins: int) -> torch.Tensor:
    """(num_bins,) int32 weighted bincount of ``values`` (out-of-range dropped).

    ``values`` and ``weights`` are 1-D contiguous int32 tensors of one length.
    """
    device = check_int32_vectors("histogram",
                                 {"values": values, "weights": weights})
    if device.type == "cpu":
        return histogram_ref(values, num_bins, weights)
    if device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {device}")
    out = torch.zeros(num_bins, dtype=torch.int32, device=device)
    n = values.shape[0]
    if n == 0 or num_bins == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(device):
        err = fn(values.data_ptr(), weights.data_ptr(), n, num_bins,
                 out.data_ptr(), _build.stream_of(out))
    _build.check(lib, err, "histogram")
    histogram_cuda.launches += 1
    return out


histogram_cuda.launches = 0
