"""Weighted bincount (the paper's ``c(e)`` counting, §5.4): the CUDA kernel's
wrapper.

The counterpart of the JAX package's ``histogram_pallas``.  The kernels
(``kernels/csrc/histogram.cu`` over ``counting.cuh``) count int32 or bool
weights (negative int32 ones included) into int32 bins, onto an optional
int32 ``into``: one pass of per-warp shared-memory bins storing per-block
partials, then a finishing kernel that stores each bin once (``counting``
holds the plan).  Integer sums are exact in any order.  Float weights take
the row-order fold instead (``ordered_histogram``, chosen by
``ops.histogram``).

On a CPU tensor the wrapper takes the plain version (``ref.histogram_ref``);
on CUDA tensors it launches the kernels on the current stream or raises.
``histogram_cuda.launches`` counts the calls that launched them.
"""
from __future__ import annotations

import ctypes

import torch

from ... import trace
from .. import _build
from . import counting
from .ref import histogram_ref

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_int64] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _launcher():
    lib = _build.load("histogram")
    fn = lib.repro_histogram
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def histogram_cuda(values: torch.Tensor, weights: torch.Tensor, num_bins: int,
                   into: torch.Tensor | None = None) -> torch.Tensor:
    """(num_bins,) int32 weighted bincount of ``values`` (out-of-range
    dropped), added onto ``into`` when given (``into`` is not modified).

    ``values`` is 1-D contiguous int32 and ``weights`` int32 or bool of its
    length; ``into`` a contiguous (num_bins,) int32 tensor on their device.
    """
    device = counting.check_inputs("histogram", {"values": values}, weights,
                                   into, (num_bins,))
    if device.type == "cpu":
        return histogram_ref(values, num_bins, weights.to(torch.int32), into)
    if device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {device}")
    if values.shape[0] == 0 or num_bins == 0:
        return (torch.zeros(num_bins, dtype=torch.int32, device=device)
                if into is None else into.clone())
    lib, fn = _launcher()
    with trace.span("kernel.histogram"):
        out = counting.launch(lib, fn, "histogram", (values,), weights,
                              (num_bins,), into)
    histogram_cuda.launches += 1
    return out


histogram_cuda.launches = 0
