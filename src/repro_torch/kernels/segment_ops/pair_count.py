"""Weighted (src, dst) pair counting: the CUDA kernel's wrapper.

The counterpart of the JAX package's ``pair_count_pallas``: the
generalization of the DFG count to any rectangular (src, dst, weight)
triple.  The kernels (``kernels/csrc/pair_count.cu`` over
``counting.cuh``) count the flat key ``src * D + dst`` with int32 or bool
weights into int32 cells, onto an optional int32 ``into``, as
``histogram_cuda`` counts ids; so they are exact at any count (integer
sums, wrapping mod 2^32), unlike the TPU's float32 MXU accumulation, which
is exact only below 2^24.

On a CPU tensor the wrapper takes the plain version (``ref.pair_count_ref``);
on CUDA tensors it launches the kernels on the current stream or raises.
``pair_count_cuda.launches`` counts the calls that launched them.
"""
from __future__ import annotations

import ctypes

import torch

from ... import trace
from .. import _build
from . import counting
from .ref import pair_count_ref

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_int64] * 3
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _launcher():
    lib = _build.load("pair_count")
    fn = lib.repro_pair_count
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def pair_count_cuda(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    num_src: int, num_dst: int,
                    into: torch.Tensor | None = None) -> torch.Tensor:
    """(num_src, num_dst) int32 weighted pair counts (out-of-range ids
    dropped), added onto ``into`` when given (``into`` is not modified).

    ``src`` and ``dst`` are 1-D contiguous int32 and ``w`` int32 or bool of
    their length; ``into`` a contiguous (num_src, num_dst) int32 tensor on
    their device.
    """
    shape = (num_src, num_dst)
    device = counting.check_inputs("pair_count", {"src": src, "dst": dst}, w,
                                   into, shape)
    if device.type == "cpu":
        return pair_count_ref(src, dst, w.to(torch.int32), num_src, num_dst, into)
    if device.type != "cuda":
        raise ValueError(f"pair_count: unsupported device {device}")
    if src.shape[0] == 0 or num_src * num_dst == 0:
        return (torch.zeros(shape, dtype=torch.int32, device=device)
                if into is None else into.clone())
    lib, fn = _launcher()
    with trace.span("kernel.pair_count"):
        out = counting.launch(lib, fn, "pair_count", (src, dst), w, shape,
                              into)
    pair_count_cuda.launches += 1
    return out


pair_count_cuda.launches = 0
