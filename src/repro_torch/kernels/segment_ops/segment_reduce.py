"""Sum / min / max over sorted segment ids: the CUDA kernel's wrapper.

The counterpart of the JAX package's ``segment_reduce_pallas`` (the
paper's ``group(D, case)`` + aggregate).  The ids must be sorted
(non-decreasing), as the JAX kernel requires: each id's rows are then one
contiguous run.  The kernel (``kernels/csrc/segment_reduce.cu``) is one
pass that writes every output slot exactly once: each run's head folds
the run left to right from shared memory and stores its value, and owns
the identity in the slots of the ids skipped before it; extra blocks of
the same grid write the identity below the first id and above the last.
So the wrapper allocates the output with ``torch.empty`` and a call is
one kernel node.  int32, float32 and uint32 values; a float32 sum is the
row-order fold, bitwise equal to the plain row-order scatter.  uint32
(``torch.uint32`` tensors, read as 32-bit storage) reduces unsigned:
identity 0 for max, 2^32 - 1 for min.

On a CPU tensor the wrapper takes the plain version
(``ref.segment_reduce_ref``); on CUDA tensors it launches the kernel on the
current stream or raises.  ``segment_reduce_cuda.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ... import trace
from .. import _build
from .ref import reduce_identity, segment_reduce_ref

OPS = {"sum": 0, "min": 1, "max": 2}
# value dtype -> the C entry point's ``kind``
KINDS = {torch.int32: 0, torch.float32: 1, torch.uint32: 2}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 2)


def _launcher():
    lib = _build.load("segment_reduce")
    fn = lib.repro_segment_reduce
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _check(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
           op: str) -> torch.device:
    if op not in OPS:
        raise ValueError(f"unknown segment_reduce op {op!r}")
    if values.device != segment_ids.device:
        raise ValueError(f"segment_reduce: inputs on different devices "
                         f"{values.device} and {segment_ids.device}")
    if values.dim() != 1 or segment_ids.shape != values.shape:
        raise ValueError(f"segment_reduce: values and segment_ids must be 1-D "
                         f"of one length, got {tuple(values.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    if values.dtype not in KINDS:
        raise TypeError(f"segment_reduce: values must be int32, float32 or "
                        f"uint32, got {values.dtype}")
    if segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_reduce: segment_ids must be int32, got "
                        f"{segment_ids.dtype}")
    if not (values.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("segment_reduce: inputs must be contiguous")
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"segment_reduce: num_segments {num_segments} "
                         f"outside [0, 2^31)")
    return values.device


def segment_reduce_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, op: str = "sum") -> torch.Tensor:
    """(num_segments,) ``op``-reduction of ``values`` by sorted int32 ids.

    ``values`` is 1-D contiguous int32, float32 or uint32; ids outside
    ``[0, num_segments)`` (including -1) are dropped and empty segments hold
    the op's identity.  The ids must be sorted (non-decreasing): on a card,
    unsorted ids leave the result undefined.
    """
    device = _check(values, segment_ids, num_segments, op)
    if device.type == "cpu":
        return segment_reduce_ref(values, segment_ids, num_segments, op)
    if device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {device}")
    n = values.shape[0]
    if n == 0 or num_segments == 0:
        # no row: every slot holds the identity, and nothing is launched
        if values.dtype == torch.uint32:
            # the identity's bit pattern in int32 storage (-1 is 0xFFFFFFFF)
            return torch.full((num_segments,), -1 if op == "min" else 0,
                              dtype=torch.int32, device=device).view(torch.uint32)
        return torch.full((num_segments,),
                          reduce_identity(op, values.dtype).item(),
                          dtype=values.dtype, device=device)
    # the kernel writes every slot (uint32 allocated as int32 storage)
    out = torch.empty((num_segments,), dtype=torch.int32 if values.dtype == torch.uint32
                      else values.dtype, device=device).view(values.dtype)
    lib, fn = _launcher()
    with trace.span("kernel.segment_reduce"), torch.cuda.device(device):
        err = fn(segment_ids.data_ptr(), values.data_ptr(), n, num_segments,
                 OPS[op], KINDS[values.dtype], out.data_ptr(),
                 _build.stream_of(out))
    _build.check(lib, err, "segment_reduce")
    segment_reduce_cuda.launches += 1
    return out


segment_reduce_cuda.launches = 0
