"""Weighted (src, dst) pair counting: the CUDA kernel's wrapper.

The counterpart of the JAX package's ``pair_count_pallas``: the
generalization of the DFG count to any rectangular (src, dst, weight)
triple.  The kernel (``kernels/csrc/pair_count.cu``) is a privatized
shared-memory histogram over the flat key ``src * D + dst`` with int32
weights and int32 output, so it is exact at any count (integer atomics),
unlike the TPU's float32 MXU accumulation, which is exact only below 2^24.

On a CPU tensor the wrapper takes the plain version (``ref.pair_count_ref``);
on CUDA tensors it launches the kernel on the current stream or raises.
``pair_count_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import pair_count_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2


def _launcher():
    lib = _build.load("pair_count")
    fn = lib.repro_pair_count
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def check_int32_vectors(what: str, tensors: dict) -> torch.device:
    """Validate the kernels' inputs: 1-D contiguous int32 of one length on
    one device.  Returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs on different devices {devices}")
    lengths = {t.shape[0] if t.dim() == 1 else None for t in tensors.values()}
    if None in lengths or len(lengths) != 1:
        raise ValueError(f"{what}: inputs must be 1-D of one length, got "
                         f"{ {k: tuple(t.shape) for k, t in tensors.items()} }")
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return devices.pop()


def pair_count_cuda(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    num_src: int, num_dst: int) -> torch.Tensor:
    """(num_src, num_dst) int32 weighted pair counts (out-of-range ids dropped).

    ``src``, ``dst`` and ``w`` are 1-D contiguous int32 tensors of one length.
    """
    device = check_int32_vectors("pair_count", {"src": src, "dst": dst, "w": w})
    if device.type == "cpu":
        return pair_count_ref(src, dst, w, num_src, num_dst)
    if device.type != "cuda":
        raise ValueError(f"pair_count: unsupported device {device}")
    out = torch.zeros((num_src, num_dst), dtype=torch.int32, device=device)
    n = src.shape[0]
    if n == 0 or out.numel() == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(device):
        err = fn(src.data_ptr(), dst.data_ptr(), w.data_ptr(), n, num_src,
                 num_dst, out.data_ptr(), _build.stream_of(out))
    _build.check(lib, err, "pair_count")
    pair_count_cuda.launches += 1
    return out


pair_count_cuda.launches = 0
