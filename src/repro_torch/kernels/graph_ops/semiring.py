"""Tiled semiring matrix product: the CUDA kernel's wrapper.

The counterpart of the JAX package's ``semiring_matmul_pallas``: an (M, K)
by (K, N) float32 product in ``plus_times`` / ``min_plus`` / ``max_min``,
the one primitive the graph closures iterate.  The kernel
(``kernels/csrc/semiring.cu``) is one tiled SIMT template over the
semiring's two operations: 32 x 32 output tiles, k walked in ascending
order, ragged edges read as the identity (no padded copies), and
``plus_times`` in full float32 (one ``fmaf`` per k, no TF32).

On a CPU tensor the wrapper takes the plain version
(``ref.semiring_matmul_ref``); on CUDA tensors it launches the kernel on
the current stream or raises.  ``semiring_matmul_cuda.launches`` counts
the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import SEMIRINGS, semiring_matmul_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_int,
                                                             ctypes.c_void_p]


def _launcher():
    lib = _build.load("semiring")
    fn = lib.repro_semiring_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def semiring_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                         semiring: str = "plus_times") -> torch.Tensor:
    """(M, N) float32 semiring product of ``a`` (M, K) and ``b`` (K, N).

    Operands of any real dtype are converted to contiguous float32 first.
    ``min_plus`` operands are finite or ``+inf`` (the graph queries' "no
    edge"), as the JAX kernel requires.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; one of {SEMIRINGS}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"semiring_matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    if a.device != b.device:
        raise ValueError(f"semiring_matmul: inputs on {a.device} and {b.device}")
    device = a.device
    if device.type == "cpu":
        return semiring_matmul_ref(a, b, semiring)
    if device.type != "cuda":
        raise ValueError(f"semiring_matmul: unsupported device {device}")
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    if m == 0 or n == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
                 SEMIRINGS.index(semiring), _build.stream_of(out))
    _build.check(lib, err, "semiring_matmul")
    semiring_matmul_cuda.launches += 1
    return out


semiring_matmul_cuda.launches = 0
