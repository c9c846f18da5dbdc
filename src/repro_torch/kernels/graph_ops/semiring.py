"""Semiring matrix product and whole closures: the CUDA kernels' wrappers.

``semiring_matmul_cuda`` is the counterpart of the JAX package's
``semiring_matmul_pallas``: an (M, K) by (K, N) float32 product in
``plus_times`` / ``min_plus`` / ``max_min``.  Its kernel
(``kernels/csrc/semiring.cu``, ``semiring_tile``) gives each thread a 4 x 4
register block of a 32 x 32 output tile, stages k-tiles through a 2-stage
``cp.async`` ring, reads ragged edges as the identity (no padded copies)
and, for the tropical semirings only, splits K across a thread block
cluster; ``plus_times`` is one ``fmaf`` per k in ascending k (no TF32, no
split), bitwise the k-order chain for any floats.

``semiring_closure_cuda`` runs a whole closure (the loop of
``ref.closure_loop``) in one block, the matrix in shared memory, for
graphs of at most ``CLOSURE_CAPACITY`` nodes (``ops`` sends it those of
at most ``CLOSURE_MAX_N``); the wrapper hands the kernel the loop's
schedule, :func:`closure_plan`.

On a CPU tensor each wrapper takes its plain version
(``ref.semiring_matmul_ref``, ``ref.semiring_closure_ref``); on CUDA
tensors it launches its kernel on the current stream or raises.
``semiring_matmul_cuda.launches`` and ``semiring_closure_cuda.launches``
count the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import (CLOSURES, SEMIRINGS, closure_exponent, closure_steps,
                  semiring_closure_ref, semiring_matmul_ref)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_int,
                                                             ctypes.c_void_p]
_CLOSURE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
                     ctypes.c_void_p]

# The closure kernel holds at most 168 nodes (two float32 (N, N) buffers,
# rows padded to 4 words, in 232,448 bytes of shared memory).
CLOSURE_CAPACITY = 168
# Largest graph whose closure ops.py sends to the closure kernel: above it
# the one block loses to the loop of tiled products over the whole card
# (PERF.md, row 8c).
CLOSURE_MAX_N = 96

# the closure kernel's steps, 2 bits each
SQUARE_ACC, ACC_TIMES_SQ, SQUARE_SQ = 0, 1, 2


def _launcher(symbol="repro_semiring_matmul", argtypes=_ARGTYPES):
    lib = _build.load("semiring")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


def closure_plan(n: int, k: int | None = None) -> tuple[bool, tuple[int, ...]]:
    """The schedule ``ref.closure_loop`` runs on an n-node graph, as the
    closure kernel takes it: whether ``acc`` starts as the seed (else as
    I; ``sq`` always starts as the seed), and the steps in order, each
    ``SQUARE_ACC`` (acc <- acc acc), ``ACC_TIMES_SQ`` (acc <- acc sq) or
    ``SQUARE_SQ`` (sq <- sq sq); the result is ``acc``.  ``k=None`` is
    every tropical closure and the full boolean one."""
    if k is None:
        return True, (SQUARE_ACC,) * closure_steps(n, n - 1)
    e = closure_exponent(n, k)
    steps = []
    while e:
        if e & 1:
            steps.append(ACC_TIMES_SQ)
        e >>= 1
        if e:
            steps.append(SQUARE_SQ)
    return False, tuple(steps)


def semiring_closure_cuda(x: torch.Tensor, kind: str = "min_plus",
                          k: int | None = None) -> torch.Tensor:
    """(N, N) closure of ``x`` in one launch: ``kind="bool"`` the k-step
    boolean reachability of ``I | x != 0`` (bool out), ``"min_plus"`` /
    ``"max_min"`` the all-pairs shortest / widest paths of the float32
    weights with the diagonal forced to 0 / +inf (float32 out) — bitwise
    ``ref.semiring_closure_ref`` for any weights.  N <= ``CLOSURE_CAPACITY``.
    """
    if kind not in CLOSURES:
        raise ValueError(f"unknown closure {kind!r}; one of {CLOSURES}")
    if x.dim() != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"semiring_closure: shape {tuple(x.shape)} is not square")
    if kind != "bool" and k is not None:
        raise ValueError(f"a {kind} closure takes no k")
    device = x.device
    if device.type == "cpu":
        return semiring_closure_ref(x, kind, k)
    if device.type != "cuda":
        raise ValueError(f"semiring_closure: unsupported device {device}")
    n = x.shape[0]
    if n > CLOSURE_CAPACITY:
        raise ValueError(f"semiring_closure: {n} nodes > CLOSURE_CAPACITY "
                         f"({CLOSURE_CAPACITY})")
    x = x.to(torch.bool if kind == "bool" else torch.float32).contiguous()
    out = torch.empty_like(x)
    if n == 0:
        return out
    from_seed, steps = closure_plan(n, k)
    code = sum(op << (2 * i) for i, op in enumerate(steps))
    lib, fn = _launcher("repro_semiring_closure", _CLOSURE_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(x.data_ptr(), out.data_ptr(), n, CLOSURES.index(kind),
                 int(from_seed), code, len(steps), _build.stream_of(out))
    _build.check(lib, err, "semiring_closure")
    semiring_closure_cuda.launches += 1
    return out


semiring_closure_cuda.launches = 0
