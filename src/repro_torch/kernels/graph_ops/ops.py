"""Public entry points for the graph semiring primitive — device dispatched.

``semiring_matmul`` is the one primitive (the hand-written CUDA kernel on
a card, the plain PyTorch version on the CPU, chosen by
``core.backend.resolve`` like the segmented primitives); the closure
helpers below iterate it by repeated squaring — ``ceil(log2(n))`` products
instead of the n relaxation sweeps of Floyd–Warshall:

* :func:`bool_closure` — k-step boolean reachability.  The 0/1 operands
  ride the ``plus_times`` product and are re-thresholded after every
  multiply, so values stay in {0, 1} and the closure is exact (hence
  bitwise across lowerings) at any k.
* :func:`minplus_closure` — all-pairs shortest distances over a weight
  matrix with ``+inf`` marking absent edges and a zero diagonal (the
  min-plus identity makes D ⊗ D the "paths of ≤ 2x the hops" relaxation).
* :func:`maxmin_closure` — all-pairs widest (bottleneck) capacities over a
  capacity matrix with ``-inf`` marking absent edges and ``+inf`` on the
  diagonal.

Tropical closures are bitwise identical across lowerings for any weights;
with integer-valued weights they are also exactly the NumPy
Floyd–Warshall result (every candidate sum is exact below 2^24).
"""
from __future__ import annotations

import math

import torch

from .ref import SEMIRINGS, semiring_matmul_ref
from .semiring import semiring_matmul_cuda


def _resolve(device, impl):
    # deferred: repro_torch.core imports this package through core.discovery
    # and the graph verbs, so a module-level import would re-enter it
    from repro_torch.core import backend

    return backend.resolve(device, impl)


def semiring_matmul(a: torch.Tensor, b: torch.Tensor,
                    semiring: str = "plus_times", *,
                    impl: str | None = None) -> torch.Tensor:
    """(M, N) float32 semiring product of ``a @ b`` (see module docstring).

    ``impl="ref"`` forces the plain version; otherwise a CUDA tensor takes
    the kernel and a CPU tensor the plain version.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; one of {SEMIRINGS}")
    if _resolve(a.device, impl) == "cuda":
        return semiring_matmul_cuda(a, b, semiring)
    return semiring_matmul_ref(a, b, semiring)


def _steps(n: int, k: int) -> int:
    # squarings needed for a horizon of k edges on an n-node graph
    k = max(1, min(int(k), max(n - 1, 1)))
    return max(0, math.ceil(math.log2(k)))


def _or_and(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # boolean AND-OR product as a thresholded 0/1 product: path counts are
    # exact integers below 2^24, so ``> 0`` recovers the exact OR
    return semiring_matmul(x.to(torch.float32), y.to(torch.float32),
                           "plus_times") > 0


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def bool_closure(adj: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """(N, N) bool: can j be reached from i in **at most** k steps?

    ``k=None`` (or k >= N-1) is the full transitive-reflexive closure —
    repeated squaring of the reflexive seed ``I | A``.  A finite k runs
    binary exponentiation of ``(I | A)^k`` instead, which never overshoots
    a non-power-of-two horizon.
    """
    n = adj.shape[0]
    base = _eye(n, adj.device) | adj.to(torch.bool)
    if k is None:
        reach = base
        for _ in range(_steps(n, n - 1)):
            reach = _or_and(reach, reach)
        return reach
    e = min(max(int(k), 0), max(n - 1, 1))
    acc = _eye(n, adj.device)
    sq = base
    while e:
        if e & 1:
            acc = _or_and(acc, sq)
        e >>= 1
        if e:
            sq = _or_and(sq, sq)
    return acc


def minplus_closure(w: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest distances of a weight matrix (``+inf`` = no edge,
    diagonal forced to 0).  ``ceil(log2(n-1))`` min-plus squarings."""
    n = w.shape[0]
    d = torch.where(_eye(n, w.device), 0.0, w.to(torch.float32))
    for _ in range(_steps(n, n - 1)):
        d = semiring_matmul(d, d, "min_plus")
    return d


def maxmin_closure(cap: torch.Tensor) -> torch.Tensor:
    """All-pairs widest-path capacities (``-inf`` = no edge, diagonal
    forced to ``+inf`` — the max-min identity)."""
    n = cap.shape[0]
    d = torch.where(_eye(n, cap.device), math.inf, cap.to(torch.float32))
    for _ in range(_steps(n, n - 1)):
        d = semiring_matmul(d, d, "max_min")
    return d
