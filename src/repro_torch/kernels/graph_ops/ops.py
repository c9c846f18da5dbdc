"""Public entry points for the graph semiring primitive — device dispatched.

``semiring_matmul`` is the one primitive (the hand-written CUDA kernel on
a card, the plain PyTorch version on the CPU, chosen by
``core.backend.resolve`` like the segmented primitives); the closure
helpers below iterate it by repeated squaring — ``ceil(log2(n))`` products
instead of the n relaxation sweeps of Floyd–Warshall.  On a CUDA tensor of
at most ``CLOSURE_MAX_N`` nodes a whole closure is one launch of the
closure kernel (``semiring_closure_cuda``); above it, and with
``impl="ref"`` on either device, the loop of products
(``ref.closure_loop``) runs on the chosen lowering:

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

import torch

from .ref import SEMIRINGS, closure_loop, semiring_matmul_ref
from .semiring import CLOSURE_MAX_N, semiring_closure_cuda, semiring_matmul_cuda


def _resolve(device, impl):
    # deferred: repro_torch.core imports this package through core.discovery
    # and the graph verbs, so a module-level import would re-enter it
    from repro_torch.core import backend

    return backend.resolve(device, impl)


def semiring_matmul(a: torch.Tensor, b: torch.Tensor,
                    semiring: str = "plus_times", *,
                    impl: str | None = None, **blocks) -> torch.Tensor:
    """(M, N) float32 semiring product of ``a @ b`` (see module docstring).

    ``impl="ref"`` forces the plain version; otherwise a CUDA tensor takes
    the kernel and a CPU tensor the plain version.  ``blocks`` takes the
    JAX package's Pallas block sizes (``block_m`` / ``block_n`` /
    ``block_k``) so its call sites carry over, and ignores them: the CUDA
    kernel's tile is fixed, and the result does not depend on a tiling.
    """
    unknown = set(blocks) - {"block_m", "block_n", "block_k"}
    if unknown:
        raise TypeError(f"semiring_matmul() got unexpected keyword "
                        f"arguments {sorted(unknown)}")
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; one of {SEMIRINGS}")
    if _resolve(a.device, impl) == "cuda":
        return semiring_matmul_cuda(a, b, semiring)
    return semiring_matmul_ref(a, b, semiring)


def _loop_product(impl):
    # the loop's product on the chosen lowering
    return lambda a, b, semiring: semiring_matmul(a, b, semiring, impl=impl)


def _closure(x: torch.Tensor, kind: str, k, impl) -> torch.Tensor:
    if (_resolve(x.device, impl) == "cuda"
            and x.shape[0] <= CLOSURE_MAX_N):
        return semiring_closure_cuda(x, kind, k)
    return closure_loop(x, kind, k, _loop_product(impl))


def bool_closure(adj: torch.Tensor, k: int | None = None, *,
                 impl: str | None = None) -> torch.Tensor:
    """(N, N) bool: can j be reached from i in **at most** k steps?

    ``k=None`` (or k >= N-1) is the full transitive-reflexive closure —
    repeated squaring of the reflexive seed ``I | A``.  A finite k runs
    binary exponentiation of ``(I | A)^k`` instead, which never overshoots
    a non-power-of-two horizon.
    """
    return _closure(adj, "bool", k, impl)


def minplus_closure(w: torch.Tensor, *, impl: str | None = None) -> torch.Tensor:
    """All-pairs shortest distances of a weight matrix (``+inf`` = no edge,
    diagonal forced to 0).  ``ceil(log2(n-1))`` min-plus squarings."""
    return _closure(w, "min_plus", None, impl)


def maxmin_closure(cap: torch.Tensor, *, impl: str | None = None) -> torch.Tensor:
    """All-pairs widest-path capacities (``-inf`` = no edge, diagonal
    forced to ``+inf`` — the max-min identity)."""
    return _closure(cap, "max_min", None, impl)
