"""Plain PyTorch versions of the graph semiring product and of the
closures over it (the parity oracles).

``plus_times`` is ``torch.matmul`` in float32; the tropical semirings are
the row-blocked broadcast reduction — blocked so the (rows, K, N)
candidate tensor stays bounded.
Each tropical candidate (``a + b`` / ``min(a, b)``) is one operation and
min/max do not depend on order, so the tropical results are bitwise those
of the CUDA kernel and of the JAX package for any tiling.  This is what a
CPU tensor takes and what the kernel is held against on the card.

:func:`closure_loop` is the closure loop of the JAX package
(``src/repro/kernels/graph_ops/ops.py``) over any product function;
:func:`semiring_closure_ref` runs it on the plain product, the plain
version of the closure kernel.
"""
from __future__ import annotations

import math

import torch

SEMIRINGS = ("plus_times", "min_plus", "max_min")
# the closures: boolean reachability (the 0/1 plus_times product
# thresholded "> 0"), shortest and widest paths
CLOSURES = ("bool", "min_plus", "max_min")

# rows per tropical block: the (rows, K, N) float32 candidate tensor of a
# 384-node graph stays at 16 * 384 * 384 * 4 B = 9.4 MB
_BLOCK_M = 16

# additive identity of each semiring: the start of every output and the
# value a ragged edge reads as, which can never win a reduction
IDENTITY = {"plus_times": 0.0,
            "min_plus": float("inf"),
            "max_min": float("-inf")}


def semiring_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                        semiring: str = "plus_times") -> torch.Tensor:
    """(M, N) float32 semiring product of ``a`` (M, K) and ``b`` (K, N)."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; one of {SEMIRINGS}")
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if semiring == "plus_times":
        return torch.matmul(a, b)
    m, n = a.shape[0], b.shape[1]
    if a.shape[1] == 0:
        return torch.full((m, n), IDENTITY[semiring], dtype=torch.float32,
                          device=a.device)
    out = []
    for lo in range(0, m, _BLOCK_M):
        ab = a[lo:lo + _BLOCK_M, :, None]
        if semiring == "min_plus":
            out.append(torch.amin(ab + b[None, :, :], dim=1))
        else:
            out.append(torch.amax(torch.minimum(ab, b[None, :, :]), dim=1))
    if not out:
        return torch.empty((0, n), dtype=torch.float32, device=a.device)
    return torch.cat(out)


def closure_steps(n: int, k: int) -> int:
    """Squarings needed for a horizon of k edges on an n-node graph."""
    k = max(1, min(int(k), max(n - 1, 1)))
    return max(0, math.ceil(math.log2(k)))


def closure_exponent(n: int, k: int) -> int:
    """The horizon of a finite-k boolean closure: k clamped to [0, n - 1]
    (at least 1 edge when n <= 2)."""
    return min(max(int(k), 0), max(n - 1, 1))


def closure_seed(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The closure's start: ``I | A`` (bool), the weights with a 0 diagonal
    (min_plus) or a +inf diagonal (max_min) in float32."""
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    if kind == "bool":
        return eye | x.to(torch.bool)
    diag = 0.0 if kind == "min_plus" else math.inf
    return torch.where(eye, diag, x.to(torch.float32))


def closure_loop(x: torch.Tensor, kind: str, k: int | None, product) -> torch.Tensor:
    """The closure of ``x`` by repeated products ``product(a, b, semiring)``.

    Tropical kinds: ``closure_steps(n, n - 1)`` squarings of the seed.
    ``bool``: ``k=None`` squares ``I | A`` as often; a finite k runs binary
    exponentiation of ``(I | A)^k``, each product the 0/1 ``plus_times``
    product thresholded ``> 0`` (path counts are exact integers below 2^24).
    """
    if kind not in CLOSURES:
        raise ValueError(f"unknown closure {kind!r}; one of {CLOSURES}")
    n = x.shape[0]
    seed = closure_seed(x, kind)
    if kind != "bool":
        if k is not None:
            raise ValueError(f"a {kind} closure takes no k")
        for _ in range(closure_steps(n, n - 1)):
            seed = product(seed, seed, kind)
        return seed

    def or_and(p, q):
        return product(p.to(torch.float32), q.to(torch.float32), "plus_times") > 0

    if k is None:
        for _ in range(closure_steps(n, n - 1)):
            seed = or_and(seed, seed)
        return seed
    e = closure_exponent(n, k)
    acc = torch.eye(n, dtype=torch.bool, device=x.device)
    sq = seed
    while e:
        if e & 1:
            acc = or_and(acc, sq)
        e >>= 1
        if e:
            sq = or_and(sq, sq)
    return acc


def semiring_closure_ref(x: torch.Tensor, kind: str = "min_plus",
                         k: int | None = None) -> torch.Tensor:
    """(N, N) closure of ``x`` (bool for ``kind="bool"``, else float32) by
    the loop of plain products."""
    return closure_loop(x, kind, k, semiring_matmul_ref)
