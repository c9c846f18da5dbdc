"""Plain PyTorch version of the graph semiring product (the parity oracle).

``plus_times`` is ``torch.matmul`` in float32; the tropical semirings are
the row-blocked broadcast reduction — blocked so the (rows, K, N)
candidate tensor stays bounded.
Each tropical candidate (``a + b`` / ``min(a, b)``) is one operation and
min/max do not depend on order, so the tropical results are bitwise those
of the CUDA kernel and of the JAX package for any tiling.  This is what a
CPU tensor takes and what the kernel is held against on the card.
"""
from __future__ import annotations

import torch

SEMIRINGS = ("plus_times", "min_plus", "max_min")

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
