"""Public entry point for DFG pair counting, dispatched by device.

The counterpart of the JAX package's ``kernels.dfg_count.ops.dfg_count``:
``core.backend.resolve`` picks the lowering, so a CUDA tensor takes
``dfg_count_cuda`` (the pair-count kernel) and a CPU tensor the
scatter-add oracle.  ``impl`` takes the port's names (``"cuda"`` /
``"ref"``) and the JAX package's (``"pallas"`` / ``"xla"``); the JAX
function's own ``"ref"`` is the port's ``"ref"`` too.
"""
from __future__ import annotations

import torch

from .dfg_count import dfg_count_cuda
from .ref import dfg_count_ref


def dfg_count(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              num_activities: int, *, impl: str | None = None) -> torch.Tensor:
    """(A, A) int32 counts of (src, dst) pairs weighted by ``w``."""
    from repro_torch.core import backend

    if backend.resolve(src.device, impl) == "cuda":
        return dfg_count_cuda(src, dst, w, num_activities)
    return dfg_count_ref(src, dst, w, num_activities)
