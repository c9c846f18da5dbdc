"""DFG pair counting — the square special case of ``segment_ops.pair_count``.

The counterpart of the JAX package's ``dfg_count_pallas``, kept as the
stable, paper-named API: count (src, dst) activity pairs into a dense
(A, A) int32 matrix.  It has no kernel of its own: it turns the same-case
mask into int32 weights and calls the pair-count kernel's wrapper (which
takes the plain version on a CPU tensor).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_ops.pair_count import pair_count_cuda


def dfg_count_cuda(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   num_activities: int) -> torch.Tensor:
    """Count (src, dst) pairs under the 0/1 mask ``w`` into (A, A) int32.

    ``w`` is the same-case mask (any dtype); a mask holding any value other
    than 0 or 1 raises ``ValueError`` (this check reads the mask back to the
    host).  Padding events must carry ``w == 0``.
    """
    if bool(((w != 0) & (w != 1)).any()):
        raise ValueError("dfg_count: w must be a 0/1 mask")
    return pair_count_cuda(src.to(torch.int32).contiguous(),
                           dst.to(torch.int32).contiguous(),
                           w.to(torch.int32).contiguous(),
                           num_activities, num_activities)
