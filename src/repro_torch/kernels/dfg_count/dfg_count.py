"""DFG pair counting — the square special case of ``segment_ops.pair_count``.

The counterpart of the JAX package's ``dfg_count_pallas``, kept as the
stable, paper-named API: count (src, dst) activity pairs into a dense
(A, A) int32 matrix.  It has no kernel of its own.  As in the JAX package,
float weights are summed in float32 and truncated to int32: they take
``pair_count``'s row-order float fold (the ordered-fold kernel on a card),
while bool and integer weights take the int32 pair-count kernel.  Nothing
is read back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_ops.ops import pair_count


def dfg_count_cuda(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   num_activities: int) -> torch.Tensor:
    """Count (src, dst) pairs weighted by ``w`` into (A, A) int32.

    ``w`` is the same-case mask (any dtype); padding events must carry
    ``w == 0``.  A float ``w`` is accumulated in float32, then truncated.
    """
    return pair_count(src, dst, num_activities, num_activities,
                      weights=w).to(torch.int32)
