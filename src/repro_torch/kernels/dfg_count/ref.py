"""Plain PyTorch oracle for the square DFG count."""
from __future__ import annotations

import torch


def dfg_count_ref(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  num_activities: int) -> torch.Tensor:
    """Scatter-add oracle: ``counts[src_i, dst_i] += w_i`` into (A, A) int32."""
    a = num_activities
    key = (src.long().clamp(0, a - 1) * a + dst.long().clamp(0, a - 1))
    inb = (src >= 0) & (src < a) & (dst >= 0) & (dst < a)
    ww = torch.where(inb, w.to(torch.float32), 0.0)
    flat = torch.zeros(a * a, dtype=torch.float32, device=src.device)
    flat.index_add_(0, key, ww)
    return flat.reshape(a, a).to(torch.int32)
