"""Plain PyTorch version of flash attention: materialized-score GQA attention.

The parity oracle of the CUDA kernel (``flash_attention.py``) and the
counterpart of the JAX package's ``kernels/flash_attention/ref.py``: scores
in float32, causal rows counted from 0, an optional sliding window and a
ragged ``kv_len`` (an int or a 0-d tensor, read on the tensor's device).
A row with no valid column is 0.  It materializes the (Sq, Sk) scores, so
it is for tests and checks, never the serving path on a card.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len=None, *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q (B, H, Sq, D), k / v (B, KVH, Sk, D) -> (B, H, Sq, D) in q's dtype."""
    _, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= cols > rows - window
    if kv_len is not None:
        mask = mask & (cols < kv_len)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)      # rows with no valid column
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
