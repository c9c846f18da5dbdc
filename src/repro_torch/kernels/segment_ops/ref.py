"""Plain PyTorch versions of the segmented primitives on the DFG path.

The paper's direct columnar translations — flat-key scatter-adds
(``index_add_``).  Out-of-range ids, including -1, are routed to a scratch
slot that is sliced off, so they are dropped exactly as in the JAX
package's XLA lowering.  These are the parity oracles of the CUDA kernels
and the lowering every CPU tensor takes.  On the CPU ``index_add_`` adds in
row order; on a card it uses atomics, which is exact only for integer
weights.
"""
from __future__ import annotations

import torch


def histogram_ref(values: torch.Tensor, num_bins: int, weights: torch.Tensor,
                  into: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted bincount; out-of-range values hit a scratch bin (sliced off).

    ``into`` adds onto an existing (num_bins,) accumulator (a new tensor is
    returned; ``into`` is not modified).
    """
    ok = (values >= 0) & (values < num_bins)
    idx = torch.where(ok, values.long(), num_bins)
    zero = torch.zeros(1, dtype=weights.dtype, device=weights.device)
    if into is None:
        acc = torch.zeros(num_bins + 1, dtype=weights.dtype, device=weights.device)
    else:
        acc = torch.cat([into.to(weights.dtype), zero])
    return acc.index_add_(0, idx, weights)[:-1]


def pair_count_ref(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   num_src: int, num_dst: int,
                   into: torch.Tensor | None = None) -> torch.Tensor:
    """Flat-key scatter-add: ``counts[src_i, dst_i] += w_i`` (OOB dropped).

    The paper's map-reduce strategy (§5.4 strategy 1): pair keys reduced
    via scatter-add, masked pairs routed to a scratch bucket.  ``into``
    adds onto an existing (num_src, num_dst) state.
    """
    ok = (src >= 0) & (src < num_src) & (dst >= 0) & (dst < num_dst)
    key = torch.where(ok, src.long() * num_dst + dst.long(), num_src * num_dst)
    zero = torch.zeros(1, dtype=w.dtype, device=w.device)
    if into is None:
        flat = torch.zeros(num_src * num_dst + 1, dtype=w.dtype, device=w.device)
    else:
        flat = torch.cat([into.reshape(-1).to(w.dtype), zero])
    flat.index_add_(0, key, w)
    return flat[:-1].reshape(num_src, num_dst)


def _one_hot(ids: torch.Tensor, num: int) -> torch.Tensor:
    """float32 one-hot rows; ids outside ``[0, num)`` give all-zero rows."""
    cls = torch.arange(num, device=ids.device)
    return (ids.long()[:, None] == cls[None, :]).to(torch.float32)


def pair_count_matmul(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                      num_src: int, num_dst: int, block: int = 2048) -> torch.Tensor:
    """Blockwise one-hot matmul: ``C = sum_k (onehot(src_k) * w_k)^T @ onehot(dst_k)``.

    The paper-side matrix formulation (float32 accumulation; exact for
    integer-valued weights with per-cell sums < 2^24).  Returns ``w``'s dtype.
    """
    c = torch.zeros((num_src, num_dst), dtype=torch.float32, device=src.device)
    wf = w.to(torch.float32)
    for lo in range(0, src.shape[0], block):
        hi = lo + block
        x = _one_hot(src[lo:hi], num_src) * wf[lo:hi, None]
        y = _one_hot(dst[lo:hi], num_dst)
        c += x.T @ y
    return c.to(w.dtype)
