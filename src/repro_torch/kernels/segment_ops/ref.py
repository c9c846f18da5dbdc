"""Plain PyTorch versions of the segmented primitives.

The paper's direct columnar translations — flat-key scatter-adds
(``index_add_``) and scatter min/max (``scatter_reduce_``).  Out-of-range
ids, including -1, are routed to a scratch slot that is sliced off, so
they are dropped exactly as in the JAX package's XLA lowering.  These are
the parity oracles of the CUDA kernels and the lowering every CPU tensor
takes.  On the CPU ``index_add_`` adds in row order, so with float weights
it is the row-order fold (``ordered_histogram_ref``); on a card it uses
atomics, which is exact only for integer weights.
"""
from __future__ import annotations

import torch

_SCATTER_OP = {"min": "amin", "max": "amax"}


def reduce_identity(op: str, dtype: torch.dtype) -> torch.Tensor:
    """The 0-d identity of ``op`` in ``dtype``: 0 for sums, +-inf for float
    min/max, the int bounds for integer min/max (what empty segments hold)."""
    if op == "sum":
        return torch.zeros((), dtype=dtype)
    if op not in _SCATTER_OP:
        raise ValueError(f"unknown segment_reduce op {op!r}")
    if dtype.is_floating_point:
        return torch.tensor(float("inf") if op == "min" else float("-inf"),
                            dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if op == "min" else info.min, dtype=dtype)


def segment_reduce_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """Scatter lowering with a scratch slot for out-of-range ids.

    Out-of-range ids (including -1) go to slot ``num_segments``, which is
    sliced off; empty segments hold ``reduce_identity(op)``.  Sums add in
    row order on the CPU (``index_add_``).
    """
    s = num_segments
    ok = (segment_ids >= 0) & (segment_ids < s)
    idx = torch.where(ok, segment_ids.long(), s)
    out = torch.full((s + 1,), reduce_identity(op, values.dtype).item(),
                     dtype=values.dtype, device=values.device)
    if op == "sum":
        out.index_add_(0, idx, values)
    else:
        out.scatter_reduce_(0, idx, values, _SCATTER_OP[op], include_self=True)
    return out[:-1]


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


def ordered_histogram_ref(values: torch.Tensor, weights: torch.Tensor,
                          num_bins: int,
                          into: torch.Tensor | None = None) -> torch.Tensor:
    """The row-order float32 fold: ``out[b] = into[b] (or 0) + w_i + w_j + ...``
    over the rows hitting ``b``, left to right.

    The plain version of the ordered-fold kernel.  It is ``histogram_ref``
    on CPU tensors, where ``index_add_`` adds in row order; a card has no
    plain row-order fold, so the inputs must lie on the CPU.
    """
    if values.device.type != "cpu":
        raise ValueError("ordered_histogram_ref: the plain row-order fold "
                         "runs on CPU tensors; copy the inputs with .cpu()")
    return histogram_ref(values, num_bins, weights.to(torch.float32), into)


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
