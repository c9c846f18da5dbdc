"""Plain PyTorch versions of the segmented primitives.

The paper's direct columnar translations — flat-key scatter-adds
(``index_add_``) and scatter min/max (``scatter_reduce_``).  Out-of-range
ids, including -1, are routed to a scratch slot that is sliced off, so
they are dropped exactly as in the JAX package's XLA lowering.  These are
the parity oracles of the CUDA kernels and the lowering every CPU tensor
takes.  On the CPU ``index_add_`` adds in row order, so with float weights
it is the row-order fold (``ordered_histogram_ref``); on a card it uses
atomics, which is exact only for integer weights.

uint32 values (the polyhash scans, variant fingerprints) are held in
32-bit storage: int32 tensors with the bit patterns, or ``torch.uint32``
views of them.  Most torch operations refuse ``torch.uint32``, so the plain
versions compute on int64 values in ``[0, 2^32)`` and mask every product
back to 32 bits (``u32_values`` / ``u32_bits``).
"""
from __future__ import annotations

import torch

_SCATTER_OP = {"min": "amin", "max": "amax"}
M32 = 0xFFFFFFFF


def u32_values(x: torch.Tensor) -> torch.Tensor:
    """uint32 values as int64 in ``[0, 2^32)``: int32 bit patterns and
    ``torch.uint32`` tensors are read as unsigned, int64 taken mod 2^32."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values, taken mod 2^32, as int32 bit patterns."""
    x = x & M32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


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
    row order on the CPU (``index_add_``).  ``torch.uint32`` values reduce
    unsigned, on int64 copies (identity 0 for sum and max, 2^32 - 1 for
    min), and come back as ``torch.uint32``.
    """
    s = num_segments
    ok = (segment_ids >= 0) & (segment_ids < s)
    idx = torch.where(ok, segment_ids.long(), s)
    unsigned = values.dtype == torch.uint32
    if unsigned:
        reduce_identity(op, torch.int64)          # validates op
        vals, ident = u32_values(values), M32 if op == "min" else 0
    else:
        vals, ident = values, reduce_identity(op, values.dtype).item()
    out = torch.full((s + 1,), ident, dtype=vals.dtype, device=values.device)
    if op == "sum":
        out.index_add_(0, idx, vals)
    else:
        out.scatter_reduce_(0, idx, vals, _SCATTER_OP[op], include_self=True)
    return u32_bits(out[:-1]).view(torch.uint32) if unsigned else out[:-1]


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


# ------------------------------------------------------- segmented scans
def _levels(seg_starts: torch.Tensor) -> list[torch.Tensor]:
    """The rows grouped by their rank within their run: ``levels[k]`` holds
    every row that is the k-th of its run, in row order.  Row 0 always opens
    a run.  A fold then takes one vectorised step per rank (as many steps as
    the longest run has rows), each row reading its predecessor's result."""
    n = seg_starts.shape[0]
    pos = torch.arange(n, device=seg_starts.device)
    head = torch.cummax(torch.where(seg_starts, pos, 0), 0).values
    rank = pos - head
    order = torch.argsort(rank, stable=True)
    ends = torch.cumsum(torch.bincount(rank), 0).tolist()
    return [order[lo:hi] for lo, hi in zip([0] + ends[:-1], ends)]


def _mul32(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``h * m mod 2^32`` for int64 values in ``[0, 2^32)``, with every
    product below 2^49 (a 64-bit product would overflow int64)."""
    lo = h * (m & 0xFFFF)
    hi = (h * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def segmented_affine_ref(mul: torch.Tensor, add: torch.Tensor,
                         seg_starts: torch.Tensor, carry
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold of explicit affine maps ``h <- h*mul + add`` (mod 2^32),
    ``h`` reset to 0 at each flagged row; an unflagged row 0 continues
    ``carry``.  Returns ``(ys, carry_out)`` as int32 bit patterns, bitwise
    the sequential fold.  ``mul``, ``add`` and ``carry`` are uint32 values in
    int32 or uint32 storage (or int64, taken mod 2^32)."""
    n = add.shape[0]
    if n == 0:
        return add, carry
    starts = seg_starts.to(torch.bool)
    m, b = u32_values(mul), u32_values(add)
    c = u32_values(torch.as_tensor(carry, device=add.device)).reshape(1)
    ys = torch.empty(n, dtype=torch.int64, device=add.device)
    levels = _levels(starts)
    heads = levels[0]
    h = torch.zeros(heads.shape[0], dtype=torch.int64, device=add.device)
    h[:1] = torch.where(starts[:1], 0, c)   # an unflagged row 0 continues the carry
    ys[heads] = (_mul32(h, m[heads]) + b[heads]) & M32
    for rows in levels[1:]:
        ys[rows] = (_mul32(ys[rows - 1], m[rows]) + b[rows]) & M32
    ys = u32_bits(ys)
    return ys, ys[-1].clone()


def segmented_scan_ref(values: torch.Tensor, seg_starts: torch.Tensor, carry,
                       op: str = "sum", base: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive case-local scan, returning ``(ys, carry_out)`` with
    ``carry_out`` the last row's value.

    ``op="sum"``: prefix sums of (N,) or (N, K) rows seeded by ``carry``
    (0-d or (K,)), each added in row order (``0 + v`` at a flagged row,
    ``y[i-1] + v`` after it), so float32 results are bitwise the sequential
    fold.  ``op="polyhash"``: ``h <- h*base + v`` mod 2^32 over uint32
    values (see ``segmented_affine_ref``).  Vectorised over runs: one step
    per rank within a run, not per row.
    """
    if op == "polyhash":
        if base is None:
            raise ValueError("segmented_scan_ref(op='polyhash') requires base=")
        mul = torch.full(values.shape, int(base) & M32, dtype=torch.int64,
                         device=values.device)
        return segmented_affine_ref(mul, values, seg_starts, carry)
    if op != "sum":
        raise ValueError(f"unknown segmented_scan op {op!r}")
    n = values.shape[0]
    if n == 0:
        return values, carry
    x = values.reshape(n, -1)
    starts = seg_starts.to(torch.bool)
    c = torch.as_tensor(carry, dtype=values.dtype,
                        device=values.device).reshape(1, x.shape[1])
    ys = torch.empty_like(x)
    levels = _levels(starts)
    heads = levels[0]
    h = torch.zeros((heads.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    h[:1] = torch.where(starts[:1, None], h[:1], c)
    ys[heads] = h + x[heads]
    for rows in levels[1:]:
        ys[rows] = ys[rows - 1] + x[rows]
    last = ys[-1].clone()
    if values.dim() == 1:
        return ys.reshape(n), last.reshape(())
    return ys, last.reshape(torch.as_tensor(carry).shape)
