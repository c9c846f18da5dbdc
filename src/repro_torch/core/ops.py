"""Transformation functions on dataframes — paper §5.3, on PyTorch tensors.

Each function mirrors one definition from the paper:

* ``proj``     — projection on a selective function (filter). Lazy: marks the
                 ``row_valid`` mask instead of compacting.
* ``group``    — grouping on an attribute. Realized as *segment ids*: after a
                 sort on the grouping attribute, groups are contiguous segments.
* ``shift``    — index shift ``I' = {i-1 | i in I}`` i.e. ``shift(D)[i] = D[i+1]``.
* ``concat``   — horizontal concatenation with a column-name suffix.
* ``sort``     — stable sort by one or more attributes.
* ``mergstrv`` — string-attribute merge. Strings are dictionary-encoded, so the
                 merge of two id columns is the *pair encoding* ``a * base + b``
                 (an injective stand-in for ``a + sep + b``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .eventframe import EventFrame

_INT32_MAX = 2**31 - 1


def proj(frame: EventFrame, mask: torch.Tensor) -> EventFrame:
    """Paper's ``proj(D, S, f)``: keep rows where the selective function is 1.

    ``mask`` is ``f`` evaluated per row. The result shares the input's column
    tensors and only narrows ``row_valid`` — O(N) worst case, matching Table 3.
    """
    rv = mask if frame.row_valid is None else (frame.row_valid & mask)
    return EventFrame(frame.columns, frame.valid, rv)


def proj_fn(frame: EventFrame, names: Sequence[str],
            f: Callable[..., torch.Tensor]) -> EventFrame:
    """Literal form of the paper's projection: ``f`` receives the named columns."""
    return proj(frame, f(*[frame[n] for n in names]))


def sort(frame: EventFrame, by: Sequence[str] | str) -> EventFrame:
    """Stable lexicographic sort by one or more columns (last key primary —
    the ``np.lexsort`` convention; pass keys minor-to-major).

    PyTorch has no lexsort: successive stable sorts, from the minor key to
    the major one, give the same order.
    """
    if isinstance(by, str):
        by = (by,)
    order = torch.arange(frame.nrows, device=frame.device)
    for name in by:
        key = frame[name][order]
        order = order[torch.sort(key, stable=True).indices]
    return frame.take(order)


def shift(frame: EventFrame, fill: int = 0) -> EventFrame:
    """``shift(D)[i] = D[i+1]``; the final row becomes invalid (index left I)."""

    def shf(col):
        return torch.cat([col[1:], torch.full((1,), fill, dtype=col.dtype,
                                              device=col.device)])

    def shf_mask(m):
        return torch.cat([m[1:], torch.zeros(1, dtype=torch.bool,
                                             device=m.device)])

    cols = {k: shf(v) for k, v in frame.columns.items()}
    vals = {k: shf_mask(v) for k, v in frame.valid.items()}
    return EventFrame(cols, vals, shf_mask(frame.rows_valid()))


def concat(a: EventFrame, b: EventFrame, suffix: str = ".2") -> EventFrame:
    """Horizontal concat; ``b``'s columns are renamed ``name + suffix``."""
    cols = dict(a.columns)
    vals = dict(a.valid)
    for k, v in b.columns.items():
        cols[k + suffix] = v
    for k, v in b.valid.items():
        vals[k + suffix] = v
    rv = None
    if a.row_valid is not None or b.row_valid is not None:
        rv = a.rows_valid() & b.rows_valid()
    return EventFrame(cols, vals, rv)


def mergstrv(frame: EventFrame, out: str, n1: str, n2: str, base: int) -> EventFrame:
    """Pair-encode two dictionary-encoded columns: ``v = col1 * base + col2``.

    ``base`` must exceed every value of ``n2`` (typically the alphabet size);
    the encoding is injective, as string concatenation with a separator is.

    The encoding lives in int32, so ``max(col1) * base + max(col2)`` must fit
    in int32; the bound is checked and a clear ``OverflowError`` raised
    instead of silently wrapping.  The check reads two maxima back to the
    host (a device sync), which is why the streaming update never calls it.
    """
    c1, c2 = frame[n1], frame[n2]
    if c1.numel():
        m1, m2 = int(c1.max()), int(c2.max())
        hi = m1 * int(base) + m2
        if hi > _INT32_MAX:
            raise OverflowError(
                f"mergstrv({n1!r}, {n2!r}): pair encoding max "
                f"{m1} * {base} + {m2} = {hi} exceeds int32 range; use a "
                f"smaller base/alphabet or split the log")
    merged = c1.to(torch.int32) * int(base) + c2.to(torch.int32)
    return frame.with_column(out, merged)


def _starts(key: torch.Tensor) -> torch.Tensor:
    head = torch.ones(min(key.shape[0], 1), dtype=torch.bool, device=key.device)
    return torch.cat([head, key[1:] != key[:-1]])


def group_segments(frame: EventFrame, by: str
                   ) -> tuple[EventFrame, torch.Tensor, torch.Tensor]:
    """Paper's ``group(D, n0)`` realized as contiguous segments.

    Returns ``(sorted_frame, segment_ids, segment_starts_mask)``. After the
    sort, rows of one group are adjacent; ``segment_ids`` numbers groups
    ``0..G-1`` in order of first appearance in the sorted frame.
    """
    sf = sort(frame, by)
    seg_ids, starts = segment_ids_sorted(sf[by])
    return sf, seg_ids, starts


def segment_ids_sorted(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment ids (int32) for an already-sorted key column (no resort)."""
    starts = _starts(key)
    return torch.cumsum(starts, 0, dtype=torch.int32) - 1, starts


def value_counts(col: torch.Tensor, num_values: int,
                 weights: torch.Tensor | None = None, *,
                 impl: str | None = None) -> torch.Tensor:
    """Histogram of a dictionary-encoded column — the ``c(e)`` count of §5.4.

    Thin alias of ``kernels.segment_ops.histogram`` (the CUDA kernel on a
    card, the plain version on the CPU); out-of-range values are dropped.
    """
    from repro_torch.kernels.segment_ops import histogram

    return histogram(col, num_values, weights, impl=impl)
