"""Public entry points for the segmented primitives.

The paper reduces process-mining algorithms to a handful of columnar
dataframe operations (§5.3–5.4); these five carry the DFG, the statistics,
the case filters, the variants and the performance overlays:

=====================  ====================================  ===================
primitive              paper operation (§5.3/5.4, Table 3)   lowerings
=====================  ====================================  ===================
``segment_reduce``     group(D, case) + aggregate            cuda / ref
``histogram``          counting ``c(e)`` after proj          cuda / ref
``pair_count``         shift + mergstrv + count (DFG)        cuda / ref / matmul
``segmented_scan``     case-local fold (variants, EFG)       cuda / ref
``segmented_affine``   the fold of composed sketch maps      cuda / ref
=====================  ====================================  ===================

Dispatch (``core.backend.resolve``): an explicit ``impl=`` wins; otherwise a
CUDA tensor takes the hand-written kernel and a CPU tensor the plain
version.  Weights follow the JAX package: ``None`` counts (int32), bool or
integer weights count as int32, float weights float32.  The integer
counting kernels read a bool mask in place and add an int32 ``into``
themselves, so a call on a card is the kernel and nothing else.

Float accumulation is order-sensitive, and the streaming engine promises
*bitwise* streaming == whole-log results.  Float weights therefore take the
row-order fold (``ordered_histogram_cuda`` on a card, ``index_add_`` on the
CPU), which adds each weight onto ``into`` one row at a time, as the JAX
package's XLA scatter does; integer counts are exact in any order and take
the atomic kernels.  A float ``segment_reduce`` sum takes the same fold
unless the caller vouches for sorted ids (``assume_exact=True``) or names
``impl``, as the JAX package's dispatch does.  The segmented scans add in
row order on both lowerings, so they need no such rule.

uint32 operands (the polyhash scans) are int32 bit patterns or
``torch.uint32`` tensors; the scans return the dtype they were given.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .histogram import histogram_cuda
from .ordered_histogram import ordered_histogram_cuda
from .pair_count import pair_count_cuda
from .segment_reduce import segment_reduce_cuda
from .segmented_scan import (segmented_affine_cuda, segmented_polyhash_cuda,
                             segmented_sum_scan_cuda)


def _resolve(device, impl):
    # deferred: repro_torch.core imports core.dfg, which imports this
    # package, so a module-level import would re-enter it mid-init
    from repro_torch.core import backend

    return backend.resolve(device, impl)


def _weights(weights, like: torch.Tensor, *, keep_bool: bool = False
             ) -> torch.Tensor:
    """int32 counts for ``None``, int32 for bool / integer weights (a bool
    mask kept as it is when ``keep_bool``: the counting kernels read it in
    place), float32 for float weights."""
    if weights is None:
        return torch.ones(like.shape, dtype=torch.int32, device=like.device)
    if keep_bool and weights.dtype == torch.bool:
        return weights
    if weights.dtype == torch.bool or not weights.is_floating_point():
        return weights.to(torch.int32)
    return weights.to(torch.float32)


def _kernel_into(into, shape, device):
    """``into`` as the counting kernels take it (added inside the kernel):
    an int32 tensor of the output's shape on the inputs' card; None for any
    other, which the caller adds afterwards (JAX's ``into + out``)."""
    if (into is not None and into.dtype == torch.int32
            and into.device == device and tuple(into.shape) == shape):
        return into.contiguous()
    return None


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, op: str = "sum", *,
                   impl: str | None = None,
                   assume_exact: bool = False) -> torch.Tensor:
    """(num_segments,) ``op``-reduction of ``values`` grouped by sorted ids.

    ``segment_ids`` must be the sorted, consecutive ids produced by
    ``ops.segment_ids_sorted`` / ``engine.global_segments``; out-of-range
    ids (including -1) are dropped.  Empty segments hold the op identity.
    Bool values reduce as int32, and bool min/max come back as bool.

    A float sum is order-sensitive, so, as in the JAX package, it stays off
    the kernel unless the caller names ``impl`` or passes
    ``assume_exact=True``: on a card it takes the row-order fold
    (``ordered_histogram_cuda``), which adds in row order for any ids.
    """
    was_bool = values.dtype == torch.bool
    vals = values.to(torch.int32) if was_bool else values
    if _resolve(values.device, impl) == "cuda":
        ids = segment_ids.to(torch.int32).contiguous()
        if (op == "sum" and vals.is_floating_point() and not assume_exact
                and impl in (None, "auto")):
            return ordered_histogram_cuda(ids, vals.contiguous(), num_segments)
        out = segment_reduce_cuda(vals.contiguous(), ids, num_segments, op)
    else:
        out = _ref.segment_reduce_ref(vals, segment_ids, num_segments, op)
    if was_bool and op in ("min", "max"):
        return out > 0
    return out


def histogram(values: torch.Tensor, num_bins: int,
              weights: torch.Tensor | None = None, *,
              into: torch.Tensor | None = None,
              impl: str | None = None) -> torch.Tensor:
    """Weighted bincount of dictionary-encoded ``values`` (OOB dropped).

    ``weights=None`` counts occurrences (int32); bool/int weights produce
    int32 counts; float weights a float32 accumulation, folded onto
    ``into`` in row order.  ``into`` adds onto an existing (num_bins,)
    state (it is not modified).  On a card a bool mask goes to the kernel
    as it is and an int32 ``into`` is added inside it.
    """
    if _resolve(values.device, impl) == "cuda":
        w = _weights(weights, values, keep_bool=True)
        v = values.to(torch.int32).contiguous()
        if w.is_floating_point():
            return ordered_histogram_cuda(
                v, w.contiguous(), num_bins,
                None if into is None else into.to(torch.float32).contiguous())
        k_into = _kernel_into(into, (num_bins,), v.device)
        out = histogram_cuda(v, w.contiguous(), num_bins, k_into)
        return out if into is None or k_into is not None else into + out
    return _ref.histogram_ref(values, num_bins, _weights(weights, values), into)


def pair_count(src: torch.Tensor, dst: torch.Tensor, num_src: int,
               num_dst: int | None = None,
               weights: torch.Tensor | None = None, *,
               into: torch.Tensor | None = None,
               impl: str | None = None) -> torch.Tensor:
    """(num_src, num_dst) weighted (src, dst) pair counts (OOB dropped).

    The generalized DFG counter: ``impl`` may also name the one-hot
    ``"matmul"`` formulation (float32 accumulation, exact while every
    per-cell sum stays < 2^24).  ``into`` adds onto an existing state; on a
    card a bool mask and an int32 ``into`` go to the kernel as they are.
    """
    num_dst = num_src if num_dst is None else num_dst
    if impl == "matmul":
        out = _ref.pair_count_matmul(src, dst, _weights(weights, src), num_src,
                                     num_dst)
        return out if into is None else into + out
    if _resolve(src.device, impl) == "cuda":
        w = _weights(weights, src, keep_bool=True)
        if w.is_floating_point():
            # the row-order fold over the flat key; a pair with either side
            # out of range is dropped first (key -1)
            ok = (src >= 0) & (src < num_src) & (dst >= 0) & (dst < num_dst)
            key = torch.where(ok, src.to(torch.int32) * num_dst
                              + dst.to(torch.int32), -1)
            flat = ordered_histogram_cuda(
                key.contiguous(), w.contiguous(), num_src * num_dst,
                None if into is None
                else into.reshape(-1).to(torch.float32).contiguous())
            return flat.reshape(num_src, num_dst)
        k_into = _kernel_into(into, (num_src, num_dst), src.device)
        out = pair_count_cuda(src.to(torch.int32).contiguous(),
                              dst.to(torch.int32).contiguous(),
                              w.contiguous(), num_src, num_dst, k_into)
        return out if into is None or k_into is not None else into + out
    return _ref.pair_count_ref(src, dst, _weights(weights, src), num_src,
                               num_dst, into)


def pair_count_matmul(src, dst, num_src, num_dst=None, weights=None, *,
                      block: int = 2048):
    """The blockwise one-hot matmul lowering, callable directly (int32 out
    unless the weights are float32)."""
    num_dst = num_src if num_dst is None else num_dst
    w = (torch.ones(src.shape, dtype=torch.int32, device=src.device)
         if weights is None else weights)
    out = _ref.pair_count_matmul(src, dst, w.to(torch.float32), num_src,
                                 num_dst, block)
    if w.dtype != torch.float32:
        return out.to(torch.int32)
    return out


def _u32_operand(x: torch.Tensor) -> torch.Tensor:
    """A uint32 operand as the kernels take it: int32 bit patterns."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).contiguous()
    if x.dtype == torch.int32:
        return x.contiguous()
    raise TypeError(f"uint32 scan operands must be int32 bit patterns or "
                    f"torch.uint32, got {x.dtype}")


def _u32_carry(carry, device) -> torch.Tensor:
    """The carry as a 0-d int32 bit pattern on ``device``: a Python int is
    taken mod 2^32; a tensor is reinterpreted (uint32) or wrapped (int64)."""
    if not isinstance(carry, torch.Tensor):
        carry = torch.tensor(int(carry) & _ref.M32, dtype=torch.int64)
    if carry.dtype == torch.uint32:
        carry = carry.view(torch.int32)
    elif carry.dtype != torch.int32:
        carry = _ref.u32_bits(carry.to(torch.int64))
    return carry.reshape(()).to(device)


def _like(ys: torch.Tensor, carry: torch.Tensor, dtype: torch.dtype):
    if dtype == torch.uint32:
        return ys.view(torch.uint32), carry.view(torch.uint32)
    return ys, carry


def segmented_scan(values: torch.Tensor, seg_starts: torch.Tensor, carry,
                   op: str = "sum", *, base: int | None = None,
                   impl: str | None = None, assume_exact: bool = False):
    """Case-local inclusive scan; returns ``(ys, carry_out)``.

    ``op="sum"``: segmented prefix sum over (N,) or (N, K) float32 / int32
    rows, seeded by ``carry`` (the open segment's running total, 0-d or
    (K,)).  ``op="polyhash"``: the rolling hash ``h <- h*base + v`` (mod
    2**32) over uint32 values.  ``carry_out`` is the inclusive value at the
    final row (feeds the next chunk's carry) and stays on the device.
    Both lowerings add float32 rows in row order, so ``assume_exact`` (kept
    for the JAX signature) changes nothing.
    """
    del assume_exact
    starts = seg_starts.to(torch.bool).contiguous()
    if op == "polyhash":
        if base is None:
            raise ValueError("segmented_scan(op='polyhash') requires base=")
        v = _u32_operand(values)
        c = _u32_carry(carry, v.device)
        if _resolve(values.device, impl) == "cuda":
            ys, out = segmented_polyhash_cuda(v, starts, c, int(base))
        else:
            ys, out = _ref.segmented_scan_ref(v, starts, c, "polyhash", base)
        return _like(ys, out, values.dtype)
    if op == "sum":
        if not isinstance(carry, torch.Tensor):
            carry = torch.tensor(carry, dtype=values.dtype)
        c = carry.to(values.device, values.dtype).contiguous()
        if _resolve(values.device, impl) == "cuda":
            return segmented_sum_scan_cuda(values.contiguous(), starts, c)
        return _ref.segmented_scan_ref(values, starts, c, "sum")
    raise ValueError(f"unknown segmented_scan op {op!r}")


def segmented_affine(mul: torch.Tensor, add: torch.Tensor,
                     seg_starts: torch.Tensor, carry, *,
                     impl: str | None = None):
    """Case-local scan of explicit affine maps ``h <- h*mul + add`` (mod
    2**32); returns ``(ys, carry_out)``.

    The generalization of ``segmented_scan(op="polyhash")`` where each row
    carries its own coefficients — what lets the variants kernel fold a
    pre-composed sketch entry (the collapsed map of a whole skipped case
    run) in a single row.
    """
    m, b = _u32_operand(mul), _u32_operand(add)
    starts = seg_starts.to(torch.bool).contiguous()
    c = _u32_carry(carry, b.device)
    if _resolve(add.device, impl) == "cuda":
        ys, out = segmented_affine_cuda(m, b, starts, c)
    else:
        ys, out = _ref.segmented_affine_ref(m, b, starts, c)
    return _like(ys, out, add.dtype)
