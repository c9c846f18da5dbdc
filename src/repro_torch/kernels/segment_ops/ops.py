"""Public entry points for the segmented primitives on the DFG path.

The paper reduces process-mining algorithms to a handful of columnar
dataframe operations (§5.3–5.4); two of them carry the directly-follows
graph:

=================  ====================================  ====================
primitive          paper operation (§5.3/5.4, Table 3)   lowerings
=================  ====================================  ====================
``histogram``      counting ``c(e)`` after proj          cuda / ref
``pair_count``     shift + mergstrv + count (DFG)        cuda / ref / matmul
=================  ====================================  ====================

Dispatch (``core.backend.resolve``): an explicit ``impl=`` wins; otherwise a
CUDA tensor takes the hand-written kernel and a CPU tensor the plain
version.  Weights follow the JAX package: ``None`` counts (int32), bool or
integer weights become int32, float weights float32.

Float weights on a card raise ``NotImplementedError``: the JAX package
sends inexact weights to its row-order scatter so streaming stays bitwise
equal to the whole-log pass, and CUDA ``index_add_`` has no such order.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .histogram import histogram_cuda
from .pair_count import pair_count_cuda

FLOAT_ON_CUDA = ("float weights on a CUDA tensor need a row-order float "
                 "accumulation, which arrives with the stats-and-filtering "
                 "slice (ROADMAP.md, Queue 1 item 3); count with bool/int "
                 "weights, or pass impl='ref' for the unordered plain version")


def _resolve(device, impl):
    # deferred: repro_torch.core imports core.dfg, which imports this
    # package, so a module-level import would re-enter it mid-init
    from repro_torch.core import backend

    return backend.resolve(device, impl)


def _weights(weights, like: torch.Tensor) -> torch.Tensor:
    if weights is None:
        return torch.ones(like.shape, dtype=torch.int32, device=like.device)
    if weights.dtype == torch.bool or not weights.is_floating_point():
        return weights.to(torch.int32)
    return weights.to(torch.float32)


def histogram(values: torch.Tensor, num_bins: int,
              weights: torch.Tensor | None = None, *,
              into: torch.Tensor | None = None,
              impl: str | None = None) -> torch.Tensor:
    """Weighted bincount of dictionary-encoded ``values`` (OOB dropped).

    ``weights=None`` counts occurrences (int32); bool/int weights produce
    int32 counts; float weights a float32 accumulation (plain version
    only).  ``into`` adds onto an existing (num_bins,) state.
    """
    w = _weights(weights, values)
    chosen = _resolve(values.device, impl)
    if chosen == "cuda":
        if w.is_floating_point():
            raise NotImplementedError(FLOAT_ON_CUDA)
        out = histogram_cuda(values.to(torch.int32).contiguous(),
                             w.contiguous(), num_bins)
        return out if into is None else into + out
    return _ref.histogram_ref(values, num_bins, w, into)


def pair_count(src: torch.Tensor, dst: torch.Tensor, num_src: int,
               num_dst: int | None = None,
               weights: torch.Tensor | None = None, *,
               into: torch.Tensor | None = None,
               impl: str | None = None) -> torch.Tensor:
    """(num_src, num_dst) weighted (src, dst) pair counts (OOB dropped).

    The generalized DFG counter: ``impl`` may also name the one-hot
    ``"matmul"`` formulation (float32 accumulation, exact while every
    per-cell sum stays < 2^24).  ``into`` adds onto an existing state.
    """
    num_dst = num_src if num_dst is None else num_dst
    w = _weights(weights, src)
    if impl == "matmul":
        out = _ref.pair_count_matmul(src, dst, w, num_src, num_dst)
        return out if into is None else into + out
    chosen = _resolve(src.device, impl)
    if chosen == "cuda":
        if w.is_floating_point():
            raise NotImplementedError(FLOAT_ON_CUDA)
        out = pair_count_cuda(src.to(torch.int32).contiguous(),
                              dst.to(torch.int32).contiguous(),
                              w.contiguous(), num_src, num_dst)
        return out if into is None else into + out
    return _ref.pair_count_ref(src, dst, w, num_src, num_dst, into)


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
