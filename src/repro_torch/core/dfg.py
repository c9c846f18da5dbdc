"""Directly-Follows Graph on dataframes — paper §5.4, on the primitive layer.

The paper gives two strategies; both (plus the matrix formulation) are
*one* call into the segmented-primitive layer
(``repro_torch.kernels.segment_ops.pair_count``), selected by ``method``:

1. ``method="shift"``   — *shifting and counting* (§5.4 strategy 2),
   literally composed from the §5.3 transformation functions:
   ``concat(D, shift(D))``, keep rows with equal case id, ``mergstrv`` the
   two activity columns, count (a histogram of A^2 bins).
2. ``method="segment"`` — *map-reduce* (§5.4 strategy 1): pair keys reduced
   by the plain scatter-add (``impl="ref"``).
3. ``method="matmul"``  — counts as a matrix product ``C = X^T Y`` with
   one-hot operands (``impl="matmul"``).
4. ``method="kernel"``  — the hand-written CUDA kernels (``impl="cuda"``;
   their wrappers take the plain version on a CPU tensor).
5. ``method="auto"``    — dispatch by device: the CUDA kernels on a card,
   the plain versions on the CPU.  The default, so the streaming engine
   takes the kernels on a card.

``segment``, ``matmul`` and ``shift`` are the paper's alternative
formulations and run only when named; ``shift`` counts with ``histogram``,
which is the kernel on a card.  All methods assume the frame is sorted by
(case, time) — the paper's stated precondition.  Counting is integer-exact
under any accumulation order, so every method returns bitwise-identical
counts.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Mapping

import numpy as np
import torch

from repro_torch.kernels.segment_ops import histogram, pair_count

from . import engine, ops
from .eventframe import ACTIVITY, CASE, EventFrame


@dataclasses.dataclass
class DFG:
    """Dense DFG: ``counts[a, b]`` = #times b directly follows a."""

    counts: torch.Tensor     # (A, A) int32
    starts: torch.Tensor     # (A,)   int32 — start-activity histogram
    ends: torch.Tensor       # (A,)   int32 — end-activity histogram

    @property
    def num_activities(self) -> int:
        return self.counts.shape[-1]

    def edges(self):
        """Host-side sparse view: list of ((src, dst), count), count > 0."""
        c = self.counts.cpu().numpy()
        src, dst = np.nonzero(c)
        return [((int(a), int(b)), int(c[a, b])) for a, b in zip(src, dst)]

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray], device) -> "DFG":
        """A DFG (or a DFG state mid-stream) from numpy arrays — e.g. the
        JAX package's ``np.asarray(dfg.counts)`` and friends."""
        return cls(*(torch.from_numpy(np.array(arrays[f.name], np.int32))
                     .to(device) for f in dataclasses.fields(cls)))


def _boundaries(case: torch.Tensor, rv: torch.Tensor):
    change = case[1:] != case[:-1]
    one = torch.ones(1, dtype=torch.bool, device=case.device)
    is_start = torch.cat([one, change]) & rv
    is_end = torch.cat([change, one]) & rv
    return is_start, is_end


# method -> pair_count impl; "auto" resolves per call by the chunk's device.
_METHOD_IMPL = {"auto": None, "segment": "ref", "matmul": "matmul",
                "kernel": "cuda"}


def _method_impl(method: str) -> str | None:
    if method not in _METHOD_IMPL:
        raise ValueError(f"unknown DFG chunk method {method!r}")
    return _METHOD_IMPL[method]


def _add_at(vec: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``vec.at[idx].add(val, mode="drop")`` for a 0-d ``idx``, with no host
    sync: an out-of-range index lands in a scratch slot that is sliced off."""
    n = vec.shape[0]
    i = idx.long().reshape(1)
    i = torch.where((i >= 0) & (i < n), i, n)
    out = torch.cat([vec, torch.zeros(1, dtype=vec.dtype, device=vec.device)])
    return out.index_add_(0, i, val.reshape(1).to(vec.dtype))[:-1]


# ------------------------------------------------------------ chunk kernel
def dfg_kernel(num_activities: int, method: str = "auto") -> engine.ChunkKernel:
    """DFG as a mergeable chunk-kernel (init / update / merge / finalize).

    The carry is the one-row halo: the directly-follows pair straddling a
    chunk boundary is (carry.act -> first row), a case continuing across the
    boundary produces no start/end, and the stream's final end activity is
    resolved in ``finalize`` from the last carry.  Any chunking of a sorted
    log therefore yields counts identical to the whole-log pass.

    Each ``update`` makes one ``pair_count`` and two ``histogram`` calls —
    on a card three kernel launches of two nodes each, the counts added onto
    the state inside them — and reads nothing back to the host.
    """
    return _dfg_kernel(num_activities, _method_impl(method))


def stitch_dfg_state(A: DFG, B: DFG, a_tail: dict, b_row0: dict,
                     straddle: bool) -> DFG:
    """Stitch of two fresh DFG folds over consecutive units of a log.

    Elementwise sums plus the boundary-halo corrections the fresh fold of
    ``b`` could not see (its carry had ``exists=False``):

    * straddle — ``b``'s first valid row is *not* a case start (subtract
      the spurious start) and ``(a.last -> b.first)`` is a directly-follows
      pair when both rows are valid;
    * no straddle — ``a``'s last valid row *ends* its case at the boundary
      (``a``'s own fold deferred that end to ``finalize``, which never ran).

    ``a_tail`` and ``b_row0`` are host dicts (``act`` int, ``rv`` bool).
    Integer state, so the reconstruction is bitwise.  The sums are new
    tensors, so the corrections never write into ``A`` or ``B``.  Shared by
    the dfg, alpha, discovery and heuristics kernels (the latter two
    through their embedded DFG state).
    """
    counts = A.counts + B.counts
    starts = A.starts + B.starts
    ends = A.ends + B.ends
    a = counts.shape[-1]
    if straddle:
        if b_row0["rv"]:
            if 0 <= b_row0["act"] < a:
                starts[b_row0["act"]] -= 1
            if a_tail["rv"] and 0 <= a_tail["act"] < a and 0 <= b_row0["act"] < a:
                counts[a_tail["act"], b_row0["act"]] += 1
    elif a_tail["rv"] and 0 <= a_tail["act"] < a:
        ends[a_tail["act"]] += 1
    return DFG(counts, starts, ends)


def _dfg_stitch(ctx: engine.StitchCtx):
    return stitch_dfg_state(ctx.a.state, ctx.b.state, ctx.a.tail,
                            ctx.b.head["rows"][0], ctx.straddle), {}


@lru_cache(maxsize=None)
def _dfg_kernel(num_activities: int, impl: str | None) -> engine.ChunkKernel:
    a = num_activities
    # "matmul" is a pair_count-only lowering; histograms take the scatter
    hist_impl = "ref" if impl == "matmul" else impl

    def init(device):
        state = DFG(torch.zeros((a, a), dtype=torch.int32, device=device),
                    torch.zeros(a, dtype=torch.int32, device=device),
                    torch.zeros(a, dtype=torch.int32, device=device))
        return state, engine.init_row_carry(device)

    def update(state, carry, chunk):
        adj = engine.adjacent(chunk, carry)
        # each count lands on the state inside the kernel (into=): on a
        # card one call is the kernel's two nodes, the bool masks read as
        # they are; integer sums, so bitwise state + counts
        counts = pair_count(adj.prev_act, adj.act, a, weights=adj.pair,
                            into=state.counts, impl=impl)
        starts = histogram(adj.act, a, weights=adj.is_start,
                           into=state.starts, impl=hist_impl)
        ends = histogram(adj.prev_act, a, weights=adj.end_prev,
                         into=state.ends, impl=hist_impl)
        return DFG(counts, starts, ends), engine.next_row_carry(carry, chunk)

    def finalize(state, carry):
        # O(1) halo update (the stream's final end activity), not an inner loop
        last_end = carry["exists"] & carry["rv"]
        ends = _add_at(state.ends, carry["act"], last_end)
        return DFG(state.counts, state.starts, ends)

    return engine.ChunkKernel(f"dfg[{impl or 'auto'}]", init, update,
                              engine.tree_sum, finalize,
                              columns=(CASE, ACTIVITY), stitch=_dfg_stitch)


# ------------------------------------------------- whole-log entry points
def dfg_shift_count(frame: EventFrame, num_activities: int,
                    impl: str | None = None) -> DFG:
    """Paper §5.4 strategy 2, composed from the §5.3 ops verbatim.

    sort -> shift -> concat -> proj(case == case.2) -> mergstrv -> histogram.
    Kept in its literal whole-log form for paper fidelity; the streaming
    equivalent is ``dfg_kernel(..., method="segment")``.  ``mergstrv``'s
    overflow guard reads two maxima back to the host.
    """
    shifted = ops.shift(frame)
    both = ops.concat(frame, shifted, ".2")
    both = ops.proj(both, both[CASE] == both[CASE + ".2"])
    both = ops.mergstrv(both, "df:pair", ACTIVITY, ACTIVITY + ".2", num_activities)
    keep = both.rows_valid()
    flat = histogram(both["df:pair"], num_activities * num_activities,
                     weights=keep, impl=impl)
    counts = flat.reshape(num_activities, num_activities)
    is_start, is_end = _boundaries(frame[CASE], frame.rows_valid())
    act = frame[ACTIVITY]
    starts = histogram(act, num_activities, weights=is_start, impl=impl)
    ends = histogram(act, num_activities, weights=is_end, impl=impl)
    return DFG(counts, starts, ends)


def dfg_segment(frame: EventFrame, num_activities: int) -> DFG:
    """Paper §5.4 strategy 1 (map-reduce): the single-chunk special case of
    ``dfg_kernel(..., "segment")``."""
    return engine.run_single(dfg_kernel(num_activities, "segment"), frame)


def dfg_matmul(frame: EventFrame, num_activities: int) -> DFG:
    """Counts as one-hot matmuls; the single-chunk special case of
    ``dfg_kernel(..., "matmul")``."""
    return engine.run_single(dfg_kernel(num_activities, "matmul"), frame)


def dfg(frame: EventFrame, num_activities: int, method: str = "auto") -> DFG:
    """Front door. ``method`` in {"auto", "shift", "segment", "matmul", "kernel"}."""
    if method == "shift":
        return dfg_shift_count(frame, num_activities)
    return engine.run_single(dfg_kernel(num_activities, method), frame)


engine.register_kernel(engine.KernelSpec(
    "dfg",
    make=lambda dims, method="auto": dfg_kernel(dims.num_activities, method),
    columns=(CASE, ACTIVITY),
    sharded_state="dfg",
    from_sharded=lambda state, **_: state,
    doc="directly-follows graph (counts + start/end histograms)"))
