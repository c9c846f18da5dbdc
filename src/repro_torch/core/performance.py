"""Performance-annotated DFG + eventually-follows graph (bottleneck analysis).

The paper's motivating analyses ("bottleneck analysis, remaining time
prediction, logical-temporal checking", §1) need *timed* relations, not just
counts.  Both structures below are single-pass columnar reductions, keeping
the Table-3/4 complexity story, and both are mergeable chunk-kernels
(``core.engine``), so they stream over logs larger than device memory —
with inner loops on the ``repro_torch.kernels.segment_ops`` primitives:

* ``performance_dfg`` — mean/total inter-event waiting time per
  directly-follows edge (the classic performance overlay).  Edge counts are
  one integer ``pair_count``; the float wait totals are a second
  ``pair_count`` with float weights, which folds each row onto the running
  state in row order (the ordered-fold kernel on a card, ``index_add_`` on
  the CPU), so streaming == whole-log bitwise.  The boundary pair of two
  chunks is stitched by the carry's (case, act, ts) halo.
* ``eventually_follows`` — counts of (a ... b) pairs within a case, the
  relation used by LTL-style checks.  The per-case *prefix* count vector is
  a ``segmented_scan`` over one-hot rows (integer-valued float32 below
  2^24, so exact); the contraction into the (A, A) matrix is a float32
  matrix product (``torch.matmul``, exact on these integers; TF32 is not
  enabled).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.kernels.segment_ops import (pair_count, segment_reduce,
                                             segmented_scan)

from . import engine, ops
from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame
from .stats import _impl


# ------------------------------------------------------------ chunk kernels
def performance_dfg_kernel(num_activities: int, backend: str | None = None) -> engine.ChunkKernel:
    """(counts, total wait) per directly-follows edge; mean at finalize."""
    return _performance_dfg_kernel(num_activities, _impl(backend))


@lru_cache(maxsize=None)
def _performance_dfg_kernel(num_activities: int, impl: str | None) -> engine.ChunkKernel:
    a = num_activities

    def init(device):
        state = (torch.zeros((a, a), dtype=torch.int32, device=device),
                 torch.zeros((a, a), dtype=torch.float32, device=device))
        return state, engine.init_row_carry(device)

    def update(state, carry, chunk):
        counts, total = state
        adj = engine.adjacent(chunk, carry, need_ts=True)
        dt = torch.where(adj.pair, adj.ts - adj.prev_ts, 0.0)
        counts = pair_count(adj.prev_act, adj.act, a, weights=adj.pair,
                            into=counts, impl=impl)
        # float wait totals are order-sensitive: into= folds each row's dt
        # onto the running state in row order
        total = pair_count(adj.prev_act, adj.act, a, weights=dt, into=total,
                           impl=impl)
        return (counts, total), engine.next_row_carry(carry, chunk)

    def finalize(state, carry):
        counts, total = state
        return counts, total / torch.clamp(counts, min=1)

    # stitch=None: the float32 wait totals accumulate in row order, so the
    # kernel keeps the sequential fold
    return engine.ChunkKernel(f"performance_dfg[{a},{impl or 'auto'}]",
                              init, update, engine.tree_sum, finalize,
                              columns=(ACTIVITY, CASE, TIMESTAMP))


def eventually_follows_kernel(num_activities: int, backend: str | None = None) -> engine.ChunkKernel:
    """EFG as a forward segmented scan; carry = open case's prefix vector."""
    return _eventually_follows_kernel(num_activities, _impl(backend))


@lru_cache(maxsize=None)
def _eventually_follows_kernel(num_activities: int, impl: str | None) -> engine.ChunkKernel:
    a = num_activities

    def init(device):
        state = torch.zeros((a, a), dtype=torch.float32, device=device)
        carry = engine.init_row_carry(
            device, prefix=torch.zeros(a, dtype=torch.float32, device=device))
        return state, carry

    def update(state, carry, chunk):
        adj = engine.adjacent(chunk, carry)
        cls = torch.arange(a, device=adj.act.device)
        onehot = ((adj.act.long()[:, None] == cls[None, :]) & adj.rv[:, None]
                  ).to(torch.float32)
        # inclusive segmented prefix counts (integer-valued f32 -> exact)
        incl, last = segmented_scan(onehot, adj.new_seg, carry["prefix"],
                                    "sum", impl=impl, assume_exact=True)
        prefixes = incl - onehot            # exclusive: earlier-events count
        state = state + prefixes.T @ onehot
        return state, engine.next_row_carry(carry, chunk, prefix=last)

    def finalize(state, carry):
        return state.to(torch.int32)

    def stitch(ctx):
        # b's lead-run rows scanned from a zero prefix; the concatenation
        # threads a's open prefix through them, adding exactly
        # outer(a.prefix, lead-run valid-activity histogram).  All values
        # are integer-valued float32 < 2^24, so the cross term is exact.
        state = ctx.a.state + ctx.b.state
        overrides = {}
        if ctx.straddle:
            hist = torch.zeros(a, dtype=torch.float32)
            for act, cnt in ctx.b.head["hist"].items():
                if 0 <= act < a:
                    hist[act] = cnt
            prefix = ctx.a.carry["prefix"]
            state = state + torch.outer(prefix, hist.to(prefix.device))
            if ctx.b.segments == 1:
                # the straddling case is still open: its true prefix is
                # both halves' counts
                overrides["prefix"] = prefix + ctx.b.carry["prefix"]
        return state, overrides

    return engine.ChunkKernel(f"eventually_follows[{a},{impl or 'auto'}]",
                              init, update, engine.tree_sum, finalize,
                              columns=(ACTIVITY, CASE), stitch=stitch)


# ------------------------------------------------- whole-log entry points
def performance_dfg(frame: EventFrame, num_activities: int,
                    backend: str | None = None):
    """(counts, mean_wait) per edge; frame sorted by (case, time)."""
    return engine.run_single(performance_dfg_kernel(num_activities, backend),
                             frame)


def eventually_follows(frame: EventFrame, num_activities: int,
                       backend: str | None = None) -> torch.Tensor:
    """EFG counts: efg[a, b] = #(event pairs i<j, same case, act_i=a, act_j=b);
    the single-chunk special case of :func:`eventually_follows_kernel`."""
    return engine.run_single(eventually_follows_kernel(num_activities, backend),
                             frame)


def remaining_time_targets(frame: EventFrame, backend: str | None = None) -> torch.Tensor:
    """Per-event remaining time to case end (regression targets for the
    'remaining time prediction' analysis).

    ``segment_reduce(op="max")`` over the case segments (exact — min/max is
    order-insensitive), broadcast back through the segment ids.
    """
    ts = frame[TIMESTAMP].to(torch.float32)
    seg, _ = ops.segment_ids_sorted(frame[CASE])
    tmax = segment_reduce(ts, seg, seg.shape[0], "max", impl=_impl(backend))
    return tmax[seg.long()] - ts


engine.register_kernel(engine.KernelSpec(
    "performance_dfg",
    make=lambda dims, backend=None: performance_dfg_kernel(
        dims.num_activities, backend),
    columns=(ACTIVITY, CASE, TIMESTAMP),
    doc="mean/total waiting time per directly-follows edge"))
engine.register_kernel(engine.KernelSpec(
    "eventually_follows",
    make=lambda dims, backend=None: eventually_follows_kernel(
        dims.num_activities, backend),
    columns=(ACTIVITY, CASE),
    doc="eventually-follows pair counts within cases"))
