"""Case/event statistics on EventFrames (segment reductions, all O(N)).

Each statistic is a mergeable chunk-kernel (``core.engine``): the public
whole-log functions are the single-chunk special case, and the same update
streams over EDF row groups for logs larger than device memory.  Cases
split across chunk boundaries are stitched by the carry (global segment id
+ last-row halo), so any chunking of a (case,time)-sorted log matches the
whole-log result.

Inner loops are the named primitives of ``repro_torch.kernels.segment_ops``
(dispatched by device, see ``core.backend``): per-case reductions are
``segment_reduce`` over the sorted global segment ids, per-activity
aggregations are ``histogram``.  Integer counting is exact in any order;
the float sojourn *totals* are order-sensitive and take the row-order fold
onto the running state (``into=``), keeping streaming == whole-log bitwise.

``backend`` selects the lowering as ``core.backend.resolve`` does: ``None``
or ``"auto"`` goes by the chunk's device, ``"ref"`` forces the plain
versions, ``"cuda"`` the kernels.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch import trace
from repro_torch.kernels.segment_ops import histogram, segment_reduce

from . import backend as _backend
from . import engine
from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame

_FBIG = torch.finfo(torch.float32).max


def _impl(backend: str | None) -> str | None:
    """The ``impl=`` every primitive call of a kernel passes (``None`` goes
    by the chunk's device at each call)."""
    if backend is None or backend == "auto":
        return None
    _backend.resolve("cpu", backend)      # validates the name
    return backend


def _seg_carry(device) -> engine.Carry:
    return engine.init_row_carry(
        device, seg=trace.to_device(-1, device, torch.int32))


# ------------------------------------------------------------ chunk kernels
def case_sizes_kernel(num_cases: int, backend: str | None = None) -> engine.ChunkKernel:
    """Valid-event count per case, indexed by global segment id."""
    return _case_sizes_kernel(num_cases, _impl(backend))


@lru_cache(maxsize=None)
def _case_sizes_kernel(num_cases: int, impl: str | None) -> engine.ChunkKernel:

    def init(device):
        return (torch.zeros(num_cases, dtype=torch.int32, device=device),
                _seg_carry(device))

    def update(state, carry, chunk):
        adj = engine.adjacent(chunk, carry)
        seg = engine.global_segments(adj, carry)
        state = state + segment_reduce(adj.rv.to(torch.int32), seg,
                                       num_cases, "sum", impl=impl)
        return state, engine.next_row_carry(carry, chunk, seg=seg[-1])

    def stitch(ctx):
        # per-row valid counts are position-free: relabel b's local segment
        # slots and add (a straddling segment's halves land in one slot)
        return ctx.a.state + engine.shift_segments(ctx.b.state,
                                                   ctx.offset), {}

    return engine.ChunkKernel(f"case_sizes[{num_cases},{impl or 'auto'}]",
                              init, update, engine.tree_sum,
                              lambda s, c: s, columns=(ACTIVITY, CASE),
                              stitch=stitch)


def case_durations_kernel(num_cases: int, backend: str | None = None) -> engine.ChunkKernel:
    """max(ts) - min(ts) per case; state = (tmin, tmax) accumulators."""
    return _case_durations_kernel(num_cases, _impl(backend))


@lru_cache(maxsize=None)
def _case_durations_kernel(num_cases: int, impl: str | None) -> engine.ChunkKernel:

    def init(device):
        state = (torch.full((num_cases,), _FBIG, dtype=torch.float32,
                            device=device),
                 torch.full((num_cases,), -_FBIG, dtype=torch.float32,
                            device=device))
        return state, _seg_carry(device)

    def update(state, carry, chunk):
        tmin, tmax = state
        adj = engine.adjacent(chunk, carry, need_ts=True)
        seg = engine.global_segments(adj, carry)
        tmin = torch.minimum(tmin, segment_reduce(
            torch.where(adj.rv, adj.ts, float("inf")), seg, num_cases, "min",
            impl=impl))
        tmax = torch.maximum(tmax, segment_reduce(
            torch.where(adj.rv, adj.ts, float("-inf")), seg, num_cases, "max",
            impl=impl))
        return (tmin, tmax), engine.next_row_carry(carry, chunk, seg=seg[-1])

    def merge(a, b):
        return (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1]))

    def finalize(state, carry):
        tmin, tmax = state
        return torch.where(tmax >= tmin, tmax - tmin, 0.0)

    def stitch(ctx):
        amin, amax = ctx.a.state
        bmin, bmax = ctx.b.state
        # min/max are exact and order-free: shift b's slots (identity
        # fills) and combine elementwise
        return (torch.minimum(amin, engine.shift_segments(
                    bmin, ctx.offset, _FBIG)),
                torch.maximum(amax, engine.shift_segments(
                    bmax, ctx.offset, -_FBIG))), {}

    return engine.ChunkKernel(f"case_durations[{num_cases},{impl or 'auto'}]",
                              init, update, merge, finalize,
                              columns=(ACTIVITY, CASE, TIMESTAMP),
                              stitch=stitch)


def activity_counts_kernel(num_activities: int, backend: str | None = None) -> engine.ChunkKernel:
    """Per-activity histogram — stateless per chunk, carry only pro forma."""
    return _activity_counts_kernel(num_activities, _impl(backend))


@lru_cache(maxsize=None)
def _activity_counts_kernel(num_activities: int, impl: str | None) -> engine.ChunkKernel:
    a = num_activities

    def init(device):
        return (torch.zeros(a, dtype=torch.int32, device=device),
                engine.init_row_carry(device))

    def update(state, carry, chunk):
        state = histogram(chunk[ACTIVITY], a, weights=chunk.rows_valid(),
                          into=state, impl=impl)
        return state, engine.next_row_carry(carry, chunk)

    return engine.ChunkKernel(f"activity_counts[{a},{impl or 'auto'}]",
                              init, update, engine.tree_sum,
                              lambda s, c: s, columns=(ACTIVITY, CASE),
                              # boundary-free integer histogram: the merge
                              # IS the stitch
                              stitch=lambda ctx: (ctx.a.state + ctx.b.state,
                                                  {}))


def sojourn_times_kernel(num_activities: int, backend: str | None = None) -> engine.ChunkKernel:
    """Mean inter-event time by *source* activity; boundary pairs stitched
    by the carry's (case, act, ts) halo."""
    return _sojourn_times_kernel(num_activities, _impl(backend))


@lru_cache(maxsize=None)
def _sojourn_times_kernel(num_activities: int, impl: str | None) -> engine.ChunkKernel:
    a = num_activities

    def init(device):
        state = (torch.zeros(a, dtype=torch.float32, device=device),
                 torch.zeros(a, dtype=torch.int32, device=device))
        return state, engine.init_row_carry(device)

    def update(state, carry, chunk):
        tot, cnt = state
        adj = engine.adjacent(chunk, carry, need_ts=True)
        dt = torch.where(adj.pair, adj.ts - adj.prev_ts, 0.0)
        # float accumulation is order-sensitive: into= folds each row's dt
        # onto the running state in row order, keeping streaming ==
        # whole-log bitwise (a per-chunk sum added on would regroup them)
        tot = histogram(adj.prev_act, a, weights=dt, into=tot, impl=impl)
        cnt = histogram(adj.prev_act, a, weights=adj.pair, into=cnt, impl=impl)
        return (tot, cnt), engine.next_row_carry(carry, chunk)

    def finalize(state, carry):
        tot, cnt = state
        return tot / torch.clamp(cnt, min=1)

    # stitch=None: the float32 dt totals accumulate in row order; regrouping
    # them is not bitwise-stable, so the kernel keeps the sequential fold
    return engine.ChunkKernel(f"sojourn_times[{a},{impl or 'auto'}]",
                              init, update, engine.tree_sum, finalize,
                              columns=(ACTIVITY, CASE, TIMESTAMP))


# ------------------------------------------------- whole-log entry points
def case_sizes(frame: EventFrame, num_cases: int,
               backend: str | None = None) -> torch.Tensor:
    return engine.run_single(case_sizes_kernel(num_cases, backend), frame)


def case_durations(frame: EventFrame, num_cases: int,
                   backend: str | None = None) -> torch.Tensor:
    """max(ts) - min(ts) per case (sorted frame)."""
    return engine.run_single(case_durations_kernel(num_cases, backend), frame)


def activity_counts(frame: EventFrame, num_activities: int,
                    backend: str | None = None) -> torch.Tensor:
    return engine.run_single(activity_counts_kernel(num_activities, backend),
                             frame)


def sojourn_times(frame: EventFrame, num_activities: int,
                  backend: str | None = None) -> torch.Tensor:
    """Mean inter-event time by *source* activity (bottleneck analysis)."""
    return engine.run_single(sojourn_times_kernel(num_activities, backend),
                             frame)


def stats_kernel(num_activities: int, num_cases: int,
                 backend: str | None = None) -> engine.ChunkKernel:
    """All four statistics fused into one pass over the stream (one disk
    scan serves a whole dashboard panel)."""
    return engine.compose({
        "activity_counts": activity_counts_kernel(num_activities, backend),
        "case_sizes": case_sizes_kernel(num_cases, backend),
        "case_durations": case_durations_kernel(num_cases, backend),
        "sojourn_times": sojourn_times_kernel(num_activities, backend),
    })


engine.register_kernel(engine.KernelSpec(
    "activity_counts",
    make=lambda dims, backend=None: activity_counts_kernel(
        dims.num_activities, backend),
    columns=(ACTIVITY, CASE),
    doc="per-activity event histogram"))
engine.register_kernel(engine.KernelSpec(
    "case_sizes",
    make=lambda dims, backend=None: case_sizes_kernel(dims.num_cases, backend),
    columns=(ACTIVITY, CASE),
    doc="valid-event count per case"))
engine.register_kernel(engine.KernelSpec(
    "case_durations",
    make=lambda dims, backend=None: case_durations_kernel(
        dims.num_cases, backend),
    columns=(ACTIVITY, CASE, TIMESTAMP),
    doc="max(ts) - min(ts) per case"))
engine.register_kernel(engine.KernelSpec(
    "sojourn_times",
    make=lambda dims, backend=None: sojourn_times_kernel(
        dims.num_activities, backend),
    columns=(ACTIVITY, CASE, TIMESTAMP),
    doc="mean inter-event time by source activity"))
engine.register_kernel(engine.KernelSpec(
    "stats",
    make=lambda dims, backend=None: stats_kernel(
        dims.num_activities, dims.num_cases, backend),
    columns=(ACTIVITY, CASE, TIMESTAMP),
    doc="activity_counts + case_sizes + case_durations + sojourn_times, "
        "one fused pass"))
