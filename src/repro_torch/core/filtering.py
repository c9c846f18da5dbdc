"""Event- and case-level filters on EventFrames (paper §6 / PM4Py parity).

Event-level filtering is the paper's O(N) columnar op — stateless, so it
chunks trivially. Case-level filtering ("keep every event of any case that
has property P") is the operation the paper calls out as needing custom
dataframe techniques — a two-phase mask broadcast: per-case predicate via
segment reduction, then expansion back to events through the case segment
ids.  Both phases are expressed over the chunk-kernels of ``core.engine``:
phase one is a mergeable or/size reduction (streams over EDF row groups),
phase two is a second pass that re-derives global segment ids per chunk
from a carry and narrows each chunk's ``row_valid``.

The eager ``filter_*`` entry points warn ``DeprecationWarning`` as the JAX
package's do: new code goes through the Dataset facade
(``repro_torch.open(...)``), which pushes the same masks down to pruned
scans.
"""
from __future__ import annotations

import warnings
from functools import lru_cache

import torch

from repro_torch.kernels.segment_ops import histogram, segment_reduce

from . import engine, ops
from .eventframe import ACTIVITY, CASE, EventFrame
from .stats import _impl, _seg_carry, case_sizes_kernel


def isin_mask(col: torch.Tensor, values) -> torch.Tensor:
    """Membership mask by sorted binary search — O(N log V) time, O(N + V)
    memory.  (The obvious ``col[:, None] == vals[None, :]`` broadcast
    materializes an (N, V) boolean: an O(N*V) blowup that runs out of
    memory when filtering a big log on a high-cardinality value set.)
    """
    vals = torch.as_tensor(values, device=col.device).reshape(-1)
    if vals.numel() == 0:
        return torch.zeros(col.shape, dtype=torch.bool, device=col.device)
    dtype = torch.promote_types(vals.dtype, col.dtype)
    vals = torch.sort(vals.to(dtype)).values
    key = col.to(dtype)
    slot = torch.clamp(torch.searchsorted(vals, key), 0, vals.numel() - 1)
    return vals[slot] == key


def time_range_mask(frame: EventFrame, name: str, lo, hi) -> torch.Tensor:
    """``lo <= frame[name] <= hi`` on valid cells."""
    col = frame[name]
    return (col >= lo) & (col <= hi) & frame.cell_valid(name)


def _warn_deprecated(old: str, verb: str) -> None:
    """The eager ``filter_*`` entry points are deprecated shims over the
    same masks the ``repro_torch.dataset`` facade pushes down — behavior
    is unchanged (bitwise), but new code should go through the facade so
    the planner can skip I/O and pick the engine."""
    warnings.warn(
        f"repro_torch.core.filtering.{old} is deprecated; use the Dataset "
        f"facade: repro_torch.open(...).{verb}", DeprecationWarning,
        stacklevel=3)


def filter_attr_values(frame: EventFrame, name: str, values, keep: bool = True) -> EventFrame:
    """Keep (or drop) events whose ``name`` is in ``values`` (event-level).

    .. deprecated:: use the Dataset facade's ``filter(col(name).isin(values))``.
    """
    _warn_deprecated("filter_attr_values",
                     "filter(col(name).isin(values))  # ~ for keep=False")
    m = isin_mask(frame[name], values)
    return ops.proj(frame, m if keep else ~m)


def filter_time_range(frame: EventFrame, name: str, lo, hi) -> EventFrame:
    """Keep events with ``lo <= frame[name] <= hi`` (event-level).

    A cell whose epsilon (validity) flag is off never matches: the stored
    sentinel value of a missing timestamp falling inside ``[lo, hi]`` must
    not resurrect the row, so the range mask is ANDed with ``cell_valid``.

    .. deprecated:: use the Dataset facade's ``filter(col(name).between(lo, hi))``.
    """
    _warn_deprecated("filter_time_range", "filter(col(name).between(lo, hi))")
    return ops.proj(frame, time_range_mask(frame, name, lo, hi))


def _case_mask_to_event_mask(case_seg: torch.Tensor,
                             case_keep: torch.Tensor) -> torch.Tensor:
    # an id past the mask reads its last entry, as JAX's clamped gather does
    return case_keep[case_seg.long().clamp(0, case_keep.shape[0] - 1)]


# --------------------------------------------------- case-level, phase one
def cases_with_value_kernel(column: str, value: int, num_cases: int,
                            backend: str | None = None) -> engine.ChunkKernel:
    """Per-case predicate "case has an event with ``column == value``" as a
    chunk-kernel; state is the (num_cases,) keep mask, merged by logical
    or.  ``cases_containing_kernel`` is the activity-column special case."""
    return _cases_with_value_kernel(str(column), int(value), int(num_cases),
                                    _impl(backend))


def cases_containing_kernel(activity: int, num_cases: int,
                            backend: str | None = None) -> engine.ChunkKernel:
    """Per-case predicate "case contains ``activity``" as a chunk-kernel."""
    return cases_with_value_kernel(ACTIVITY, activity, num_cases, backend)


@lru_cache(maxsize=None)
def _cases_with_value_kernel(column: str, value: int, num_cases: int,
                             impl: str | None) -> engine.ChunkKernel:

    def init(device):
        return (torch.zeros(num_cases, dtype=torch.bool, device=device),
                _seg_carry(device))

    def update(state, carry, chunk):
        adj = engine.adjacent(chunk, carry)
        seg = engine.global_segments(adj, carry)
        hit = (chunk[column] == value) & adj.rv
        # or-reduce per case == segment max over the boolean hit column
        state = state | segment_reduce(hit, seg, num_cases, "max", impl=impl)
        return state, engine.next_row_carry(carry, chunk, seg=seg[-1])

    return engine.ChunkKernel(
        f"cases_with_value[{column}={value},{impl or 'auto'}]",
        init, update, torch.logical_or, lambda s, c: s)


def streaming_cases_containing(chunks, activity: int, num_cases: int) -> torch.Tensor:
    """Phase one over a chunk stream: the per-case keep mask."""
    return engine.run_streaming(cases_containing_kernel(activity, num_cases),
                                chunks)


def streaming_case_size_keep(chunks, min_events: int, max_events: int,
                             num_cases: int) -> torch.Tensor:
    sizes = engine.run_streaming(case_sizes_kernel(num_cases), chunks)
    return (sizes >= min_events) & (sizes <= max_events)


# --------------------------------------------------- case-level, phase two
def stream_apply_case_mask(chunks, case_keep: torch.Tensor):
    """Second pass: narrow each chunk's ``row_valid`` by its case's verdict.

    Re-derives global segment ids with the same carry logic as phase one, so
    a case split across chunks is consistently kept or dropped.  Yields
    chunks lazily — peak residency stays one chunk.  Each chunk must lie on
    ``case_keep``'s device.
    """
    s = case_keep.shape[0]
    carry = _seg_carry(case_keep.device)
    for chunk in chunks:
        if chunk.nrows == 0:
            yield chunk
            continue
        adj = engine.adjacent(chunk, carry)
        seg = engine.global_segments(adj, carry)
        keep = case_keep[seg.long().clamp(0, s - 1)] & (seg < s)
        carry = engine.next_row_carry(carry, chunk, seg=seg[-1])
        yield ops.proj(chunk, keep)


# ------------------------------------------------- whole-log entry points
def filter_cases_containing(frame: EventFrame, activity: int, num_cases: int) -> EventFrame:
    """Case-level: keep all events of cases that contain ``activity``.

    Requires frame sorted by (case, time); the single-chunk special case of
    ``cases_containing_kernel`` + mask broadcast.

    .. deprecated:: use the Dataset facade's ``filter(cases_containing(activity))``.
    """
    _warn_deprecated("filter_cases_containing",
                     "filter(cases_containing(activity))")
    kernel = cases_containing_kernel(activity, num_cases)
    state, carry = kernel.init(frame.device)
    case_keep, _ = kernel.update(state, carry, frame)
    seg, _ = ops.segment_ids_sorted(frame[CASE])
    return ops.proj(frame, _case_mask_to_event_mask(seg, case_keep))


def filter_case_size(frame: EventFrame, min_events: int, max_events: int, num_cases: int) -> EventFrame:
    """Case-level: keep cases whose (valid-)event count is within bounds.

    .. deprecated:: use the Dataset facade's ``filter(case_size(lo, hi))``.
    """
    _warn_deprecated("filter_case_size", "filter(case_size(lo, hi))")
    from .stats import case_sizes

    sizes = case_sizes(frame, num_cases)
    case_keep = (sizes >= min_events) & (sizes <= max_events)
    seg, _ = ops.segment_ids_sorted(frame[CASE])
    return ops.proj(frame, _case_mask_to_event_mask(seg, case_keep))


def most_common_activity(frame: EventFrame, num_activities: int) -> torch.Tensor:
    """The paper's Table-5 filter target: the most frequent activity (the
    first one on a tie), as a 0-d int32 tensor on the frame's device (the
    dtype of JAX's ``jnp.argmax``)."""
    counts = histogram(frame[ACTIVITY], num_activities,
                       weights=frame.rows_valid())
    return torch.argmax(counts).to(torch.int32)


def streaming_most_common_activity(chunks, num_activities: int) -> int:
    from .stats import activity_counts_kernel

    counts = engine.run_streaming(activity_counts_kernel(num_activities), chunks)
    return int(torch.argmax(counts))
