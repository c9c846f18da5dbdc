"""Chunked out-of-core execution engine — mergeable chunk-kernels.

The paper's headline scenario (Table 6) is a log that does *not* fit in
device memory.  This module restructures log algorithms around
device-sized partitions of a (case, time)-sorted log: an algorithm is a
:class:`ChunkKernel` — a 4-tuple ``(init, update, merge, finalize)``::

    state, carry = kernel.init(device)
    for chunk in chunks:                      # EventFrame chunks, in order
        state, carry = kernel.update(state, carry, chunk)
    result = kernel.finalize(state, carry)

* ``state`` is the mergeable partial result (count matrices, histograms);
  ``merge(a, b)`` combines the states of two runs over consecutive log
  partitions whose boundary rows were stitched with carries.
* ``carry`` is the one-row halo: the last row of the previous chunk (case
  id, activity, timestamp, row-validity, and an ``exists`` flag that is
  False only before the first row), plus kernel-specific streaming state.
  The carry stitches directly-follows pairs and case starts/ends across
  chunk boundaries, so *any* chunking of a sorted log yields results
  identical to the whole-log pass — including cases split across many
  chunks.

State and carry are tensors on one device, given to ``init``:
:func:`run_streaming` takes it from the chunk source.  A carry entry is a
0-d tensor, and ``update`` reads no tensor value back to the host (no
``.item()``, no Python branch on a tensor): a sync per chunk would stall
the stream.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, NamedTuple

import numpy as np
import torch

from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame

State = Any
Carry = dict
Chunk = EventFrame


@dataclasses.dataclass(frozen=True)
class ChunkKernel:
    """A log algorithm in mergeable chunk form (see module docstring).

    ``mask_exact`` declares that rows masked out by ``row_valid``
    contribute nothing to the state (they may still move the carry's case
    bookkeeping).  ``columns`` names the event columns ``update`` reads (the
    projection a scan must materialize); the empty tuple means "unknown —
    read everything".
    """

    name: str
    init: Callable[[Any], tuple[State, Carry]]
    update: Callable[[State, Carry, Chunk], tuple[State, Carry]]
    merge: Callable[[State, State], State]
    finalize: Callable[[State, Carry], Any]
    mask_exact: bool = True
    columns: tuple = ()


# ------------------------------------------------------- kernel registry
class Dims(NamedTuple):
    """The two capacity dimensions that size every kernel's state."""

    num_activities: int
    num_cases: int


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A terminal mining verb as *data*: the registry entry a generic driver
    runs.

    * ``make(dims, **kwargs)`` — build the :class:`ChunkKernel`;
    * ``columns`` — the event columns the kernel's ``update`` reads;
    * ``doc`` — one line for listings.
    """

    name: str
    make: Callable[..., ChunkKernel]
    columns: tuple
    doc: str = ""


_KERNEL_SPECS: dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    """Register (or replace) a terminal verb; returns the spec for chaining."""
    _KERNEL_SPECS[spec.name] = spec
    return spec


def _load_standard_specs() -> None:
    # algorithm modules register their specs at import time; the port has
    # the DFG, the statistics, the variants, the performance overlays,
    # discovery and the graph verbs (imported here, never at module top:
    # repro_torch.graph.verbs imports this module)
    from . import discovery, dfg, performance, stats, variants  # noqa: F401
    import repro_torch.graph.verbs  # noqa: F401


def kernel_spec(name: str) -> KernelSpec:
    """Look up a registered verb by name (KeyError lists what exists and
    suggests close matches for typos)."""
    if name not in _KERNEL_SPECS:
        _load_standard_specs()
    try:
        return _KERNEL_SPECS[name]
    except KeyError:
        import difflib

        close = difflib.get_close_matches(name, _KERNEL_SPECS, n=3)
        hint = f" (did you mean {' / '.join(map(repr, close))}?)" if close else ""
        raise KeyError(f"no kernel spec named {name!r}{hint}; registered: "
                       f"{sorted(_KERNEL_SPECS)}") from None


def kernel_specs() -> dict[str, KernelSpec]:
    """Snapshot of the registry."""
    _load_standard_specs()
    return dict(_KERNEL_SPECS)


# --------------------------------------------------------------- carries
# dtype of each standard carry entry (case ids stay int64, as in the frame;
# the ``*2`` entries are discovery's two-back row)
CARRY_DTYPES = {"case": torch.int64, "act": torch.int32, "ts": torch.float32,
                "rv": torch.bool, "exists": torch.bool,
                "case2": torch.int64, "act2": torch.int32, "rv2": torch.bool,
                "exists2": torch.bool}


def init_row_carry(device, **extra) -> Carry:
    """The halo before the first row: ``exists=False`` masks everything."""
    init = {"case": -1, "act": 0, "ts": 0.0, "rv": False, "exists": False}
    carry = {k: torch.tensor(v, dtype=CARRY_DTYPES[k], device=device)
             for k, v in init.items()}
    carry.update(extra)
    return carry


def next_row_carry(carry: Carry, frame: Chunk, **extra) -> Carry:
    """Carry for the next chunk: this chunk's last row + kernel extras (0-d
    tensors on the chunk's device; nothing is read back to the host)."""
    out = dict(carry)
    out["case"] = frame[CASE][-1].to(torch.int64)
    out["act"] = frame[ACTIVITY][-1].to(torch.int32)
    if TIMESTAMP in frame:
        out["ts"] = frame[TIMESTAMP][-1].to(torch.float32)
    out["rv"] = frame.rows_valid()[-1]
    out["exists"] = torch.ones((), dtype=torch.bool, device=frame.device)
    out.update(extra)
    return out


def carry_to_numpy(carry: Carry) -> dict[str, np.ndarray]:
    """A carry as numpy scalars (what the JAX package's carry holds)."""
    return {k: v.cpu().numpy() for k, v in carry.items()}


def carry_from_numpy(d: Mapping[str, np.ndarray], device) -> Carry:
    """A carry from numpy values — e.g. the JAX package's carry after it
    folded a prefix of the stream, so the port can fold the rest.  uint32
    entries (the variants' hash state ``h1``/``h2``) become int32 tensors
    holding the same bit patterns, the form the port's kernels take."""
    out = {}
    for k, v in d.items():
        arr = np.asarray(v)
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        dtype = CARRY_DTYPES.get(k)
        t = torch.from_numpy(arr.copy()) if dtype is None else \
            torch.tensor(arr.item(), dtype=dtype)
        out[k] = t.to(device)
    return out


class Adjacent(NamedTuple):
    """Per-row tensors pairing each row with its predecessor (carry at row 0).

    ``pair`` marks directly-follows pairs (same case, both rows valid),
    ``new_seg`` marks case-segment starts *ignoring* validity (as
    ``ops.segment_ids_sorted`` does), ``is_start``/``end_prev`` are the
    start/end-activity events.  ``end_prev[i]`` says row ``i-1`` (the carry
    for ``i=0``) ended its case; the final row's end is resolved by
    ``finalize`` from the last carry.
    """

    case: torch.Tensor
    act: torch.Tensor
    rv: torch.Tensor
    ts: torch.Tensor
    prev_case: torch.Tensor
    prev_act: torch.Tensor
    prev_rv: torch.Tensor
    prev_ts: torch.Tensor
    prev_exists: torch.Tensor
    new_seg: torch.Tensor      # bool — row starts a new case segment
    pair: torch.Tensor         # bool — (prev row -> row) is a valid DF pair
    is_start: torch.Tensor     # bool — row is a start activity
    end_prev: torch.Tensor     # bool — previous row was an end activity


def _with_prev(head: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return torch.cat([head.reshape(1).to(col.dtype), col[:-1]])


def adjacent(frame: Chunk, carry: Carry, *, need_ts: bool = False) -> Adjacent:
    case = frame[CASE]
    act = frame[ACTIVITY]
    rv = frame.rows_valid()
    n = case.shape[0]
    if TIMESTAMP in frame:
        ts = frame[TIMESTAMP].to(torch.float32)
    elif need_ts:
        raise KeyError(TIMESTAMP)   # timed kernel on an untimed frame
    else:
        ts = torch.zeros(n, dtype=torch.float32, device=case.device)
    prev_case = _with_prev(carry["case"], case)
    prev_act = _with_prev(carry["act"], act)
    prev_ts = _with_prev(carry["ts"], ts)
    prev_rv = _with_prev(carry["rv"], rv)
    prev_exists = torch.cat([carry["exists"].reshape(1),
                             torch.ones(n - 1, dtype=torch.bool,
                                        device=case.device)])
    same = case == prev_case
    new_seg = ~same | ~prev_exists
    pair = same & prev_exists & rv & prev_rv
    is_start = new_seg & rv
    end_prev = ~same & prev_exists & prev_rv
    return Adjacent(case, act, rv, ts, prev_case, prev_act, prev_rv, prev_ts,
                    prev_exists, new_seg, pair, is_start, end_prev)


def global_segments(adj: Adjacent, carry: Carry) -> torch.Tensor:
    """Global case-segment ids for a chunk: ``carry['seg']`` continues the
    numbering (``-1`` before the first row, so the first segment is 0)."""
    return carry["seg"] + torch.cumsum(adj.new_seg, 0, dtype=torch.int32)


# --------------------------------------------------------------- drivers
def run_streaming(kernel: ChunkKernel, chunks: Iterable[Chunk], device=None):
    """Fold a kernel over an ordered chunk stream; O(chunk) residency.

    The state's device is ``device``, else the source's ``device``
    attribute (``ChunkedEventFrame``), else the first chunk's.
    """
    if device is None:
        device = getattr(chunks, "device", None)
    state = carry = None
    if device is not None:
        state, carry = kernel.init(device)
    for chunk in chunks:
        if chunk.nrows == 0:        # empty source / empty tail group
            continue
        if state is None:
            state, carry = kernel.init(chunk.device)
        state, carry = kernel.update(state, carry, chunk)
    if state is None:
        raise ValueError("run_streaming: empty chunk stream and no device")
    return kernel.finalize(state, carry)


def run_single(kernel: ChunkKernel, frame: Chunk):
    """The single-chunk special case: how the whole-log entry points route
    through the same kernel code as the streaming path."""
    state, carry = kernel.init(frame.device)
    state, carry = kernel.update(state, carry, frame)
    return kernel.finalize(state, carry)


def union_columns(column_sets: Iterable[tuple]) -> tuple:
    """Union column requirements in first-seen order; any *unknown* set
    (the empty tuple) makes the union unknown — read everything."""
    out: list = []
    for cols in column_sets:
        if not cols:
            return ()
        for c in cols:
            if c not in out:
                out.append(c)
    return tuple(out)


def compose(kernels: Mapping[str, ChunkKernel]) -> ChunkKernel:
    """Fuse kernels into one that shares a single pass over the stream.

    States/carries are dicts keyed like ``kernels``; ``finalize`` returns a
    dict of results.  One disk scan computes a whole dashboard panel.  The
    fused kernel's ``columns`` is the union of the members' column
    requirements (unknown if any member's is unknown) and ``mask_exact``
    the conjunction.
    """
    names = tuple(kernels)

    def init(device):
        pairs = {k: kernels[k].init(device) for k in names}
        return ({k: s for k, (s, _) in pairs.items()},
                {k: c for k, (_, c) in pairs.items()})

    def update(state, carry, chunk):
        out_s, out_c = {}, {}
        for k in names:
            out_s[k], out_c[k] = kernels[k].update(state[k], carry[k], chunk)
        return out_s, out_c

    def merge(a, b):
        return {k: kernels[k].merge(a[k], b[k]) for k in names}

    def finalize(state, carry):
        return {k: kernels[k].finalize(state[k], carry[k]) for k in names}

    return ChunkKernel("compose(" + ",".join(names) + ")",
                       init, update, merge, finalize,
                       mask_exact=all(k.mask_exact for k in kernels.values()),
                       columns=union_columns(
                           k.columns for k in kernels.values()))


def tree_sum(a, b):
    """The common merge: leafwise addition of two partial states
    (tensors, dicts of them, or dataclasses of them)."""
    if isinstance(a, torch.Tensor):
        return a + b
    if isinstance(a, dict):
        return {k: tree_sum(a[k], b[k]) for k in a}
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: tree_sum(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    raise TypeError(f"tree_sum: unsupported state leaf {type(a).__name__}")


# --------------------------------------------- convenience streaming API
# Thin front doors; kernel factories live next to their whole-log twins
# (lazy imports keep core.<algo> -> engine one-directional).
def streaming_dfg(chunks, num_activities: int, method: str = "segment"):
    from .dfg import dfg_kernel
    return run_streaming(dfg_kernel(num_activities, method=method), chunks)


def streaming_activity_counts(chunks, num_activities: int):
    from .stats import activity_counts_kernel
    return run_streaming(activity_counts_kernel(num_activities), chunks)


def streaming_case_sizes(chunks, num_cases: int):
    from .stats import case_sizes_kernel
    return run_streaming(case_sizes_kernel(num_cases), chunks)


def streaming_case_durations(chunks, num_cases: int):
    from .stats import case_durations_kernel
    return run_streaming(case_durations_kernel(num_cases), chunks)


def streaming_sojourn_times(chunks, num_activities: int):
    from .stats import sojourn_times_kernel
    return run_streaming(sojourn_times_kernel(num_activities), chunks)


def streaming_variant_fingerprints(chunks, num_cases: int):
    from .variants import variants_kernel
    return run_streaming(variants_kernel(num_cases), chunks)


def streaming_variant_counts(chunks, num_cases: int):
    from .variants import streaming_variant_counts as _svc
    return _svc(chunks, num_cases)


def streaming_performance_dfg(chunks, num_activities: int):
    from .performance import performance_dfg_kernel
    return run_streaming(performance_dfg_kernel(num_activities), chunks)


def streaming_eventually_follows(chunks, num_activities: int):
    from .performance import eventually_follows_kernel
    return run_streaming(eventually_follows_kernel(num_activities), chunks)
