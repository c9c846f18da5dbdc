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

from repro_torch import trace

from . import polyhash
from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame

State = Any
Carry = dict
Chunk = EventFrame


@dataclasses.dataclass(frozen=True)
class ChunkKernel:
    """A log algorithm in mergeable chunk form (see module docstring).

    ``mask_exact`` declares the kernel stays exact on a pruned stream:
    either rows masked out by ``row_valid`` contribute nothing to the state
    (they may still move the carry's case bookkeeping), or the kernel
    recovers what they would have contributed from the ghost-chunk
    metadata the query layer supplies.  ``columns`` names the event columns
    ``update`` reads (the projection a scan must materialize); the empty
    tuple means "unknown — read everything".

    ``ghost_sketch`` asks the query layer to attach per-segment affine
    polyhash maps (``core.polyhash.SKETCH_COLUMNS``, composed from EDF
    header sketches) to the ghost chunks it synthesizes: how the variants
    kernel replays the validity-blind hash of skipped runs without reading
    them.

    ``stitch`` is the kernel's *group-state algebra*: given a
    :class:`StitchCtx` pairing two :class:`GroupState` fresh folds, it
    returns the state (and carry overrides) of the fresh fold of the
    concatenation — an O(1) boundary-halo fix on top of elementwise
    combination.  ``None`` marks the kernel non-mergeable at the group
    level (order-sensitive float accumulation).  A stitch never writes into
    the tensors of the states it is given: cached states are merged again.
    """

    name: str
    init: Callable[[Any], tuple[State, Carry]]
    update: Callable[[State, Carry, Chunk], tuple[State, Carry]]
    merge: Callable[[State, State], State]
    finalize: Callable[[State, Carry], Any]
    mask_exact: bool = True
    columns: tuple = ()
    ghost_sketch: bool = False
    stitch: Callable[["StitchCtx"], tuple[State, dict]] | None = None


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
    * ``sharded_state`` — name of the distributed driver that produces this
      verb's mergeable state (``"dfg"`` / ``"discovery"`` / ``"variants"``,
      ``repro_torch.distributed.query``), or ``None`` when the verb has no
      exact distributed lowering (order-sensitive float sums; a stitchable
      verb then shards as a merge tree);
    * ``from_sharded(state, **kwargs)`` — the finalize mapping that
      distributed state to the verb's result (identity for the DFG, the
      model discovery step for alpha / heuristics);
    * ``doc`` — one line for listings;
    * ``members`` — for fused specs (:func:`compose_specs`): the member
      verb names, in collection order (empty for an ordinary verb).
    """

    name: str
    make: Callable[..., ChunkKernel]
    columns: tuple
    sharded_state: str | None = None
    from_sharded: Callable | None = None
    doc: str = ""
    members: tuple = ()


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
    carry = {k: trace.to_device(v, device, CARRY_DTYPES[k])
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


# ------------------------------------------------- group-state algebra
# A GroupState is the *fresh* fold of a kernel over one contiguous unit of
# the sorted log (a row group, a whole file): state + carry from ``init``,
# case segments numbered locally from 0, plus the boundary halo a later
# merge needs — the unit's leading row(s) and the lead run's
# histogram/affine summaries.  ``merge_group_states`` reconstructs, bitwise,
# the fresh fold of the concatenation of two units, so
#
#     finalize(merge_tree([fold_group(unit) for unit in units]))
#     ==  run_streaming(kernel, all chunks)            (bitwise)
#
# for every kernel with a ``stitch``.
@dataclasses.dataclass
class GroupState:
    """Fresh fold of one contiguous unit: mergeable, cacheable, re-usable.

    ``head`` / ``tail`` are the boundary halo (host-side Python values):
    ``head["rows"]`` holds up to two leading physical rows (the two-row
    stitch the L2-loop kernels need), ``head["hist"]`` the valid-activity
    histogram of the unit's *lead run* (all leading rows of its first
    case — the EFG cross term), ``head["affine"]`` the validity-blind
    polyhash map of that lead run (the variants hash correction).
    ``segments``/``rows`` count case segments (locally numbered from 0)
    and physical rows.  ``rows == 0`` is the merge identity.  The state and
    carry tensors are never written once the fold returns.
    """

    state: State
    carry: Carry
    head: dict | None
    tail: dict | None
    segments: int
    rows: int


class StitchCtx(NamedTuple):
    """Everything a kernel ``stitch`` may consult to merge ``a ++ b``:
    ``straddle`` says the boundary splits one case segment, ``offset`` is
    the relabel added to ``b``'s local segment ids (``a.segments``, minus
    one when the straddling segment keeps ``a``'s numbering)."""

    a: GroupState
    b: GroupState
    straddle: bool
    offset: int


def mergeable(kernel: ChunkKernel) -> bool:
    """Does this kernel support the group-state algebra (has a stitch)?"""
    return kernel.stitch is not None


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a state or carry tree (tensors, dicts, tuples, lists
    and dataclasses of them), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tensor_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensor_leaves(getattr(tree, f.name))]
    return []


def map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to each tensor, through the containers
    :func:`tensor_leaves` walks (dataclass and namedtuple types kept, dict
    keys and tuple order too); any other leaf comes back as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [map_tensors(fn, v) for v in tree]
        return tree._make(items) if hasattr(tree, "_make") else type(tree)(items)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def empty_group_state(kernel: ChunkKernel, device) -> GroupState:
    """The merge identity: the fresh fold of zero rows, on ``device`` (the
    port's ``init`` takes a device; the JAX package's takes none)."""
    state, carry = kernel.init(device)
    return GroupState(state, carry, None, None, 0, 0)


def shift_segments(arr: torch.Tensor, offset: int, fill=0) -> torch.Tensor:
    """Relabel a per-segment state vector by ``offset`` slots (how a merge
    maps ``b``'s local segment ids into the concatenation's numbering).
    Entries shifted past capacity drop — matching the sequential fold's
    out-of-range scatter drop.  Returns a new tensor (or ``arr`` itself for
    ``offset <= 0``); ``arr`` is never written."""
    if offset <= 0:
        return arr
    cap = arr.shape[0]
    out = torch.full_like(arr, fill)
    if offset < cap:
        out[offset:] = arr[:cap - offset]
    return out


def _compose4(a: tuple, b: tuple) -> tuple:
    """Compose two (mul1, add1, mul2, add2) affine-map quadruples."""
    m1, a1 = polyhash.compose(a[0], a[1], b[0], b[1])
    m2, a2 = polyhash.compose(a[2], a[3], b[2], b[3])
    return (m1, a1, m2, a2)


def _u32_host(col: torch.Tensor) -> torch.Tensor:
    """A uint32 column (bit patterns in int32, or ``torch.uint32``) as int64
    values in [0, 2^32), on its device."""
    if col.dtype == torch.uint32:
        col = col.view(torch.int32)
    return col.to(torch.int64) & polyhash.M32


def _chunk_halo(chunk: Chunk, lead_open: bool, heads_missing: int):
    """What :func:`fold_group` reads of one chunk, copied to the host in one
    transfer: the case-change count, the lead run's length ``k``, the first
    ``p`` rows' (case, act, rv) with ``p`` covering the lead run (when it
    may still be open) and the missing head rows, the last row, and, on a
    ghost chunk, the lead run's sketch maps.  On a card that is two small
    reads, never the chunk's columns."""
    case = chunk[CASE]
    n = case.shape[0]
    if n > 1:
        change = case[1:] != case[:-1]
        nchg, first = trace.host_read(
            torch.stack([change.sum(), torch.argmax(change.to(torch.int32))]),
            torch.Tensor.tolist)
    else:
        nchg, first = 0, 0
    k = first + 1 if nchg else n
    p = max(1, min(n, heads_missing), k if lead_open else 0)
    act = chunk[ACTIVITY]
    rv = chunk.rows_valid()
    parts = [case[:p].to(torch.int64), act[:p].to(torch.int64),
             rv[:p].to(torch.int64),
             torch.stack([case[-1].to(torch.int64), act[-1].to(torch.int64),
                          rv[-1].to(torch.int64)])]
    sketch = lead_open and polyhash.SK_MUL1 in chunk
    if sketch:
        parts += [_u32_host(chunk[c][:k]) for c in polyhash.SKETCH_COLUMNS]
    flat = trace.host_read(torch.cat(parts)).numpy()
    rows = {"case": flat[:p], "act": flat[p:2 * p],
            "rv": flat[2 * p:3 * p].astype(bool)}
    last = flat[3 * p:3 * p + 3]
    maps = None
    if sketch:
        maps = flat[3 * p + 3:].reshape(4, k)
    return nchg, k, rows, last, maps


def fold_group(kernel: ChunkKernel, chunks: Iterable[Chunk],
               device=None) -> GroupState:
    """Fold a kernel *freshly* over one contiguous unit of the stream,
    capturing the boundary halo a later :func:`merge_group_states` needs.

    The state/carry fold is exactly :func:`run_streaming`'s loop (bitwise).
    The halo is read from each chunk by :func:`_chunk_halo`: the segment
    count and first case change are found on the chunk's device, and only
    the lead run (one case), the first two rows and the last row come back
    to the host; halo values are Python ints, as in the JAX package.  Ghost
    chunks participate like real ones: their rows are masked (so the lead
    histogram stays empty) and their sketch columns supply the lead run's
    composed affine map.  The state lives on ``device``, else on the first
    chunk's device; a unit with no rows needs ``device``.
    """
    state = carry = None
    if device is not None:
        state, carry = kernel.init(device)
    segments = 0
    rows = 0
    head_rows: list[dict] = []
    hist: dict[int, int] = {}
    affine = (1, 0, 1, 0)
    lead_open = True
    first_case = None
    tail = None
    for chunk in chunks:
        n = int(chunk.nrows)
        if n == 0:
            continue
        if state is None:
            state, carry = kernel.init(chunk.device)
        with trace.span("fold.halo"):
            nchg, k, head, last, maps = _chunk_halo(chunk, lead_open,
                                                    2 - len(head_rows))
        case, act, rv = head["case"], head["act"], head["rv"]
        cont = rows > 0 and int(case[0]) == tail["case"]
        segments += 1 + nchg - (1 if cont else 0)
        if rows == 0:
            first_case = int(case[0])
        while len(head_rows) < 2 and len(head_rows) < rows + n:
            i = len(head_rows) - rows
            head_rows.append({"case": int(case[i]), "act": int(act[i]),
                              "rv": bool(rv[i])})
        if lead_open and rows > 0 and not cont:
            lead_open = False
        if lead_open:
            counts = np.bincount(act[:k][rv[:k]])
            for a_id in np.flatnonzero(counts):
                hist[int(a_id)] = hist.get(int(a_id), 0) + int(counts[a_id])
            if maps is not None:
                m1, a1, m2, a2 = maps
                for i in np.flatnonzero((m1 != 1) | (a1 != 0)
                                        | (m2 != 1) | (a2 != 0)):
                    affine = _compose4(affine, (int(m1[i]), int(a1[i]),
                                                int(m2[i]), int(a2[i])))
            else:
                sk = polyhash.segment_sketch(act[:k], np.zeros(k, np.int64))
                affine = _compose4(affine, (int(sk["mul1"][0]),
                                            int(sk["add1"][0]),
                                            int(sk["mul2"][0]),
                                            int(sk["add2"][0])))
            if nchg:
                lead_open = False
        state, carry = kernel.update(state, carry, chunk)
        rows += n
        tail = {"case": int(last[0]), "act": int(last[1]),
                "rv": bool(last[2])}
    if state is None:
        raise ValueError("fold_group: a unit with no rows needs a device")
    if rows == 0:
        return GroupState(state, carry, None, None, 0, 0)
    head = {"case": first_case, "rows": tuple(head_rows),
            "hist": hist, "affine": affine}
    return GroupState(state, carry, head, tail, segments, rows)


def _shift_carry(carry, offset: int):
    """Recursively relabel every ``"seg"`` entry of a (possibly composed)
    carry by the merge's segment offset (int32 stays int32)."""
    if not isinstance(carry, dict):
        return carry
    out = {}
    for k, v in carry.items():
        if k == "seg":
            out[k] = v + offset
        elif isinstance(v, dict):
            out[k] = _shift_carry(v, offset)
        else:
            out[k] = v
    return out


def _apply_overrides(carry: dict, overrides: dict) -> dict:
    out = dict(carry)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _apply_overrides(out[k], v)
        else:
            out[k] = v
    return out


def _merge_head(a: GroupState, b: GroupState, straddle: bool) -> dict:
    head = dict(a.head)
    head["rows"] = (a.head["rows"] + b.head["rows"])[:2]
    if straddle and a.segments == 1:
        # a is entirely one case run that continues into b: the merged
        # unit's lead run is a's rows followed by b's lead run
        hist = dict(a.head["hist"])
        for act, cnt in b.head["hist"].items():
            hist[act] = hist.get(act, 0) + cnt
        head["hist"] = hist
        head["affine"] = _compose4(a.head["affine"], b.head["affine"])
    return head


def merge_group_states(kernel: ChunkKernel, a: GroupState,
                       b: GroupState) -> GroupState:
    """The algebra's ``merge``: the fresh fold of ``a ++ b``, bitwise.

    Elementwise state combination plus the kernel's O(1) boundary stitch;
    ``b``'s carry becomes the merged carry with its local segment ids
    relabelled (and any kernel-specific overrides applied).  Associative
    — merging reconstructs fresh folds, so any merge-tree shape over the
    same ordered units yields the same bits.  Neither input is written.
    """
    if a.rows == 0:
        return b
    if b.rows == 0:
        return a
    if kernel.stitch is None:
        raise ValueError(
            f"kernel {kernel.name!r} has no group-state stitch "
            "(order-sensitive float state); use the sequential fold")
    straddle = a.tail["case"] == b.head["case"]
    offset = a.segments - (1 if straddle else 0)
    state, overrides = kernel.stitch(StitchCtx(a, b, straddle, offset))
    carry = _shift_carry(b.carry, offset)
    if overrides:
        carry = _apply_overrides(carry, overrides)
    return GroupState(state, carry, _merge_head(a, b, straddle), b.tail,
                      a.segments + b.segments - (1 if straddle else 0),
                      a.rows + b.rows)


def merge_tree(kernel: ChunkKernel, states: Iterable[GroupState],
               device=None) -> GroupState:
    """Reduce ordered unit states pairwise (a balanced merge tree).

    The tree shape is a free choice — the merge is bitwise-associative.
    With no nonempty state the result is the identity on ``device``, else
    on the device of the first state given.
    """
    states = [s for s in states if s is not None]
    level = [s for s in states if s.rows > 0]
    if not level:
        if device is None:
            leaves = [t for s in states for t in tensor_leaves(s.state)]
            if not leaves:
                raise ValueError("merge_tree: no states and no device")
            device = leaves[0].device
        return empty_group_state(kernel, device)
    while len(level) > 1:
        nxt = [merge_group_states(kernel, level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def finalize_group(kernel: ChunkKernel, gs: GroupState):
    """Terminal step of the algebra: the kernel's ordinary ``finalize``."""
    return kernel.finalize(gs.state, gs.carry)


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


def _step_spans(verb: str) -> tuple[str, str, str]:
    return tuple(f"fold.{step}.{verb}" for step in ("init", "update",
                                                    "finalize"))


def traced(kernel: ChunkKernel, verb: str) -> ChunkKernel:
    """``kernel`` with its ``init``, each ``update`` and its ``finalize``
    in the spans ``fold.init.<verb>``, ``fold.update.<verb>`` and
    ``fold.finalize.<verb>`` (``repro_torch.trace``; no-ops while no
    profiler records), as :func:`compose` spans its members."""
    init_span, update_span, finalize_span = _step_spans(verb)

    def init(device):
        with trace.span(init_span):
            return kernel.init(device)

    def update(state, carry, chunk):
        with trace.span(update_span):
            return kernel.update(state, carry, chunk)

    def finalize(state, carry):
        with trace.span(finalize_span):
            return kernel.finalize(state, carry)

    return dataclasses.replace(kernel, init=init, update=update,
                               finalize=finalize)


def compose(kernels: Mapping[str, ChunkKernel]) -> ChunkKernel:
    """Fuse kernels into one that shares a single pass over the stream.

    States/carries are dicts keyed like ``kernels``; ``finalize`` returns a
    dict of results.  One disk scan computes a whole dashboard panel.  The
    fused kernel's ``columns`` is the union of the members' column
    requirements (unknown if any member's is unknown), ``mask_exact`` the
    conjunction, and ``ghost_sketch`` the disjunction — one
    sketch-consuming member is enough for ghost chunks to carry sketches.
    Each member's init, update and finalize run in the spans
    ``fold.init.<key>``, ``fold.update.<key>`` and ``fold.finalize.<key>``.
    """
    names = tuple(kernels)
    spans = {k: _step_spans(k) for k in names}

    def init(device):
        pairs = {}
        for k in names:
            with trace.span(spans[k][0]):
                pairs[k] = kernels[k].init(device)
        return ({k: s for k, (s, _) in pairs.items()},
                {k: c for k, (_, c) in pairs.items()})

    def update(state, carry, chunk):
        out_s, out_c = {}, {}
        for k in names:
            with trace.span(spans[k][1]):
                out_s[k], out_c[k] = kernels[k].update(state[k], carry[k],
                                                       chunk)
        return out_s, out_c

    def merge(a, b):
        return {k: kernels[k].merge(a[k], b[k]) for k in names}

    def finalize(state, carry):
        out = {}
        for k in names:
            with trace.span(spans[k][2]):
                out[k] = kernels[k].finalize(state[k], carry[k])
        return out

    # the fused kernel joins the group-state algebra exactly when every
    # member does: its stitch slices the dict state/carry per member and
    # runs each member's stitch under the shared boundary halo
    stitch = None
    if all(k.stitch is not None for k in kernels.values()):
        def stitch(ctx):
            states, overrides = {}, {}
            for k in names:
                sub = StitchCtx(
                    dataclasses.replace(ctx.a, state=ctx.a.state[k],
                                        carry=ctx.a.carry[k]),
                    dataclasses.replace(ctx.b, state=ctx.b.state[k],
                                        carry=ctx.b.carry[k]),
                    ctx.straddle, ctx.offset)
                states[k], over = kernels[k].stitch(sub)
                if over:
                    overrides[k] = over
            return states, overrides

    return ChunkKernel("compose(" + ",".join(names) + ")",
                       init, update, merge, finalize,
                       mask_exact=all(k.mask_exact for k in kernels.values()),
                       columns=union_columns(
                           k.columns for k in kernels.values()),
                       ghost_sketch=any(
                           k.ghost_sketch for k in kernels.values()),
                       stitch=stitch)


def compose_specs(specs: Mapping[str, KernelSpec]) -> KernelSpec:
    """Fuse registered verbs into one first-class :class:`KernelSpec`.

    Its ``make`` builds the :func:`compose` of the member kernels
    (``verb_kwargs`` routes per-verb options), its ``columns`` is the union
    of the member column sets, and its ``sharded_state`` is ``"fused"``
    exactly when *every* member has an exact distributed lowering —
    ``repro_torch.distributed.query`` then mines each distinct member state
    in one sharded pass.  Results come back as ``{verb: result}``, bitwise
    equal per verb to running each member alone.
    """
    specs = dict(specs)
    if not specs:
        raise ValueError("compose_specs() needs at least one verb")
    names = tuple(specs)

    def make(dims: Dims, verb_kwargs: Mapping[str, dict] | None = None,
             **common) -> ChunkKernel:
        vk = dict(verb_kwargs or {})
        unknown = set(vk) - set(names)
        if unknown:
            raise KeyError(f"verb_kwargs for verbs not in the fused set: "
                           f"{sorted(unknown)} (fusing {list(names)})")
        return compose({v: specs[v].make(dims, **{**common, **vk.get(v, {})})
                        for v in names})

    sharded = ("fused" if all(s.sharded_state is not None
                              for s in specs.values()) else None)
    return KernelSpec(
        name="fused(" + ",".join(names) + ")",
        make=make,
        columns=union_columns(s.columns for s in specs.values()),
        sharded_state=sharded,
        from_sharded=None,      # the fused driver finalizes per member
        doc="fused multi-verb collection: " + ", ".join(names),
        members=names)


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
