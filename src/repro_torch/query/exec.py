"""Pruned plan execution: ghost carries, residual masks, chunk kernels.

``execute(plan, mine=kernel)`` drives the surviving row groups of a
compiled plan through any ``repro_torch.core.engine`` chunk kernel, on the
card unless the caller passes ``device="cpu"``.  The
contract is **bitwise identity** with the eager pipeline the plan
replaces: ``mine(filterN(...filter1(edf.read(path))))`` — while reading
strictly fewer bytes whenever the zone maps refute any group.

Two mechanisms make the pruned stream indistinguishable from the full
one for the kernels:

* **residual masks** — each read group's chunk arrives with
  ``row_valid`` = the conjunction of every predicate the zone maps could
  not decide (plus the broadcast case-level keep masks), exactly the
  lazy ``ops.proj`` mask the eager filters would have produced.  The
  kernels already fold ``rows_valid()`` into every update, so a masked
  chunk contributes precisely what the filtered whole log would.
* **ghost chunks** — a run of skipped groups is replaced by an
  O(segments) synthetic chunk: one all-masked row per case segment, case
  ids rising from the run's first case to its recorded tail, last row
  carrying the persisted tail halo.  Driving it through the kernel's own
  ``update`` advances the carry — case id, one/two-row halo, *global
  segment numbering* — exactly as the unread rows would have (they are
  all refuted, hence all masked), at a cost independent of the run's row
  count.  Kernels whose state depends on masked rows declare
  ``ghost_sketch`` (variants' validity-blind hashing): their ghost
  chunks additionally carry the run's composed per-segment affine
  polyhash maps (``core.polyhash``, read from EDF headers), so the
  kernel replays the skipped rows' hash contribution bitwise without
  any I/O — every registered verb now runs on the pruned stream.

Case-level predicates resolve in as little as **zero** passes: variant
predicates (``variant_of`` / ``variant_in``) derive their per-case keep
masks straight from the composed header sketches when every file has
them; the remaining data-dependent case predicates
(``cases_containing`` / ``case_size``) run a fused **single-pass**
schedule (:func:`_single_pass_source`) that folds their phase-one
kernels and the mining kernel over one scan — each surviving group is
read once, buffered until its segments' keeps are resolved, and either
emitted masked or replaced by a ghost — instead of the old two-pass
plan (a phase-one scan per predicate, then the final scan).

``execute_frame`` materializes the filtered, projected frame instead
(equal to ``filterN(...).compact()``); ``pruned_source`` exposes the
pruned stream as a re-iterable ``ChunkedEventFrame`` for custom drivers.

**Read-ahead** — the scan's wall clock is ``sum(read+decode) +
sum(kernel update)`` when sequential; a process-wide pool of host threads
(:func:`_decode_pool`) fetches and decodes the next *W* read groups
concurrently while the kernel runs on group *g*, overlapping the two
terms and spreading the decode (``zlib`` releases the GIL) over the host's
cores.  *W* is ``REPRO_QUERY_PREFETCH`` when set (``0`` = off), else the
pool's size (:func:`prefetch_depth`).  Only the file read and the decode
to host numpy move off the consumer thread (a worker makes no device
call): the copy to the device, residual masks, segment tracking and
ghost-chunk synthesis are order-dependent and stay on the consumer, in
schedule order, so the chunk stream — and therefore every kernel result —
is bitwise identical with the read-ahead on or off, at any window.

Residual masks are evaluated on the device the chunk lands on; segment
tracking and the case-level keep broadcast run on the host over the
decoded case column (no value is read back from the device), and ghost
chunks are built on the host and copied to the device.

Spans (``repro_torch.trace``, opened on the consumer's thread only, none
held across a ``yield``): ``scan.plan`` (``compile_plan``), ``scan.wait``
(the consumer blocked on its next group's decode), ``scan.read`` (a
``read_group_numpy`` on the consumer), ``scan.h2d`` (a decoded group, a
ghost chunk or a keep mask copied to the device: :func:`_h2d`, whose
``nbytes`` counts the bytes), ``scan.ghost`` (a ghost chunk built, and
folded where the scan folds it) and ``scan.merge`` (``merge_tree`` and
``finalize_group`` of the grouped path).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import backend, engine
from repro_torch.core.chunked import ChunkedEventFrame
from repro_torch.core.eventframe import ACTIVITY, CASE, EventFrame
from repro_torch.core.polyhash import sketch_columns
from repro_torch.storage.edf import EDFReader

from .expr import ALL, NONE, CasePredicate, Expr, SketchPredicate
from .optimize import GhostItem, PhysicalPlan, ReadItem, compile_plan
from .plan import MultiPlan, Plan




# ------------------------------------------------------------- reporting
@dataclasses.dataclass
class ScanReport:
    """I/O accounting for one executed plan (all byte counts are on-disk
    compressed extents of the scan's projected column set)."""

    path: str
    columns: tuple
    pruned: bool
    prefetch: int = 0           # read-ahead depth the scan ran with
    groups_total: int = 0
    groups_read: int = 0
    groups_skipped: int = 0
    groups_proved: int = 0      # read groups whose residual mask was proved
    groups_cached: int = 0      # grouped path: states served from the cache
    groups_folded: int = 0      # grouped path: states freshly decoded+folded
    rows_total: int = 0
    rows_read: int = 0
    bytes_total: int = 0
    bytes_read: int = 0
    phase1_groups_read: int = 0
    phase1_bytes_read: int = 0
    per_file: tuple = ()        # multi-file plans: the per-file reports

    @property
    def skip_ratio(self) -> float:
        return self.groups_skipped / self.groups_total if self.groups_total else 0.0

    @property
    def bytes_saved_ratio(self) -> float:
        if not self.bytes_total:
            return 0.0
        return 1.0 - self.bytes_read / self.bytes_total

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["columns"] = list(self.columns)
        out["skip_ratio"] = self.skip_ratio
        out["bytes_saved_ratio"] = self.bytes_saved_ratio
        out["per_file"] = [r.to_dict() for r in self.per_file]
        return out


def merge_reports(reports) -> ScanReport:
    """Aggregate per-file reports into one dataset-level report (the
    originals remain available on ``per_file``)."""
    reports = tuple(reports)
    if len(reports) == 1:
        return reports[0]
    out = ScanReport(";".join(r.path for r in reports),
                     reports[0].columns if reports else (),
                     any(r.pruned for r in reports),
                     prefetch=max(r.prefetch for r in reports),
                     per_file=reports)
    for f in ("groups_total", "groups_read", "groups_skipped",
              "groups_proved", "groups_cached", "groups_folded",
              "rows_total", "rows_read", "bytes_total",
              "bytes_read", "phase1_groups_read", "phase1_bytes_read"):
        setattr(out, f, sum(getattr(r, f) for r in reports))
    return out


def _account(report: ScanReport, physical: PhysicalPlan, schedule,
             read_columns, phase1: bool = False) -> None:
    reader = physical.reader
    for item in schedule:
        if isinstance(item, GhostItem):
            continue
        nbytes = reader.group_nbytes(item.index, read_columns)
        if phase1:
            report.phase1_groups_read += 1
            report.phase1_bytes_read += nbytes
        else:
            report.groups_read += 1
            report.bytes_read += nbytes
            report.rows_read += reader.group_nrows(item.index)
            if not item.residual and physical.steps:
                report.groups_proved += 1


# ----------------------------------------------------------- the stream
_POOL_MAX = 8               # decode threads at most, whatever the host has
_POOL_LOCK = threading.Lock()
_pool: tuple | None = None  # (pid, the executor): see _decode_pool


def _pool_size() -> int:
    """Decode threads for this host: the cores the process may run on (all
    of them where the platform has no affinity call), one left to the
    consumer, at least 1 and at most ``_POOL_MAX``."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:      # no affinity call on this platform
        cores = os.cpu_count() or 1
    return min(max(cores - 1, 1), _POOL_MAX)


def _decode_pool() -> ThreadPoolExecutor:
    """The process-wide pool that decodes read-ahead groups, created on
    first use and again in a forked child (whose copy has no threads).  One
    pool bounds the threads however many scans run at once."""
    global _pool
    with _POOL_LOCK:
        if _pool is None or _pool[0] != os.getpid():
            _pool = (os.getpid(), ThreadPoolExecutor(
                _pool_size(), thread_name_prefix="repro-decode"))
        return _pool[1]


def prefetch_depth(prefetch: int | None = None) -> int:
    """Resolve the read-ahead window: explicit argument wins, else the
    ``REPRO_QUERY_PREFETCH`` env var, else the decode pool's size
    (:func:`_pool_size`); 0 disables."""
    if prefetch is None:
        try:
            prefetch = int(os.environ["REPRO_QUERY_PREFETCH"])
        except (KeyError, ValueError):
            prefetch = _pool_size()
    return max(int(prefetch), 0)


def _read_ahead(reader: EDFReader, schedule, read_columns, depth: int):
    """Yield ``(item, (columns, valid) | None)`` pairs in schedule order,
    keeping up to ``depth`` read groups in flight on the decode pool (each
    fetched and decoded concurrently while the consumer works on the group
    before them).  A worker runs ``read_group_numpy`` and nothing else: it
    returns host numpy and makes no device call.  Taking group *g* submits
    group *g + depth*; the consumer then waits for *g* in ``scan.wait``.
    Ghost items pass through with ``None`` — their synthesis is
    order-dependent and stays on the consumer.  A worker's exception
    re-raises at the consumer's matching position.  However the generator
    ends (exhausted, raising, or closed early by an abandoned consumer),
    the groups not yet started are cancelled and the running ones waited
    for before it returns, so no decode touches ``reader`` after it.

    ``_read_ahead.ready`` and ``_read_ahead.waited`` count the groups whose
    decode had finished when the consumer asked for them, and those it
    waited on."""
    pool = _decode_pool()
    reads = (item for item in schedule if not isinstance(item, GhostItem))
    pending = collections.deque()   # the futures of the groups in flight

    def submit():
        item = next(reads, None)
        if item is not None:
            pending.append(pool.submit(reader.read_group_numpy, item.index,
                                       read_columns))

    try:
        for _ in range(depth):
            submit()
        for item in schedule:
            if isinstance(item, GhostItem):
                yield item, None
                continue
            fut = pending[0]    # stays in flight until its result is in
            submit()
            with trace.span("scan.wait"):
                ready = fut.done()
                host = fut.result()
            pending.popleft()
            with _AHEAD_LOCK:
                if ready:
                    _read_ahead.ready += 1
                else:
                    _read_ahead.waited += 1
            yield item, host
    finally:
        for fut in pending:
            fut.cancel()
        wait(pending)


_AHEAD_LOCK = threading.Lock()
_read_ahead.ready = 0
_read_ahead.waited = 0


_H2D_LOCK = threading.Lock()


def _h2d(cols: dict, valid: dict | None, device) -> EventFrame:
    """``EventFrame.from_numpy`` in the span ``scan.h2d``; its bytes are
    added to ``_h2d.nbytes`` (counted on every device, as
    ``trace.to_device`` counts, but not as a host sync)."""
    with trace.span("scan.h2d"):
        frame = EventFrame.from_numpy(cols, valid, device=device)
    nbytes = sum(a.nbytes for a in cols.values()) + \
        sum(a.nbytes for a in (valid or {}).values())
    with _H2D_LOCK:
        _h2d.nbytes += nbytes
    return frame


_h2d.nbytes = 0


def _read(reader: EDFReader, g: int, columns, device
          ) -> tuple[EventFrame, np.ndarray | None]:
    """Row group ``g`` read and decoded on the consumer (``scan.read``) and
    copied to ``device``; the frame and its host case column."""
    with trace.span("scan.read"):
        cols, valid = reader.read_group_numpy(g, columns)
    return _h2d(cols, valid, device), cols.get(CASE)


def _ghost_chunk(item: GhostItem, chunk_columns, reader: EDFReader,
                 device) -> EventFrame:
    """One all-masked row per case segment of a skipped run, the last row
    carrying the persisted tail halo; built on the host and copied to
    ``device``.  Unlike the JAX package, which pads the rows to a power of
    two to bound its retraces, nothing is padded: nothing here is traced,
    and a padding run repeating the tail case is work for every scan."""
    d = max(int(item.segments), 1)
    tail_vals = item.tail["values"]
    cols: dict[str, np.ndarray] = {}
    valid: dict[str, np.ndarray] = {}
    for name in chunk_columns:
        meta = reader.schema[name]
        dtype = np.dtype(meta["dtype"])
        if name == CASE:
            arr = np.full(d, tail_vals[CASE], dtype)
            arr[:d - 1] = item.first_case + np.arange(d - 1)
        else:
            arr = np.zeros(d, dtype)
            arr[d - 1] = dtype.type(tail_vals.get(name, 0))
        cols[name] = arr
        if meta.get("has_valid"):
            # every ghost row is row-masked, but the tail halo keeps its
            # persisted epsilon flag so the carry is faithful to the file
            v = np.ones(d, bool)
            v[d - 1] = bool(item.tail.get("valid", {}).get(name, True))
            valid[name] = v
    if item.sketch is not None:
        # per-segment composed affine polyhash maps — sketch-consuming
        # kernels (variants) fold these with the affine scan instead of
        # hashing unread rows
        cols.update(sketch_columns(item.sketch, d, d))
    frame = _h2d(cols, valid, device)
    return EventFrame(frame.columns, frame.valid,
                      torch.zeros(d, dtype=torch.bool, device=device))


def _row_mask(frame: EventFrame, steps, residual) -> torch.Tensor:
    """Conjunction of the residual predicates' masks, on the frame's device."""
    mask = torch.ones(frame.nrows, dtype=torch.bool, device=frame.device)
    for pos in residual:
        mask &= steps[pos].mask(frame).to(torch.bool)
    return mask


def _iter_chunks(physical: PhysicalPlan, schedule, keeps: dict,
                 chunk_columns, read_columns, prefetch: int | None = None,
                 device="cuda"):
    """Yield the pruned chunk stream on ``device``: read groups with
    residual masks, ghost chunks for skipped runs.  Tracks global segment
    numbering sequentially (read groups from their decoded case column,
    ghost runs from metadata), so case-level keep masks broadcast to the
    right rows.  Up to ``prefetch`` read groups are fetched and decoded
    ahead, concurrently, on the decode pool (:func:`prefetch_depth`
    resolves ``None`` from the environment or the pool's size; 0 reads on
    this thread); the masking below consumes them strictly in schedule
    order, so the stream is bitwise identical at any window."""
    reader = physical.reader
    steps = physical.steps
    depth = prefetch_depth(prefetch)
    if depth > 0:
        pairs = _read_ahead(reader, schedule, read_columns, depth)
    else:
        pairs = ((item, None) for item in schedule)
    # global segment ids are only materialized when a keep mask needs the
    # broadcast; ghost continuation needs just the previous case id
    track_segs = any(getattr(item, "case_steps", ()) for item in schedule)
    try:
        yield from _masked_chunks(pairs, reader, steps, keeps, chunk_columns,
                                  read_columns, track_segs, device)
    finally:
        close = getattr(pairs, "close", None)
        if close is not None:
            close()


def _masked_chunks(pairs, reader, steps, keeps, chunk_columns, read_columns,
                   track_segs, device):
    last_seg = -1
    prev_case = None
    for item, host in pairs:
        if isinstance(item, GhostItem):
            cont = prev_case is not None and item.first_case == prev_case
            with trace.span("scan.ghost"):
                ghost = _ghost_chunk(item, chunk_columns, reader, device)
            yield ghost
            del ghost   # held here, it would stay on the device to the scan's end
            last_seg += int(item.segments) - (1 if cont else 0)
            prev_case = item.tail["values"][CASE]
            continue
        if host is None:
            with trace.span("scan.read"):
                host = reader.read_group_numpy(item.index, read_columns)
        cols, valid = host
        frame = _h2d(cols, valid, device)
        mask = _row_mask(frame, steps, item.residual)
        if CASE in cols and frame.nrows:
            case = cols[CASE]
            if track_segs:
                new0 = prev_case is None or case[0] != prev_case
                seg = last_seg + int(new0) + np.concatenate(
                    [[0], np.cumsum(case[1:] != case[:-1])])
                if item.case_steps:
                    keep_rows = np.ones(frame.nrows, bool)
                    for pos in item.case_steps:
                        keep = keeps[pos]
                        seg_c = np.minimum(seg, len(keep) - 1)
                        keep_rows &= keep[seg_c] & (seg < len(keep))
                    mask &= _h2d({"keep": keep_rows}, None, device)["keep"]
                last_seg = int(seg[-1])
            prev_case = case[-1]
        sel = frame.select(chunk_columns)
        yield EventFrame(sel.columns, sel.valid, mask)


def _base_report(physical: PhysicalPlan) -> ScanReport:
    reader = physical.reader
    report = ScanReport(physical.plan.path, physical.read_columns,
                        physical.prune)
    for g in range(reader.num_groups):
        n = reader.group_nrows(g)
        if n == 0:
            continue
        report.groups_total += 1
        report.rows_total += n
        report.bytes_total += reader.group_nbytes(g, physical.read_columns)
    return report


# -------------------------------------------------------- multi-file plans
def check_homogeneous(readers) -> None:
    """A multi-file plan needs one schema: identical column names, dtypes,
    kinds, dictionary tables and validity flags across every file (byte
    layout/version may differ — v1/v2/v3 files mix freely)."""

    def shape(reader):
        return {
            name: (meta["dtype"], meta.get("kind", "numeric"),
                   tuple(meta.get("table", ())),
                   bool(meta.get("has_valid") or "valid_offset" in meta))
            for name, meta in reader.schema.items()
        }

    readers = list(readers)
    first = shape(readers[0])
    for reader in readers[1:]:
        if shape(reader) != first:
            raise ValueError(
                f"multi-file plan over incompatible schemas: "
                f"{readers[0].path!r} vs {reader.path!r}")


def _case_extent(ph: PhysicalPlan):
    """(first case id, last case id) of a file, from header metadata."""
    if ph.metas is None or CASE not in ph.reader.schema:
        return None, None
    nonempty = [g for g in range(ph.reader.num_groups)
                if ph.reader.group_nrows(g) > 0]
    if not nonempty:
        return None, None
    first = ph.metas[nonempty[0]]["zones"].get(CASE, {}).get("min")
    tail = ph.metas[nonempty[-1]].get("tail", {}).get("values", {}).get(CASE)
    return first, tail


def _multi_offsets(physicals):
    """Global segment id of each file's first segment, plus the total case
    count — the multi-file extension of the per-group segment accounting.
    A case straddling a file boundary (same id on both sides) is counted
    once: the next file's offset backs up by one.  Returns ``(None, None)``
    when any file lacks segment metadata."""
    offsets: list[int] = []
    total = 0
    prev_tail = None
    for ph in physicals:
        if ph.num_cases is None:
            return None, None
        first, tail = _case_extent(ph)
        cont = (prev_tail is not None and first is not None
                and first == prev_tail)
        off = total - 1 if cont else total
        offsets.append(off)
        total = off + ph.num_cases
        if tail is not None:
            prev_tail = tail
    return offsets, total


def _local_keeps(keeps: dict, off: int, num_cases: int) -> dict:
    """Slice global per-case keep masks to one file's segment range."""
    return {pos: k[off:off + num_cases] for pos, k in keeps.items()}


def _sketch_fingerprints(physicals, total):
    """Whole-dataset per-case variant fingerprints from header sketches
    alone (no data I/O): walk the nonempty groups in stream order, folding
    each segment's composed affine map — a case that straddles group/file
    boundaries composes across them exactly like the streamed hash.
    Returns ``(fp1, fp2)`` uint32 arrays of length ``total``, or ``None``
    when any group lacks a sketch."""
    if total is None:
        return None
    fp1 = np.zeros(total, np.uint32)
    fp2 = np.zeros(total, np.uint32)
    seg = -1                    # id of the open (possibly straddling) case
    h1 = h2 = 0                 # its running hash pair (python ints, mod 2^32)
    prev_tail = None
    for ph in physicals:
        for g in ph._nonempty():
            sk = ph.reader.group_sketch(g)
            if sk is None:
                return None
            meta = ph.metas[g]
            first = meta["zones"][CASE]["min"]
            mul1, add1 = sk["mul1"], sk["add1"]
            mul2, add2 = sk["mul2"], sk["add2"]
            nsegs = len(mul1)
            j0 = 0
            if prev_tail is not None and first == prev_tail:
                h1 = (h1 * int(mul1[0]) + int(add1[0])) & 0xFFFFFFFF
                h2 = (h2 * int(mul2[0]) + int(add2[0])) & 0xFFFFFFFF
                j0 = 1
            if nsegs > j0:
                if seg >= 0:
                    fp1[seg], fp2[seg] = h1, h2     # close the open case
                # fresh segments closed inside the group start from h=0:
                # their fingerprint is their additive coefficient directly
                fresh = nsegs - j0
                fp1[seg + 1:seg + fresh] = add1[j0:nsegs - 1]
                fp2[seg + 1:seg + fresh] = add2[j0:nsegs - 1]
                seg += fresh
                h1, h2 = int(add1[nsegs - 1]), int(add2[nsegs - 1])
            prev_tail = meta["tail"]["values"][CASE]
    if seg >= 0:
        fp1[seg], fp2[seg] = h1, h2
    return fp1, fp2


def _sketch_keeps(physicals, total, steps) -> dict:
    """Keep masks of every :class:`SketchPredicate` step, resolved entirely
    from header sketches (empty when fingerprints aren't derivable — those
    predicates then fall back to the streamed phase-one kernel)."""
    pos_list = [i for i, s in enumerate(steps)
                if isinstance(s, SketchPredicate)]
    if not pos_list or total is None or \
            not all(ph.can_ghost for ph in physicals):
        return {}
    fps = _sketch_fingerprints(physicals, total)
    if fps is None:
        return {}
    return {pos: np.asarray(steps[pos].keep_from_fps(*fps), bool)
            for pos in pos_list}


def _multi_phase1(physicals, reports, offsets, total,
                  prefetch: int | None = None,
                  seeded: dict | None = None, device="cuda") -> dict:
    """Phase one of every case predicate, streamed across the whole file
    set with one kernel (its carry numbers segments globally, so a case
    straddling a file boundary accumulates into a single slot).  Variant
    predicates resolve header-only via :func:`_sketch_keeps` first and
    skip the streamed pass entirely."""
    steps = physicals[0].steps
    keeps: dict = dict(seeded) if seeded is not None else \
        _sketch_keeps(physicals, total, steps)
    for pos, step in enumerate(steps):
        if not isinstance(step, CasePredicate) or pos in keeps:
            continue
        if total is None:
            raise ValueError(
                f"case-level predicates need a {CASE!r} column with "
                f"per-group segment metadata in every file of the plan")
        chunk_cols = tuple(sorted({CASE, ACTIVITY} | set(step.columns())))
        read = set(chunk_cols)
        for i in range(pos):
            s = steps[i]
            if not isinstance(s, CasePredicate):
                read |= s.columns()
        read_cols = tuple(sorted(read))
        kern = step.phase1_kernel(total)
        sketch = getattr(kern, "ghost_sketch", False)
        locals_ = [_local_keeps(keeps, off, ph.num_cases)
                   for ph, off in zip(physicals, offsets)]
        schedules = [ph.phase1_schedule(pos, lk, sketch=sketch)
                     for ph, lk in zip(physicals, locals_)]
        for ph, rep, sched in zip(physicals, reports, schedules):
            _account(rep, ph, sched, read_cols, phase1=True)

        def gen():
            for ph, sched, lk in zip(physicals, schedules, locals_):
                yield from _iter_chunks(ph, sched, lk, chunk_cols, read_cols,
                                        prefetch, device)

        result = engine.run_streaming(kern, gen(), device=device)
        keeps[pos] = np.asarray(step.finalize_keep(result), bool)
    return keeps


def _multi_compile(mplan: MultiPlan, prune: bool,
                   prefetch: int | None = None, device="cuda"):
    physicals = [compile_plan(p, prune) for p in mplan.per_file()]
    check_homogeneous(ph.reader for ph in physicals)
    reports = [_base_report(ph) for ph in physicals]
    offsets, total = _multi_offsets(physicals)
    keeps = _multi_phase1(physicals, reports, offsets, total, prefetch,
                          device=device)
    if offsets is None:
        offsets = [0] * len(physicals)
    return physicals, reports, offsets, keeps


def _multi_schedules(physicals, reports, offsets, keeps, *, ghosts,
                     skippable, sketch=False):
    schedules, locals_ = [], []
    for ph, rep, off in zip(physicals, reports, offsets):
        lk = _local_keeps(keeps, off, ph.num_cases or 0)
        sched = ph.final_schedule(lk, ghosts=ghosts, skippable=skippable,
                                  sketch=sketch)
        _account(rep, ph, sched, ph.read_columns)
        rep.groups_skipped = rep.groups_total - rep.groups_read
        schedules.append(sched)
        locals_.append(lk)
    return schedules, locals_


def _sp_buffer_cap() -> int:
    """Single-pass frame buffer: decoded groups held while their segments'
    keeps resolve (``REPRO_QUERY_SP_BUFFER``, default 16).  Overflowed
    frames are dropped (their read charged to phase one) and re-read at
    emission, bounding residency on adversarial straddles."""
    try:
        cap = int(os.environ.get("REPRO_QUERY_SP_BUFFER", "16"))
    except ValueError:
        cap = 16
    return max(cap, 1)


def _group_ghost(ph: PhysicalPlan, g: int, sketch: bool) -> GhostItem:
    meta = ph.metas[g]
    sk = None
    if sketch:
        sk = ph.reader.group_sketch(g)
        if sk is None:
            raise ValueError(
                f"group {g} of {ph.reader.path!r} has no variant sketch "
                f"(case/activity columns missing?) — cannot ghost-skip it "
                f"for a sketch-consuming kernel")
    return GhostItem((g,), int(ph.seg_count[g]), meta["zones"][CASE]["min"],
                     meta["tail"], sk)


def _single_pass_source(physicals, reports, offsets, total, sk_keeps,
                        data_pos, sketch, device):
    """Fused phase-one + mine scan (the ``cases_containing`` fast path).

    One walk over the nonempty groups: each group is either refuted
    header-only, read once (feeding every data-dependent case predicate's
    phase-one kernel the frame masked by its *preceding* expression
    residuals), or ghosted through the phase-one kernels.  Groups buffer
    (on the device, with their host case column) until the scan has passed
    their segment range — phase-one states are segment-local with pure
    finalize, so a closed segment's keep is final the moment the scan moves
    past it — then emit to the consumer: masked chunk if any segment
    survives, ghost otherwise.  Bitwise equal to the two-pass plan while
    reading each surviving group once.

    Accounting lands at emission: a surviving group's read counts as scan
    I/O, a read that only served phase one counts as phase-one I/O, and a
    header-refuted group costs nothing.  Re-iterating the source replays
    a conventional schedule from the resolved keeps (no re-accounting).
    """
    from collections import deque

    steps = physicals[0].steps
    exprs = [i for i, s in enumerate(steps) if isinstance(s, Expr)]
    case_pos = [i for i, s in enumerate(steps)
                if isinstance(s, CasePredicate)]
    before = {pos: [i for i in exprs if i < pos] for pos in data_pos}
    merged = merge_reports(reports)
    targets = [[rep] if merged is rep else [rep, merged] for rep in reports]
    all_targets = [t for tg in targets for t in tg]
    cell: dict = {"finals": None, "replay": None}

    def read(ph, g):
        return _read(ph.reader, g, ph.read_columns, device)

    def first_pass():
        for rep in all_targets:     # idempotent restart of an abandoned pass
            rep.groups_read = rep.bytes_read = rep.rows_read = 0
            rep.groups_proved = rep.groups_skipped = 0
            rep.phase1_groups_read = rep.phase1_bytes_read = 0
        kernels = {pos: steps[pos].phase1_kernel(total) for pos in data_pos}
        p1_sketch = any(getattr(k, "ghost_sketch", False)
                        for k in kernels.values())
        states = {pos: k.init(device) for pos, k in kernels.items()}
        finals: dict = {}
        dirty = True
        pending: deque = deque()
        held = 0
        cap = _sp_buffer_cap()

        def keep_masks():
            nonlocal dirty
            if dirty:
                for pos in data_pos:
                    st, ca = states[pos]
                    finals[pos] = np.asarray(steps[pos].finalize_keep(
                        kernels[pos].finalize(st, ca)), bool)
                dirty = False
            return {**sk_keeps, **finals}

        def emit(entry):
            fi, g, glo, ghi, got, was_read = entry
            ph, tg = physicals[fi], targets[fi]
            keeps = keep_masks()
            refuted = (any(ph.proves[i][g] == NONE for i in exprs) or
                       any(not keeps[p][glo:ghi].any() for p in case_pos))
            if refuted:
                if was_read:        # the read only served phase one
                    nb = ph.reader.group_nbytes(g, ph.read_columns)
                    for rep in tg:
                        rep.phase1_groups_read += 1
                        rep.phase1_bytes_read += nb
                with trace.span("scan.ghost"):
                    ghost = _ghost_chunk(_group_ghost(ph, g, sketch),
                                         ph.read_columns, ph.reader, device)
                yield ghost
                return
            if got is None:         # never read, or dropped at the cap
                got = read(ph, g)
            frame, case = got
            nb = ph.reader.group_nbytes(g, ph.read_columns)
            for rep in tg:
                rep.groups_read += 1
                rep.bytes_read += nb
                rep.rows_read += frame.nrows
            residual = [i for i in exprs if ph.proves[i][g] != ALL]
            if not residual and ph.steps:
                for rep in tg:
                    rep.groups_proved += 1
            mask = _row_mask(frame, steps, residual)
            seg = glo + np.concatenate(
                [[0], np.cumsum(case[1:] != case[:-1])])
            keep_rows = np.ones(frame.nrows, bool)
            for p in case_pos:
                keep_rows &= keeps[p][seg]
            mask &= _h2d({"keep": keep_rows}, None, device)["keep"]
            sel = frame.select(ph.chunk_columns)
            yield EventFrame(sel.columns, sel.valid, mask)

        def masked_for(frame, residual, cache):
            key = tuple(residual)
            if key not in cache:
                if not key:
                    cache[key] = frame
                else:
                    cache[key] = EventFrame(frame.columns, frame.valid,
                                            _row_mask(frame, steps, key))
            return cache[key]

        for fi, ph in enumerate(physicals):
            off = offsets[fi]
            for g in ph._nonempty():
                glo = off + int(ph.seg_start[g])
                ghi = glo + int(ph.seg_count[g])
                meta = ph.metas[g]
                # phase one wants the rows iff some predicate's preceding
                # conjuncts don't refute the group and its own header
                # proof can't (presence bitsets / zone maps)
                want = any(
                    not any(ph.proves[i][g] == NONE for i in before[pos])
                    and steps[pos].phase1_prove(meta) != NONE
                    for pos in data_pos)
                got = None
                if want:
                    got = read(ph, g)
                    cache: dict = {}
                    for pos in data_pos:
                        resid = [i for i in before[pos]
                                 if ph.proves[i][g] != ALL]
                        st, ca = states[pos]
                        states[pos] = kernels[pos].update(
                            st, ca, masked_for(got[0], resid, cache))
                    dirty = True
                    held += 1
                else:
                    with trace.span("scan.ghost"):
                        ghost = _ghost_chunk(_group_ghost(ph, g, p1_sketch),
                                             ph.read_columns, ph.reader,
                                             device)
                        for pos in data_pos:
                            st, ca = states[pos]
                            states[pos] = kernels[pos].update(st, ca, ghost)
                pending.append([fi, g, glo, ghi, got, want])
                while held > cap:
                    for entry in pending:
                        if entry[4] is not None:
                            nb = physicals[entry[0]].reader.group_nbytes(
                                entry[1], physicals[entry[0]].read_columns)
                            for rep in targets[entry[0]]:
                                rep.phase1_groups_read += 1
                                rep.phase1_bytes_read += nb
                            entry[4], entry[5] = None, False
                            held -= 1
                            break
                # segments below the open one (ghi - 1) are closed: their
                # phase-one state slots are final, so those groups resolve
                while pending and pending[0][3] <= ghi - 1:
                    entry = pending.popleft()
                    if entry[4] is not None:
                        held -= 1
                    yield from emit(entry)
        while pending:
            entry = pending.popleft()
            yield from emit(entry)
        for rep in all_targets:
            rep.groups_skipped = rep.groups_total - rep.groups_read
        cell["finals"] = keep_masks()

    def factory():
        if cell["finals"] is None:
            yield from first_pass()
            return
        if cell["replay"] is None:      # resolved keeps -> plain schedules
            schedules, locals_ = [], []
            for ph, off in zip(physicals, offsets):
                lk = _local_keeps(cell["finals"], off, ph.num_cases or 0)
                schedules.append(ph.final_schedule(
                    lk, ghosts=True, skippable=True, sketch=sketch))
                locals_.append(lk)
            cell["replay"] = (schedules, locals_)
        for ph, sched, lk in zip(physicals, *cell["replay"]):
            yield from _iter_chunks(ph, sched, lk, ph.chunk_columns,
                                    ph.read_columns, device=device)

    src = ChunkedEventFrame(factory, device, num_chunks=None,
                            tables=dict(physicals[0].reader.tables))
    return src, merged


def multi_pruned_source(mplan: MultiPlan, *, prune: bool = True,
                        mask_exact: bool = True, sketch: bool = False,
                        prefetch: int | None = None, device="cuda"
                        ) -> tuple[ChunkedEventFrame, ScanReport]:
    """Compile a multi-file plan into one re-iterable pruned chunk stream
    on ``device``.

    The stream is the concatenation of every file's pruned scan; a single
    kernel driven over it is bitwise equal to mining the concatenation of
    the files (the engine's carry crosses file boundaries exactly as it
    crosses row-group boundaries).  The returned report aggregates the
    per-file reports (``per_file``).  ``sketch`` attaches composed header
    sketch maps to every ghost chunk (what ``ghost_sketch`` kernels need);
    ``prefetch`` sets the read-ahead depth of every scan the source runs
    (``None`` = the ``REPRO_QUERY_PREFETCH`` environment default).

    Plans whose case predicates are all sketch-resolvable compile with
    zero phase-one passes; remaining data-dependent case predicates fuse
    into the scan itself (:func:`_single_pass_source`) when the plan is
    pruned with complete segment metadata — the classic two-pass schedule
    is the fallback.
    """
    with trace.span("scan.plan"):
        physicals = [compile_plan(p, prune) for p in mplan.per_file()]
    check_homogeneous(ph.reader for ph in physicals)
    reports = [_base_report(ph) for ph in physicals]
    offsets, total = _multi_offsets(physicals)
    steps = physicals[0].steps
    sk_keeps = _sketch_keeps(physicals, total, steps)
    data_pos = [i for i, s in enumerate(steps)
                if isinstance(s, CasePredicate) and i not in sk_keeps]
    depth = prefetch_depth(prefetch)
    if (prune and mask_exact and data_pos and total is not None
            and all(ph.can_ghost for ph in physicals)):
        for rep in reports:
            rep.prefetch = depth
        return _single_pass_source(physicals, reports, offsets, total,
                                   sk_keeps, data_pos, sketch, device)
    keeps = _multi_phase1(physicals, reports, offsets, total, prefetch,
                          seeded=sk_keeps, device=device)
    if offsets is None:
        offsets = [0] * len(physicals)
    schedules, locals_ = _multi_schedules(physicals, reports, offsets, keeps,
                                          ghosts=mask_exact,
                                          skippable=mask_exact,
                                          sketch=sketch)
    for rep in reports:
        rep.prefetch = depth

    def factory():
        for ph, sched, lk in zip(physicals, schedules, locals_):
            yield from _iter_chunks(ph, sched, lk, ph.chunk_columns,
                                    ph.read_columns, depth, device)

    src = ChunkedEventFrame(factory, device,
                            num_chunks=sum(len(s) for s in schedules),
                            tables=dict(physicals[0].reader.tables))
    return src, merge_reports(reports)


# ------------------------------------------------------------ public API
def count_cases(plan: "Plan | MultiPlan") -> int | None:
    """Total case segments across the plan's file(s), from header metadata
    only (None when any file lacks segment metadata)."""
    if isinstance(plan, MultiPlan):
        physicals = [compile_plan(Plan(p), True) for p in plan.paths]
        _, total = _multi_offsets(physicals)
        return total
    return compile_plan(Plan(plan.path), True).num_cases


def pruned_source(plan: "Plan | MultiPlan", *, prune: bool = True,
                  mask_exact: bool = True, sketch: bool = False,
                  prefetch: int | None = None, device="cuda"
                  ) -> tuple[ChunkedEventFrame, ScanReport]:
    """Compile a plan into a re-iterable pruned chunk stream on ``device``.

    ``mask_exact=False`` keeps every group in the stream (residual masks
    only) for consumers that inspect masked rows; ``sketch=True`` attaches
    the composed header sketch maps to ghost chunks (what ``ghost_sketch``
    kernels — variants — need to replay skipped runs).  The returned
    source plugs into ``engine.run_streaming``.  A single-file ``Plan`` is
    the one-path special case of :func:`multi_pruned_source`.
    """
    if isinstance(plan, Plan):
        plan = MultiPlan((plan.path,), plan.steps, plan.projection)
    return multi_pruned_source(plan, prune=prune, mask_exact=mask_exact,
                               sketch=sketch, prefetch=prefetch,
                               device=device)


def execute(plan: "Plan | MultiPlan", mine: engine.ChunkKernel, *,
            prune: bool = True, prefetch: int | None = None, device="cuda"):
    """Fold a chunk kernel over the pruned scan of ``plan`` on ``device``.

    Returns ``(result, report)`` with ``result`` bitwise equal to running
    the same kernel over the eagerly filtered whole log (for multi-file
    plans: the eagerly filtered concatenation of the files).
    ``prune=False`` executes the identical plan without zone-map skipping
    (the full-scan baseline).
    """
    src, report = pruned_source(
        plan, prune=prune, mask_exact=getattr(mine, "mask_exact", True),
        sketch=getattr(mine, "ghost_sketch", False), prefetch=prefetch,
        device=device)
    return engine.run_streaming(mine, src), report


# -------------------------------------------------- group-state execution
def grouped_eligible(kernel: engine.ChunkKernel, steps) -> bool:
    """True when a plan can run on the group-state algebra: the kernel
    defines a ``stitch`` (bitwise-mergeable states) and every plan step is
    a row-level expression (case-level keep masks are global, so those
    plans stay on the sequential schedules)."""
    return engine.mergeable(kernel) and not any(
        isinstance(s, CasePredicate) for s in steps)


def _unit_key(ph: PhysicalPlan, item: ReadItem, spec_fp, device) -> tuple:
    """State-cache key of one read unit: kernel spec fingerprint, the
    scan's device type and the lowering it resolves to, file path + group
    index, the group's content signature, and the residual predicate set
    the fold masked with ("" when none — zone-proved and unfiltered folds
    share entries)."""
    residual_fp = "&".join(repr(ph.steps[i]) for i in item.residual)
    dev = torch.device(device).type
    return (spec_fp, dev, backend.resolve(dev), ph.reader.path, item.index,
            ph.reader.group_signature(item.index), residual_fp)


def group_states(plan: "Plan | MultiPlan", kernel: engine.ChunkKernel,
                 spec_fp, *, prune: bool = True, device="cuda"):
    """One :class:`~repro_torch.core.engine.GroupState` per nonempty row
    group, on ``device``.

    Each unit of :meth:`PhysicalPlan.unit_schedule` is resolved to a
    group state three ways:

    * **cached** — the state cache (``query.statecache``) holds a fold of
      this exact group content (group signature), under this exact kernel
      spec (``spec_fp``, from :func:`~.statecache.spec_fingerprint`), on
      this device type and its lowering, and with this residual predicate
      set: reuse it with zero I/O (``groups_cached``);
    * **folded** — read the group, apply the residual masks (the same
      masking the sequential scan applies), fold it fresh, and cache the
      result (``groups_read`` / ``groups_folded``);
    * **ghosted** — a refuted group folds its O(segments) ghost chunk
      fresh each time (no I/O), counted in ``groups_skipped``.

    ``finalize_group(merge_tree(states))`` is bitwise equal to
    ``execute(plan, kernel)``.  Returns ``(states, report)`` in stream
    order.
    """
    from .statecache import state_cache

    if isinstance(plan, Plan):
        plan = MultiPlan((plan.path,), plan.steps, plan.projection)
    if not engine.mergeable(kernel):
        raise ValueError(f"kernel {kernel.name!r} defines no stitch — it "
                         f"cannot run on the group-state algebra")
    with trace.span("scan.plan"):
        physicals = [compile_plan(p, prune) for p in plan.per_file()]
    check_homogeneous(ph.reader for ph in physicals)
    if not grouped_eligible(kernel, physicals[0].steps):
        raise ValueError("group_states: case-level predicates are not "
                         "group-local — use execute()")
    reports = [_base_report(ph) for ph in physicals]
    cache = state_cache()
    sketch = getattr(kernel, "ghost_sketch", False)
    mask_exact = getattr(kernel, "mask_exact", True)
    states: list[engine.GroupState] = []
    for ph, rep in zip(physicals, reports):
        steps = ph.steps
        for item in ph.unit_schedule(sketch=sketch, mask_exact=mask_exact):
            if isinstance(item, GhostItem):
                with trace.span("scan.ghost"):
                    ghost = _ghost_chunk(item, ph.chunk_columns, ph.reader,
                                         device)
                    states.append(engine.fold_group(kernel, [ghost], device))
                continue
            g = item.index
            key = _unit_key(ph, item, spec_fp, device)
            hit = cache.get(key)
            if hit is not None:
                rep.groups_cached += 1
                states.append(hit)
                continue
            frame, _ = _read(ph.reader, g, ph.read_columns, device)
            mask = _row_mask(frame, steps, item.residual)
            sel = frame.select(ph.chunk_columns)
            gs = engine.fold_group(kernel, [EventFrame(sel.columns, sel.valid,
                                                       mask)], device)
            cache.put(key, gs)
            states.append(gs)
            rep.groups_folded += 1
            rep.groups_read += 1
            rep.bytes_read += ph.reader.group_nbytes(g, ph.read_columns)
            rep.rows_read += frame.nrows
            if not item.residual and ph.steps:
                rep.groups_proved += 1
        rep.groups_skipped = (rep.groups_total - rep.groups_read
                              - rep.groups_cached)
    return states, merge_reports(reports)


def execute_grouped(plan: "Plan | MultiPlan", kernel: engine.ChunkKernel,
                    spec_fp, *, prune: bool = True, device="cuda"):
    """Mine ``plan`` as a merge tree over per-group states on ``device``.

    ``finalize(merge_tree(group_states(plan)))`` — bitwise equal to
    :func:`execute` with the same kernel, but incremental: a re-collect
    only decodes what the state cache has not seen.  Returns
    ``(result, report)``.
    """
    states, report = group_states(plan, kernel, spec_fp, prune=prune,
                                  device=device)
    with trace.span("scan.merge"):
        merged = engine.merge_tree(kernel, states, device)
        return engine.finalize_group(kernel, merged), report


def grouped_cache_probe(plan: "Plan | MultiPlan", kernel: engine.ChunkKernel,
                        spec_fp, *, prune: bool = True,
                        device="cuda") -> dict | None:
    """How :func:`group_states` would resolve the plan *right now*, from
    headers alone — no data I/O, no cache mutation (probes with
    ``contains``, which skips the hit/miss counters).  Returns ``{"units",
    "cached", "fresh", "ghosted"}``, or ``None`` when the plan/kernel is
    not grouped-eligible."""
    from .statecache import state_cache

    if isinstance(plan, Plan):
        plan = MultiPlan((plan.path,), plan.steps, plan.projection)
    if not engine.mergeable(kernel):
        return None
    physicals = [compile_plan(p, prune) for p in plan.per_file()]
    if not grouped_eligible(kernel, physicals[0].steps):
        return None
    cache = state_cache()
    out = {"units": 0, "cached": 0, "fresh": 0, "ghosted": 0}
    for ph in physicals:
        for item in ph.unit_schedule(
                sketch=getattr(kernel, "ghost_sketch", False),
                mask_exact=getattr(kernel, "mask_exact", True)):
            out["units"] += 1
            if isinstance(item, GhostItem):
                out["ghosted"] += 1
            elif cache.contains(_unit_key(ph, item, spec_fp, device)):
                out["cached"] += 1
            else:
                out["fresh"] += 1
    return out


def _materialize(parts, physical: PhysicalPlan, device):
    """Concatenate compacted parts into one frame (+ projected tables)."""
    from repro_torch.core.eventframe import concat_frames

    parts = [p for p in parts if p.nrows] or parts[:1]
    tables = {k: v for k, v in physical.reader.tables.items()
              if k in physical.chunk_columns}
    if not parts:
        schema = physical.reader.schema
        cols = {k: np.zeros(0, np.dtype(schema[k]["dtype"]))
                for k in physical.chunk_columns}
        valid = {k: np.zeros(0, bool) for k in physical.chunk_columns
                 if schema[k].get("has_valid") or "valid_offset" in schema[k]}
        return EventFrame.from_numpy(cols, valid, device=device), tables
    return concat_frames(parts), tables


def execute_frame(plan: "Plan | MultiPlan", *, prune: bool = True,
                  prefetch: int | None = None, device="cuda"):
    """Materialize the filtered, projected frame on ``device`` (rows the
    predicates refute are dropped — equal to the eager filter chain +
    ``compact``; multi-file plans concatenate in path order).

    Returns ``(frame, tables, report)``.
    """
    if isinstance(plan, Plan):
        plan = MultiPlan((plan.path,), plan.steps, plan.projection)
    physicals, reports, offsets, keeps = _multi_compile(plan, prune, prefetch,
                                                        device)
    schedules, locals_ = _multi_schedules(physicals, reports, offsets,
                                          keeps, ghosts=False,
                                          skippable=True)
    depth = prefetch_depth(prefetch)
    for rep in reports:
        rep.prefetch = depth
    parts = []
    for ph, sched, lk in zip(physicals, schedules, locals_):
        parts += [c.compact() for c in
                  _iter_chunks(ph, sched, lk, ph.chunk_columns,
                               ph.read_columns, depth, device)]
    frame, tables = _materialize(parts, physicals[0], device)
    return frame, tables, merge_reports(reports)
