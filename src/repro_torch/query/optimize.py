"""Plan compilation: predicate + projection pushdown over zone maps.

``compile_plan`` turns a logical :class:`repro_torch.query.plan.Plan` into a
:class:`PhysicalPlan`:

* **predicate pushdown** — every row-level conjunct is ``prove()``-d
  against each row group's zone maps; a group any conjunct refutes is
  never read (its byte extents are never touched), and a group a conjunct
  *proves* skips that conjunct's residual mask;
* **projection pushdown** — the scan reads only the union of the
  consumer's columns and the columns of the predicates that still need
  residual evaluation (plus the case column when segment bookkeeping is
  required);
* **segment accounting** — from the per-group ``segments`` / ``tail``
  metadata the planner derives, without any data I/O, the global segment
  id of every group's first row and the total case count.  This is what
  keeps case-indexed kernels (case sizes, durations, variants, case-level
  filters) bitwise identical under pruning: a skipped run of groups is
  replaced by an O(segments) *ghost chunk* that advances the engine's
  carry exactly as the unread rows would have (all of them masked).
  When the consumer declares ``ghost_sketch`` (variants), the ghost also
  carries the run's composed per-segment affine polyhash maps
  (``core.polyhash``), so even validity-blind hashing replays skipped
  runs exactly;
* **two-pass planning** — each :class:`CasePredicate` gets its own
  phase-one schedule (pruned by the conjuncts that precede it in the
  plan), whose streamed kernel result becomes a per-case keep mask; the
  final scan then also skips groups whose entire segment range is
  refuted by the keep masks.

The executor (``repro_torch.query.exec``) asks the physical plan for a
*schedule* — an ordered list of ``read`` / ``ghost`` items — once the
phase-one keep masks are known.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.eventframe import ACTIVITY, CASE
from repro_torch.storage.edf import EDFReader, pooled_reader

from .expr import ALL, NONE, CasePredicate, Expr, bind_schema
from .plan import Plan


@dataclasses.dataclass(frozen=True)
class ReadItem:
    """Read group ``index`` and mask it with the listed residual steps."""

    index: int
    residual: tuple       # step positions (Expr) needing per-row evaluation
    case_steps: tuple     # step positions (CasePredicate) to broadcast


@dataclasses.dataclass(frozen=True)
class GhostItem:
    """A run of consecutive skipped groups, collapsed to segment metadata."""

    indices: tuple        # skipped group indices (ascending, all nonempty)
    segments: int         # distinct case segments across the run
    first_case: int       # case id of the run's first row
    tail: dict            # last row's {"values", "valid"} halo
    sketch: dict | None = None  # per-segment composed affine polyhash maps
    #   ({"mul1","add1","mul2","add2"} uint32 arrays of length ``segments``,
    #   header sketches composed across the run's group boundaries) — only
    #   materialized when the consumer asked for it (kernel.ghost_sketch)


@dataclasses.dataclass
class PhysicalPlan:
    reader: EDFReader
    plan: Plan
    steps: tuple                    # resolved steps, plan order
    chunk_columns: tuple            # what the consumer (kernel) sees
    read_columns: tuple             # what the scan materializes
    prune: bool
    metas: list | None              # per-group metadata (None: prune=False)
    proves: dict                    # expr step position -> list[str] per group
    seg_start: np.ndarray | None    # global segment id of each group's row 0
    seg_count: np.ndarray | None    # segments per group
    num_cases: int | None           # total case segments in the file
    can_ghost: bool                 # segment metadata complete enough to skip

    # ------------------------------------------------------------ helpers
    def _nonempty(self):
        return [g for g in range(self.reader.num_groups)
                if self.reader.group_nrows(g) > 0]

    def _keep_refutes(self, g: int, pos: int, keeps: dict) -> bool:
        """True when keep mask of the case predicate at ``pos`` rules out
        every segment that intersects group ``g``."""
        if self.seg_start is None:
            return False            # no segment metadata — never skip by keep
        lo = int(self.seg_start[g])
        hi = lo + int(self.seg_count[g])
        return not keeps[pos][lo:hi].any()

    def _run_sketch(self, run) -> dict:
        """Compose the run's per-group header sketches into one per-segment
        map list, merging the maps of a case that straddles a group boundary
        (apply the earlier group's partial map first, then the later's)."""
        acc: dict | None = None
        prev_tail = None
        for g in run:
            sk = self.reader.group_sketch(g)
            if sk is None:
                raise ValueError(
                    f"group {g} of {self.reader.path!r} has no variant "
                    f"sketch (case/activity columns missing?) — cannot "
                    f"ghost-skip it for a sketch-consuming kernel")
            first = self.metas[g]["zones"][CASE]["min"]
            if acc is None:
                acc = {k: sk[k].copy() for k in sk}
            elif prev_tail is not None and first == prev_tail:
                for mk, ak in (("mul1", "add1"), ("mul2", "add2")):
                    # python-int compose: uint32 scalar ops would warn on wrap
                    m0, a0 = int(sk[mk][0]), int(sk[ak][0])
                    acc[ak][-1] = (int(acc[ak][-1]) * m0 + a0) & 0xFFFFFFFF
                    acc[mk][-1] = (int(acc[mk][-1]) * m0) & 0xFFFFFFFF
                acc = {k: np.concatenate([acc[k], sk[k][1:]]) for k in sk}
            else:
                acc = {k: np.concatenate([acc[k], sk[k]]) for k in sk}
            prev_tail = self.metas[g]["tail"]["values"][CASE]
        return acc

    def _schedule(self, skip, residual, case_steps, ghosts: bool,
                  sketch: bool = False):
        """Fold per-group decisions into read items and ghost runs."""
        items: list = []
        run: list[int] = []

        def flush():
            if not run:
                return
            segs = 0
            prev_tail = None
            for g in run:
                first = self.metas[g]["zones"][CASE]["min"]
                segs += int(self.metas[g]["segments"])
                if prev_tail is not None and first == prev_tail:
                    segs -= 1
                prev_tail = self.metas[g]["tail"]["values"][CASE]
            items.append(GhostItem(
                tuple(run), segs,
                self.metas[run[0]]["zones"][CASE]["min"],
                self.metas[run[-1]]["tail"],
                self._run_sketch(run) if sketch else None))
            run.clear()

        for g in self._nonempty():
            if skip(g):
                if ghosts:
                    run.append(g)
                continue
            flush()
            items.append(ReadItem(g, tuple(residual(g)), tuple(case_steps)))
        flush()
        return items

    # ----------------------------------------------------------- schedules
    def phase1_schedule(self, pos: int, keeps: dict, sketch: bool = False):
        """Schedule for phase one of the case predicate at step ``pos``;
        pruned by the plan steps that precede it."""
        pred = self.steps[pos]
        before_exprs = [i for i in range(pos) if isinstance(self.steps[i], Expr)]
        before_cases = [i for i in range(pos)
                        if isinstance(self.steps[i], CasePredicate)]

        def skip(g):
            # phase-one kernels are segment-indexed: skipping is only safe
            # when a ghost chunk can advance the numbering
            if not (self.prune and self.can_ghost):
                return False
            if any(self.proves[i][g] == NONE for i in before_exprs):
                return True
            if pred.phase1_prove(self.metas[g]) == NONE:
                return True
            return any(self._keep_refutes(g, i, keeps) for i in before_cases)

        def residual(g):
            # keep every conjunct the zone maps did not PROVE: a group that
            # is read despite a NONE proof (no ghost available) still needs
            # its refuting predicate applied to mask the rows
            if not self.prune:
                return before_exprs
            return [i for i in before_exprs if self.proves[i][g] != ALL]

        return self._schedule(skip, residual, tuple(before_cases),
                              ghosts=self.can_ghost and self.prune,
                              sketch=sketch)

    def final_schedule(self, keeps: dict, ghosts: bool = True,
                       skippable: bool = True, sketch: bool = False):
        """Schedule for the final (mine / materialize) pass.

        ``skippable=False`` reads every group (consumers that inspect
        masked rows — ``mask_exact=False`` kernels) while still skipping
        residual evaluation on groups the zone maps prove.
        """
        exprs = [i for i, s in enumerate(self.steps) if isinstance(s, Expr)]
        cases = [i for i, s in enumerate(self.steps)
                 if isinstance(s, CasePredicate)]
        # with ghosts requested (mine path), a skip is only safe when the
        # segment metadata can stand in for the unread rows; without ghosts
        # (materialize path) skipped rows are simply dropped
        can_skip = self.prune and skippable and (self.can_ghost or not ghosts)

        def skip(g):
            if not can_skip:
                return False
            if any(self.proves[i][g] == NONE for i in exprs):
                return True
            return any(self._keep_refutes(g, i, keeps) for i in cases)

        def residual(g):
            # non-ALL (not just SOME): a NONE-proved group can still be
            # read — mask_exact=False consumers, or no ghost metadata —
            # and must then arrive with its rows masked
            if not self.prune:
                return exprs
            return [i for i in exprs if self.proves[i][g] != ALL]

        return self._schedule(skip, residual, tuple(cases),
                              ghosts=ghosts and self.can_ghost and self.prune,
                              sketch=sketch)

    def unit_schedule(self, sketch: bool = False, mask_exact: bool = True):
        """Group-granular schedule: exactly one item per nonempty group.

        The group-state algebra (``core.engine``) folds each item into its
        own :class:`~repro_torch.core.engine.GroupState`, so units must map 1:1
        to row groups — no run coalescing, or the per-group states could
        not be cached and re-merged independently.  Refuted groups become
        *single-group* ghost items (segment metadata permitting); their
        fold is O(segments) with zero I/O.  Only row-level (``Expr``)
        plans qualify — case-level predicates need global keep masks and
        stay on the sequential schedules.
        """
        exprs = [i for i, s in enumerate(self.steps) if isinstance(s, Expr)]
        if any(isinstance(s, CasePredicate) for s in self.steps):
            raise ValueError("unit_schedule: case-level predicates are not "
                             "group-local — use final_schedule")
        items: list = []
        for g in self._nonempty():
            refuted = self.prune and any(
                self.proves[i][g] == NONE for i in exprs)
            if refuted and self.can_ghost and mask_exact:
                meta = self.metas[g]
                items.append(GhostItem(
                    (g,), int(self.seg_count[g]),
                    meta["zones"][CASE]["min"], meta["tail"],
                    self._run_sketch([g]) if sketch else None))
                continue
            residual = [i for i in exprs if self.proves[i][g] != ALL] \
                if self.prune else exprs
            items.append(ReadItem(g, tuple(residual), ()))
        return items


def compile_plan(plan: Plan, prune: bool = True) -> PhysicalPlan:
    # readers are pooled: every plan over the same file shares one cached
    # header (and one open handle) — a multi-file plan compiles N plans
    # without re-parsing or re-synthesizing anything
    reader = pooled_reader(plan.path)
    steps = tuple(s.resolve(reader.tables) if isinstance(s, CasePredicate)
                  else bind_schema(s, reader.schema) for s in plan.steps)
    exprs = [(i, s) for i, s in enumerate(steps) if isinstance(s, Expr)]
    case_steps = [s for s in steps if isinstance(s, CasePredicate)]

    chunk_columns = tuple(plan.projection) if plan.projection is not None \
        else reader.column_names
    unknown = set(chunk_columns) - set(reader.column_names)
    for _, e in exprs:
        unknown |= e.columns() - set(reader.column_names)
    for s in case_steps:
        unknown |= s.columns() - set(reader.column_names)
    if unknown:
        raise KeyError(f"plan references columns not in {plan.path!r}: "
                       f"{sorted(unknown)}")
    read = set(chunk_columns)
    for _, e in exprs:
        read |= e.columns()
    for s in case_steps:
        # phase-one kernels + segment broadcast + the predicate's column
        read |= {CASE, ACTIVITY} | s.columns()
    read_columns = tuple(sorted(read))

    metas = None
    proves: dict = {}
    seg_start = seg_count = None
    num_cases = None
    can_ghost = False
    if prune or case_steps:
        # case predicates need the segment accounting (kernel capacity +
        # keep-mask broadcast) even on an unpruned scan
        metas = [reader.group_meta(g) for g in range(reader.num_groups)]
        if prune:
            proves = {i: [e.prove(metas[g]) for g in range(reader.num_groups)]
                      for i, e in exprs}
        nonempty = [g for g in range(reader.num_groups)
                    if reader.group_nrows(g) > 0]
        can_ghost = (CASE in reader.schema and
                     all("segments" in metas[g] for g in nonempty))
        if can_ghost:
            seg_start = np.zeros(reader.num_groups, np.int64)
            seg_count = np.zeros(reader.num_groups, np.int64)
            last_seg, prev_tail = -1, None
            for g in nonempty:
                first = metas[g]["zones"][CASE]["min"]
                cont = prev_tail is not None and first == prev_tail
                seg_start[g] = last_seg if cont else last_seg + 1
                seg_count[g] = int(metas[g]["segments"])
                last_seg = seg_start[g] + seg_count[g] - 1
                prev_tail = metas[g]["tail"]["values"][CASE]
            num_cases = int(last_seg) + 1
    return PhysicalPlan(reader, plan, steps, chunk_columns, read_columns,
                        prune, metas, proves, seg_start, seg_count,
                        num_cases, can_ghost)
