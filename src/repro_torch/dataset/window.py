"""Sliding windows over a dataset: re-merge cached group states per window.

``Dataset.window(by=..., size=..., step=...)`` turns the one-shot facade
into the paper's "online scenario" without a second mining machinery:

* ``by="groups"`` — the window unit is one nonempty row group (the
  storage layout's natural chunk).  A window is a contiguous span of
  units; mining it is ``finalize(merge_tree(states[lo:hi]))`` over the
  *same* per-group :class:`~repro_torch.core.engine.GroupState` values the
  streaming engine folds and caches (``query.statecache``) — so sliding
  by ``step`` re-decodes **nothing**: the ring of states is already
  resident and each slide only re-merges, at a cost proportional to the
  window's unit count (and after the first window the fold cost is
  proportional to the *delta* units entering the ring, since every other
  unit state is a cache hit).
* ``by="time"`` — windows are ``[t, t + size]`` intervals stepped by
  ``step`` across the dataset's timestamp extent (header zone maps; both
  edges inclusive, so with ``step == size`` a boundary row belongs to
  both adjacent windows).  Each window is an ordinary
  ``filter(col(timestamp).between(...)).collect(...)``: zone maps refute
  the groups outside the interval, and the groups *inside* it fold with
  an empty residual fingerprint — the same cache entries the unfiltered
  collect uses, so successive overlapping windows share state.

Windows mine on the dataset's device (group states, merges and the
scratch path's masked chunks alike); a card dataset's window answers are
delivered to page-locked host memory, as ``Dataset.collect``'s are.
Every window's result is **bitwise
equal** to mining the same rows from scratch — the merge reconstructs the fresh fold exactly (``core.engine``
invariant), and verbs without a mergeable state (``sojourn_times`` /
``performance_dfg`` / ``stats``) transparently re-mine each window
sequentially instead.

On top of the windowed collects:

* :meth:`Windows.drift` scores each window's DFG footprint against the
  previous window's (or a fixed reference) — concept-drift detection as
  one merge + one footprint comparison per slide;
* :meth:`Windows.conformance` replays every window against a discovered
  model (same dispatch as ``Dataset.conformance``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

import torch

from repro_torch.core import engine as _engine
from repro_torch.core.eventframe import TIMESTAMP, EventFrame

from . import engines


@dataclasses.dataclass(frozen=True)
class WindowResult:
    """Per-window results of one windowed collect.

    ``results[i]`` is the verb's result over window ``bounds[i]`` —
    bitwise equal to collecting the same rows from scratch.  ``report``
    aggregates the scan accounting of the underlying group-state
    resolution (None for in-memory datasets); its ``groups_cached`` /
    ``groups_folded`` counters show how much the window ring reused.
    """

    results: tuple
    bounds: tuple               # (lo, hi) unit spans or (t_lo, t_hi) times
    by: str
    verb: Any
    report: Any | None = None

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i):
        return self.results[i]


def _check_row_level(steps) -> None:
    from repro_torch.query.expr import CasePredicate

    if any(isinstance(s, CasePredicate) for s in steps):
        raise ValueError("window() supports row-level filters only — "
                         "case-level predicates are global (their keep "
                         "masks span windows); apply them per window "
                         "instead")


def _time_extent(dataset) -> tuple[float, float]:
    """The dataset's [min, max] timestamp from header zone maps (files) or
    the frame column (in-memory)."""
    if not dataset.is_files:
        ts = dataset.frame[TIMESTAMP]
        if not ts.numel():
            raise ValueError("window(by='time') over an empty dataset")
        return float(ts.min()), float(ts.max())
    lo = hi = None
    for r in dataset._readers:
        for g in range(r.num_groups):
            if r.group_nrows(g) == 0:
                continue
            z = r.group_meta(g)["zones"].get(TIMESTAMP)
            if z is None or "min" not in z:
                raise ValueError(
                    f"window(by='time') needs {TIMESTAMP!r} zone maps in "
                    f"every file (rewrite as EDFV0003)")
            lo = float(z["min"]) if lo is None else min(lo, float(z["min"]))
            hi = float(z["max"]) if hi is None else max(hi, float(z["max"]))
    if lo is None:
        raise ValueError("window(by='time') over an empty dataset")
    return lo, hi


@dataclasses.dataclass(frozen=True)
class Windows:
    """A sliding-window view built by :meth:`Dataset.window` (see module
    docstring).  Immutable; every method re-derives from the dataset."""

    dataset: Any
    by: str
    size: float
    step: float

    def __post_init__(self):
        if self.by not in ("groups", "time"):
            raise ValueError(f"window by={self.by!r}; one of 'groups', "
                             f"'time'")
        if self.size <= 0 or self.step <= 0:
            raise ValueError("window size and step must be positive")
        if self.by == "groups":
            if self.size != int(self.size) or self.step != int(self.step):
                raise ValueError("window(by='groups') takes integer "
                                 "size/step (units are row groups)")
            if not self.dataset.is_files:
                raise ValueError("window(by='groups') needs a file-backed "
                                 "dataset (the unit is one row group)")
        _check_row_level(self.dataset.steps)

    # ------------------------------------------------------------ geometry
    def _num_units(self) -> int:
        return sum(1 for r in self.dataset._readers
                   for g in range(r.num_groups) if r.group_nrows(g) > 0)

    def bounds(self) -> tuple:
        """The window extents: ``(lo, hi)`` unit spans (``by="groups"``,
        half-open) or ``(t_lo, t_hi)`` time intervals (inclusive)."""
        if self.by == "groups":
            n = self._num_units()
            size, step = int(self.size), int(self.step)
            return tuple((off, min(off + size, n))
                         for off in range(0, max(n, 1), step)
                         if off < n or off == 0)
        lo, hi = _time_extent(self.dataset)
        out = []
        start = lo
        while True:
            out.append((start, start + self.size))
            if start + self.size >= hi:
                break
            start += self.step
        return tuple(out)

    # ------------------------------------------------------------ collects
    def collect(self, verb: str, **kwargs) -> WindowResult:
        """Run a registered verb over every window."""
        if self.by == "time":
            return self._collect_time(verb, kwargs)
        return self._collect_groups(verb, kwargs)

    def collect_many(self, verbs: Iterable[str], *,
                     verb_kwargs: Mapping[str, dict] | None = None,
                     **common) -> WindowResult:
        """Fused windowed collection: each window yields the per-verb
        result dict of one :func:`~repro_torch.core.engine.compose_specs` pass
        (merge-tree over fused group states when every member stitches)."""
        verbs = tuple(verbs)
        vk = dict(verb_kwargs or {})
        if self.by == "time":
            common.setdefault("engine", "streaming")
            results, reports, bounds = [], [], self.bounds()
            for t_lo, t_hi in bounds:
                res = self._window_ds(t_lo, t_hi).collect_many(
                    verbs, verb_kwargs=vk, **common)
                results.append(dict(res.results))
                reports.append(res.report)
            return WindowResult(tuple(results), bounds, self.by, verbs,
                                _merge_optional(reports))
        specs = {v: engines.spec_for(v) for v in verbs}
        fused = _engine.compose_specs(specs)
        dims = _engine.Dims(self.dataset.num_activities,
                            self.dataset.num_cases)
        kernel = fused.make(dims, verb_kwargs=vk, **common)
        fp = engines._spec_fp("+".join(verbs), dims,
                              {"verb_kwargs": sorted(vk.items()), **common})
        results, bounds, report = self._grouped_results(
            kernel, fp, post=dict)
        return WindowResult(tuple(results), bounds, self.by, verbs, report)

    def _window_ds(self, t_lo: float, t_hi: float):
        from repro_torch.query.expr import col

        return self.dataset.filter(col(TIMESTAMP).between(t_lo, t_hi))

    def _collect_time(self, verb: str, kwargs) -> WindowResult:
        # default to streaming: the grouped path lets overlapping windows
        # share cached interior-group states (auto might pick eager)
        kwargs.setdefault("engine", "streaming")
        results, reports, bounds = [], [], self.bounds()
        for t_lo, t_hi in bounds:
            res = engines.collect(self._window_ds(t_lo, t_hi), verb,
                                  **kwargs)
            results.append(res.result)
            reports.append(res.report)
        return WindowResult(tuple(results), bounds, self.by, verb,
                            _merge_optional(reports))

    def _collect_groups(self, verb: str, kwargs) -> WindowResult:
        spec = engines.spec_for(verb)
        dims = _engine.Dims(self.dataset.num_activities,
                            self.dataset.num_cases)
        kernel = spec.make(dims, **kwargs)
        fp = engines._spec_fp(verb, dims, kwargs)
        results, bounds, report = self._grouped_results(kernel, fp)
        return WindowResult(tuple(results), bounds, self.by, verb, report)

    def _grouped_results(self, kernel, spec_fp, post=None):
        """Fold once, merge per window — or re-mine each window from
        scratch when the kernel has no mergeable state; every window's
        answer delivered to the host as the front door delivers one."""
        from repro_torch.query.exec import group_states

        bounds = self.bounds()
        device = self.dataset.device
        if _engine.mergeable(kernel):
            states, report = group_states(
                self.dataset.plan(columns=kernel.columns), kernel, spec_fp,
                device=device)
            results = []
            for lo, hi in bounds:
                merged = _engine.merge_tree(kernel, states[lo:hi], device)
                out = _engine.finalize_group(kernel, merged)
                results.append(post(out) if post else out)
            return engines._deliver(results), bounds, report
        # no stitch: each window folds its rows sequentially from scratch
        units, physicals = self._units(kernel.columns)
        results = []
        for lo, hi in bounds:
            state, carry = kernel.init(device)
            for chunk in _unit_chunks(units[lo:hi], device):
                if chunk.nrows:
                    state, carry = kernel.update(state, carry, chunk)
            out = kernel.finalize(state, carry)
            results.append(post(out) if post else out)
        return engines._deliver(results), bounds, None

    def _units(self, columns):
        """The global unit list [(physical, group)] in stream order."""
        from repro_torch.query.optimize import compile_plan

        plan = self.dataset.plan(columns=columns)
        physicals = [compile_plan(p, True) for p in plan.per_file()]
        units = [(ph, g) for ph in physicals for g in ph._nonempty()]
        return units, physicals

    # ------------------------------------------------------------ analyses
    def drift(self, reference=None, *, min_count: int = 1,
              **kwargs) -> list[float]:
        """Per-window footprint-drift scores in [0, 1].

        Each window's DFG footprint (alpha relation classes) is compared
        to the *previous* window's — 1.0 means the behavioural relations
        are unchanged, lower means drift — or to a fixed ``reference``
        (a DFG, a :class:`~repro_torch.core.discovery.Footprint`, or any model
        with one) when given, its footprint copied to where the windows'
        DFGs are delivered.  The first window scores 1.0 against
        ``reference=None`` (nothing to drift from).
        """
        from repro_torch.core.conformance import footprint_conformance
        from repro_torch.core.dfg import DFG
        from repro_torch.core.discovery import footprint
        from repro_torch.core.engine import map_tensors

        dfgs = self.collect("dfg", **kwargs).results
        ref = footprint(reference, min_count) \
            if isinstance(reference, DFG) else reference
        if ref is not None and dfgs:
            dev = dfgs[0].counts.device
            ref = map_tensors(lambda t: t.to(dev),
                              getattr(ref, "footprint", ref))
        scores: list[float] = []
        prev = None
        for d in dfgs:
            model = ref if ref is not None else prev
            scores.append(1.0 if model is None
                          else float(footprint_conformance(d, model)))
            if ref is None:
                prev = footprint(d, min_count)
        return scores

    def conformance(self, model, **kwargs) -> list[float]:
        """Replay every window's DFG against a discovered model (same
        dispatch as :meth:`Dataset.conformance`): per-window fitness."""
        from repro_torch.core import conformance as _conformance

        from .dataset import _allowed

        dfgs = self.collect("dfg", **kwargs).results
        allowed = _allowed(model, dfgs[0].counts.device) if dfgs else None
        return [float(_conformance.footprint_fitness(d, allowed))
                for d in dfgs]


def _merge_optional(reports):
    from repro_torch.query.exec import merge_reports

    reports = [r for r in reports if r is not None]
    return merge_reports(reports) if reports else None


def _unit_chunks(units, device):
    """Masked chunks of a unit span on ``device`` — the scratch path's
    stream (reads every unit; residual masks refute rows exactly like the
    pruned scan)."""
    from repro_torch.query.expr import ALL, Expr

    for ph, g in units:
        frame = ph.reader.read_group(g, ph.read_columns, device=device)
        exprs = [i for i, s in enumerate(ph.steps) if isinstance(s, Expr)]
        residual = [i for i in exprs if ph.proves[i][g] != ALL] \
            if ph.prune else exprs
        mask = torch.ones(frame.nrows, dtype=torch.bool, device=device)
        for i in residual:
            mask &= ph.steps[i].mask(frame).to(torch.bool)
        sel = frame.select(ph.chunk_columns)
        yield EventFrame(sel.columns, sel.valid, mask)
