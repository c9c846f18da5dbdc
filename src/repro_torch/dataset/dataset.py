"""The ``Dataset`` facade: one fluent API over every execution engine.

``repro_torch.open(...)`` accepts a path, an ordered list of paths (the
partitions of one (case,time)-sorted log), or an in-memory
:class:`~repro_torch.core.eventframe.EventFrame`, and returns an immutable
:class:`Dataset` bound to a device (``device="cuda"`` unless the caller
names the CPU).  Transformations (``filter`` / ``project`` / ``union``)
return new datasets and never touch data; terminal verbs (``dfg`` /
``variants`` / ``stats`` / ``alpha`` / ``heuristics`` / ``conformance`` /
``to_frame``) compile the accumulated steps into one logical plan over the
whole file set and hand it to an execution engine::

    import repro_torch
    from repro_torch import col, cases_containing

    ds = repro_torch.open(["jan.edf", "feb.edf", "mar.edf"])
    graph = ds.filter(col("org:resource") == 7).dfg()     # cold groups unread
    net   = ds.filter(cases_containing("pay")).heuristics()

Every verb resolves through the :class:`~repro_torch.core.engine.KernelSpec`
registry (verbs are data, not if-chains) and accepts ``engine=``:

* ``"eager"``      — load everything, filter in memory, mine once (the
  paper's baseline; fastest for small survivors);
* ``"streaming"``  — zone-map-pruned scans, one chunk resident at a time
  (``repro_torch.query``); refuted row groups are never read;
* ``"sharded"``    — the pruned stream sharded over a single-controller
  mesh of devices (``repro_torch.distributed.query``; shard *i* on
  ``cuda:(i % device_count)``); verbs without a distributed state shard
  as a merge tree of group states;
* ``"auto"``       — cost-based choice from header metadata only (file
  sizes + zone-map selectivity; see ``repro_torch.dataset.engines``).

Whatever the engine, the result is bitwise equal to mining the eagerly
filtered concatenation of the files — the engines are interchangeable
lowerings of one logical plan, which is what makes the choice safe to
automate.  Every engine runs on the dataset's ``device``: the files'
groups are decoded on the host and copied there, and the verbs' kernels
launch there (or raise — nothing falls back to the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.eventframe import (ACTIVITY, CASE, EventFrame,
                                         concat_frames)
from repro_torch.query.plan import MultiPlan, check_predicate

from . import engines


def _is_pathlike(x) -> bool:
    import os

    return isinstance(x, (str, os.PathLike))


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    """The numpy dtype of a tensor's elements (what EDF schemas name)."""
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _allowed(model, device) -> torch.Tensor:
    """The relations a model allows as a bool tensor on ``device`` (the
    footprint-fitness operand): a heuristics net's dependency graph, an
    alpha model's footprint, or an array-like matrix."""
    from repro_torch.core.discovery import AlphaModel, HeuristicsNet

    if isinstance(model, HeuristicsNet):
        model = model.graph
    elif isinstance(model, AlphaModel):
        model = model.footprint.direct
    if not isinstance(model, torch.Tensor):
        model = torch.as_tensor(np.asarray(model))
    return model.to(device=device, dtype=torch.bool)


@dataclasses.dataclass(frozen=True, eq=False)
class Dataset:
    """Immutable, fluent view over a set of EDF files or one in-memory
    frame, bound to the ``device`` its verbs run on (see module
    docstring).  Construct with :func:`repro_torch.open`."""

    paths: tuple = ()
    frame: EventFrame | None = None
    frame_tables: dict = dataclasses.field(default_factory=dict)
    steps: tuple = ()
    projection: tuple | None = None
    hint_activities: int | None = None
    hint_cases: int | None = None
    device: Any = "cuda"

    # -------------------------------------------------------- transforms
    def filter(self, predicate) -> "Dataset":
        """Append a predicate (row-level ``Expr`` or two-pass
        ``CasePredicate``); composes like the eager filter chain."""
        check_predicate(predicate)
        return dataclasses.replace(self, steps=self.steps + (predicate,))

    def project(self, columns: Iterable[str]) -> "Dataset":
        """Restrict the columns the dataset exposes (and the scans read)."""
        return dataclasses.replace(self, projection=tuple(columns))

    def union(self, other: "Dataset") -> "Dataset":
        """Concatenate another dataset's files (or frame rows) after this
        one's.  Both sides must be in the same filter/projection state —
        union the raw opens first, then filter the union."""
        if not isinstance(other, Dataset):
            raise TypeError(f"union() takes a Dataset, got "
                            f"{type(other).__name__}")
        if self.steps != other.steps or self.projection != other.projection:
            raise ValueError(
                "union() requires identical filter/projection state on both "
                "sides; build the union first, then filter it")
        # capacity hints never carry over: num_cases of a union is the sum
        # (minus straddles) and must be re-derived; num_activities only
        # survives when both sides agree
        acts = (self.hint_activities
                if self.hint_activities == other.hint_activities else None)
        if self.is_files and other.is_files:
            return dataclasses.replace(self, paths=self.paths + other.paths,
                                       hint_activities=acts, hint_cases=None)
        if not self.is_files and not other.is_files:
            if self.frame_tables != other.frame_tables:
                raise ValueError("union() of frames with different "
                                 "dictionary tables")
            out = concat_frames([self.frame, other.frame])
            return dataclasses.replace(self, frame=out,
                                       hint_activities=acts, hint_cases=None)
        raise ValueError("union() cannot mix file-backed and in-memory "
                         "datasets; write the frame to EDF first")

    def append(self, frame: EventFrame, *, path: str | None = None,
               tables: Mapping[str, list] | None = None,
               row_group_rows: int | None = None) -> "Dataset":
        """Append ``frame``'s rows to the dataset's last file, atomically.

        The rows become new row groups of that file
        (``storage.edf.append``): old groups' bytes — and their content
        signatures, and therefore the group-state cache — are untouched,
        and the header rewrite is atomic (temp file + ``os.replace``), so
        concurrent readers see either the old snapshot or the new one,
        never a torn mix.  The frame must match the file's schema, be
        case-sorted, and start at/after the file's tail case (the log
        stays (case, time)-sorted case-major across the whole set, which
        is why only the *last* file may grow — earlier partitions are
        sealed).  Dictionary ``tables`` may extend the file's.

        Returns a dataset over the same paths (shape accessors are live,
        so this handle sees the new rows too; the return value exists for
        fluent chaining).  ``row_group_rows=None`` appends one group.
        """
        from repro_torch.storage.edf import append as edf_append

        if not self.is_files:
            raise ValueError("append() needs a file-backed dataset; write "
                             "the frame to EDF first")
        target = str(path) if path is not None else self.paths[-1]
        if target != self.paths[-1]:
            raise ValueError(
                f"append() only extends the last file of the set "
                f"({self.paths[-1]!r}); earlier partitions are sealed")
        edf_append(target, frame, tables=tables,
                   row_group_rows=row_group_rows)
        return dataclasses.replace(self)

    # ------------------------------------------------------------- shape
    # Shape accessors are *live* properties, not cached: files can grow
    # underneath a Dataset via :meth:`append` (this handle or another),
    # and a collect must size its kernels for the groups it will actually
    # scan.  The reads are header-only through pooled readers, so the
    # recompute is cheap; pin capacities explicitly via
    # ``repro_torch.open(..., num_cases=N)`` when kernel-shape stability
    # matters (the mining service does — that is what keeps its state
    # cache warm across appends).
    @property
    def is_files(self) -> bool:
        return bool(self.paths)

    @property
    def _readers(self) -> tuple:
        from repro_torch.storage.edf import pooled_reader

        return tuple(pooled_reader(p) for p in self.paths)

    @property
    def tables(self) -> dict:
        """Dictionary tables, merged across the file set.  Each file's
        table must be a *prefix* of the longest one for its column —
        appends may extend a table (old ids keep their meaning), never
        reorder it — so partitions written before an alphabet grew stay
        unioned with ones written after."""
        if not self.is_files:
            return dict(self.frame_tables)
        merged: dict[str, list] = {}
        for r in self._readers:
            for name, table in r.tables.items():
                cur = merged.get(name)
                if cur is None:
                    merged[name] = list(table)
                    continue
                short, long_ = sorted((cur, list(table)), key=len)
                if long_[:len(short)] != short:
                    raise ValueError(
                        f"dataset files disagree on the dictionary table "
                        f"of {name!r} (not a prefix extension): "
                        f"{self.paths[0]!r} vs {r.path!r}")
                merged[name] = long_
        return merged

    @property
    def schema(self) -> dict:
        """Column name -> {"dtype": ...} (from the files, or synthesized
        from the frame's arrays) — what predicate constants bind against."""
        if self.is_files:
            return dict(self._readers[0].schema)
        return {k: {"dtype": str(_numpy_dtype(v))}
                for k, v in self.frame.columns.items()}

    @property
    def num_activities(self) -> int:
        if self.hint_activities is not None:
            return int(self.hint_activities)
        table = self.tables.get(ACTIVITY)
        if table is not None:
            return len(table)
        if self.is_files:
            hi = -1
            for r in self._readers:
                for g in range(r.num_groups):
                    if r.group_nrows(g) == 0:
                        continue
                    z = r.group_meta(g)["zones"].get(ACTIVITY)
                    if z is None or "max" not in z:
                        raise ValueError(
                            "cannot infer num_activities (no dictionary "
                            "table, no zone maps); pass "
                            "repro_torch.open(..., num_activities=N)")
                    hi = max(hi, int(z["max"]))
            return hi + 1
        acts = self.frame[ACTIVITY]
        return trace.host_read(acts.max(), int) + 1 if acts.numel() else 0

    @property
    def num_cases(self) -> int:
        if self.hint_cases is not None:
            return int(self.hint_cases)
        if self.is_files:
            from repro_torch.query.exec import count_cases

            total = count_cases(MultiPlan(self.paths))
            if total is None:
                raise ValueError(
                    "cannot infer num_cases (a file lacks segment "
                    "metadata); pass repro_torch.open(..., num_cases=N)")
            return total
        case = self.frame[CASE]
        if not case.numel():
            return 0
        return trace.host_read((case[1:] != case[:-1]).sum(), int) + 1

    def file_sizes(self) -> dict:
        """Summed ``storage.edf.file_sizes`` accounting over the file set."""
        from repro_torch.storage.edf import file_sizes

        if not self.is_files:
            raise ValueError("file_sizes() needs a file-backed dataset")
        sizes = [file_sizes(p) for p in self.paths]
        return {"total": sum(s["total"] for s in sizes),
                "raw": sum(s["raw"] for s in sizes),
                "per_file": sizes}

    def plan(self, columns: Iterable[str] | None = None) -> MultiPlan:
        """The logical plan the streaming/sharded engines execute.

        ``columns`` is the verb's column requirement: used as the scan
        projection when the user has not projected explicitly (predicates
        add their own columns at compile time).
        """
        if not self.is_files:
            raise ValueError("in-memory datasets have no scan plan")
        proj = self.projection
        if proj is not None and columns is not None:
            missing = set(columns) & set(self.schema) - set(proj)
            if missing:
                raise ValueError(
                    f"verb needs columns {sorted(missing)} but the dataset "
                    f"is projected to {list(proj)}")
        if proj is None and columns is not None:
            proj = tuple(c for c in columns if c in self.schema)
        return MultiPlan(self.paths, self.steps, proj)

    def describe(self) -> str:
        """One line per logical node, dataset-level."""
        if self.is_files:
            lines = [f"open({list(self.paths)!r})"]
        else:
            lines = [f"open(<frame: {self.frame.nrows} rows>)"]
        lines += [f"  filter {s!r}" for s in self.steps]
        if self.projection is not None:
            lines.append(f"  project {list(self.projection)}")
        return "\n".join(lines)

    def explain(self, verb: str | None = "dfg",
                verbs: Iterable[str] | None = None) -> str:
        """The plan, the engine the calibrated cost model would pick, and
        — for a fused collection (``verbs=[...]``) — the fused plan: the
        member verbs, the shared scan columns, whether pruning survives
        the ``mask_exact`` intersection, and the prefetch depth."""
        from repro_torch.core.engine import compose_specs
        from repro_torch.query.exec import prefetch_depth

        if verbs is not None:
            spec = compose_specs({v: engines.spec_for(v) for v in verbs})
        else:
            spec = engines.spec_for(verb)
        est = engines.estimate(self) if self.is_files else None
        choice = engines.choose(self, spec, est)
        lines = [self.describe(), f"  engine {choice} (auto)"]
        if verb in ("graph", "reachability", "bottleneck_paths",
                    "node_centrality") and verbs is None:
            n = self.num_activities + 2
            lines.append(f"  graph query: semiring closure over the "
                         f"({n}, {n}) compiled ProcessGraph — finalize of "
                         f"the merged dfg state, not a second scan")
        if est is not None:
            cal = engines.calibration()
            lines.append(f"  estimate {est.bytes_est}/{est.bytes_total} "
                         f"bytes, {est.groups_est}/{est.groups_total} groups")
            lines.append(f"  cost eager~{cal.eager_us(est):.0f}us "
                         f"streaming~{cal.streaming_us(est):.0f}us "
                         f"(calibration: {cal.source})")
        if verbs is not None:
            lines.append(f"  fused [{', '.join(spec.members)}] -> one "
                         f"pruned scan of {list(spec.columns)}")
            lines.append(f"  prefetch {prefetch_depth()} group(s) ahead")
        probe = None if verbs is not None else engines.cache_probe(self, verb)
        if probe is not None:
            from repro_torch.query.statecache import state_cache

            lines.append(
                f"  state-cache {probe['units']} group units: "
                f"{probe['cached']} merged-from-cache, {probe['fresh']} "
                f"freshly decoded, {probe['ghosted']} ghosted "
                f"({state_cache().bytes >> 10} KiB resident)")
        sketch_refuted = self._sketch_refutations()
        if sketch_refuted is not None:
            lines.append(f"  sketch keeps refute {sketch_refuted[0]}/"
                         f"{sketch_refuted[1]} groups (header-only, "
                         f"no phase-one I/O)")
        return "\n".join(lines)

    def _sketch_refutations(self) -> tuple | None:
        """(groups refuted by sketch-derived keep masks, nonempty groups)
        when the plan carries a :class:`~repro_torch.query.expr.SketchPredicate`
        and every file's variant sketches resolve it header-only; None
        otherwise (no such predicate, or sketches unavailable)."""
        from repro_torch.query.exec import (_multi_offsets, _sketch_keeps)
        from repro_torch.query.expr import SketchPredicate
        from repro_torch.query.optimize import compile_plan

        if not self.is_files or not any(isinstance(s, SketchPredicate)
                                        for s in self.steps):
            return None
        physicals = [compile_plan(p, True) for p in self.plan().per_file()]
        offsets, total = _multi_offsets(physicals)
        keeps = _sketch_keeps(physicals, total, physicals[0].steps)
        if not keeps:
            return None
        refuted = groups = 0
        for ph, off in zip(physicals, offsets):
            for g in ph._nonempty():
                groups += 1
                lo = off + int(ph.seg_start[g])
                hi = lo + int(ph.seg_count[g])
                if any(not k[lo:hi].any() for k in keeps.values()):
                    refuted += 1
        return refuted, groups

    # ------------------------------------------------------------- verbs
    def collect(self, verb: str, *, engine: str = "auto",
                num_shards: int | None = None,
                **kwargs) -> "engines.CollectResult":
        """Run a registered terminal verb; returns result + I/O report +
        the engine that ran (the named verbs below are sugar over this).
        On a card dataset the answer's tensors are in page-locked host
        memory; ``.to(device)`` continues on the card."""
        return engines.collect(self, verb, engine=engine,
                               num_shards=num_shards, **kwargs)

    def collect_many(self, verbs: Iterable[str], *, engine: str = "auto",
                     num_shards: int | None = None,
                     prefetch: int | None = None,
                     verb_kwargs: Mapping[str, dict] | None = None,
                     **common) -> "engines.CollectManyResult":
        """Run several verbs in ONE pass — one fused kernel over one scan
        (or one eager load / one sharded gather), each verb's result
        bitwise equal to its separate :meth:`collect`::

            res = ds.collect_many(["dfg", "stats", "variants"])
            res["dfg"], res["stats"], res["variants"]

        ``verb_kwargs={"alpha": {"min_count": 2}}`` routes per-verb
        options; remaining keyword arguments apply to every member.
        Results are the verbs' raw kernel outputs (``variants`` yields the
        fingerprint triple — post-process with
        ``repro_torch.core.variants._counts_from_fps`` as :meth:`variants` does).
        On a card dataset the answer's tensors are in page-locked host
        memory; ``.to(device)`` continues on the card.
        """
        return engines.collect_many(self, verbs, engine=engine,
                                    num_shards=num_shards, prefetch=prefetch,
                                    verb_kwargs=verb_kwargs, **common)

    def profile(self, *, engine: str = "auto",
                verb_kwargs: Mapping[str, dict] | None = None,
                **common) -> "engines.CollectManyResult":
        """Every registered verb, one pass: the whole-dashboard collection
        (``collect_many`` over the full kernel registry).  Needs the full
        event schema (timed verbs read ``time:timestamp``)."""
        from repro_torch.core.engine import kernel_specs

        verbs = tuple(n for n, s in kernel_specs().items() if not s.members)
        return self.collect_many(verbs, engine=engine,
                                 verb_kwargs=verb_kwargs, **common)

    def dfg(self, *, engine: str = "auto", method: str = "auto", **kw):
        """Directly-follows graph (counts + start/end histograms)."""
        return self.collect("dfg", engine=engine, method=method, **kw).result

    def stats(self, *, engine: str = "auto", **kw) -> dict:
        """Activity counts, case sizes, case durations, sojourn times —
        one fused pass over the stream."""
        return self.collect("stats", engine=engine, **kw).result

    def variants(self, *, engine: str = "auto", **kw) -> dict:
        """{variant fingerprint: number of cases} (the paper's Variants).

        Pruning-exact like every other verb: refuted row groups are
        skipped and their hash contribution replayed from the per-group
        affine sketch maps persisted in EDFV0003 headers (synthesized
        on open for older files), so pruned == eager == sharded bitwise.
        Filter by result with :func:`repro_torch.variant_in` /
        :func:`repro_torch.variant_of` — those predicates resolve from the same
        sketches with zero phase-one I/O.
        """
        from repro_torch.core.variants import _counts_from_fps

        fp1, fp2, ncases = self.collect("variants", engine=engine,
                                        **kw).result
        return _counts_from_fps(fp1, fp2, min(int(ncases), self.num_cases))

    def alpha(self, *, engine: str = "auto", min_count: int = 1,
              method: str = "auto", **kw):
        """Alpha miner (places + start/end activities) over the dataset."""
        return self.collect("alpha", engine=engine, min_count=min_count,
                            method=method, **kw).result

    def heuristics(self, *, engine: str = "auto", method: str = "auto",
                   **thresholds):
        """Heuristics miner (dependency graph + AND/XOR bindings)."""
        return self.collect("heuristics", engine=engine, method=method,
                            **thresholds).result

    # ------------------------------------------------------- graph verbs
    def _activity_labels(self):
        try:
            tables = self.tables
        except Exception:
            return None
        lab = tables.get(ACTIVITY)
        if lab is not None and len(lab) == self.num_activities:
            return lab
        return None

    def graph(self, *, engine: str = "auto", timed: bool = False,
              method: str = "auto", **kw):
        """Compile the dataset's DFG state into a
        :class:`~repro_torch.graph.ir.ProcessGraph` — dense weighted adjacency
        over the activity alphabet plus artificial start (``▶``) / end
        (``■``) nodes.  ``timed=True`` overlays mean waiting times per
        edge (streaming/eager only: f32 waits are order-sensitive).
        Activity labels from the dictionary tables are attached when
        available."""
        g = self.collect("graph", engine=engine, timed=timed,
                         method=method, **kw).result
        lab = self._activity_labels()
        return g if lab is None else g.with_labels(lab)

    def reachability(self, k: int | None = None, *, engine: str = "auto",
                     **kw):
        """k-step reachability closure of the process graph (``k=None`` =
        full transitive closure); exact and bitwise engine-invariant."""
        return self.collect("reachability", engine=engine, k=k, **kw).result

    def bottlenecks(self, weights: str = "frequency", *,
                    engine: str = "auto", **kw):
        """All-pairs shortest (min-plus) + widest (max-min) paths over the
        process graph, plus the source→sink bottleneck corridor.
        ``weights="performance"`` uses mean waiting times (streaming/eager
        only)."""
        return self.collect("bottleneck_paths", engine=engine,
                            weights=weights, **kw).result

    def centrality(self, iters: int = 16, *, engine: str = "auto", **kw):
        """Per-node in/out degree + power-method flow centrality."""
        return self.collect("node_centrality", engine=engine, iters=iters,
                            **kw).result

    def to_xes(self, path: str) -> None:
        """Export the filtered events as XES (ISO-8601 timestamps;
        dictionary columns decoded through the string tables).  Re-imported
        and re-mined, the XES reproduces this dataset's DFG state bitwise."""
        from repro_torch.graph.export import frame_to_xes

        frame_to_xes(path, self.to_frame(), self.tables)

    def conformance(self, model, *, engine: str = "auto",
                    method: str = "auto", **kw):
        """Replay the dataset's DFG against a discovered model.

        Dispatches on the model type: :class:`HeuristicsNet` -> heuristics
        fitness (its dependency graph), :class:`AlphaModel` -> alpha
        fitness (its footprint), anything array-like -> footprint fitness
        against an allowed-relation matrix.  The (A, A) score runs where
        the collected DFG is delivered, the model's matrix copied there.
        """
        from repro_torch.core import conformance as _conformance

        d = self.collect("dfg", engine=engine, method=method, **kw).result
        return _conformance.footprint_fitness(
            d, _allowed(model, d.counts.device))

    def window(self, by: str = "groups", *, size, step=None):
        """Sliding windows over the dataset (``repro_torch.dataset.window``).

        ``by="groups"`` windows span ``size`` row groups stepped by
        ``step`` (mined by re-merging cached per-group states — a slide
        re-decodes nothing); ``by="time"`` windows span ``[t, t + size]``
        timestamp intervals stepped by ``step`` (inclusive edges).
        ``step`` defaults to ``size`` (tumbling windows)::

            w = ds.window(by="time", size=86400.0, step=3600.0)
            w.collect("dfg")              # per-window DFGs
            w.drift()                     # footprint drift per slide
            w.conformance(ds.alpha())     # per-window replay fitness
        """
        from .window import Windows

        return Windows(self, by, size, size if step is None else step)

    def to_frame(self) -> EventFrame:
        """Materialize the filtered, projected events as one compact frame
        (refuted rows dropped; multi-file datasets concatenate in order)."""
        return engines.to_frame(self)


def open_dataset(source, *, tables: Mapping[str, list] | None = None,
                 num_activities: int | None = None,
                 num_cases: int | None = None, device="cuda") -> Dataset:
    """Open an event dataset: the single entry point of the facade.

    ``source`` is an EDF path, an ordered iterable of EDF paths (the
    partitions of one (case,time)-sorted log — any mix of v1/v2/v3 files
    with one schema), or an in-memory ``EventFrame`` (pass its dictionary
    ``tables`` alongside; the frame is moved to ``device``).
    ``num_activities`` / ``num_cases`` override the inferred capacity
    dimensions (useful for files without dictionary tables or segment
    metadata).  Every verb runs on ``device`` (default the card).
    """
    if isinstance(source, EventFrame):
        return Dataset(frame=source.to(device),
                       frame_tables=dict(tables or {}),
                       hint_activities=num_activities, hint_cases=num_cases,
                       device=device)
    if tables is not None:
        raise ValueError("tables= is only for in-memory frames (files carry "
                         "their own dictionary tables)")
    if _is_pathlike(source):
        paths: tuple = (str(source),)
    else:
        paths = tuple(str(p) for p in source)
    if not paths:
        raise ValueError("open() needs at least one path")
    return Dataset(paths=paths, hint_activities=num_activities,
                   hint_cases=num_cases, device=device)
