"""Logical query plans: ``scan -> filter* -> project -> mine``.

A :class:`Plan` is an immutable description of *what* to compute over an
EDF file — which predicates restrict the rows, which columns the consumer
needs — with no commitment to *how*.  The how (which row groups are read
at all, which predicates still need a residual mask, how global segment
numbering survives the skips) is decided by ``repro_torch.query.optimize`` from
the file's zone maps, and executed by ``repro_torch.query.exec``::

    from repro_torch.query import Plan, col, execute
    plan = (Plan("log.edf")
            .filter(col(CASE).between(1_000, 2_000))
            .filter(col(ACTIVITY).isin([2, 5]))
            .project([CASE, ACTIVITY]))
    graph, report = execute(plan, mine=dfg_kernel(num_activities))

Filters are applied in order; each step is either a row-level
:class:`~repro_torch.query.expr.Expr` or a two-pass
:class:`~repro_torch.query.expr.CasePredicate`.  The composed semantics are
exactly the eager chain of ``repro_torch.core.filtering`` calls the plan
replaces — the executor's contract is bitwise identity with
``mine(filterN(...filter1(edf.read(path))))``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, Sequence

from .expr import CasePredicate, Expr


def check_predicate(predicate) -> None:
    """Shared ``filter()`` argument validation (Plan / MultiPlan)."""
    if not isinstance(predicate, (Expr, CasePredicate)):
        raise TypeError(
            f"filter() takes an Expr or CasePredicate, got "
            f"{type(predicate).__name__} (build one with col()/"
            f"cases_containing()/case_size())")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Immutable logical plan over one EDF file (see module docstring)."""

    path: str
    steps: tuple = ()               # Expr | CasePredicate, in application order
    projection: tuple | None = None  # None = every column in the schema

    def filter(self, predicate) -> "Plan":
        """Append a filter step (row-level ``Expr`` or ``CasePredicate``)."""
        check_predicate(predicate)
        return dataclasses.replace(self, steps=self.steps + (predicate,))

    def project(self, columns: Iterable[str]) -> "Plan":
        """Restrict the columns the scan materializes (the downstream
        kernel must find every column it reads in this set)."""
        return dataclasses.replace(self, projection=tuple(columns))

    # ------------------------------------------------------------- views
    @property
    def exprs(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, Expr))

    @property
    def case_predicates(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, CasePredicate))

    def describe(self) -> str:
        """One line per plan node (scan -> filters -> project)."""
        lines = [f"scan({self.path!r})"]
        lines += [f"  filter {s!r}" for s in self.steps]
        if self.projection is not None:
            lines.append(f"  project {list(self.projection)}")
        return "\n".join(lines)

    def union(self, other: "Plan | MultiPlan") -> "MultiPlan":
        """Widen this plan to also scan ``other``'s file(s) — see
        :meth:`MultiPlan.union` for the compatibility rules."""
        return MultiPlan((self.path,), self.steps, self.projection).union(other)


@dataclasses.dataclass(frozen=True)
class MultiPlan:
    """One logical plan over a *set* of EDF files.

    The files are the ordered partitions of one (case,time)-sorted log
    (cases may even straddle a file boundary — the executor's carry flows
    across files exactly as it flows across row groups).  Filters and
    projection apply to every file; each file keeps its own zone-map
    pruning, and the executor drives a single kernel over the concatenated
    pruned streams, so the result is bitwise equal to mining the
    concatenation of the files.  Build with :func:`scan_many` or by
    ``union``-ing plans.
    """

    paths: tuple
    steps: tuple = ()
    projection: tuple | None = None

    def filter(self, predicate) -> "MultiPlan":
        """Append a filter step (applies to every file)."""
        check_predicate(predicate)
        return dataclasses.replace(self, steps=self.steps + (predicate,))

    def project(self, columns: Iterable[str]) -> "MultiPlan":
        """Restrict the columns every scan materializes."""
        return dataclasses.replace(self, projection=tuple(columns))

    def union(self, other: "Plan | MultiPlan") -> "MultiPlan":
        """Concatenate another plan's file set onto this one.

        Both sides must carry the *same* filter steps and projection
        (practically: union the scans first, then filter the union) — a
        union of differently-filtered plans has no single logical plan to
        compile to.
        """
        if isinstance(other, Plan):
            other = MultiPlan((other.path,), other.steps, other.projection)
        if not isinstance(other, MultiPlan):
            raise TypeError(f"union() takes a Plan or MultiPlan, got "
                            f"{type(other).__name__}")
        if self.steps != other.steps or self.projection != other.projection:
            raise ValueError(
                "union() requires identical filter/projection state on both "
                "sides; build the union first, then filter it")
        return dataclasses.replace(self, paths=self.paths + other.paths)

    def per_file(self) -> tuple[Plan, ...]:
        """The single-file plan each scan compiles from."""
        return tuple(Plan(p, self.steps, self.projection) for p in self.paths)

    # ------------------------------------------------------------- views
    @property
    def exprs(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, Expr))

    @property
    def case_predicates(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, CasePredicate))

    def describe(self) -> str:
        lines = [f"scan_many({list(self.paths)!r})"]
        lines += [f"  filter {s!r}" for s in self.steps]
        if self.projection is not None:
            lines.append(f"  project {list(self.projection)}")
        return "\n".join(lines)


def scan_many(paths: Iterable[str]) -> MultiPlan:
    """Start a lazy plan over an ordered set of EDF files (the partitions
    of one sorted log)."""
    paths = tuple(paths)
    if not paths:
        raise ValueError("scan_many() needs at least one path")
    return MultiPlan(paths)


def scan(path: str) -> Plan:
    """Start a lazy plan over an EDF file (any version; zone maps are
    synthesized on open for v1/v2 files).

    .. deprecated:: use ``repro_torch.open(path).filter(...)`` — the
       ``Dataset`` facade plans over file *sets* and picks the execution
       engine; the ``Plan`` IR stays public for custom drivers via
       ``Plan(path)``.
    """
    warnings.warn(
        "repro_torch.query.scan() is deprecated; use repro_torch.open(path) "
        "and the Dataset verbs (.filter/.dfg/.stats/...) — or Plan(path) "
        "directly for a raw logical plan", DeprecationWarning, stacklevel=2)
    return Plan(path)
