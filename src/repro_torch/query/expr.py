"""Predicate expression trees over event attributes (the query language).

An :class:`Expr` is a small, closed algebra of row-level predicates —
comparisons, set membership, time ranges, and ``& | ~`` combinations —
built with the :func:`col` factory::

    from repro_torch.query import col
    e = col("concept:name").isin([3, 7]) & col("time:timestamp").between(0, 9)

Every node supports three operations, and the split between them is the
whole point of the subsystem:

* ``columns()`` — the attributes the predicate reads (projection pushdown:
  the scan loads only these plus what the downstream kernel needs);
* ``mask(frame)`` — the per-row boolean tensor, on the frame's device,
  *bitwise identical* to the corresponding eager filter in
  ``repro_torch.core.filtering`` (comparisons
  and ``isin`` follow ``filter_attr_values`` and compare stored values;
  ``between`` follows ``filter_time_range`` and additionally requires the
  cell's epsilon flag — a missing timestamp never matches a range);
* ``prove(meta)`` — the tri-state zone-map valuation over a whole row
  group: ``NONE`` (no row can match → the scan skips the group's bytes),
  ``ALL`` (every row matches → the scan skips evaluating the residual
  mask), or ``SOME``.  Proofs are conservative: zone min/max cover every
  *stored* value (sentinels of invalid cells included), so refutation is
  always sound.

Case-level predicates (:func:`cases_containing`, :func:`case_size`) are
*not* row-local — they need a first pass over the log ("does this case
contain activity a anywhere?") before any row can be kept.  They implement
the :class:`CasePredicate` interface instead: a phase-one chunk kernel
(from ``core.filtering`` / ``core.stats``) whose result is a per-case keep
mask, which the planner then broadcasts through global segment ids in the
second, pruned pass.  Keep masks are host numpy arrays: the planner
decides from them which row groups to read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.eventframe import ACTIVITY, EventFrame

# tri-state zone-map valuations
NONE = "none"   # zone maps refute the predicate for every row of the group
SOME = "some"   # undecided — read the group and evaluate the residual mask
ALL = "all"     # zone maps prove the predicate for every row of the group

_NEG = {NONE: ALL, SOME: SOME, ALL: NONE}


def _host(x) -> np.ndarray:
    """A kernel result (a tensor on any device) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return trace.host_read(x).numpy()
    return np.asarray(x)


def _zone(meta: dict, name: str) -> dict | None:
    return (meta.get("zones") or {}).get(name)


def _bitset(zone: dict) -> np.ndarray | None:
    """Decode a dictionary-presence bitset (or None when not recorded)."""
    bits = zone.get("bits")
    if bits is None:
        return None
    raw = np.frombuffer(bytes.fromhex(bits), np.uint8)
    return np.unpackbits(raw).astype(bool)


class Expr:
    """Base class of row-level predicate nodes (see module docstring)."""

    def columns(self) -> frozenset[str]:
        raise NotImplementedError

    def mask(self, frame: EventFrame) -> torch.Tensor:
        raise NotImplementedError

    def prove(self, meta: dict) -> str:
        """Tri-state valuation over a row group's zone maps (NONE/SOME/ALL)."""
        raise NotImplementedError

    def __and__(self, other: "Expr") -> "Expr":
        return And(_parts(self, other, And))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(_parts(self, other, Or))

    def __invert__(self) -> "Expr":
        return Not(self)


def _parts(a: Expr, b: Expr, kind) -> tuple:
    """Flatten nested And/And (Or/Or) chains into one n-ary node."""
    if not isinstance(b, Expr):
        raise TypeError(f"cannot combine Expr with {type(b).__name__}")
    pa = a.parts if isinstance(a, kind) else (a,)
    pb = b.parts if isinstance(b, kind) else (b,)
    return pa + pb


# ------------------------------------------------------------ leaf nodes
_CMP = {
    "eq": lambda c, v: c == v, "ne": lambda c, v: c != v,
    "lt": lambda c, v: c < v, "le": lambda c, v: c <= v,
    "gt": lambda c, v: c > v, "ge": lambda c, v: c >= v,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Cmp(Expr):
    """``frame[name] <op> value`` over stored values (validity-agnostic,
    matching ``filter_attr_values``'s treatment of the raw column)."""

    name: str
    op: str
    value: Any

    def columns(self):
        return frozenset((self.name,))

    def mask(self, frame):
        return _CMP[self.op](frame[self.name], self.value)

    def prove(self, meta):
        z = _zone(meta, self.name)
        if meta.get("nrows", 1) == 0:
            return NONE
        if z is None or "min" not in z:
            return SOME
        lo, hi, v, op = z["min"], z["max"], self.value, self.op
        if op == "eq":
            if v < lo or v > hi:
                return NONE
            bits = _bitset(z)
            if bits is not None and not (0 <= int(v) < bits.size and bits[int(v)]):
                return NONE
            return ALL if lo == hi == v else SOME
        if op == "ne":
            return _NEG[Cmp(self.name, "eq", v).prove(meta)]
        if op == "lt":
            return NONE if lo >= v else (ALL if hi < v else SOME)
        if op == "le":
            return NONE if lo > v else (ALL if hi <= v else SOME)
        if op == "gt":
            return NONE if hi <= v else (ALL if lo > v else SOME)
        if op == "ge":
            return NONE if hi < v else (ALL if lo >= v else SOME)
        raise ValueError(f"unknown comparison {op!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class IsIn(Expr):
    """Membership in a value set — the pushdown form of
    ``filtering.filter_attr_values`` (same sorted-binary-search mask)."""

    name: str
    values: tuple

    def columns(self):
        return frozenset((self.name,))

    def mask(self, frame):
        from repro_torch.core.filtering import isin_mask

        return isin_mask(frame[self.name], np.asarray(self.values))

    def prove(self, meta):
        if meta.get("nrows", 1) == 0 or not self.values:
            return NONE
        z = _zone(meta, self.name)
        if z is None or "min" not in z:
            return SOME
        vals = np.asarray(self.values).ravel()
        in_range = vals[(vals >= z["min"]) & (vals <= z["max"])]
        if in_range.size == 0:
            return NONE
        bits = _bitset(z)
        if bits is not None:
            chosen = np.zeros(bits.size, bool)
            ids = in_range[(in_range >= 0) & (in_range < bits.size)].astype(np.int64)
            chosen[ids] = True
            if not (bits & chosen).any():
                return NONE
            if not (bits & ~chosen).any():
                return ALL          # every id present in the group is chosen
            return SOME
        if z["min"] == z["max"]:
            return ALL
        return SOME


@dataclasses.dataclass(frozen=True, eq=False)
class Between(Expr):
    """``lo <= frame[name] <= hi`` on *valid* cells — the pushdown form of
    ``filtering.filter_time_range`` (epsilon cells never match)."""

    name: str
    lo: Any
    hi: Any

    def columns(self):
        return frozenset((self.name,))

    def mask(self, frame):
        from repro_torch.core.filtering import time_range_mask

        return time_range_mask(frame, self.name, self.lo, self.hi)

    def prove(self, meta):
        n = meta.get("nrows", 1)
        if n == 0:
            return NONE
        z = _zone(meta, self.name)
        if z is None or "min" not in z:
            return SOME
        if z.get("nulls", 0) >= n:
            return NONE             # every cell is epsilon — nothing matches
        if self.hi < z["min"] or self.lo > z["max"]:
            return NONE
        if z.get("nulls", 0) == 0 and z["min"] >= self.lo and z["max"] <= self.hi:
            return ALL
        return SOME


# ------------------------------------------------------------ combinators
@dataclasses.dataclass(frozen=True, eq=False)
class And(Expr):
    parts: tuple

    def columns(self):
        return frozenset().union(*(p.columns() for p in self.parts))

    def mask(self, frame):
        m = self.parts[0].mask(frame)
        for p in self.parts[1:]:
            m = m & p.mask(frame)
        return m

    def prove(self, meta):
        got = [p.prove(meta) for p in self.parts]
        if NONE in got:
            return NONE
        return ALL if all(g == ALL for g in got) else SOME


@dataclasses.dataclass(frozen=True, eq=False)
class Or(Expr):
    parts: tuple

    def columns(self):
        return frozenset().union(*(p.columns() for p in self.parts))

    def mask(self, frame):
        m = self.parts[0].mask(frame)
        for p in self.parts[1:]:
            m = m | p.mask(frame)
        return m

    def prove(self, meta):
        got = [p.prove(meta) for p in self.parts]
        if ALL in got:
            return ALL
        return NONE if all(g == NONE for g in got) else SOME


@dataclasses.dataclass(frozen=True, eq=False)
class Not(Expr):
    part: Expr

    def columns(self):
        return self.part.columns()

    def mask(self, frame):
        return ~self.part.mask(frame)

    def prove(self, meta):
        return _NEG[self.part.prove(meta)]


# ------------------------------------------------------- schema binding
def _cast_const(schema: dict, name: str, v):
    """Snap a predicate constant to the column's storage dtype.

    Zone-map proofs compare in binary64 while ``mask`` compares in the
    column's dtype (a Python ``0.1`` weak-casts to ``float32(0.1) =
    0.10000000149``); snapping the constant once makes both sides see the
    same number, so a proof can never refute a row the mask would keep.
    Non-integral constants on integer columns are left untouched (the
    mask's promote-to-float comparison has no integer counterpart).
    """
    meta = schema.get(name)
    if meta is None:
        return v
    dt = np.dtype(meta["dtype"])
    try:
        if np.issubdtype(dt, np.integer):
            return int(dt.type(v)) if float(v).is_integer() else v
        return float(dt.type(v))
    except (OverflowError, ValueError):
        return v                    # out-of-range constant: leave untouched


def bind_schema(e: Expr, schema: dict) -> Expr:
    """Rebuild an expression with every leaf constant cast to its
    column's dtype (see :func:`_cast_const`); called by the planner."""
    if isinstance(e, Cmp):
        return Cmp(e.name, e.op, _cast_const(schema, e.name, e.value))
    if isinstance(e, IsIn):
        return IsIn(e.name, tuple(_cast_const(schema, e.name, v)
                                  for v in e.values))
    if isinstance(e, Between):
        return Between(e.name, _cast_const(schema, e.name, e.lo),
                       _cast_const(schema, e.name, e.hi))
    if isinstance(e, Not):
        return Not(bind_schema(e.part, schema))
    if isinstance(e, (And, Or)):
        return type(e)(tuple(bind_schema(p, schema) for p in e.parts))
    return e


# ---------------------------------------------------------------- column
class Col:
    """Column reference; comparison operators build the leaf nodes."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"col({self.name!r})"

    def isin(self, values: Iterable) -> Expr:
        return IsIn(self.name, tuple(np.asarray(list(values)).ravel().tolist()))

    def between(self, lo, hi) -> Expr:
        return Between(self.name, lo, hi)

    def __eq__(self, v):            # noqa: A003 — predicate DSL, not identity
        return Cmp(self.name, "eq", v)

    def __ne__(self, v):
        return Cmp(self.name, "ne", v)

    def __lt__(self, v):
        return Cmp(self.name, "lt", v)

    def __le__(self, v):
        return Cmp(self.name, "le", v)

    def __gt__(self, v):
        return Cmp(self.name, "gt", v)

    def __ge__(self, v):
        return Cmp(self.name, "ge", v)

    __hash__ = None                 # == builds an Expr; keys would be wrong


def col(name: str) -> Col:
    """Entry point of the predicate DSL: ``col("concept:name") == 3``."""
    return Col(name)


# ------------------------------------------------- case-level predicates
class CasePredicate:
    """A two-pass predicate: phase one folds a chunk kernel into a per-case
    keep mask; phase two broadcasts ``keep[segment_id]`` onto rows.  The
    planner prunes *both* passes with zone maps (phase one additionally via
    :meth:`phase1_prove`)."""

    def phase1_kernel(self, num_cases: int):
        """Chunk kernel whose streamed result yields the keep mask."""
        raise NotImplementedError

    def finalize_keep(self, result) -> np.ndarray:
        """Map the kernel's streamed result to a boolean (num_cases,) mask."""
        raise NotImplementedError

    def columns(self) -> frozenset[str]:
        """Extra columns phase one reads (beyond case + activity)."""
        return frozenset()

    def phase1_prove(self, meta: dict) -> str:
        """NONE when the group provably contributes nothing to phase one."""
        return SOME

    def resolve(self, tables: dict) -> "CasePredicate":
        """Resolve string attribute values against dictionary tables."""
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class CaseContains(CasePredicate):
    """Keep every event of any case containing ``activity`` — the paper's
    case-level filter; phase one is ``filtering.cases_containing_kernel``."""

    activity: Any
    column: str = ACTIVITY

    def phase1_kernel(self, num_cases: int):
        from repro_torch.core.filtering import cases_with_value_kernel

        return cases_with_value_kernel(self.column, int(self.activity),
                                       num_cases)

    def finalize_keep(self, result):
        return _host(result).astype(bool)

    def columns(self):
        return frozenset((self.column,))

    def phase1_prove(self, meta):
        # a group that cannot contain the activity contributes no hits
        return NONE if Cmp(self.column, "eq", int(self.activity)).prove(
            meta) == NONE else SOME

    def resolve(self, tables):
        if isinstance(self.activity, str):
            table = tables.get(self.column)
            if table is None or self.activity not in table:
                raise KeyError(f"activity {self.activity!r} not in the "
                               f"dictionary table of {self.column!r}")
            return CaseContains(table.index(self.activity), self.column)
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class CaseSizeBetween(CasePredicate):
    """Keep cases whose valid-event count lies in ``[min_events,
    max_events]``; phase one is ``stats.case_sizes_kernel``."""

    min_events: int
    max_events: int

    def phase1_kernel(self, num_cases: int):
        from repro_torch.core.stats import case_sizes_kernel

        return case_sizes_kernel(num_cases)

    def finalize_keep(self, result):
        sizes = _host(result)
        return (sizes >= self.min_events) & (sizes <= self.max_events)


class SketchPredicate(CasePredicate):
    """A case predicate decidable from variant fingerprints alone.

    The planner resolves these **without any phase-one I/O** when every
    file carries (or can synthesize) per-group variant sketches: composing
    the header sketch maps in stream order reproduces each case's exact
    fingerprint pair, and :meth:`keep_from_fps` turns those into the keep
    mask.  Files without sketch metadata fall back to the generic
    phase-one kernel path (``phase1_kernel`` — the variants kernel itself,
    which is still pruned and ghost-exact)."""

    def keep_from_fps(self, fp1: np.ndarray, fp2: np.ndarray) -> np.ndarray:
        """Boolean keep mask from the per-case fingerprint pair arrays."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class VariantIn(SketchPredicate):
    """Keep every event of any case whose variant fingerprint is one of
    ``pairs`` — the variant-band filter.  ``pairs`` holds ``(fp1, fp2)``
    tuples as produced by ``variant_counts`` (the port's fingerprints are
    int64 values in [0, 2^32), compared as uint32)."""

    pairs: tuple

    def phase1_kernel(self, num_cases: int):
        from repro_torch.core.variants import variants_kernel

        return variants_kernel(num_cases)

    def finalize_keep(self, result):
        fp1, fp2, _ncases = result
        return self.keep_from_fps(_host(fp1), _host(fp2))

    def keep_from_fps(self, fp1, fp2):
        keep = np.zeros(fp1.shape, bool)
        for a, b in self.pairs:
            keep |= (fp1 == np.uint32(a)) & (fp2 == np.uint32(b))
        return keep


@dataclasses.dataclass(frozen=True, eq=False)
class VariantOf(SketchPredicate):
    """Keep cases whose activity sequence equals ``sequence`` exactly.

    Resolves (at plan time, against the file's dictionary tables when the
    sequence is given as strings) to a single-pair :class:`VariantIn` via
    :func:`repro_torch.core.polyhash.sequence_fingerprint`."""

    sequence: tuple

    def resolve(self, tables):
        from repro_torch.core.polyhash import sequence_fingerprint

        seq = self.sequence
        if any(isinstance(a, str) for a in seq):
            table = tables.get(ACTIVITY)
            if table is None:
                raise KeyError(f"no dictionary table for {ACTIVITY!r}; "
                               f"pass integer activity ids")
            seq = tuple(table.index(a) if isinstance(a, str) else int(a)
                        for a in seq)
        return VariantIn((sequence_fingerprint(seq),))

    def phase1_kernel(self, num_cases: int):
        raise RuntimeError("VariantOf must be resolve()-d to VariantIn "
                           "before execution")

    def finalize_keep(self, result):
        raise RuntimeError("VariantOf must be resolve()-d to VariantIn "
                           "before execution")

    def keep_from_fps(self, fp1, fp2):
        raise RuntimeError("VariantOf must be resolve()-d to VariantIn "
                           "before execution")


def cases_containing(activity, column: str = ACTIVITY) -> CaseContains:
    """Case-level ``contains(activity)``; accepts a dictionary id or the
    decoded string (resolved against the file's tables at plan time)."""
    return CaseContains(activity, column)


def case_size(min_events: int, max_events: int) -> CaseSizeBetween:
    """Case-level size filter (``filtering.filter_case_size`` pushed down)."""
    return CaseSizeBetween(int(min_events), int(max_events))


def variant_in(pairs) -> VariantIn:
    """Case-level variant membership filter.  ``pairs`` is an iterable of
    ``(fp1, fp2)`` fingerprint tuples (see ``variants.variant_counts``); the
    planner decides it from header sketches alone — zero phase-one I/O —
    whenever the files carry variant sketch metadata."""
    return VariantIn(tuple((int(a) & 0xFFFFFFFF, int(b) & 0xFFFFFFFF)
                           for a, b in pairs))


def variant_of(sequence) -> VariantOf:
    """Keep cases following exactly this activity sequence (ids or decoded
    strings — strings resolve against the file's tables at plan time)."""
    return VariantOf(tuple(sequence))
