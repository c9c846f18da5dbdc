"""Classical event log (paper Def. 1) — the compared baseline structure.

``L = (C_I, E, A, case_ev, act, attr, <=)`` where each event's ``attr`` is an
associative map (the XES / XESLite implementation strategy). This is the
structure whose per-event map lookups give the O(N*M) worst-case filtering and
O(N^2) worst-case DFG of Tables 3/4. Kept faithfully *un*-vectorized: plain
Python dicts and iteration, used by the complexity/assessment benchmarks as
the row-oriented baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame


@dataclasses.dataclass
class ClassicEventLog:
    """List-of-events with per-event attribute maps, totally ordered."""

    events: list[dict[str, Any]]  # each dict is the event's attr map

    # ------------------------------------------------------------- Def. 1
    @property
    def case_ids(self) -> set:
        return {e[CASE] for e in self.events}

    def case_ev(self) -> dict[Any, list[int]]:
        m: dict[Any, list[int]] = {}
        for i, e in enumerate(self.events):
            m.setdefault(e[CASE], []).append(i)
        return m

    def act(self, i: int) -> Any:
        return self.events[i][ACTIVITY]

    # --------------------------------------------------------- operations
    def filter_events(self, name: str, values: set) -> "ClassicEventLog":
        """Attr-map filtering: one map lookup per event (Table 3 baseline)."""
        kept = [e for e in self.events if e.get(name) in values]
        return ClassicEventLog(kept)

    def dfg_iterative(self) -> dict[tuple, int]:
        """Single pass over cases storing edges in a map (Table 4 baseline)."""
        counts: dict[tuple, int] = {}
        last_by_case: dict[Any, Any] = {}
        for e in self.events:  # events are totally ordered
            c, a = e[CASE], e[ACTIVITY]
            if c in last_by_case:
                key = (last_by_case[c], a)
                counts[key] = counts.get(key, 0) + 1
            last_by_case[c] = a
        return counts

    def dfg_l2_iterative(self) -> dict[tuple, int]:
        """Count ``a, b, a`` triples per case (heuristics-miner L2-loop
        counts), one pass with per-case last-two maps — the row-oriented
        oracle for ``discovery.DiscoveryState.l2_counts``."""
        counts: dict[tuple, int] = {}
        prev1: dict[Any, Any] = {}
        prev2: dict[Any, Any] = {}
        for e in self.events:
            c, a = e[CASE], e[ACTIVITY]
            if c in prev2 and prev2[c] == a:
                key = (prev2[c], prev1[c])
                counts[key] = counts.get(key, 0) + 1
            prev2[c] = prev1.get(c)
            prev1[c] = a
        return counts

    def start_end_activities(self) -> tuple[dict, dict]:
        starts: dict[Any, int] = {}
        ends: dict[Any, int] = {}
        last_act: dict[Any, Any] = {}
        seen: set = set()
        for e in self.events:
            c, a = e[CASE], e[ACTIVITY]
            if c not in seen:
                seen.add(c)
                starts[a] = starts.get(a, 0) + 1
            last_act[c] = a
        for a in last_act.values():
            ends[a] = ends.get(a, 0) + 1
        return starts, ends

    # -------------------------------------------------- conversion (§5.2)
    def to_eventframe(self, device="cuda") -> tuple[EventFrame, dict[str, list]]:
        """Paper §5.2 conversion: E is a <=-ordered sequence; every attribute
        name becomes a column; missing attributes become epsilon (validity 0).
        Object-valued columns are dictionary-encoded; the string tables are
        returned alongside the frame, which lives on ``device``."""
        names = sorted({n for e in self.events for n in e})
        n = len(self.events)
        cols: dict[str, np.ndarray] = {}
        valid: dict[str, np.ndarray] = {}
        tables: dict[str, list] = {}
        for name in names:
            raw = [e.get(name) for e in self.events]
            mask = np.array([r is not None for r in raw])
            if all(isinstance(r, (int, float, np.integer, np.floating)) or r is None for r in raw):
                arr = np.array([r if r is not None else 0 for r in raw], dtype=np.float64)
                if all(isinstance(r, (int, np.integer)) or r is None for r in raw):
                    arr = arr.astype(np.int64)
                cols[name] = arr
            else:  # dictionary-encode
                table: list = []
                index: dict = {}
                ids = np.zeros((n,), dtype=np.int32)
                for i, r in enumerate(raw):
                    if r is None:
                        continue
                    if r not in index:
                        index[r] = len(table)
                        table.append(r)
                    ids[i] = index[r]
                cols[name] = ids
                tables[name] = table
            if not mask.all():
                valid[name] = mask
        return EventFrame.from_numpy(cols, valid, device=device), tables

    @staticmethod
    def from_eventframe(frame: EventFrame, tables: dict[str, list] | None = None) -> "ClassicEventLog":
        tables = tables or {}
        data = frame.to_numpy()
        rv = frame.rows_valid().cpu().numpy()
        valid = {k: v.cpu().numpy() for k, v in frame.valid.items()}
        events = []
        for i in range(frame.nrows):
            if not rv[i]:
                continue
            e = {}
            for k, v in data.items():
                if k in valid and not bool(valid[k][i]):
                    continue
                val = v[i].item()
                if k in tables:
                    val = tables[k][int(val)]
                e[k] = val
            events.append(e)
        return ClassicEventLog(events)


# ---------------------------------------------------- discovery oracle
# Row-oriented reference implementations of the columnar miners in
# ``core.discovery`` — deliberately set/dict based and brute-force, so the
# two code paths share nothing but the definitions they implement.
def footprint_reference(log: ClassicEventLog):
    """Alpha relations as sets of activity-label pairs.

    Returns ``(alphabet, direct, causal, parallel)``; choice is the
    complement.  ``alphabet`` is sorted for deterministic iteration.
    """
    direct = set(log.dfg_iterative())
    causal = {(a, b) for (a, b) in direct if (b, a) not in direct}
    parallel = {(a, b) for (a, b) in direct if (b, a) in direct}
    alphabet = sorted({e[ACTIVITY] for e in log.events})
    return alphabet, direct, causal, parallel


def alpha_reference(log: ClassicEventLog):
    """Brute-force alpha miner: enumerate *all* subset pairs (exponential,
    test-sized alphabets only) and keep the maximal valid ones.

    Returns ``(places, starts, ends)`` with places as a set of
    ``(frozenset, frozenset)`` of activity labels.
    """
    from itertools import chain, combinations

    alphabet, direct, causal, _ = footprint_reference(log)

    def choice(a, b):
        return (a, b) not in direct and (b, a) not in direct

    def powerset(xs):
        return chain.from_iterable(combinations(xs, r)
                                   for r in range(1, len(xs) + 1))

    # only choice-cliques (incl. a#a: no self-loop) can appear on a side
    cliques = [frozenset(s) for s in powerset(alphabet)
               if all(choice(x, y) for x in s for y in s)]
    valid = {(aa, bb) for aa in cliques for bb in cliques
             if all((a, b) in causal for a in aa for b in bb)}
    places = {p for p in valid
              if not any(q != p and p[0] <= q[0] and p[1] <= q[1]
                         for q in valid)}
    starts_c, ends_c = log.start_end_activities()
    return places, frozenset(starts_c), frozenset(ends_c)


def heuristics_reference(log: ClassicEventLog, *,
                         dependency_threshold: float = 0.5,
                         l2_threshold: float = 0.5,
                         min_count: int = 1):
    """Dict-based heuristics measures + thresholded dependency graph.

    Returns ``(dep, l2, edges)``: ``dep[(a, b)]`` is the dependency measure
    (diagonal entries are the L1-loop measure), ``l2[(a, b)]`` the L2-loop
    measure, ``edges`` the set of kept label pairs (L1 loops as ``(a, a)``).
    """
    c = log.dfg_iterative()
    c2 = log.dfg_l2_iterative()
    alphabet = sorted({e[ACTIVITY] for e in log.events})
    dep: dict[tuple, float] = {}
    l2: dict[tuple, float] = {}
    for a in alphabet:
        for b in alphabet:
            ab, ba = c.get((a, b), 0), c.get((b, a), 0)
            if a == b:
                dep[(a, b)] = ab / (ab + 1.0)
                l2[(a, b)] = 0.0
            else:
                dep[(a, b)] = (ab - ba) / (ab + ba + 1.0)
                t = c2.get((a, b), 0) + c2.get((b, a), 0)
                l2[(a, b)] = t / (t + 1.0)
    loops1 = {a for a in alphabet
              if dep[(a, a)] >= dependency_threshold
              and c.get((a, a), 0) >= min_count}
    edges = {(a, b) for a in alphabet for b in alphabet if a != b
             and dep[(a, b)] >= dependency_threshold
             and c.get((a, b), 0) >= min_count}
    edges |= {(a, a) for a in loops1}
    for a in alphabet:
        for b in alphabet:
            if a == b or a in loops1 or b in loops1:
                continue
            t = c2.get((a, b), 0) + c2.get((b, a), 0)
            if l2[(a, b)] >= l2_threshold and t >= min_count:
                edges.add((a, b))
                edges.add((b, a))
    return dep, l2, edges


def make_classic_log(cases: Iterable[tuple[Any, list[tuple[Any, float]]]],
                     extra_attrs: int = 0) -> ClassicEventLog:
    """Build a classic log from (case_id, [(activity, ts), ...]) traces."""
    events = []
    for cid, trace in cases:
        for j, (a, ts) in enumerate(trace):
            e = {CASE: cid, ACTIVITY: a, TIMESTAMP: ts}
            for k in range(extra_attrs):
                e[f"attr{k}"] = j * 31 + k
            events.append(e)
    events.sort(key=lambda e: e[TIMESTAMP])
    return ClassicEventLog(events)
