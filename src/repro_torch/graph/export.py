"""Model export: mined objects → PM4Py-compatible interchange formats.

The mining side of this repo is columnar and dictionary-encoded; the rest
of the process-mining world speaks PNML Petri nets, DOT graphs, process
trees, and DFG JSON.  This module is the bridge — every exporter is pure
host-side serialization of an already-finalized model (tensors are read
back with ``.cpu().numpy()``), and the formats round-trip:

* :func:`alpha_to_pnml` / :func:`read_pnml` — the alpha miner's
  :class:`~repro_torch.core.discovery.AlphaModel` as a PNML 2009 place/transition
  net; the reader parses any of our nets back structurally, and
  :func:`pnml_places` recovers the exact ``(A, B)`` place pairs for the
  round-trip test.
* :func:`heuristics_to_dot` / :func:`graph_to_dot` — Graphviz DOT of a
  :class:`~repro_torch.core.discovery.HeuristicsNet` dependency graph or a
  :class:`~repro_torch.graph.ir.ProcessGraph` (edge labels: dependency measure /
  frequency + mean wait).
* :func:`discover_process_tree` — a compact inductive-style cut finder
  over accumulated DFG state emitting PM4Py process-tree notation
  (``->(...)``, ``X(...)``, ``+(...)``, ``*(...)``, ``tau``): xor cut
  (weak components), sequence cut (condensation of SCCs merged by
  incomparability), parallel cut (complement components), loop cut
  (redo components re-entering the starts), flower fallthrough.
* :func:`dfg_to_json` / :func:`dfg_from_json` — the DFG + start/end
  histograms as PM4Py-style ``dfg.json`` (labelled edge triples); the
  importer reconstructs the dense :class:`~repro_torch.core.dfg.DFG` bitwise.
* :func:`frame_to_xes` / :func:`frame_from_xes` — EventFrame ↔ XES via
  ``storage.xes`` (ISO-8601 timestamps); re-import preserves
  (case, time) order and activity spelling, so re-mining reproduces the
  DFG state bitwise.
"""
from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

import numpy as np

from repro_torch.core.classic_log import ClassicEventLog
from repro_torch.core.dfg import DFG
from repro_torch.core.discovery import AlphaModel, HeuristicsNet
from repro_torch.core.eventframe import EventFrame

from .ir import ProcessGraph


def _labels(num_activities: int, labels=None) -> list[str]:
    if labels is None:
        return [f"a{i}" for i in range(num_activities)]
    out = [str(x) for x in labels]
    if len(out) != num_activities:
        raise ValueError(f"{len(out)} labels for {num_activities} activities")
    return out


# ------------------------------------------------------------------ PNML
def alpha_to_pnml(model: AlphaModel, labels=None, *,
                  net_id: str = "alpha") -> str:
    """Serialize an :class:`AlphaModel` as a PNML 2009 P/T net.

    One transition per activity; one place per discovered ``(A, B)`` pair
    (``id="p<i>"``) plus ``source``/``sink`` wired to the start/end
    activities — the standard alpha-net construction, in the grammar
    PM4Py's ``pnml`` importer reads.
    """
    lab = _labels(model.num_activities, labels)
    lines = ['<?xml version="1.0" encoding="UTF-8"?>',
             '<pnml xmlns="http://www.pnml.org/version-2009/grammar/pnml">',
             f'  <net id="{net_id}" '
             'type="http://www.pnml.org/version-2009/grammar/ptnet">',
             '    <page id="page1">']

    def place(pid, marking=0):
        lines.append(f'      <place id="{pid}">')
        lines.append(f'        <name><text>{escape(pid)}</text></name>')
        if marking:
            lines.append('        <initialMarking>'
                         f'<text>{marking}</text></initialMarking>')
        lines.append('      </place>')

    place("source", marking=1)
    place("sink")
    for i in range(len(model.places)):
        place(f"p{i}")
    for a in range(model.num_activities):
        lines.append(f'      <transition id="t{a}">')
        lines.append(f'        <name><text>{escape(lab[a])}</text></name>')
        lines.append('      </transition>')
    arcs = []
    for a in sorted(model.start_activities):
        arcs.append(("source", f"t{a}"))
    for a in sorted(model.end_activities):
        arcs.append((f"t{a}", "sink"))
    for i, (ins, outs) in enumerate(model.places):
        for a in sorted(ins):
            arcs.append((f"t{a}", f"p{i}"))
        for b in sorted(outs):
            arcs.append((f"p{i}", f"t{b}"))
    for j, (src, dst) in enumerate(arcs):
        lines.append(f'      <arc id="arc{j}" source="{src}" '
                     f'target="{dst}"/>')
    lines += ['    </page>', '  </net>', '</pnml>', '']
    return "\n".join(lines)


def read_pnml(source: str):
    """Structural parse of a PNML net (path or XML string).

    Returns ``(places, transitions, arcs)``: place ids with initial
    markings, transition ``id -> label``, and ``(source, target)`` id
    pairs — namespace-agnostic, enough to verify any exported net
    round-trips.
    """
    text = source if source.lstrip().startswith("<") else open(source).read()
    root = ET.fromstring(text)

    def local(tag):
        return tag.rsplit("}", 1)[-1]

    places: dict[str, int] = {}
    transitions: dict[str, str] = {}
    arcs: list[tuple[str, str]] = []
    for el in root.iter():
        kind = local(el.tag)
        if kind == "place":
            marking = 0
            for sub in el.iter():
                if local(sub.tag) == "initialMarking":
                    for t in sub.iter():
                        if local(t.tag) == "text":
                            marking = int(t.text)
            places[el.get("id")] = marking
        elif kind == "transition":
            label = el.get("id")
            for sub in el.iter():
                if local(sub.tag) == "name":
                    for t in sub.iter():
                        if local(t.tag) == "text":
                            label = t.text
            transitions[el.get("id")] = label
        elif kind == "arc":
            arcs.append((el.get("source"), el.get("target")))
    return places, transitions, arcs


def pnml_places(source: str):
    """Recover the alpha ``(A, B)`` pairs from an exported net: for each
    internal place, the frozensets of transition indices wired in/out —
    compared against ``AlphaModel.places`` by the round-trip test."""
    places, transitions, arcs = read_pnml(source)
    t_index = {tid: i for i, tid in
               enumerate(sorted(transitions, key=lambda t: int(t[1:])))}
    pairs = {}
    for src, dst in arcs:
        if dst in places and dst not in ("source", "sink"):
            pairs.setdefault(dst, (set(), set()))[0].add(t_index[src])
        elif src in places and src not in ("source", "sink"):
            pairs.setdefault(src, (set(), set()))[1].add(t_index[dst])
    starts = frozenset(t_index[d] for s, d in arcs if s == "source")
    ends = frozenset(t_index[s] for s, d in arcs if d == "sink")
    place_pairs = tuple(sorted(
        ((frozenset(i), frozenset(o)) for i, o in pairs.values()),
        key=lambda p: (sorted(p[0]), sorted(p[1]))))
    return place_pairs, starts, ends


# ------------------------------------------------------------------- DOT
def heuristics_to_dot(net: HeuristicsNet, labels=None, *,
                      name: str = "heuristics") -> str:
    """Graphviz DOT of the thresholded dependency graph (edge label =
    dependency measure, 2 decimals — PM4Py's heuristics-net visualizer
    convention)."""
    lab = _labels(net.num_activities, labels)
    lines = [f'digraph "{name}" {{', '  rankdir=LR;',
             '  node [shape=box];']
    used = sorted({n for (a, b), _ in net.edges() for n in (a, b)}
                  | net.start_activities | net.end_activities)
    for a in used:
        lines.append(f'  n{a} [label="{escape(lab[a])}"];')
    lines.append('  __start [shape=circle, label="", style=filled, '
                 'fillcolor=green];')
    lines.append('  __end [shape=doublecircle, label="", style=filled, '
                 'fillcolor=orange];')
    for a in sorted(net.start_activities):
        lines.append(f'  __start -> n{a};')
    for a in sorted(net.end_activities):
        lines.append(f'  n{a} -> __end;')
    for (a, b), dep in net.edges():
        lines.append(f'  n{a} -> n{b} [label="{dep:.2f}"];')
    lines.append('}')
    return "\n".join(lines) + "\n"


def graph_to_dot(g: ProcessGraph, *, name: str = "process") -> str:
    """Graphviz DOT of a :class:`ProcessGraph` (edge label = frequency,
    plus mean wait when the performance overlay is present)."""
    lab = g.node_labels()
    lines = [f'digraph "{name}" {{', '  rankdir=LR;',
             '  node [shape=box];',
             f'  n{g.source} [shape=circle, style=filled, '
             'fillcolor=green];',
             f'  n{g.sink} [shape=doublecircle, style=filled, '
             'fillcolor=orange];']
    for e in g.edges():
        (a, b), cnt = e[0], e[1]
        label = str(cnt) if len(e) == 2 else f"{cnt} ({e[2]:.2f}s)"
        lines.append(f'  n{a} -> n{b} [label="{label}"];')
    for n in sorted({v for e in g.edges() for v in e[0]}
                    - {g.source, g.sink}):
        lines.append(f'  n{n} [label="{escape(lab[n])}"];')
    lines.append('}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------- process tree
def _cc(nodes, edges):
    """Connected components over an undirected edge set."""
    parent = {n: n for n in nodes}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        parent[find(a)] = find(b)
    comps: dict = {}
    for n in nodes:
        comps.setdefault(find(n), set()).add(n)
    return list(comps.values())


def _sccs(nodes, succ):
    """Tarjan over the restricted successor map (iterative)."""
    index, low, on, stack, out = {}, {}, set(), [], []
    counter = [0]
    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(succ[w])))
                    advanced = True
                    break
                if w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[v])
            if low[v] == index[v]:
                comp = set()
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.add(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _tree(nodes, edges, starts, ends, lab, depth=0):
    nodes = set(nodes)
    e = {(a, b) for a, b in edges if a in nodes and b in nodes and a != b}
    selfloops = {a for a, b in edges if a == b and a in nodes}
    if len(nodes) == 1:
        (a,) = nodes
        leaf = f"'{lab[a]}'"
        return f"*( {leaf}, tau )" if a in selfloops else leaf
    succ = {n: sorted({b for a, b in e if a == n}) for n in nodes}

    def recurse(group, g_starts, g_ends):
        return _tree(group, edges, g_starts & group or _entry(group),
                     g_ends & group or _exit(group), lab, depth + 1)

    def _entry(group):
        ins = {b for a, b in e if a not in group and b in group}
        return ins or set(group)

    def _exit(group):
        outs = {a for a, b in e if a in group and b not in group}
        return outs or set(group)

    # xor cut: weakly connected components
    comps = _cc(nodes, {(a, b) for a, b in e})
    if len(comps) > 1 and depth < 16:
        parts = [recurse(c, starts, ends) for c in
                 sorted(comps, key=lambda c: sorted(c))]
        return "X( " + ", ".join(parts) + " )"
    # sequence cut: condensation of SCCs, incomparable classes merged
    sccs = _sccs(sorted(nodes), succ)
    if len(sccs) > 1 and depth < 16:
        reach = {i: set() for i in range(len(sccs))}
        node_scc = {n: i for i, c in enumerate(sccs) for n in c}
        for a, b in e:
            if node_scc[a] != node_scc[b]:
                reach[node_scc[a]].add(node_scc[b])
        for k in range(len(sccs)):          # transitive closure
            for i in range(len(sccs)):
                if k in reach[i]:
                    reach[i] |= reach[k]
        group_of = list(range(len(sccs)))
        for i in range(len(sccs)):
            for j in range(i + 1, len(sccs)):
                if j not in reach[i] and i not in reach[j]:
                    gj, gi = group_of[j], group_of[i]
                    group_of = [gi if g == gj else g for g in group_of]
        groups: dict[int, set] = {}
        for i, g in enumerate(group_of):
            groups.setdefault(g, set()).update(sccs[i])
        ordered = sorted(groups.values(),
                         key=lambda grp: sum(
                             1 for other in groups.values()
                             if other is not grp and any(
                                 node_scc[n] in reach[node_scc[m]]
                                 for m in other for n in grp)))
        if len(ordered) > 1:
            total = all(
                all(node_scc[n] in reach[node_scc[m]]
                    for m in ordered[i] for n in ordered[i + 1])
                for i in range(len(ordered) - 1))
            if total:
                parts = [recurse(g, starts if i == 0 else set(),
                                 ends if i == len(ordered) - 1 else set())
                         for i, g in enumerate(ordered)]
                return "->( " + ", ".join(parts) + " )"
    # parallel cut: components of the missing-double-edge graph
    missing = {(a, b) for a in nodes for b in nodes if a < b
               and not ((a, b) in e and (b, a) in e)}
    pcomps = _cc(nodes, missing)
    if len(pcomps) > 1 and depth < 16 and all(
            c & starts and c & ends for c in pcomps):
        parts = [recurse(c, starts, ends) for c in
                 sorted(pcomps, key=lambda c: sorted(c))]
        return "+( " + ", ".join(parts) + " )"
    # loop cut: redo components whose edges re-enter the starts
    body = set(starts) | set(ends)
    rest = nodes - body
    if rest and depth < 16:
        redo_comps = _cc(rest, {(a, b) for a, b in e
                                if a in rest and b in rest})
        redos = [c for c in redo_comps
                 if all(a in ends for a, b in e if b in c and a not in c)
                 and all(b in starts for a, b in e if a in c and b not in c)]
        if redos:
            do = nodes - set().union(*redos)
            parts = [recurse(do, starts, ends)]
            parts += [recurse(c, _entry(c), _exit(c)) for c in
                      sorted(redos, key=lambda c: sorted(c))]
            return "*( " + ", ".join(parts) + " )"
    # fallthrough: flower model
    leaves = ", ".join(f"'{lab[a]}'" for a in sorted(nodes))
    return f"*( tau, {leaves} )"


def discover_process_tree(source: "DFG | ProcessGraph", labels=None) -> str:
    """Inductive-style process tree over accumulated DFG state, in PM4Py
    notation (see module docstring).  A compact IMd: cuts are found on the
    directly-follows graph alone, with the flower model as fallthrough —
    guaranteed fitness, precision only as good as the cuts."""
    if isinstance(source, ProcessGraph):
        a = source.num_activities
        freq = source.freq.cpu().numpy()
        counts = freq[:a, :a]
        starts = freq[source.source, :a]
        ends = freq[:a, source.sink]
        lab = list(source.node_labels()[:a]) if labels is None else None
    elif isinstance(source, DFG):
        a = source.num_activities
        counts = source.counts.cpu().numpy()
        starts = source.starts.cpu().numpy()
        ends = source.ends.cpu().numpy()
        lab = None
    else:
        raise TypeError(f"cannot build a process tree from "
                        f"{type(source).__name__}")
    if lab is None:
        lab = _labels(a, labels)
    observed = {int(i) for i in
                np.nonzero(counts.sum(0) + counts.sum(1)
                           + starts + ends)[0]}
    if not observed:
        return "tau"
    edges = {(int(x), int(y)) for x, y in zip(*np.nonzero(counts))}
    s = {int(i) for i in np.nonzero(starts)[0]}
    t = {int(i) for i in np.nonzero(ends)[0]}
    return _tree(observed, edges, s, t, lab)


# ------------------------------------------------------------- DFG JSON
def dfg_to_json(d: DFG, labels=None) -> str:
    """PM4Py-style ``dfg.json``: labelled edge triples plus start/end
    activity histograms (the format ``pm4py.read_dfg`` round-trips)."""
    lab = _labels(d.num_activities, labels)
    counts = d.counts.cpu().numpy()
    starts = d.starts.cpu().numpy()
    ends = d.ends.cpu().numpy()
    return json.dumps({
        "activities": lab,
        "dfg": [[lab[a], lab[b], int(counts[a, b])]
                for a, b in zip(*np.nonzero(counts))],
        "start_activities": {lab[i]: int(starts[i])
                             for i in np.nonzero(starts)[0]},
        "end_activities": {lab[i]: int(ends[i])
                           for i in np.nonzero(ends)[0]},
    }, indent=2)


def dfg_from_json(text: str, device="cuda") -> tuple[DFG, list[str]]:
    """Inverse of :func:`dfg_to_json`: the dense :class:`DFG` on ``device``
    (bitwise round-trip) plus the activity labels."""
    doc = json.loads(text)
    lab = list(doc["activities"])
    index = {l: i for i, l in enumerate(lab)}
    a = len(lab)
    counts = np.zeros((a, a), np.int32)
    for src, dst, cnt in doc["dfg"]:
        counts[index[src], index[dst]] = cnt
    starts = np.zeros((a,), np.int32)
    ends = np.zeros((a,), np.int32)
    for l, cnt in doc["start_activities"].items():
        starts[index[l]] = cnt
    for l, cnt in doc["end_activities"].items():
        ends[index[l]] = cnt
    return DFG.from_numpy({"counts": counts, "starts": starts,
                           "ends": ends}, device), lab


# -------------------------------------------------------------- XES I/O
def frame_to_xes(path: str, frame: EventFrame,
                 tables: dict[str, list] | None = None) -> None:
    """Write a (case, time)-sorted EventFrame as XES (dictionary columns
    decoded through ``tables``; timestamps ISO-8601 via ``storage.xes``)."""
    from repro_torch.storage import xes

    xes.write(path, ClassicEventLog.from_eventframe(frame, tables))


def frame_from_xes(path: str, device="cuda") -> tuple[EventFrame, dict[str, list]]:
    """Read XES back into a dictionary-encoded EventFrame on ``device`` +
    string tables (first-seen encoding in (case, time) order — re-mining an
    exported frame reproduces the original DFG state bitwise)."""
    from repro_torch.storage import xes

    return xes.read(path).to_eventframe(device)
