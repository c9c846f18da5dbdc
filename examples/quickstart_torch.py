"""Quickstart on the PyTorch / CUDA port: the paper's pipeline end to end
on one page — the Dataset API, mining on the card.

generate log -> columnar EDF (Parquet role) -> repro_torch.open() -> fluent
filters (pushed down to zone maps: cold row groups are never read) ->
DFG / stats / alpha miner / heuristics miner / conformance replay /
sliding windows / an atomic append, each a terminal verb that compiles to
the same chunk-kernel engine whatever the execution engine (eager |
streaming | auto), with the verbs' CUDA kernels on the card.

  PYTHONPATH=src python examples/quickstart_torch.py [--cases N] [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

import repro_torch
from repro_torch import col
from repro_torch.core import ACTIVITY, CASE, EventFrame, conformance
from repro_torch.data import synthetic
from repro_torch.storage import edf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=100_000)
    ap.add_argument("--device", default="cuda",
                    help="where the verbs run (default: the card)")
    args = ap.parse_args()

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    frame, tables = synthetic.generate(num_cases=args.cases,
                                       num_activities=12, seed=0,
                                       device="cpu")
    print(f"generated {frame.nrows:,} events / {args.cases:,} cases "
          f"in {time.time()-t0:.2f}s")

    d = tempfile.mkdtemp()
    path = os.path.join(d, "log.edf")
    edf.write(path, frame, tables, codec="zlib1",
              row_group_rows=max(1, frame.nrows // 24))
    print(f"EDF on disk: {os.path.getsize(path)/2**20:.1f} MiB "
          f"({edf.file_sizes(path)['raw']/2**20:.1f} MiB raw, "
          f"{edf.num_row_groups(path)} row groups + zone maps)")

    # one fluent facade over every engine, bound to the device -----------
    ds = repro_torch.open(path, device=args.device)
    acts = ds.tables[ACTIVITY]

    t0 = time.time()
    graph = ds.dfg()                       # engine picked by cost (auto)
    sync()
    print(f"DFG on {graph.counts.device} in {time.time()-t0:.3f}s: "
          f"{len(graph.edges())} edges, {int(graph.counts.sum()):,} df-pairs")
    for (a, b), c in sorted(graph.edges(), key=lambda e: -e[1])[:5]:
        print(f"   {acts[a]:>8s} -> {acts[b]:<8s} x{c:,}")

    model = conformance.discover_model(graph, noise_threshold=0.05)
    fit = conformance.footprint_fitness(graph, model)
    print(f"discovered model (IMDF-style 5% noise cut): fitness {float(fit):.3f}")

    # alpha + heuristics miners: terminal verbs over the same state
    t0 = time.time()
    alpha_model = ds.alpha()
    net = ds.heuristics()
    print(f"alpha miner in {time.time()-t0:.3f}s: {alpha_model.num_places} "
          f"places, starts={sorted(acts[i] for i in alpha_model.start_activities)}")
    n_edges = int(net.graph.sum())
    print(f"heuristics miner: {n_edges} dependency edges, "
          f"fitness {float(ds.conformance(net)):.3f}, "
          f"alpha conformance {float(ds.conformance(alpha_model)):.3f}")

    # pushdown filters: the zone maps decide which row groups to read
    # BEFORE any I/O — same bitwise DFG, a fraction of the bytes
    lo, hi = args.cases // 10, args.cases // 10 + args.cases // 20
    sel = ds.filter(col(CASE).between(lo, hi)).project([CASE, ACTIVITY])
    t0 = time.time()
    r = sel.collect("dfg", engine="streaming")
    sync()
    print(f"pushdown query in {time.time()-t0:.3f}s: skipped "
          f"{r.report.groups_skipped}/{r.report.groups_total} row groups, "
          f"read {r.report.bytes_read/2**10:.0f} KiB of "
          f"{r.report.bytes_total/2**10:.0f} KiB "
          f"-> {int(r.result.counts.sum()):,} df-pairs "
          f"(bitwise == filter-then-mine)")

    # the cost model explains itself
    print(sel.explain("dfg"))

    top = int(torch.argmax(ds.collect("activity_counts").result))
    kept = ds.filter(col(ACTIVITY) == top).to_frame()
    print(f"filter most-common activity ({acts[top]}): "
          f"{kept.nrows:,} events kept")

    # sliding windows re-merge cached per-group states: a slide decodes
    # nothing new
    w = ds.window(by="groups", size=6, step=3)
    res = w.collect("dfg")
    print(f"{len(res)} windows of 6 row groups: drift "
          f"{[round(x, 3) for x in w.drift()]}; "
          f"second sweep folded {w.collect('dfg').report.groups_folded} groups")

    # an atomic append: new row groups, old groups (and their cached
    # states) untouched
    more, _ = synthetic.generate(num_cases=args.cases // 10, num_activities=12,
                                 seed=1, device="cpu")
    more = EventFrame.from_numpy(
        {k: (v.numpy() + (int(frame[CASE][-1]) + 1 if k == CASE else 0))
         for k, v in more.columns.items()}, device=args.device)
    pinned = repro_torch.open(path, device=args.device,
                              num_cases=args.cases + args.cases // 10)
    pinned.collect("dfg", engine="streaming")
    pinned.append(more, row_group_rows=max(1, frame.nrows // 24))
    rep = pinned.collect("dfg", engine="streaming").report
    print(f"appended {more.nrows:,} events: re-collect folded "
          f"{rep.groups_folded} fresh groups, {rep.groups_cached} from the "
          f"state cache")


if __name__ == "__main__":
    main()
