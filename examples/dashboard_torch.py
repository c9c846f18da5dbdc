"""Multi-log dashboard on the PyTorch / CUDA port: interactive filter
queries over a file *set*, the verbs on the card.

The serving-layer scenario the Dataset facade was built for: an event log
partitioned into monthly EDF files (cases never re-open across months),
queried interactively -- every dashboard widget is a fluent filter + verb,
and the zone maps make sure a widget scoped to one month (or one org
region, one case band) never reads the cold months' bytes.  The same
widgets and fused panels as ``examples/dashboard.py``, through
``repro_torch.open(paths, device=...)``; the log is built with numpy and
torch on the host.

  PYTHONPATH=src python examples/dashboard_torch.py [--cases N] [--months M]
                                                    [--device cpu] [--json F]

``--json`` writes every widget's answer (no timings), so two runs (the
card and the CPU) can be compared.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

import repro_torch
from repro_torch import cases_containing, col
from repro_torch.core import ACTIVITY, CASE

REGION = "org:region"          # an extra dictionary attribute per event


def build_monthly_logs(num_cases: int, months: int, tmpdir: str):
    """One synthetic sorted log, written as consecutive monthly files."""
    from repro_torch.data import synthetic
    from repro_torch.storage import edf

    frame, tables = synthetic.generate(num_cases=num_cases, num_activities=10,
                                       seed=42, device="cpu")
    # tag every event with a region drawn per case (east/west/north/south)
    rng = np.random.default_rng(7)
    case = frame[CASE].numpy()
    per_case = rng.integers(0, 4, size=num_cases)
    frame = frame.with_column(REGION, torch.from_numpy(per_case[case].astype(np.int32)))
    tables = dict(tables, **{REGION: ["east", "west", "north", "south"]})

    paths = []
    cases_per_month = -(-num_cases // months)
    for m in range(months):
        lo = int(np.searchsorted(case, m * cases_per_month))
        hi = int(np.searchsorted(case, (m + 1) * cases_per_month))
        if lo == hi:
            continue
        p = os.path.join(tmpdir, f"month_{m:02d}.edf")
        part = frame.take(torch.arange(lo, hi))
        edf.write(p, part, tables, codec="zlib1",
                  row_group_rows=max(1, (hi - lo) // 8))
        paths.append(p)
    return paths, tables


def widget(title: str, ds, verb: str = "dfg", **kwargs):
    """One dashboard panel: run a verb, report latency + bytes touched."""
    t0 = time.time()
    r = ds.collect(verb, **kwargs)
    dt = time.time() - t0
    if r.report is not None:
        io = (f"{r.report.bytes_read/2**10:.0f}/"
              f"{r.report.bytes_total/2**10:.0f} KiB, "
              f"{r.report.groups_skipped}/{r.report.groups_total} groups "
              f"skipped")
    else:
        io = "in-memory"
    print(f"  {title:<44s} {dt*1e3:7.1f} ms  [{r.engine:>9s}] {io}")
    return r.result


def fused_panel(title: str, ds, verbs, **kwargs):
    """A whole panel *group* in one pass: ``collect_many`` fuses the verbs
    into a single kernel over a single scan, so the refresh costs one
    read of the union of the verbs' columns instead of one scan each."""
    t0 = time.time()
    r = ds.collect_many(verbs, **kwargs)
    dt = time.time() - t0
    if r.report is not None:
        io = (f"{r.report.bytes_read/2**10:.0f}/"
              f"{r.report.bytes_total/2**10:.0f} KiB, "
              f"prefetch {r.report.prefetch}")
    else:
        io = "in-memory"
    print(f"  {title:<44s} {dt*1e3:7.1f} ms  [{r.engine:>9s}] {io}")
    print(f"    one scan -> {', '.join(r.verbs)}")
    return r


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def dashboard(cases: int, months: int, device: str, tmpdir: str) -> dict:
    """Every panel of the dashboard; returns their answers (counts, sizes,
    drift scores, the bottleneck corridor), with no timing."""
    t0 = time.time()
    paths, tables = build_monthly_logs(cases, months, tmpdir)
    total = sum(os.path.getsize(p) for p in paths)
    print(f"{len(paths)} monthly files, {total/2**20:.1f} MiB total "
          f"(built in {time.time()-t0:.1f}s)")

    ds = repro_torch.open(paths, device=device)   # the whole year, one dataset
    acts = ds.tables[ACTIVITY]
    region = ds.tables[REGION]
    out: dict = {"files": len(paths), "bytes": total}

    print(f"\ndashboard over {cases:,} cases / {len(paths)} logs on {device} "
          f"(every result bitwise == filter-then-mine):")

    # the landing page: DFG + stats + performance + an alpha model -- four
    # widgets, ONE fused kernel, ONE scan of the year
    landing = fused_panel("whole-year landing page (4 verbs, 1 scan)", ds,
                          ["dfg", "stats", "performance_dfg", "alpha"])
    sizes = _host(landing["stats"]["case_sizes"])
    counts = _host(landing["dfg"].counts)
    print(f"    busiest edge x{int(counts.max())}"
          f", {int((sizes > 0).sum())} cases, "
          f"{len(landing['alpha'].places)} alpha places")
    out["landing"] = {"dfg": counts.tolist(), "case_sizes": sizes.tolist(),
                      "alpha_places": len(landing["alpha"].places)}

    east = region.index("east")
    out["east_dfg"] = _host(widget('region == "east" DFG',
                                   ds.filter(col(REGION) == east), "dfg").counts).tolist()

    month_cases = -(-cases // months)
    one_month = ds.filter(col(CASE).between(2 * month_cases, 3 * month_cases - 1))
    out["month_dfg"] = _host(widget("one month's case band (cold months unread)",
                                    one_month, "dfg", engine="streaming").counts).tolist()

    net = widget(f'cases containing "{acts[4]}" -> heuristics net',
                 ds.filter(cases_containing(4)), "heuristics")
    out["heuristics_edges"] = int(_host(net.graph).sum())

    sel = one_month.filter(col(REGION) == east)
    r = sel.collect("dfg", engine="streaming")
    frac = r.report.bytes_read / max(r.report.bytes_total, 1)
    out["drill_down_dfg"] = _host(widget("month x region drill-down", sel, "dfg",
                                         engine="streaming").counts).tolist()
    out["drill_down_skipped"] = [r.report.groups_skipped, r.report.groups_total]
    print(f"\ndrill-down read {100*frac:.1f}% of the dataset's bytes "
          f"({r.report.groups_skipped}/{r.report.groups_total} row groups "
          f"skipped before any I/O)")

    # the monitoring strip: a sliding window re-merges cached per-group
    # states, so after the first refresh a slide decodes nothing -- and
    # drift scores each window's DFG against the previous one
    n_units = ds.window(by="groups", size=1)._num_units()
    size = max(2, n_units // len(paths) * 2)          # ~two months wide
    w = ds.window(by="groups", size=size, step=max(1, size // 2))
    t0 = time.time()
    wm = w.collect_many(["dfg", "activity_counts"])
    cold_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    w.collect_many(["dfg", "activity_counts"])
    warm_ms = (time.time() - t0) * 1e3
    scores = [float(x) for x in w.drift()]
    print(f"\nsliding-window strip ({len(wm.bounds)} windows of {size} "
          f"row groups, step {max(1, size // 2)}):")
    print(f"  first refresh {cold_ms:7.1f} ms (decodes each group once), "
          f"slide {warm_ms:7.1f} ms (pure re-merge)")
    busiest = []
    for (lo, hi), drift_w, res in zip(wm.bounds, scores, wm.results):
        busiest.append(int(_host(res["dfg"].counts).max()))
        bar = "#" * int(round(20 * drift_w))
        print(f"  groups [{lo:2d},{hi:2d})  drift {drift_w:5.3f} {bar:<20s}"
              f" busiest edge x{busiest[-1]}")
    out["windows"] = {"bounds": [list(map(int, b)) for b in wm.bounds],
                      "drift": scores, "busiest": busiest}

    # the bottleneck panel: the year's merged DFG state as the weighted
    # process graph, and its widest start -> end corridor (max-min semiring
    # closure over the frequency weights)
    t0 = time.time()
    g = ds.graph()
    bp = ds.bottlenecks()
    dt = (time.time() - t0) * 1e3
    labels = g.node_labels()
    freq = _host(g.freq)
    print(f"\nbottleneck corridor ({g.num_nodes}-node graph, {dt:.1f} ms):")
    path = [int(i) for i in bp.path]
    hops = list(zip(path[:-1], path[1:]))
    print("  " + " -> ".join(labels[i] for i in path))
    print("  edge flows: " + ", ".join(f"{labels[a]}->{labels[b]} x{freq[a, b]}"
                                       for a, b in hops))
    print(f"  throttled at x{float(bp.bottleneck):.0f} "
          f"(rarest edge on the widest start->end path)")
    out["bottleneck"] = {"path": path, "bottleneck": float(bp.bottleneck)}

    print("\nexplain (the fused landing-page plan):")
    print(ds.explain(verbs=["dfg", "stats", "performance_dfg", "alpha"]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=60_000)
    ap.add_argument("--months", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="where the verbs run (default: the card)")
    ap.add_argument("--json", default=None, help="write the panels' answers here")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        answers = dashboard(args.cases, args.months, args.device, d)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(answers, f)


if __name__ == "__main__":
    main()
