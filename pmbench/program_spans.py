"""The program's own spans and counters in a traced window, and the five
per-layer numbers they give.

The program (``repro_torch.trace``) opens ``repro_torch.*`` profiler
ranges inside its collect path and counts its host syncs and the bytes of
its copies between host and device.  This module reduces a traced
window's events with them:

* each device kernel or copy goes to the innermost program span whose host
  interval holds its launch: the launch event (``LAUNCH_CATS``, either CUDA
  API) that carries the same ``correlation`` id;
* each idle gap of the device goes to the innermost program span holding
  it, else to the harness's span (``pmbench.trace.GAP_ORDER``), else to
  "between requests";
* the counters' difference over the window.

The five numbers (means over the window's requests unless said):

* ``host_syncs_per_request`` -- the program's host syncs;
* ``program_copy_mb`` -- the program's own copies, both ways, in MB (the
  client's read-back is not the program's);
* ``case_filter_ms`` -- a ``filter.case`` span from its start to the end of
  the last device op launched inside it (or its own end, if later), over
  the case-filtered requests only;
* ``ordered_fold_ms`` -- device time of the ops launched inside
  ``kernel.ordered_histogram`` spans;
* ``fold_idle_ms`` -- device idle time while the host is inside a program
  ``fold`` span.

Each is ``None`` where its spans or counters are absent (a program without
them, a cell without case filters, a run without a device).  A traced run
of ``pmbench.run`` hands the reduction to every per-layer reader as
``TraceData.program``; ``pmbench/metrics/<name>.py`` reads each of the five.
``ProgramTrace.host_s`` and ``.count`` hold every program span's summed
host seconds and count, so a reader can time a span the program adds.

    python -m pmbench.program_spans --workload L1-panel --seed 7

runs a cell traced, as ``python -m pmbench.run --trace 1`` does, and prints
what its result line does not hold: the counters' differences, and the
device time, host time and idle gaps named by the program's spans.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys

from pmbench import trace as harness_trace

PROGRAM_PREFIX = "repro_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Nested host intervals of one thread: ``innermost(t)`` is the index
    of the innermost interval holding ``t``, or ``None``."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent = []
        stack: list[int] = []
        for i, (s, e, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, t: float) -> int | None:
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            s, e, _ = self.spans[i]
            if s <= t <= e:
                return i
            i = self.parent[i]
        return None

    def name(self, i: int | None) -> str | None:
        return None if i is None else self.spans[i][2]


@dataclasses.dataclass
class ProgramTrace:
    """The window reduced to the program's spans and counters."""

    requests: list          # the traced window's requests (traffic.Request)
    counters: dict | None   # counter -> difference over the window
    host_s: dict            # program span -> summed host seconds
    count: dict             # program span -> how many opened in the window
    device_s_in: dict       # program span -> device seconds launched in it
    fold_idle_s: float | None
    case_filter_s: list     # one a filter.case span
    idle_gaps: list         # [[program or harness span, idle seconds]]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _busy_within(busy: list, a: float, b: float) -> float:
    """Length of the union ``busy`` (sorted, disjoint) inside ``[a, b]``."""
    i = bisect.bisect_right(busy, [a, float("inf")]) - 1
    j = bisect.bisect_left(busy, [b, float("-inf")])
    total = 0.0
    for s, e in busy[max(i, 0):j]:
        total += max(0.0, min(e, b) - max(s, a))
    return total


def reduce(events: list[dict], requests: list, before: dict | None,
           after: dict | None) -> ProgramTrace:
    """Reduce a traced window's chrome-trace events (``before`` and
    ``after``: the program's counters at the window's ends, or ``None``
    where the program has none)."""
    program, harness, device = [], {}, []
    launch = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, cat = ev.get("name", ""), ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if name.startswith(PROGRAM_PREFIX):
                program.append((ts, ts + dur, name[len(PROGRAM_PREFIX):]))
            elif name.startswith(harness_trace.SPAN_PREFIX):
                harness.setdefault(name[len(harness_trace.SPAN_PREFIX):],
                                   []).append((ts, ts + dur, name))
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = ts
        elif cat in harness_trace.DEVICE_CATS:
            device.append((ts, ts + dur,
                           (ev.get("args") or {}).get("correlation")))
    req = sorted(harness.get("request", []))
    w0, w1 = (req[0][0], max(e for _, e, _ in req)) if req else (0.0, 0.0)
    device = [d for d in device if w0 <= d[0] <= w1]
    spans = Spans(program)
    harness_spans = {k: Spans(v) for k, v in harness.items()}

    device_s_in: dict = {}
    last_end = {}           # filter.case span index -> its ops' last end
    for s, e, corr in device:
        t = launch.get(corr)
        i = None if t is None else spans.innermost(t)
        if i is None:
            continue
        name = spans.name(i)
        device_s_in[name] = device_s_in.get(name, 0.0) + (e - s) * 1e-6
        while i is not None:                # every span holding the launch
            if spans.spans[i][2] == "filter.case":
                last_end[i] = max(last_end.get(i, e), e)
            i = spans.parent[i]
    case_filter_s = [(max(e, last_end.get(i, e)) - s) * 1e-6
                     for i, (s, e, name) in enumerate(spans.spans)
                     if name == "filter.case" and w0 <= s <= w1]

    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device
                   if e > w0 and s < w1])
    fold_idle_s = None
    if device and any(n == "fold" for _, _, n in program):
        fold_idle_s = sum(
            (min(e, w1) - max(s, w0))
            - _busy_within(busy, max(s, w0), min(e, w1))
            for s, e, n in spans.spans if n == "fold" and e > w0 and s < w1
        ) * 1e-6

    def holder(t: float) -> str:
        name = spans.name(spans.innermost(t))
        if name is not None:
            return name
        for h in harness_trace.GAP_ORDER:
            if h in harness_spans and \
                    harness_spans[h].innermost(t) is not None:
                return h
        return "between requests"

    gaps: dict = {}
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            what = holder((s + prev) / 2)
            gaps[what] = gaps.get(what, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    counters = None
    if before is not None and after is not None:
        counters = {k: after[k] - before.get(k, 0) for k in after}
    host_s: dict = {}
    count: dict = {}
    for s, e, name in program:
        if w0 <= s <= w1:
            host_s[name] = host_s.get(name, 0.0) + (e - s) * 1e-6
            count[name] = count.get(name, 0) + 1
    return ProgramTrace(
        requests=requests, counters=counters, host_s=host_s, count=count,
        device_s_in=device_s_in, fold_idle_s=fold_idle_s,
        case_filter_s=case_filter_s,
        idle_gaps=[list(kv) for kv in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])


# ------------------------------------------------------ the five numbers
def host_syncs_per_request(p: ProgramTrace):
    if p.counters is None or not p.requests:
        return None
    return p.counters["host_syncs"] / len(p.requests)


def program_copy_mb(p: ProgramTrace):
    if p.counters is None or not p.requests:
        return None
    return (p.counters["d2h_bytes"] + p.counters["h2d_bytes"]) \
        / len(p.requests) / 1e6


def case_filter_ms(p: ProgramTrace):
    if not p.case_filter_s:
        return None
    return sum(p.case_filter_s) / len(p.case_filter_s) * 1e3


def ordered_fold_ms(p: ProgramTrace):
    s = p.device_s_in.get("kernel.ordered_histogram")
    if s is None or not p.requests:
        return None
    return s / len(p.requests) * 1e3


def fold_idle_ms(p: ProgramTrace):
    if p.fold_idle_s is None or not p.requests:
        return None
    return p.fold_idle_s / len(p.requests) * 1e3


READERS = (host_syncs_per_request, program_copy_mb, case_filter_ms,
           ordered_fold_ms, fold_idle_ms)


def numbers(p: ProgramTrace) -> dict:
    """The five numbers that have something to read."""
    out = {}
    for fn in READERS:
        value = fn(p)
        if value is not None:
            out[fn.__name__] = value
    return out


# ------------------------------------------------------------- the run
def program_counters() -> dict | None:
    """The program's counters now, or ``None`` for a program without
    them."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.counters()


def main(argv=None) -> int:
    import argparse
    import json
    import time
    from pathlib import Path

    ap = argparse.ArgumentParser(prog="python -m pmbench.program_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    from pmbench import harness

    res = harness.run_cell(root, args.workload, args.seed, args.seconds,
                           True, args.device, time.time())
    p = res.data.program

    def top(d: dict) -> list:
        return [list(kv) for kv in
                sorted(d.items(), key=lambda kv: -kv[1])[:12]]

    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "correct": res.line["correct"], "requests": len(p.requests),
        "counters": p.counters,
        "spans_per_request": sum(p.count.values())
        / max(len(p.requests), 1),
        "device_s_by_program_span": top(p.device_s_in),
        "host_s_by_program_span": top(p.host_s),
        "idle_gaps": p.idle_gaps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
