"""Spans around the calls into each layer, and the profiler's trace reduced
to what the per-layer metrics read.

The spans are the benchmark's own: in a traced run the harness wraps the
request (``request``), the facade call (``facade``: ``Dataset.filter`` ->
``collect`` / ``collect_many``), the two engine functions the facade calls
for an in-memory frame -- ``dataset.engines.eager_frame`` (``filter``: the
row masks and the case filter's phase one) and ``dataset.engines.
_fold_eager`` (``fold``: the verbs' kernels and finalize) -- and the
read-back (``readback``).  Each span synchronises the device at both ends,
so its host time holds the device work it launched, and each opens a
``torch.profiler.record_function`` range, so the trace can put every
device kernel into the span that launched it.

The program's own spans and counters (``repro_torch.trace``) are reduced
from the same window by ``pmbench.program_spans`` and reach the readers as
``TraceData.program``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import torch

SPAN_PREFIX = "pmbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# innermost first: an idle gap is put down to the first span holding it
GAP_ORDER = ("filter", "fold", "facade", "readback", "request")


class Recorder:
    """Host spans of the traced window: ``(name, request index, t0, t1)``."""

    def __init__(self, sync):
        self.sync = sync
        self.spans: list[tuple] = []
        self.request = -1

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            try:
                yield
            finally:
                self.sync()
        self.spans.append((name, self.request, t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return spanned


@contextlib.contextmanager
def engine_spans(recorder: Recorder):
    """Wrap the eager engine's filter and fold functions in spans."""
    from repro_torch.dataset import engines

    saved = engines.eager_frame, engines._fold_eager
    engines.eager_frame = recorder.wrap("filter", saved[0])
    engines._fold_eager = recorder.wrap("fold", saved[1])
    try:
        yield
    finally:
        engines.eager_frame, engines._fold_eager = saved


def profiler(device_type: str):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read_events(prof) -> tuple[list[dict], int]:
    """The trace's events and the bytes of the trace file they were read
    from (written to a temporary file, read, deleted)."""
    fd, path = tempfile.mkstemp(prefix="pmbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", []), os.path.getsize(path)
    finally:
        os.unlink(path)


@dataclasses.dataclass
class TraceData:
    """What the per-layer metric readers (``pmbench/metrics``) read."""

    requests: list          # the traced window's requests (traffic.Request)
    cfg: dict               # the configuration
    rows: int               # the log's rows
    num_cases: int
    spans: dict             # span name -> summed host seconds over the window
    device_s_in: dict       # span name -> device kernel seconds inside it
    kernels: int            # device kernels in the window
    busy_s: float | None    # device busy seconds (None: no device events)
    window_s: float         # the traced window's length
    device_ops: list        # [[name, seconds]] of the busiest device ops
    idle_gaps: list         # [[what the host was doing, idle seconds]]
    program: object = None  # the program's spans and counters
    #                         (program_spans.ProgramTrace)

    @property
    def has_device(self) -> bool:
        return self.busy_s is not None


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list[dict], recorder: Recorder, requests: list,
           cfg: dict, rows: int, num_cases: int,
           program=None) -> TraceData:
    spans = {}
    for name, _, t0, t1 in recorder.spans:
        spans[name] = spans.get(name, 0.0) + (t1 - t0)
    ranges = {}                 # span name -> sorted [(start, end)] in us
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, cat = ev.get("name", ""), ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            ranges.setdefault(name[len(SPAN_PREFIX):], []).append(
                (ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((name, cat, ts, ts + dur))
    for r in ranges.values():
        r.sort()
    req = ranges.get("request", [])
    if req:
        w0, w1 = req[0][0], max(e for _, e in req)
    else:
        w0, w1 = 0.0, 0.0
    window_s = (w1 - w0) * 1e-6 if req else sum(
        t1 - t0 for n, _, t0, t1 in recorder.spans if n == "request")

    def holder(t: float) -> str | None:
        for name in GAP_ORDER:
            r = ranges.get(name, [])
            i = bisect.bisect_right(r, (t, float("inf"))) - 1
            if i >= 0 and r[i][0] <= t <= r[i][1]:
                return name
        return None

    inside = {}
    ops = {}
    kernels = 0
    for name, cat, s, e in device:
        if not w0 <= s <= w1:
            continue
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
        if cat != "kernel":
            continue
        kernels += 1
        for span in ("filter", "fold", "facade", "readback"):
            r = ranges.get(span, [])
            i = bisect.bisect_right(r, (s, float("inf"))) - 1
            if i >= 0 and r[i][0] <= s and e <= r[i][1]:
                inside[span] = inside.get(span, 0.0) + (e - s) * 1e-6
    busy = _union([(max(s, w0), min(e, w1)) for _, _, s, e in device
                   if e > w0 and s < w1])
    gaps = {}
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            what = holder((s + prev) / 2) or "between requests"
            gaps[what] = gaps.get(what, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceData(
        requests=requests, cfg=cfg, rows=rows, num_cases=num_cases,
        spans=spans, device_s_in=inside, kernels=kernels,
        busy_s=(sum(e - s for s, e in busy) * 1e-6) if device else None,
        window_s=window_s, device_ops=[list(kv) for kv in top],
        idle_gaps=[list(kv) for kv in idle], program=program)
