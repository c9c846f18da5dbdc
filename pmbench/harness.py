"""One run of one cell: set-up, the measured window, the check, one line.

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``pmbench/configs/<config>.json``) and a traffic mix
(``pmbench/traffic/<traffic>.json``); the mix's verbs are
``pmbench/verbs/<verb>.py`` and the cell's per-layer metrics
``pmbench/metrics/<metric>.py``.  Nothing here names a cell, a
configuration, a mix, a verb or a metric: a new one is a new file and a new
entry.

The run, in order:

1. the program's mining kernels are built (in parallel) or loaded;
2. the log is drawn on the device from ``--seed`` (``pmbench.gen``);
3. ``repro_torch.open(frame, device=...)`` holds it as an in-memory
   ``Dataset`` -- or, where the configuration has a ``storage`` key
   (``STORAGE_KEYS``), the log is written as EDF files
   (``repro_torch.storage.edf.write``: ``files`` contiguous case ranges)
   into a directory made for the run and removed when the run ends, the
   reference's columns move to host memory, and
   ``repro_torch.open(paths, device=...)`` opens the files, its engine
   chosen by ``auto`` as for any user;
4. every (filter kind, verb) pair of the mix is asked once (warm-up);
5. a closed loop of one client asks the mix's requests for ``--seconds``
   (``--trace 1``: a shorter window under the profiler, with the
   harness's spans and the program's own spans and counters);
6. a sample of the answers, drawn from the seed per stratum, is held
   against the plain reference (``pmbench.reference``), on the device;
   the inputs (the columns, and each file's signature) are held against
   what they were before the window;
7. one JSON line.

A request is ``ds.filter(pred).collect(verb)`` (or ``collect_many``), and
it ends when every tensor of its answer is a numpy array in host memory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import gen, traffic
from .reference import Log, compare

MINING_SOURCES = ("pair_count", "histogram", "segment_reduce",
                  "ordered_histogram", "segmented_scan")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
TRACE_SECONDS = 3.0
GIB = 2.0 ** 30
# a configuration's ``storage``: the log as EDF files, written as
# ``edf.write(path, frame, codec=, row_group_rows=, version=)`` into
# ``files`` contiguous case ranges
STORAGE_KEYS = ("format", "version", "codec", "row_group_rows", "files")


# ------------------------------------------------------------- the data
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic mix) of a workload name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"one of {sorted(cells)}")
    cell = cells[workload]
    cfg = load_config(root, cell["config"])
    return bench, cell, cfg, traffic.load(root, cell["traffic"])


def load_config(root: Path, name: str) -> dict:
    """A configuration; a ``storage`` the harness does not read is
    refused, never ignored."""
    cfg = load_json(Path(root) / "pmbench" / "configs" / f"{name}.json")
    storage = cfg.get("storage")
    if storage is not None:
        if set(storage) != set(STORAGE_KEYS):
            raise ValueError(
                f"config {name!r}: storage keys {sorted(storage)}; the "
                f"harness reads exactly {sorted(STORAGE_KEYS)}")
        if storage["format"] != "edf" or int(storage["files"]) < 1:
            raise ValueError(f"config {name!r}: storage {storage} is not "
                             f"EDF files (format 'edf', files >= 1)")
    return cfg


def verb(name: str):
    return importlib.import_module(f"pmbench.verbs.{name}")


def metric_reader(root: Path, name: str):
    path = root / "pmbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pmbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------- the program
def to_host(x):
    """An answer as host data: tensors become numpy arrays, dataclasses
    dicts of their fields, sets sorted int64 arrays."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_host(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(to_host(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return np.array(sorted(x), dtype=np.int64)
    return x


def predicate(req: traffic.Request):
    from repro_torch import cases_containing, col

    if req.kind == "none":
        return None
    if req.kind == "cases_containing":
        return cases_containing(req.params[0])
    if req.kind == "attr_lt":
        column, k = req.params
        return col(column) < k
    lo, hi = req.params
    return col(gen.CASE).between(lo, hi)


def ask(ds, req: traffic.Request):
    pred = predicate(req)
    d = ds if pred is None else ds.filter(pred)
    if req.fused:
        return d.collect_many(req.verbs).results
    return d.collect(req.verbs[0]).result


def program_answers(req: traffic.Request, answer) -> dict:
    """{verb: the program's answer as that verb's named arrays}."""
    if req.fused:
        return {v: verb(v).program(answer[v]) for v in req.verbs}
    return {req.verbs[0]: verb(req.verbs[0]).program(answer)}


# ----------------------------------------------------------- the window
class Sampler:
    """A reservoir of ``k`` answers a stratum (filter kind and verbs),
    drawn from the seed: the answers the check holds against the
    reference."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed) % 2**64, 3])
        self.slots: dict[str, list] = {}
        self.seen: dict[str, int] = {}

    def offer(self, req, answer) -> None:
        n = self.seen.get(req.stratum, 0)
        self.seen[req.stratum] = n + 1
        slots = self.slots.setdefault(req.stratum, [])
        if n < self.k:
            slots.append((req, answer))
            return
        j = int(self.rng.integers(n + 1))
        if j < self.k:
            slots[j] = (req, answer)

    def items(self) -> list:
        return [it for s in sorted(self.slots) for it in self.slots[s]]


@dataclasses.dataclass
class Window:
    latencies: list
    answered: int
    failed: int
    seconds: float
    requests: list
    errors: list
    split: list


def run_window(ds, stream, seconds: float, sampler: Sampler,
               recorder=None) -> Window:
    lat, reqs, errors = [], [], []
    split = [0.0, 0.0]      # host seconds in the call, and in the read-back
    answered = failed = 0
    t_start = time.perf_counter()
    t_end = t_start
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        req = next(stream)
        answer = None
        try:
            if recorder is None:
                raw = ask(ds, req)
                t_asked = time.perf_counter()
                answer = to_host(raw)
                del raw
                split[0] += t_asked - t0
                split[1] += time.perf_counter() - t_asked
            else:
                recorder.request = req.index
                with recorder.span("request"):
                    with recorder.span("facade"):
                        raw = ask(ds, req)
                    with recorder.span("readback"):
                        answer = to_host(raw)
                    del raw
            answered += 1
        except Exception as e:      # a failed request is counted, not fatal
            failed += 1
            if len(errors) < 3:
                errors.append(f"request {req.index} ({req.stratum}): "
                              f"{type(e).__name__}: {e}")
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        reqs.append(req)
        sampler.offer(req, answer)
    return Window(lat, answered, failed, t_end - t_start, reqs, errors,
                  split)


# ------------------------------------------------------------ the check
def check(cols: dict, cfg: dict, items: list) -> dict:
    """Hold sampled answers against the reference.  ``items`` is a list of
    ``(request, {verb: named arrays})``; an answer that never came is
    ``None`` (the run counts those as failed).  Returns the numbers
    compared and how many answers were."""
    log = Log(cols, cfg["num_activities"])
    mismatches, err, checked = 0, 0.0, 0
    for req, answers in items:
        if answers is None:
            continue
        view = log.view(req.kind, req.params)
        for name, prog in answers.items():
            m, e = compare(prog, verb(name).reference(view))
            mismatches += m
            err = max(err, e)
        checked += 1
        del view
    return {"int_mismatches": mismatches, "float_err": err,
            "checked": checked}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit, and whether all hold (and
    at least one answer was checked)."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(numbers[k] <= limits[k] for k in limits)
    return ok and numbers["checked"] > 0, shown


# ------------------------------------------------------------- the run
def process_start() -> float | None:
    """The process's start on ``time.time()``'s clock, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log_dir(cfg: dict):
    """The directory a run writes its log's files into, removed when the
    context ends (also on a failure); nothing for a resident log."""
    if "storage" not in cfg:
        return contextlib.nullcontext()
    return tempfile.TemporaryDirectory(prefix="pmbench-edf-")


def write_log(cols: dict, cfg: dict, directory) -> list[str]:
    """The log as ``storage["files"]`` EDF files of contiguous case ranges,
    in (case, time) order; their paths."""
    from repro_torch.core.eventframe import EventFrame
    from repro_torch.storage import edf

    st = cfg["storage"]
    n, parts = int(cfg["num_cases"]), int(st["files"])
    case = cols[gen.CASE]
    cuts = torch.tensor([k * n // parts for k in range(1, parts)],
                        dtype=case.dtype, device=case.device)
    bounds = [0, *torch.searchsorted(case, cuts).tolist(), case.shape[0]]
    paths = []
    for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        path = os.path.join(directory, f"part-{i:04d}.edf")
        edf.write(path, EventFrame({k: v[lo:hi] for k, v in cols.items()}),
                  tables=gen.tables(cfg), codec=st["codec"],
                  row_group_rows=int(st["row_group_rows"]),
                  version=int(st["version"]))
        paths.append(path)
    return paths


def file_sigs(ds) -> list:
    """Each file's ``edf.file_sig`` (none for a resident log)."""
    from repro_torch.storage import edf

    return [edf.file_sig(p) for p in ds.paths] if ds.is_files else []


def prepare(cfg: dict, mix: dict, seed: int, dev: torch.device,
            marks: list | None = None, directory=None):
    """The set-up: the mining kernels built or loaded, the log drawn on
    ``dev``, the ``Dataset`` opened on it (in memory, or over the files
    written into ``directory`` where ``cfg`` has a ``storage``), every
    (filter, verb) pair of the mix asked once.  Returns ``(columns,
    dataset)``: the columns on ``dev`` for a resident log, in host memory
    for a log in files (``on_device`` brings them back for the check).
    Appends ``(step, time)`` to ``marks``."""
    import repro_torch
    from repro_torch.core.eventframe import EventFrame

    marks = [] if marks is None else marks
    marks.append(("imports", time.time()))
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build(MINING_SOURCES)
        torch.cuda.init()
    marks.append(("kernels", time.time()))
    cols = gen.generate(cfg, seed, dev)
    if "storage" in cfg:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append(("log", time.time()))
        cols = {k: v.cpu() for k, v in cols.items()}
        ds = repro_torch.open(write_log(cols, cfg, directory), device=dev)
        marks.append(("storage", time.time()))
    else:
        ds = repro_torch.open(EventFrame(dict(cols)), tables=gen.tables(cfg),
                              device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append(("log", time.time()))
    for req in traffic.warm_requests(mix, cfg):
        to_host(ask(ds, req))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.time()))
    return cols, ds


def on_device(cols: dict, dev: torch.device) -> dict:
    """The reference's columns on ``dev`` (where the check runs)."""
    return {k: v.to(dev) for k, v in cols.items()}


@dataclasses.dataclass
class Result:
    line: dict
    stderr: list
    data: object = None     # a traced run's trace.TraceData


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_process: float) -> Result:
    """One run of a cell on ``device``; returns the result line and the
    lines for standard error (the check's numbers last)."""
    root = Path(root)
    bench, cell, cfg, mix = load_cell(root, workload)
    with log_dir(cfg) as directory:
        return _run_cell(root, bench, cfg, mix, workload, seed, seconds,
                         trace, device, t_process, directory)


def _run_cell(root, bench, cfg, mix, workload, seed, seconds, trace, device,
              t_process, directory) -> Result:
    limits = load_json(root / "pmbench" / "limits.json")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    marks = [("start", t_process)]
    cols, ds = prepare(cfg, mix, seed, dev, marks, directory)
    rows = int(cols[gen.CASE].shape[0])
    digest = gen.digest(cols)
    sigs = file_sigs(ds)
    sampler = Sampler(mix["sample_per_stratum"], seed)
    stream = traffic.requests(mix, cfg, seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_process
    recorder = data = None
    if trace:
        from . import program_spans as ps
        from . import trace as tr

        recorder = tr.Recorder(sync)
        sync()
        before = ps.program_counters()
        with tr.engine_spans(recorder), tr.profiler(dev.type) as prof:
            win = run_window(ds, stream, min(seconds, TRACE_SECONDS),
                             sampler, recorder)
        sync()
        after = ps.program_counters()
    else:
        win = run_window(ds, stream, seconds, sampler)
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    num_cases = ds.num_cases
    sigs_changed = file_sigs(ds) != sigs
    del ds
    trace_bytes = 0
    if trace:
        events, trace_bytes = tr.read_events(prof)
        data = tr.reduce(events, recorder, win.requests, cfg, rows, num_cases,
                         ps.reduce(events, win.requests, before, after))
        del prof, events

    items = [(req, None if ans is None else program_answers(req, ans))
             for req, ans in sampler.items()]
    del sampler
    cols = on_device(cols, dev)
    numbers = check(cols, cfg, items)
    numbers["unanswered"] = win.failed
    numbers["inputs_changed"] = int(gen.digest(cols) != digest
                                    or sigs_changed)
    ok, shown = verdict(numbers, limits)

    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = metric_reader(root, m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        done = win.answered
        values = {
            "events_per_s": done * rows / win.seconds if win.seconds else 0.0,
            "request_p95_ms": float(np.percentile(win.latencies, 95)) * 1e3,
            "peak_device_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if workload in m.get("workloads", [workload])}
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    limit = power_limit() if cuda else "none"
    info["power_limit"] = limit
    line = {"correct": ok, "attempted": len(win.latencies),
            "failed": win.failed, "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = data.busy_s if data.has_device else 0.0
        info["window_s"] = data.window_s
        line["breakdown"] = {"device_ops": data.device_ops,
                             "idle_gaps": data.idle_gaps}
    line["check"] = shown
    n_req = max(len(win.latencies), 1)
    err = [f"pmbench: {workload} seed {seed} rows {rows} requests "
           f"{len(win.latencies)} answered {win.answered} "
           f"checked {numbers['checked']} setup_s {setup_s:.3f} "
           f"trace_bytes {trace_bytes}",
           "pmbench: set-up s " + " ".join(
               f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
           f"pmbench: card {limit}"] + [f"pmbench: {e}" for e in win.errors]
    if not trace:
        err.append(f"pmbench: host ms a request: call "
                   f"{win.split[0] / n_req * 1e3:.3f} read-back "
                   f"{win.split[1] / n_req * 1e3:.3f} (the read-back waits "
                   f"for the device)")
    err += [f"check {k} = {v['value']!r} (limit {v['limit']!r})"
            for k, v in shown.items()]
    # last, once every verb and metric file of the run has been loaded
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"pmbench: modules of another package were loaded: "
                         f"{bad}")
    return Result(line, err, data)
