#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel bitwise against its plain PyTorch version on the
card, times it, and then drives the main path — the paper's Table-6 level-L1
log (10^6 cases, ~7x10^6 events, 26 activities) written as an EDF file with
524,288-row groups and streamed from disk through the out-of-core DFG
engine on the card.  The streamed DFG must equal, bitwise, the same stream
through the plain versions on the CPU, the whole-log DFG on the card, the
literal shift-and-count DFG on the card, and a numpy count made straight
from the generator's columns.

Every line of standard output is one JSON object; the last one is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed.  The script exits non-zero, before any work, when no CUDA device is
visible, and it imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NUM_ACTIVITIES = 26
ROW_GROUP_ROWS = 524_288
SEED = 1
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the non-tensor-core
# 32-bit rate (the counting kernels do one integer add per event)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
PAIR_COUNT_TPU = "src/repro/kernels/segment_ops/pair_count.py:74"
HISTOGRAM_TPU = "src/repro/kernels/segment_ops/histogram.py:56"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def time_ms(torch, fn, n_inputs: int, iters: int = 200) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` launches (CUDA events),
    cycling through ``n_inputs`` input sets, after a warm-up."""
    for i in range(min(n_inputs, 5)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(torch, fn) -> dict:
    """Device-side activity of ``fn`` from a ``torch.profiler`` trace:
    ``{name: (count, device microseconds)}`` over kernels, copies and
    fills only (host-side operators, which also carry their kernels'
    device time, are left out so nothing is counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        rows[e.key] = (e.count, t)
    return rows


def graph_ms(torch, fn, launches: int, replays: int = 50) -> float:
    """Device time per call with the host's per-call cost out of the way:
    ``fn``'s ``launches`` calls are captured once into a CUDA graph and the
    graph is replayed (each call's output allocation and zero-fill included)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / launches


def check_kernels(torch, so) -> dict:
    """Each kernel against its plain version on the card, bitwise, over the
    shape sweep: ids include -1 and >= the bound, weights 0/1 and signed.
    Sizes 242 and 300 (and 242^2 bins) take the global-atomic branch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def ids(n, hi):
        return torch.randint(-1, hi + 2, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def weights(n, kind):
        lo, hi = (0, 2) if kind == "mask" else (-3, 4)
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    sizes_e = (0, 1, 511, 524_288, 7_000_000)
    out = {"pair_count": {"cases": 0, "max_abs_err": 0},
           "histogram": {"cases": 0, "max_abs_err": 0}}

    def record(name, got, want, what):
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        out[name]["cases"] += 1
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} kernel != plain version at {what}: "
                                 f"max abs err {err}")

    shapes = [(a, a) for a in (1, 26, 129, 241, 242, 300)] + [(3, 200), (11, 7)]
    for s, d in shapes:
        for e in sizes_e:
            for kind in ("mask", "signed"):
                src, dst, w = ids(e, s), ids(e, d), weights(e, kind)
                got = so.pair_count_cuda(src, dst, w, s, d)
                want = so.pair_count_ref(src, dst, w, s, d)
                record("pair_count", got, want, f"S={s} D={d} E={e} w={kind}")
    for b in (1, 26, 129, 241, 242, 300, 676, 241 * 241, 242 * 242):
        for e in sizes_e:
            for kind in ("mask", "signed"):
                v, w = ids(e, b), weights(e, kind)
                got = so.histogram_cuda(v, w, b)
                want = so.histogram_ref(v, b, w)
                record("histogram", got, want, f"B={b} E={e} w={kind}")
    torch.cuda.synchronize()
    return out


def time_kernels(torch, so, engine, frame_gpu) -> dict:
    """Kernel, plain-version and library times at the main path's shapes:
    the DFG update's inputs over the L1 log, per 524,288-row chunk (the
    chunks cycle, so inputs come from HBM, not L2) and over the whole log."""
    a = NUM_ACTIVITIES
    adj = engine.adjacent(frame_gpu, engine.init_row_carry("cuda"))
    prev_act, act = adj.prev_act.contiguous(), adj.act.contiguous()
    pair = adj.pair.to(torch.int32)
    is_start = adj.is_start.to(torch.int32)
    pair_key = prev_act.long() * a + act.long()
    act_long = act.long()
    n = act.shape[0]
    spans = [(lo, min(lo + ROW_GROUP_ROWS, n)) for lo in range(0, n, ROW_GROUP_ROWS)]
    spans = [s for s in spans if s[1] - s[0] == ROW_GROUP_ROWS]
    whole = [(0, n)]
    pc_out = torch.zeros(a * a, dtype=torch.int32, device="cuda")
    h_out = torch.zeros(a, dtype=torch.int32, device="cuda")
    h2_out = torch.zeros(a * a, dtype=torch.int32, device="cuda")
    shift_key = (prev_act * a + act).contiguous()   # the shift method's df:pair ids
    rows = {}
    for label, sp in (("chunk", spans), ("whole_log", whole)):
        e = sp[0][1] - sp[0][0]
        k = len(sp)

        def sl(t, i, sp=sp):
            lo, hi = sp[i]
            return t[lo:hi]

        rows[f"pair_count/{label}"] = {
            "E": e, "S": a, "D": a,
            "ms": time_ms(torch, lambda i: so.pair_count_cuda(
                sl(prev_act, i), sl(act, i), sl(pair, i), a, a), k),
            "plain_ms": time_ms(torch, lambda i: so.pair_count_ref(
                sl(prev_act, i), sl(act, i), sl(pair, i), a, a), k),
            "library_ms": time_ms(torch, lambda i: pc_out.index_add_(
                0, sl(pair_key, i), sl(pair, i)), k),
            **bound(12 * e + 4 * a * a, e)}
        rows[f"histogram/{label}"] = {
            "E": e, "B": a,
            "ms": time_ms(torch, lambda i: so.histogram_cuda(
                sl(act, i), sl(is_start, i), a), k),
            "plain_ms": time_ms(torch, lambda i: so.histogram_ref(
                sl(act, i), a, sl(is_start, i)), k),
            "library_ms": time_ms(torch, lambda i: h_out.index_add_(
                0, sl(act_long, i), sl(is_start, i)), k),
            **bound(8 * e + 4 * a, e)}
    # device time per call (the event times above include the host's
    # per-call cost whenever the card outruns the launches)
    for label, sp in (("chunk", spans), ("whole_log", whole)):
        rows[f"pair_count/{label}"]["graph_ms"] = graph_ms(torch, lambda sp=sp: [
            so.pair_count_cuda(prev_act[lo:hi], act[lo:hi], pair[lo:hi], a, a)
            for lo, hi in sp], len(sp))
        rows[f"histogram/{label}"]["graph_ms"] = graph_ms(torch, lambda sp=sp: [
            so.histogram_cuda(act[lo:hi], is_start[lo:hi], a)
            for lo, hi in sp], len(sp))
    e = n
    rows["histogram/shift_whole_log"] = {
        "E": e, "B": a * a,
        "ms": time_ms(torch, lambda i: so.histogram_cuda(shift_key, pair, a * a), 1),
        "plain_ms": time_ms(torch, lambda i: so.histogram_ref(shift_key, a * a, pair), 1),
        "library_ms": time_ms(torch, lambda i: h2_out.index_add_(0, pair_key, pair), 1),
        **bound(8 * e + 4 * a * a, e)}
    torch.cuda.synchronize()
    return rows


def numpy_dfg(case: np.ndarray, act: np.ndarray, a: int):
    """Independent host oracle of the DFG of an all-valid sorted log."""
    same = case[1:] == case[:-1]
    key = act[:-1].astype(np.int64) * a + act[1:]
    counts = np.bincount(key[same], minlength=a * a).reshape(a, a)
    start = np.concatenate([[True], ~same])
    end = np.concatenate([~same, [True]])
    return (counts.astype(np.int32),
            np.bincount(act[start], minlength=a).astype(np.int32),
            np.bincount(act[end], minlength=a).astype(np.int32))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (ACTIVITY, CASE, ChunkedEventFrame, EventFrame,
                                  dfg, dfg_kernel, engine, run_streaming)
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_ops as so
    from repro_torch.storage import edf

    # ---------------------------------------------------------------- device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    log = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                       if "Used" in ln or "spill" in ln
                                       or "entry function" in ln]}
                      for name, v in log.items()}})

    # --------------------------------------------------- kernels vs plain
    t0 = time.perf_counter()
    checks = check_kernels(torch, so)
    emit({"phase": "kernels_check", "seconds": time.perf_counter() - t0,
          "tolerance": "bitwise (integer counts)", **checks})

    # -------------------------------------------------- main path: L1 log
    cfg = synthetic.paper_table6_config(1)
    t0 = time.perf_counter()
    cols, tables = synthetic.generate_numpy(**cfg)
    case_np, act_np = cols[CASE], cols[ACTIVITY]
    del cols
    events = int(case_np.shape[0])
    cases = int((case_np[1:] != case_np[:-1]).sum()) + 1
    t_gen = time.perf_counter() - t0

    frame_cpu = EventFrame.from_numpy({CASE: case_np, ACTIVITY: act_np},
                                      device="cpu")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "L1.edf")
    t0 = time.perf_counter()
    header = edf.write(path, frame_cpu, {ACTIVITY: tables[ACTIVITY]},
                       codec="zlib1", row_group_rows=ROW_GROUP_ROWS, version=3)
    t_write = time.perf_counter() - t0
    chunks = len(header["groups"])
    emit({"phase": "data", "level": "L1", "config": cfg, "events": events,
          "cases": cases, "row_group_rows": ROW_GROUP_ROWS, "groups": chunks,
          "file_bytes": Path(path).stat().st_size,
          "generate_s": t_gen, "write_s": t_write})

    try:
        cols_proj = [CASE, ACTIVITY]
        source = ChunkedEventFrame.from_edf(path, columns=cols_proj, device="cuda")
        kernel = dfg_kernel(NUM_ACTIVITIES)
        run_streaming(kernel, source)          # warm-up: first-use costs
        torch.cuda.synchronize()

        so.pair_count_cuda.launches = 0
        so.histogram_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d_gpu = run_streaming(kernel, source)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        launches = {"pair_count": so.pair_count_cuda.launches,
                    "histogram": so.histogram_cuda.launches}
        peak = torch.cuda.max_memory_allocated()

        # stage breakdown of the same stream, each stage synchronized
        t_read = t_h2d = t_dev = 0.0
        state, carry = kernel.init("cuda")
        it = edf.read_streaming(path, columns=cols_proj, device="cpu")
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            t_read += time.perf_counter() - t0
            if item is None:
                break
            t0 = time.perf_counter()
            chunk = item[0].to("cuda")
            torch.cuda.synchronize()
            t_h2d += time.perf_counter() - t0
            t0 = time.perf_counter()
            state, carry = kernel.update(state, carry, chunk)
            torch.cuda.synchronize()
            t_dev += time.perf_counter() - t0
        d_staged = kernel.finalize(state, carry)

        d_cpu = run_streaming(dfg_kernel(NUM_ACTIVITIES), ChunkedEventFrame.from_edf(
            path, columns=cols_proj, device="cpu"))
        frame_gpu = frame_cpu.to("cuda")
        d_whole = dfg(frame_gpu, NUM_ACTIVITIES)
        d_shift = dfg(frame_gpu, NUM_ACTIVITIES, method="shift")
        oracle = numpy_dfg(case_np, act_np, NUM_ACTIVITIES)

        def host(d):
            return tuple(getattr(d, f).cpu().numpy()
                         for f in ("counts", "starts", "ends"))

        got = host(d_gpu)
        for label, other in (("cpu_plain_stream", host(d_cpu)),
                             ("staged_stream", host(d_staged)),
                             ("whole_log", host(d_whole)),
                             ("shift", host(d_shift)),
                             ("numpy_oracle", oracle)):
            for name, x, y in zip(("counts", "starts", "ends"), got, other):
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"streamed DFG {name} != {label}")
        invariants = {
            "counts_sum": int(got[0].sum()), "events_minus_cases": events - cases,
            "starts_sum": int(got[1].sum()), "ends_sum": int(got[2].sum()),
            "cases": cases}
        if not (invariants["counts_sum"] == events - cases
                and invariants["starts_sum"] == cases == invariants["ends_sum"]):
            raise AssertionError(f"count invariants fail: {invariants}")
        if launches["pair_count"] < chunks or launches["histogram"] < 2 * chunks:
            raise AssertionError(f"main path did not go through the kernels: "
                                 f"{launches} for {chunks} chunks")
        emit({"phase": "main_path", "events": events, "chunks": chunks,
              "seconds": t_stream, "events_per_s": events / t_stream,
              "stages_s": {"read_decode": t_read, "host_to_device": t_h2d,
                           "device": t_dev},
              "max_memory_allocated": peak, "launches": launches,
              "bitwise_equal_to": ["cpu_plain_stream", "staged_stream",
                                   "whole_log", "shift", "numpy_oracle"],
              "invariants": invariants, "nvidia_smi": smi})

        # device busy time of one more stream, from a profiler trace; the
        # idle share is against the unprofiled stream's wall time
        prof = profile_device(torch, lambda: run_streaming(kernel, source))
        busy_us = sum(t for _, t in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
        emit({"phase": "main_path_profile", "stream_wall_s": t_stream,
              "device_busy_s": busy_us / 1e6,
              "device_idle_share": 1.0 - busy_us / 1e6 / t_stream,
              "top_device": [{"name": k[:80], "count": c, "us": t}
                             for k, (c, t) in top]})

        # ------------------------------------------- kernel times on card
        times = time_kernels(torch, so, engine, frame_gpu)
        emit({"phase": "kernel_times", "nvidia_smi": smi, "rows": times})
    finally:
        Path(path).unlink(missing_ok=True)

    def entry(name, source_file, replaces, row):
        return {"name": name, "route": "cuda", "source": source_file,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": checks[name]["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    emit({"kernels": [
        entry("pair_count", "src/repro_torch/kernels/csrc/pair_count.cu",
              PAIR_COUNT_TPU, times["pair_count/chunk"]),
        entry("histogram", "src/repro_torch/kernels/csrc/histogram.cu",
              HISTOGRAM_TPU, times["histogram/chunk"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
