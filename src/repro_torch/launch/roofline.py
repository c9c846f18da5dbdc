"""Roofline analysis of dry-run records on NVIDIA H100 SXM5 80 GB.

Three terms per (arch x shape x mesh), all **per device** (the dry run
counts one device's shards, ``launch.account``):

    compute    = flops_per_device / PEAK_FLOPS[compute dtype]
    memory     = bytes_per_device / HBM_BW
    collective = sum over mesh axes of that axis's bytes / its link rate

plus the model FLOPs, ``2 * N_active * tokens`` forward (``6 N D`` for a
train step), the yardstick that shows remat and replicated work, and the
roofline fraction ``useful_time / max(terms)``.  ``mfu`` is the share a
measured step reached: model FLOPs over (seconds x the peak of its dtype).

The constants are NVIDIA's H100 SXM5 data sheet (the 700 W card of every
measurement in ``PERF.md``): dense bf16 tensor-core 989 TFLOP/s, TF32
495 TFLOP/s, FP32 (no tensor cores) 67 TFLOP/s, HBM3 3.35 TB/s, NVLink 4
450 GB/s a direction (900 GB/s both ways), 80 GB of memory; and one 400
Gb/s NDR InfiniBand link a GPU (ConnectX-7), 50 GB/s, for the axes that
leave the 8-GPU NVLink board.  The model axis of the production mesh is one
board (``launch.mesh``); the data and pod axes cross InfiniBand.
"""
from __future__ import annotations

import argparse
import json

PEAK_FLOPS = {"bfloat16": 989e12,     # dense bf16 tensor cores
              "float16": 989e12,      # dense fp16 tensor cores
              "tf32": 495e12,         # dense TF32 tensor cores
              "float32": 67e12}       # FP32 without tensor cores (TF32 off)
HBM_BW = 3.35e12                      # B/s, HBM3
HBM_BYTES = 80e9                      # B
NVLINK_BW = 450e9                     # B/s a direction, NVLink 4 (18 links)
IB_BW = 50e9                          # B/s, one 400 Gb/s NDR link a GPU
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

TRAIN_FLOP_MULT = 3.0                 # fwd + bwd = 3x forward matmul flops


def peak_flops(compute_dtype: str) -> float:
    return PEAK_FLOPS.get(compute_dtype, PEAK_FLOPS["float32"])


def tokens_of(shape_name: str) -> int:
    from repro_torch.configs.shapes import SHAPES
    s = SHAPES[shape_name]
    if s.kind in ("train", "prefill"):
        return s.batch * s.seq
    return s.batch                           # decode: one token per sequence


def model_flops(n_active: float, tokens: int, kind: str) -> float:
    """``2 N D`` forward, ``6 N D`` a train step: the work a step must do."""
    return 2.0 * n_active * tokens * (TRAIN_FLOP_MULT if kind == "train" else 1.0)


def mfu(n_active: float, tokens: int, kind: str, seconds: float,
        compute_dtype: str) -> float:
    """Model FLOPs over (measured seconds x the peak of the compute dtype)."""
    return model_flops(n_active, tokens, kind) / (seconds * peak_flops(compute_dtype))


def collective_seconds(rec: dict) -> float:
    by_axis = rec.get("collectives_by_axis")
    if not by_axis:
        return rec["collective_bytes_per_device"] / IB_BW
    return sum(b / AXIS_BW.get(axis, IB_BW) for axis, b in by_axis.items())


def analyze_record(rec: dict, chips: int) -> dict:
    from repro_torch.configs.shapes import SHAPES
    shape = SHAPES[rec["shape"]]
    dtype = rec.get("compute_dtype", "bfloat16")
    peak = peak_flops(dtype)
    t_comp = rec["flops_per_device"] / peak
    t_mem = rec["bytes_per_device"] / HBM_BW
    t_coll = collective_seconds(rec)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)

    n_active = rec.get("active_params", rec.get("params", 0))
    useful_per_dev = model_flops(n_active, tokens_of(rec["shape"]), shape.kind) / chips
    flops = max(rec["flops_per_device"], 1.0)
    t_bound = max(terms.values())
    peak_bytes = rec.get("memory", {}).get("peak_bytes")
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "bottleneck": bottleneck,
        "peak_flops": peak, "peak_dtype": dtype,
        "model_flops_per_dev": useful_per_dev,
        "useful_ratio": useful_per_dev / flops,
        "roofline_fraction": (useful_per_dev / peak) / t_bound if t_bound else 0.0,
        "step_time_bound_s": t_bound,
        "fits": None if peak_bytes is None else peak_bytes <= HBM_BYTES,
    }


def chips_of(mesh: str) -> int:
    n = 1
    for s in mesh.split("x"):
        n *= int(s)
    return n


def load(path: str, mesh: str | None = None, tag: str = "baseline"):
    seen = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if not r.get("ok"):
                continue
            if mesh and r["mesh"] != mesh:
                continue
            if tag and r.get("tag", "baseline") != tag:
                continue
            seen[(r["arch"], r["shape"], r["mesh"])] = r  # last wins
    return list(seen.values())


def table(path: str, mesh: str = "32x8", tag: str = "baseline") -> list[dict]:
    rows = []
    for r in load(path, mesh, tag):
        rows.append({**r, **analyze_record(r, chips_of(r["mesh"]))})
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    return rows


def render(rows: list[dict]) -> str:
    hdr = (f"{'arch':<20} {'shape':<12} {'bottleneck':<11} "
           f"{'t_comp(ms)':>10} {'t_mem(ms)':>10} {'t_coll(ms)':>10} "
           f"{'useful%':>8} {'roofline%':>9} {'peak(GB)':>9} {'fits':>5}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        peak = r.get("memory", {}).get("peak_bytes", float("nan")) / 1e9
        out.append(
            f"{r['arch']:<20} {r['shape']:<12} {r['bottleneck']:<11} "
            f"{r['t_compute']*1e3:>10.2f} {r['t_memory']*1e3:>10.2f} "
            f"{r['t_collective']*1e3:>10.2f} {r['useful_ratio']*100:>7.1f}% "
            f"{r['roofline_fraction']*100:>8.1f}% {peak:>9.2f} {str(r['fits']):>5}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun.jsonl")
    ap.add_argument("--mesh", default="32x8")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rows = table(args.inp, args.mesh, args.tag)
    print(render(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
