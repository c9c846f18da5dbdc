"""Distributed process mining on the PyTorch / CUDA port: the sharded DFG
(halo carry + psum) and the all-to-all distributed sort, on a
single-controller mesh of 8 shards (shard i on cuda:(i % device_count);
on one card all 8 share it), plus the Dataset facade's engine="sharded".

Computes the DFG of a ~1.4M-event log sharded 8 ways, validates it against
the single-shard result, mines the same log from an EDF file with
engine="sharded", and shows the distributed sort-by-case that the shifting
strategy assumes.

  PYTHONPATH=src python examples/distributed_mining_torch.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

import repro_torch
from repro_torch.core import ACTIVITY, CASE, TIMESTAMP, EventFrame, dfg
from repro_torch.data import synthetic
from repro_torch.distributed.dfg import dfg_sharded
from repro_torch.distributed.mesh import mesh_for
from repro_torch.distributed.sort import sort_by_case_sharded
from repro_torch.storage import edf

SHARDS = 8
A = 26


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=200_000)
    ap.add_argument("--device", default="cuda",
                    help="where the shards live (default: the card)")
    args = ap.parse_args()

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    mesh = mesh_for(SHARDS, args.device)
    print(f"mesh: {mesh.size} shards on {sorted({str(d) for d in mesh.devices})}")
    cols, tables = synthetic.generate_numpy(num_cases=args.cases,
                                            num_activities=A, seed=5)
    cols = {k: cols[k] for k in (CASE, ACTIVITY, TIMESTAMP)}
    n = cols[CASE].shape[0]
    pad = (-n) % SHARDS
    padded = {k: np.concatenate([v, np.full(pad, -1, v.dtype)])
              for k, v in cols.items()}
    frame = EventFrame.from_numpy(padded, device=args.device)
    frame = EventFrame(frame.columns, {}, torch.arange(
        n + pad, device=args.device) < n)
    print(f"log: {n:,} events, sharded {SHARDS} ways")

    dfg(frame, A)
    dfg_sharded(frame, A, mesh)                 # first use: kernel builds
    sync()
    t0 = time.perf_counter()
    ref = dfg(frame, A)
    sync()
    t_local = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = dfg_sharded(frame, A, mesh)
    sync()
    t_dist = time.perf_counter() - t0
    same = all(torch.equal(getattr(got, f), getattr(ref, f))
               for f in ("counts", "starts", "ends"))
    assert same, "distributed DFG mismatch!"
    print(f"DFG one shard: {t_local * 1e3:.1f}ms   sharded x{SHARDS} "
          f"(halo + psum): {t_dist * 1e3:.1f}ms   counts identical: {same}")
    print(f"reduce payload: one {A}x{A} int32 psum + two ({A},) histograms = "
          f"{(A * A + 2 * A) * 4} bytes (vs a Spark shuffle of O(N) edges)")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "log.edf")
        edf.write(path, EventFrame.from_numpy(cols, device="cpu"),
                  {ACTIVITY: tables[ACTIVITY]}, row_group_rows=65_536)
        ds = repro_torch.open(path, device=args.device)
        t0 = time.perf_counter()
        res = ds.collect("dfg", engine="sharded", num_shards=SHARDS)
        sync()
        t_ds = time.perf_counter() - t0
        streamed = ds.collect("dfg", engine="streaming").result
        ok = all(torch.equal(getattr(res.result, f), getattr(streamed, f))
                 for f in ("counts", "starts", "ends"))
        assert ok, "sharded engine != streaming engine!"
        print(f"Dataset engine='sharded' ({SHARDS} shards, from disk): "
              f"{t_ds * 1e3:.1f}ms   equal to streaming: {ok}")

    # distributed sort: scramble event order, re-sort by case via all_to_all
    perm = torch.from_numpy(np.random.default_rng(0).permutation(frame.nrows))
    scrambled = frame.take(perm.to(args.device))
    sort_by_case_sharded(scrambled, mesh)
    sync()
    t0 = time.perf_counter()
    case_s, act_s, ts_s, overflow = sort_by_case_sharded(scrambled, mesh)
    sync()
    print(f"distributed sort-by-case (bucket all_to_all + local lexsort): "
          f"{(time.perf_counter() - t0) * 1e3:.1f}ms, bucket overflow: "
          f"{bool(overflow)}")
    rows = [c.cpu().numpy() for c in case_s]        # one array per shard
    ok = all(bool((np.diff(r[r >= 0]) >= 0).all()) for r in rows)
    owned = all(bool((np.unique(r[r >= 0]) % SHARDS == i).all())
                for i, r in enumerate(rows))
    kept = sum(len(np.unique(r[r >= 0])) for r in rows)
    print(f"each shard case-sorted: {ok}; cases land on case%{SHARDS} shard: "
          f"{owned}; no case lost: {kept == args.cases}")
    if not (ok and owned and kept == args.cases and not bool(overflow)):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
