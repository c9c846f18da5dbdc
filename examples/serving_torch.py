"""Live mining service demo on the PyTorch / CUDA port: ingest an event
stream while clients query, every request mined on the card.

The end-to-end serving loop: a producer drops batch files into a spool
directory, an :class:`Ingestor` tails them into partitioned EDFV0003
files (atomic appends, crash-safe skip-index), and an HTTP JSON API
answers mining queries concurrently — every response carrying the exact
snapshot it was mined from, with the per-group state cache keeping
post-append re-collects incremental.

  PYTHONPATH=src python examples/serving_torch.py [--cases N] [--batches B]
                                                  [--port P] [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=20_000)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--port", type=int, default=0,
                    help="0 picks a free port")
    ap.add_argument("--device", default="cuda",
                    help="where requests are mined (default: the card)")
    args = ap.parse_args()

    from repro_torch.core.eventframe import CASE, EventFrame
    from repro_torch.data import synthetic
    from repro_torch.service import Ingestor, serve
    from repro_torch.storage import edf

    frame, tables = synthetic.generate(num_cases=args.cases,
                                       num_activities=10, seed=42,
                                       device="cpu")
    case = frame[CASE].numpy()
    bounds = np.flatnonzero(case[1:] != case[:-1]) + 1
    per = max(1, len(bounds) // args.batches)
    cuts = [0] + [int(bounds[i]) for i in range(per - 1, len(bounds), per)]
    if cuts[-1] != frame.nrows:
        cuts.append(frame.nrows)
    print(f"log: {frame.nrows} events, {args.cases} cases, "
          f"{len(cuts) - 1} batches")

    root = tempfile.mkdtemp(prefix="repro-torch-serving-")
    spool, parts = os.path.join(root, "spool"), os.path.join(root, "parts")
    os.makedirs(spool)

    def produce():
        """The event stream: one batch file lands every 200 ms."""
        for i in range(len(cuts) - 1):
            a, b = cuts[i], cuts[i + 1]
            batch = EventFrame(
                {k: v[a:b] for k, v in frame.columns.items()},
                {k: v[a:b] for k, v in frame.valid.items()})
            edf.write(os.path.join(spool, f"batch_{i:04d}.edf"), batch,
                      tables, version=3)
            print(f"  producer: batch {i} ({b - a} events)")
            time.sleep(0.2)

    ingestor = Ingestor(parts, spool, poll_interval=0.05).start()
    httpd = serve(ingestor, port=args.port, case_capacity=args.cases,
                  device=args.device)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"serving on http://127.0.0.1:{port}\n")

    producer = threading.Thread(target=produce)
    producer.start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return json.loads(r.read())

    # query while the log grows: each response names its snapshot
    for _ in range(6):
        time.sleep(0.3)
        try:
            out = get("/collect?verb=dfg&engine=streaming")
        except urllib.error.HTTPError as e:     # 503 while spinning up
            print(f"  client: not ready yet ({e.code})")
            continue
        rep = out["report"]
        print(f"  client: dfg over {out['snapshot']['rows']} rows "
              f"(groups: {rep['groups_cached']} cached, "
              f"{rep['groups_folded']} folded, "
              f"{out['elapsed_us'] / 1000:.1f} ms)")

    producer.join()
    while ingestor.run_once():
        pass

    health = get("/health")
    print(f"\nfinal: {health['rows']} rows in {len(health['files'])} "
          f"partition(s); {health['requests']} requests, "
          f"{health['ingested']} batches ingested")
    top = get("/collect?verb=activity_counts")
    counts = top["result"]
    acts = tables["concept:name"]
    order = np.argsort(counts)[::-1][:5]
    print("top activities:",
          ", ".join(f"{acts[i]}={int(counts[i])}" for i in order))
    httpd.shutdown()
    ingestor.stop()


if __name__ == "__main__":
    main()
