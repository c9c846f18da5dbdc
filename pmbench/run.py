"""Run one cell of ``BENCHMARK.json`` once on the card.

    python -m pmbench.run --workload L5-widgets --seed 7 --seconds 20 --trace 0

from the root of a checkout (the program is ``src/repro_torch``).  The last
line of standard output is the run's JSON result; the last lines of
standard error give each number the check compared beside its limit.  A
run refuses to start without the cards its cell asks for: it never falls
back to the CPU.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"pmbench: no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from pmbench import harness

    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pmbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    t_process = harness.process_start()
    if t_process is None or not 0 <= T_IMPORT - t_process < 60:
        t_process = T_IMPORT
    res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_process)
    for line in res.stderr:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
