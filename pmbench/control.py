"""The readings the check's limits are set from, on the card.

    python -m pmbench.control --workload L5-panel --seeds 11 12 13 ... \
        --control 3 --seconds 3

For each seed, in one process: the cell's log, a short window of the
program at the cell's own load, and the numbers the check compares for
the program's sampled answers (the lower readings).  For the first
``--control`` seeds, the same sampled requests answered by the control in
the program's place -- the plain reference in bfloat16, the precision
below the configuration's float32 -- and its numbers (the upper
readings).  One JSON line a seed.  The benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_answers(cols: dict, cfg: dict, req) -> dict:
    """The control in the program's place: the reference in bfloat16."""
    from pmbench import harness
    from pmbench.reference import Log, host

    view = Log(cols, cfg["num_activities"]).view(req.kind, req.params,
                                                 lower=True)
    return {v: {k: host(x) for k, x in harness.verb(v).reference(view).items()}
            for v in req.verbs}


def readings(root: Path, workload: str, seeds, n_control: int,
             seconds: float, device: str):
    """Yield ``{"seed", "program", "control"}`` for each seed."""
    import torch

    from pmbench import harness, traffic

    _, _, cfg, mix = harness.load_cell(root, workload)
    dev = torch.device(device)
    for i, seed in enumerate(seeds):
        with harness.log_dir(cfg) as directory:
            cols, ds = harness.prepare(cfg, mix, seed, dev, None, directory)
            sampler = harness.Sampler(mix["sample_per_stratum"], seed)
            win = harness.run_window(ds, traffic.requests(mix, cfg, seed),
                                     seconds, sampler)
            del ds
        cols = harness.on_device(cols, dev)
        sampled = sampler.items()
        items = [(r, None if a is None else harness.program_answers(r, a))
                 for r, a in sampled]
        out = {"seed": seed, "requests": len(win.latencies),
               "failed": win.failed,
               "program": harness.check(cols, cfg, items)}
        if i < n_control:
            ctl = [(r, control_answers(cols, cfg, r))
                   for r, _ in sampled]
            out["control"] = harness.check(cols, cfg, ctl)
        del cols, items, sampled
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("pmbench.control: no CUDA card", file=sys.stderr)
        return 3
    for out in readings(ROOT, args.workload, args.seeds, args.control,
                        args.seconds, "cuda"):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
