"""End-to-end example on the PyTorch / CUDA port: train EventLM on
next-activity prediction.

The EventFrame pipeline feeds packed case sequences into the LM; training
runs with checkpointing, auto-resume and failure injection, through
``repro_torch.launch.train`` (on a card each layer's attention is the
flash-attention forward kernel and its backward kernel).

  # quick (reduced ~1M params):
  PYTHONPATH=src python examples/train_eventlm_torch.py [--device cpu]
  # full 100M-param run, a few hundred steps:
  PYTHONPATH=src python examples/train_eventlm_torch.py --full --steps 300
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

from repro_torch.launch import train as T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full eventlm-100m config instead of the reduced one")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step to demo restart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    ckpt = tempfile.mkdtemp(prefix="eventlm_ckpt_")
    argv = ["--arch", "eventlm-100m", "--steps", str(args.steps),
            "--batch", "8", "--seq", "128", "--ckpt-dir", ckpt,
            "--ckpt-every", "25", "--device", args.device]
    if not args.full:
        argv.append("--reduced")

    if args.fail_at is not None:
        # the first run dies at --fail-at; the second resumes from the
        # latest checkpoint, the multi-pod restart story on one host
        try:
            T.main(argv + ["--fail-at", str(args.fail_at)])
        except RuntimeError as e:
            print(f"[example] {e} -> restarting from checkpoint")
        T.main(argv + ["--resume"])
    else:
        T.main(argv)
    print(f"[example] checkpoints kept in {ckpt}")


if __name__ == "__main__":
    main()
