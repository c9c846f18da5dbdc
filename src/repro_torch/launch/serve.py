"""Serving entry point: batched next-activity serving on a trained checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch eventlm-100m --reduced \
      --ckpt-dir /path/to/ckpts --requests 16 --steps 8 [--device cpu]

The flags and printed lines are the JAX package's ``repro.launch.serve``;
``--device`` (default ``cuda``) names where the model runs.  A checkpoint
directory written by the JAX package's trainer restores as it is.  The
dense, MoE, hybrid and ssm families serve (``--arch qwen3-moe-30b-a3b``,
``mixtral-8x7b``, ``zamba2-7b``, ``xlstm-1.3b``).  ``whisper-medium`` and
``internvl2-2b`` need a frontend (encoder frames / patch embeddings) that
this launcher does not make: they raise a ``ValueError`` naming it, where
the JAX package's launcher fails an ``assert``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.eventframe import ACTIVITY
from repro_torch.data import pipeline, synthetic, tokenizer
from repro_torch.models import model as Mdl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.module import Initializer
from repro_torch.serve.engine import Engine
from repro_torch.train.checkpoint import CheckpointManager


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="eventlm-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.family in Mdl.FRONTENDS:
        raise ValueError(f"--arch {args.arch}: the {cfg.family} family needs a frontend "
                         f"({Mdl.FRONTENDS[cfg.family]}), which this launcher does not make; "
                         f"pass one to serve.engine.Engine.generate(..., frontend=)")
    device = torch.device(args.device)
    model = Mdl.init_params(cfg, Initializer(
        torch.Generator(device=device).manual_seed(args.seed), cfg.param_dtype))
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        step, state = mgr.restore_latest()
        if step is not None:
            model.load_state_dict(params_from_jax(state["params"]))
            print(f"[serve] restored step {step} from {args.ckpt_dir}")

    frame, tables = synthetic.generate(num_cases=2_000,
                                       num_activities=min(cfg.vocab_size - 8, 32),
                                       seed=args.seed, device=device)
    tok = tokenizer.ActivityTokenizer(tables[ACTIVITY])
    stream = pipeline.frame_to_token_stream(frame, tok)
    prompts = np.stack([stream[i * 37:i * 37 + args.prompt_len]
                        for i in range(args.requests)])

    engine = Engine(cfg, model, max_len=args.max_len, device=device)
    t0 = time.time()
    out = engine.generate(prompts, steps=args.steps)
    dt = time.time() - t0
    total = args.requests * args.steps
    print(f"[serve] {args.requests} requests x {args.steps} tokens "
          f"in {dt:.2f}s = {total/dt:.1f} tok/s (incl. prefill + compile)")
    for r in range(min(3, args.requests)):
        print(f"  req {r}: ...{' '.join(tok.decode(prompts[r])[-3:])} => "
              f"{' '.join(tok.decode(out.tokens[r]))}")
    return out


if __name__ == "__main__":
    main()
