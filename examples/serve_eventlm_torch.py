"""Serve an event LM on the PyTorch / CUDA port: batched prefill + KV-cache
decode.

Trains a small model briefly on synthetic process logs, then serves batched
"what happens next?" queries: greedy continuations of running cases.

  PYTHONPATH=src python examples/serve_eventlm_torch.py [--device cpu]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.eventframe import ACTIVITY
from repro_torch.data import pipeline, synthetic, tokenizer
from repro_torch.launch import train as T
from repro_torch.models import model as Mdl
from repro_torch.models.module import Initializer
from repro_torch.serve.engine import Engine
from repro_torch.train import trainstep as TS
from repro_torch.train.optimizer import OptConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    cfg = reduced_config(get_config("eventlm-100m")).with_overrides(vocab_size=128)
    frame, tables = synthetic.generate(num_cases=30_000, num_activities=20, seed=1,
                                       device="cpu")
    tok = tokenizer.ActivityTokenizer(tables[ACTIVITY])

    # short training run so predictions beat chance
    model = Mdl.init_params(cfg, Initializer(torch.Generator(device=device).manual_seed(0)))
    state = TS.init_state(cfg, model)
    step = TS.make_train_step(cfg, OptConfig(total_steps=150), 1)
    stream = pipeline.frame_to_token_stream(frame, tok)
    it = pipeline.batches(stream, 8, 128)
    for i in range(150):
        state, m = step(state, T.to_device(next(it), device))
        if i % 50 == 0:
            print(f"[serve-example] warmup train step {i} loss {float(m['loss']):.3f}")

    engine = Engine(cfg, state["params"], max_len=64, device=device)
    # batched requests: prefixes of real cases
    prompts = np.stack([stream[i * 40:i * 40 + 12] for i in range(8)])
    t0 = time.time()
    out = engine.generate(prompts, steps=8)
    dt = time.time() - t0
    print(f"[serve-example] 8 requests x 8 tokens in {dt:.2f}s "
          f"({8 * 8 / dt:.1f} tok/s incl. prefill)")
    for r in range(3):
        ctx = " ".join(tok.decode(prompts[r])[-4:])
        cont = " ".join(tok.decode(out.tokens[r]))
        print(f"  case {r}: ...{ctx}  =>  {cont}")


if __name__ == "__main__":
    main()
