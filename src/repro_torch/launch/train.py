"""End-to-end training entry point: EventFrame data pipeline -> packed batches ->
train step (flash-attention forward and backward kernels on a card) ->
checkpoint manager -> failure / straggler handling.

  PYTHONPATH=src python -m repro_torch.launch.train --arch eventlm-100m \\
      --steps 300 --batch 8 --seq 128 --reduced [--device cpu]

The flags and printed lines are the JAX package's ``repro.launch.train``;
``--device`` (default ``cuda``) names where the model trains.  Every
family without a frontend trains (dense, moe, hybrid, ssm); the audio and
vlm families raise a ``ValueError`` naming the frontend they need, which
the launcher does not make (nor does the JAX package's).  Weights
come from a ``torch.Generator`` seeded with ``--seed`` (the JAX package's
distribution, not its bits).  Checkpoints are in the JAX package's format,
so either package resumes the other's (``--resume``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.eventframe import ACTIVITY
from repro_torch.data import pipeline, synthetic, tokenizer
from repro_torch.models import model as Mdl
from repro_torch.models.module import Initializer
from repro_torch.train import trainstep as TS
from repro_torch.train.checkpoint import CheckpointManager, load_train_state
from repro_torch.train.ft import FailureInjector, StragglerMonitor
from repro_torch.train.optimizer import OptConfig


def make_data(cfg, batch, seq, num_cases=20000, seed=0, host_id=0, num_hosts=1):
    """A prefetched endless iterator of packed ``Batch`` es (host numpy) over
    the tokenized synthetic log, and its tokenizer; built on the host."""
    frame, tables = synthetic.generate(num_cases=num_cases,
                                       num_activities=min(cfg.vocab_size - 8, 64),
                                       seed=seed, device="cpu")
    tok = tokenizer.ActivityTokenizer(tables[ACTIVITY])
    stream = pipeline.frame_to_token_stream(frame, tok, host_id, num_hosts)

    def epochs():
        while True:
            yield from pipeline.batches(stream, batch, seq)

    return pipeline.Prefetcher(epochs()), tok


def opt_config(steps: int) -> OptConfig:
    """The launcher's optimizer settings for a run of ``steps``."""
    return OptConfig(total_steps=max(steps, 10), warmup_steps=max(steps // 20, 5))


def to_device(batch, device) -> dict:
    """A host ``Batch`` as the train step's dict of tensors on ``device``."""
    return {"tokens": torch.as_tensor(batch.tokens, device=device),
            "targets": torch.as_tensor(batch.targets, device=device),
            "loss_mask": torch.as_tensor(batch.loss_mask, device=device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="eventlm-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.family in Mdl.FRONTENDS:
        raise ValueError(f"--arch {args.arch}: the {cfg.family} family needs a frontend "
                         f"({Mdl.FRONTENDS[cfg.family]}), which this launcher does not make; "
                         f"put one in the batch as train.trainstep's \"frontend\"")
    device = torch.device(args.device)
    oc = opt_config(args.steps)

    model = Mdl.init_params(cfg, Initializer(
        torch.Generator(device=device).manual_seed(args.seed), cfg.param_dtype))
    state = TS.init_state(cfg, model)
    step_fn = TS.make_train_step(cfg, oc, args.microbatches)

    mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume:
        got, tree = mgr.restore_latest()
        if got is not None:
            start, state = got, load_train_state(cfg, tree, device)
            print(f"[train] resumed from step {start}")

    data, tok = make_data(cfg, args.batch, args.seq, seed=args.seed)
    injector = FailureInjector(set(args.fail_at))
    monitor = StragglerMonitor()
    losses = []
    t_start = time.time()
    for step in range(start, args.steps):
        batch = next(data)
        t0 = time.time()
        injector.check(step)
        state, metrics = step_fn(state, to_device(batch, device))
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        if monitor.observe(dt):
            print(f"[train] straggler step {step}: {dt:.2f}s vs ewma {monitor.ewma:.2f}s")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state)
        if step % args.log_every == 0 or step == args.steps - 1:
            tput = args.batch * args.seq / dt
            print(f"[train] step {step} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} {tput:.0f} tok/s", flush=True)
    if mgr:
        mgr.save(args.steps, state)
        mgr.wait()
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"({time.time()-t_start:.1f}s)")
    return losses


if __name__ == "__main__":
    main()
