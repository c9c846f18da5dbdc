"""AdamW + cosine schedule + global-norm clipping on dicts of tensors.

The JAX package's ``train/optimizer.py`` on mappings keyed by the port's
parameter names (``dict(model.named_parameters())``); the optimizer state
is ``{"m": {name: tensor}, "v": {name: tensor}, "step": 0-d int32}``.
Unlike JAX's pure update, ``adamw_update`` writes ``m``, ``v`` and the
parameters in place (under ``torch.no_grad``) and returns them, so a
step holds one copy of each.

The rounding points are the JAX package's: the schedule, ``b1 ** step``
and ``b2 ** step`` are float32 tensors on the parameters' device (Python
float64 scalars would differ in the last bits), every elementwise product
and sum is a separate float32 operation in JAX's order, and
``global_norm`` adds its per-tensor sums of squares in JAX's leaf order
(the sorted ``keystr`` paths, a per-layer leaf's layers in order) without
stacking a copy of the gradients; the order within a sum is the device's.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32: linear
    warm-up, then a cosine down to ``min_lr_ratio``."""
    step = step.to(torch.float32)
    warm = step / max(oc.warmup_steps, 1)
    prog = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)


def init_opt_state(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero moments shaped like the parameters, ``step`` 0 on their device."""
    device = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


_LAYER = re.compile(r"^layers\.(\d+)\.")


def jax_leaves(names) -> list[list[str]]:
    """The port's parameter names grouped into the JAX package's leaves, in
    JAX's leaf order: ``layers.{i}.x.y`` of every layer form the one leaf
    ``['layers']['x']['y']`` (layers in order), the leaves sorted by their
    path of dict keys, as ``jax.tree.leaves`` walks a dict."""
    groups: dict[tuple, list[tuple[int, str]]] = {}
    for name in names:
        m = _LAYER.match(name)
        if m:
            key = ("layers", *name[m.end():].split("."))
            groups.setdefault(key, []).append((int(m.group(1)), name))
        else:
            groups.setdefault(tuple(name.split(".")), []).append((0, name))
    return [[n for _, n in sorted(groups[key])] for key in sorted(groups)]


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every value, float32, the tensors'
    sums added in JAX's leaf order (``jax_leaves``, a stacked leaf's layers
    in order).  No leaf is stacked: the sums within a leaf run in another
    order than JAX's, which the card's reductions do anyway."""
    total = None
    for names in jax_leaves(tree):
        for n in names:
            s = torch.sum(torch.square(tree[n].to(torch.float32)))
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(oc: OptConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], opt_state: dict):
    """One AdamW step with global-norm clipping, in place: ``params``,
    ``opt_state["m"]`` and ``opt_state["v"]`` are updated where they lie.
    Returns ``(params, opt_state, {"lr", "grad_norm"})``; ``grad_norm`` is
    the norm before clipping, and ``opt_state["step"]`` a new tensor."""
    step = opt_state["step"] + 1
    lr = schedule(oc, step)
    gnorm = global_norm(grads)
    clip = torch.tensor(oc.clip_norm, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = oc.beta1, oc.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
        u = u + oc.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
    return params, {**opt_state, "step": step}, {"lr": lr, "grad_norm": gnorm}
