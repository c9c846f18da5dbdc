"""Train step builder: loss, microbatched gradient accumulation, AdamW update.

The JAX package's ``train/trainstep.py`` on a ``Model``.  The state is
``{"params": Model, "opt": {"m", "v", "step"}}`` (``optimizer.init_opt_state``
of its named parameters); a batch is ``{"tokens", "targets", "loss_mask"}``,
and ``"frontend"`` for the audio and vlm families, of tensors on the
model's device with the global batch as the leading dimension (each is
split along it into the microbatches).  Gradients come from autograd through ``Mdl.forward`` (on a
card each layer's attention is the flash-attention kernel and its backward
kernel), and the update is ``optimizer.adamw_update`` in place, so
``train_step`` returns the state it was given with ``step`` advanced.

Microbatches run as a Python loop in place of JAX's ``lax.scan``: each
one's loss is backpropagated, autograd sums the gradients into ``.grad``
in microbatch order, and then the summed loss and gradients are scaled by
``1 / n``, as JAX does.  ``state_specs`` / ``abstract_state`` are sharding
tooling and arrive with the launch tooling.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as Mdl
from repro_torch.models.config import ModelConfig
from .optimizer import OptConfig, adamw_update, init_opt_state


def loss_fn(cfg: ModelConfig, model: Mdl.Model, batch) -> torch.Tensor:
    """Mean next-token negative log-likelihood over the masked positions.
    ``batch["frontend"]`` (audio frames, vlm patch embeddings) reaches
    ``forward``; the vlm family's patch positions carry no loss."""
    logits = Mdl.forward(cfg, model, batch["tokens"], frontend=batch.get("frontend"))
    if cfg.family == "vlm":                 # drop the vision prefix's positions
        logits = logits[:, cfg.num_patches:]
    logits = logits.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["targets"].long()[..., None])[..., 0]
    mask = batch["loss_mask"].to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(cfg: ModelConfig, oc: OptConfig, num_microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``{"loss", "lr", "grad_norm"}`` are 0-d float32 tensors on the device."""

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if num_microbatches == 1:
            loss = loss_fn(cfg, model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            mbs = {k: v.reshape(num_microbatches, -1, *v.shape[1:]) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(num_microbatches):
                mb_loss = loss_fn(cfg, model, {k: v[i] for k, v in mbs.items()})
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            inv = 1.0 / num_microbatches
            loss = loss * inv
            for p in params.values():
                p.grad.mul_(inv)
        grads = {k: p.grad for k, p in params.items()}
        _, opt, om = adamw_update(oc, params, grads, state["opt"])
        for p in params.values():
            p.grad = None
        return {"params": model, "opt": opt}, {"loss": loss, **om}

    return train_step


def init_state(cfg: ModelConfig, model: Mdl.Model) -> dict:
    return {"params": model, "opt": init_opt_state(dict(model.named_parameters()))}
