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
``1 / n``, as JAX does.  The step is three parts, each its own function so
the launch tooling's dry run can trace one microbatch and weight it by the
count: ``grad_step`` (one microbatch's loss backpropagated into ``.grad``),
``microbatches`` (the split) and ``finish_step`` (the scaling and AdamW).

``state_specs`` / ``abstract_state`` are the state's sharding and its
abstract form (``meta`` tensors: the parameters in ``cfg.param_dtype``,
``m`` / ``v`` float32, ``step`` a 0-d int32), the JAX package's twins with
the parameters keyed like ``Model.state_dict()``.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as Mdl
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import P, ShardingRules
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


def grad_step(cfg: ModelConfig, model: Mdl.Model, batch) -> torch.Tensor:
    """``loss_fn`` of one (micro)batch backpropagated: its gradients summed
    onto each parameter's ``.grad`` (set where it was None).  Returns the
    loss, detached."""
    loss = loss_fn(cfg, model, batch)
    loss.backward()
    return loss.detach()


def microbatches(batch, num_microbatches: int) -> list[dict]:
    """The batch split along its leading dimension into ``num_microbatches``
    consecutive microbatches (views), as JAX's reshape to (n, -1, ...)."""
    mbs = {k: v.reshape(num_microbatches, -1, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in mbs.items()} for i in range(num_microbatches)]


def finish_step(oc: OptConfig, state, loss, num_microbatches: int = 1):
    """The summed loss and ``.grad`` scaled by ``1 / n`` (n > 1), the AdamW
    update in place, the gradients cleared.  Returns (state, metrics)."""
    model = state["params"]
    params = dict(model.named_parameters())
    if num_microbatches > 1:
        inv = 1.0 / num_microbatches
        loss = loss * inv
        for p in params.values():
            p.grad.mul_(inv)
    grads = {k: p.grad for k, p in params.items()}
    _, opt, om = adamw_update(oc, params, grads, state["opt"])
    for p in params.values():
        p.grad = None
    return {"params": model, "opt": opt}, {"loss": loss, **om}


def make_train_step(cfg: ModelConfig, oc: OptConfig, num_microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``{"loss", "lr", "grad_norm"}`` are 0-d float32 tensors on the device."""

    def train_step(state, batch):
        for p in state["params"].parameters():
            p.grad = None
        if num_microbatches == 1:
            loss = grad_step(cfg, state["params"], batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for mb in microbatches(batch, num_microbatches):
                loss = loss + grad_step(cfg, state["params"], mb)
        return finish_step(oc, state, loss, num_microbatches)

    return train_step


def init_state(cfg: ModelConfig, model: Mdl.Model) -> dict:
    return {"params": model, "opt": init_opt_state(dict(model.named_parameters()))}


def state_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    """The train state's ``PartitionSpec``s: the parameters' (keyed like
    ``Model.state_dict()``) for them and for ``m`` / ``v``, ``step``
    replicated."""
    pspecs = Mdl.param_specs(cfg, rules)
    return {"params": pspecs, "opt": {"m": pspecs, "v": dict(pspecs), "step": P()}}


def abstract_state(cfg: ModelConfig, device="meta") -> dict:
    """The train state with no storage: ``Mdl.abstract_params`` and AdamW's
    ``m`` / ``v`` as float32 ``meta`` tensors of the same shapes, ``step``
    a 0-d int32."""
    model = Mdl.abstract_params(cfg, device)

    def like():
        return {k: torch.empty(p.shape, dtype=torch.float32, device=p.device)
                for k, p in model.named_parameters()}

    return {"params": model,
            "opt": {"m": like(), "v": like(),
                    "step": torch.empty((), dtype=torch.int32, device=device)}}
