"""Parameter creation: one structural definition, several readings.

Model code builds every parameter through a ``Creator`` call
``c(name, shape, axes, dtype, scale)``, as in the JAX package, where the
logical ``axes`` name what each dimension is for sharding rules:

* ``"embed"``  -- the residual / d_model dim (FSDP over the data axis);
* ``"vocab"``  -- the vocabulary dim (tensor parallel);
* ``"heads"``  -- the flattened heads x head_dim dim (tensor parallel);
* ``"mlp"``    -- the feed-forward hidden dim (tensor parallel);
* ``"expert"`` -- the MoE expert dim (expert parallel);
* ``"layers"`` -- a stacked-layer dim (never sharded);
* ``None``     -- replicated.

``ShardingRules`` maps logical axes to mesh axes and ``PartitionSpec``
(``P``) holds the result, one entry a tensor dim: a mesh-axis name, a tuple
of names or ``None``, compared entry by entry as JAX's ``PartitionSpec``.
The port's creators:

* ``Initializer`` -- truncated-normal fan-in init (the JAX package's
  distribution: a standard normal cut at +-2, times ``fan_in ** -0.5`` or
  the given scale; ``"zeros"`` / ``"ones"`` constant) drawn from one
  ``torch.Generator``, on its device.  It gives the same distribution, not
  JAX's bits.
* ``Empty`` -- uninitialized tensors, for a model whose values are loaded
  next (``load_state_dict``).
* ``AbstractCreator`` -- tensors with no storage (``device="meta"``) in the
  requested dtype, each carrying its ``logical_axes``, which ``parameter``
  keeps; the launch tooling's dry run reads shapes, dtypes and axes off
  such a model (``models.model.abstract_params``).
* ``SpecCreator`` -- the ``PartitionSpec`` of a parameter from its logical
  axes under ``ShardingRules`` (``models.model.param_specs``).

The JAX package stacks each family's layers on a leading ``"layers"`` axis
(``stack_init``) and casts whole pytrees (``cast_leaves``); the port holds
one module per layer in ``nn.ModuleList``s and casts at each product, so
neither has a role here.  The one place that puts the ``"layers"`` axis
back is ``models.convert.params_to_jax``, which stacks the per-layer
leaves into the JAX layout (its specs gain a leading ``None``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


class PartitionSpec(tuple):
    """The sharding of a tensor, one entry a dimension: a mesh-axis name, a
    tuple of names (the dimension split over all of them, major first) or
    ``None`` (replicated); the twin of JAX's ``PartitionSpec`` as a plain
    tuple, so two specs with the same entries compare equal.  As JAX does,
    a one-name tuple is stored as the name and an empty one as ``None``."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                return None if not e else (e[0] if len(e) == 1 else tuple(e))
            return e
        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    embed: Any = "data"
    vocab: Any = "model"
    heads: Any = "model"
    mlp: Any = "model"
    expert: Any = "model"
    layers: Any = None
    seq: Any = None          # activation seq dim (SP when = "model")
    batch: Any = ("pod", "data")

    def spec(self, axes: tuple[str | None, ...]) -> PartitionSpec:
        return P(*[getattr(self, a) if a else None for a in axes])


# Baseline rule sets of the configs, as in the JAX package.
RULES_2D = ShardingRules()                                # (data, model) pod-less
RULES_EP = ShardingRules()                                # expert -> model (qwen3)
RULES_TP_FF = ShardingRules(expert=None)                  # mixtral: experts replicated, mlp TP


class Creator:
    def __call__(self, name, shape, axes=None, dtype=None, scale=None): ...


class Initializer(Creator):
    """Materializes truncated-normal parameters (fan-in scaled) on the
    device of ``generator``."""

    def __init__(self, generator: torch.Generator, dtype: str = "float32"):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype

    def __call__(self, name, shape, axes=None, dtype=None, scale=None):
        dtype = getattr(torch, dtype or self.dtype)
        if scale == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if scale == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = (1.0 / max(fan_in, 1)) ** 0.5 if scale is None else scale
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.generator)
        return (t * std).to(dtype)


class Empty(Creator):
    """Uninitialized parameters on ``device``, to be overwritten."""

    def __init__(self, dtype: str = "float32", device="cuda"):
        self.dtype = dtype
        self.device = torch.device(device)

    def __call__(self, name, shape, axes=None, dtype=None, scale=None):
        return torch.empty(shape, dtype=getattr(torch, dtype or self.dtype),
                           device=self.device)


class SpecCreator(Creator):
    """The ``PartitionSpec`` of a parameter from its logical axes."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __call__(self, name, shape, axes=None, dtype=None, scale=None):
        assert len(axes) == len(shape), (name, shape, axes)
        return self.rules.spec(axes)


class AbstractCreator(Creator):
    """Tensors with no storage on ``device`` (``"meta"``), in ``dtype``
    unless the call names one, each carrying its ``logical_axes``."""

    def __init__(self, dtype: str = "float32", device="meta"):
        self.dtype = dtype
        self.device = torch.device(device)

    def __call__(self, name, shape, axes=None, dtype=None, scale=None):
        t = torch.empty(shape, dtype=getattr(torch, dtype or self.dtype),
                        device=self.device)
        t.logical_axes = tuple(axes)
        return t


def parameter(t: torch.Tensor) -> torch.nn.Parameter:
    """A model parameter; it takes gradients (training differentiates the
    loss through the flash-attention kernel's autograd function).  Serving
    runs under ``torch.inference_mode`` (``serve.engine.Engine``), and the
    model's ``prefill`` / ``decode_step`` under ``torch.no_grad``, so they
    build no graph.  The ``logical_axes`` an ``AbstractCreator`` attached
    are kept."""
    p = torch.nn.Parameter(t, requires_grad=True)
    if hasattr(t, "logical_axes"):
        p.logical_axes = t.logical_axes
    return p
