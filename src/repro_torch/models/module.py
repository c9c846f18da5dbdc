"""Parameter creation: one structural definition, read by a creator.

Model code builds every parameter through a ``Creator`` call
``c(name, shape, axes, dtype, scale)``, as in the JAX package, where the
logical ``axes`` name what each dimension is (``"embed"``, ``"vocab"``,
``"heads"``, ``"mlp"``) for sharding rules.  The port's creators:

* ``Initializer`` -- truncated-normal fan-in init (the JAX package's
  distribution: a standard normal cut at +-2, times ``fan_in ** -0.5`` or
  the given scale; ``"zeros"`` / ``"ones"`` constant) drawn from one
  ``torch.Generator``, on its device.  It gives the same distribution, not
  JAX's bits.
* ``Empty`` -- uninitialized tensors, for a model whose values are loaded
  next (``load_state_dict``).

The sharding readings (``SpecCreator``, ``AbstractCreator``) arrive with
the distributed slice; ``axes`` is carried and not read until then.
"""
from __future__ import annotations

import torch


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


def parameter(t: torch.Tensor) -> torch.nn.Parameter:
    """A model parameter; it takes gradients (training differentiates the
    loss through the flash-attention kernel's autograd function).  Serving
    runs under ``torch.inference_mode`` (``serve.engine.Engine``), and the
    model's ``prefill`` / ``decode_step`` under ``torch.no_grad``, so they
    build no graph."""
    return torch.nn.Parameter(t, requires_grad=True)
