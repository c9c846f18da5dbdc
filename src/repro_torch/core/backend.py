"""Lowering selection for the segmented primitives (``kernels.segment_ops``).

Each primitive on this port's path has two lowerings:

* ``"cuda"`` — the hand-written CUDA kernel for Hopper
  (``kernels/csrc/*.cu``), launched on a CUDA tensor;
* ``"ref"``  — the plain PyTorch version (flat-key ``index_add_``), the
  parity oracle.

Resolution goes by the device of the tensors a primitive is given:

1. an explicit ``impl="ref"`` (or ``"cuda"``) at a call site wins — tests
   and ``chip_smoke.py`` use ``"ref"`` to run the plain version on a card;
2. otherwise a CUDA tensor takes the kernel and a CPU tensor the plain
   version.  A ``meta`` tensor (no storage) takes the kernel's route too:
   it stands for a tensor on the card in the launch tooling's dry run
   (``launch.dryrun``), which counts the work the card runs, and there the
   kernels' custom ops give shapes through their abstract forms.

The JAX package's names are accepted too, so its call sites carry over:
``"xla"`` (its reference lowering) means ``"ref"`` and ``"pallas"`` (its
kernels) means ``"cuda"``.

There is no process-wide switch or environment variable that moves CUDA
tensors onto the plain path: on a CUDA tensor a primitive launches its
kernel or raises.
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "cuda", "ref")
# the JAX package's lowering names, mapped onto the port's
JAX_IMPLS = {"xla": "ref", "pallas": "cuda"}


def resolve(device, impl: str | None = None) -> str:
    """Concrete lowering for a primitive on ``device``: ``"cuda"`` or ``"ref"``."""
    if impl is None or impl == "auto":
        return "cuda" if torch.device(device).type in ("cuda", "meta") else "ref"
    impl = JAX_IMPLS.get(impl, impl)
    if impl not in IMPLS:
        raise ValueError(f"unknown segment-ops impl {impl!r}; expected one "
                         f"of {IMPLS} or the JAX names {tuple(JAX_IMPLS)}")
    return impl
