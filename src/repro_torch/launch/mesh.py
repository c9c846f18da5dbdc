"""Production mesh and sharding-rule resolution for the launch tooling.

``make_rules`` and ``sanitize_spec`` / ``sanitize_specs`` are the JAX
package's logic on the port's ``PartitionSpec``: any object with ``.shape``
(a dict of axis sizes) and ``.axis_names`` is a mesh.

``make_production_mesh`` is the H100 layout: ``(data, model) = (32, 8)``
over 256 GPUs, or ``(pod, data, model) = (2, 32, 8)`` over 512.  The model
axis is one HGX H100 board's eight GPUs, joined by NVLink, so every
tensor-parallel collective stays on NVLink and only the data and pod axes
cross the InfiniBand links (JAX's 16 x 16 torus would put half of every
model-axis group off the board).  The mesh is a ``DeviceMesh`` over a
fake process group (``fake_world``), which runs no communication, its
device type ``"cpu"``: a placeholder, as the tensors on it are ``meta``
shards, and no card is touched.  It exists only inside the dry run, from
``fake_world`` to its end, and nothing here creates one at import.  The
mining, serving and training paths never use ``torch.distributed``;
``distributed/mesh.py`` is their mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping

from repro_torch.models.config import ModelConfig
from repro_torch.models.module import P, PartitionSpec, ShardingRules

SINGLE_POD = {"data": 32, "model": 8}
MULTI_POD = {"pod": 2, "data": 32, "model": 8}


def mesh_name(shape: Mapping[str, int]) -> str:
    return "x".join(str(n) for n in shape.values())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes by name (``shape``), their order (``axis_names``) and the
    ``DeviceMesh`` over the fake process group, when one was made."""
    shape: dict
    axis_names: tuple
    device_mesh: Any = None


@contextlib.contextmanager
def fake_world(size: int):
    """A process group of ``size`` ranks of which this process is rank 0,
    on the ``fake`` backend: collectives return at once and move nothing.
    Torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Mapping[str, int], device_type: str = "cpu") -> Mesh:
    """A ``DeviceMesh`` of ``shape`` over the initialized (fake) group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = dict(shape)
    dm = init_device_mesh(device_type, tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    return Mesh(shape, tuple(shape), dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(32, 8) data x model, or (2, 32, 8) pod x data x model; inside
    ``fake_world(256)`` / ``fake_world(512)``."""
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD)


def make_rules(mesh, cfg: ModelConfig, *, seq_parallel: bool = False) -> ShardingRules:
    """Resolve logical-axis -> mesh-axis rules for this (mesh, arch).

    MoE: experts shard on "model" only when the expert count divides it
    (on the 8-wide model axis both qwen3's 128 and mixtral's 8); otherwise
    the experts stay replicated and the expert FFN is TP-sharded on d_ff.
    """
    batch = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    model_size = mesh.shape["model"]
    expert = "model"
    mlp = "model"
    if cfg.num_experts:
        if cfg.num_experts % model_size == 0:
            mlp = None      # EP: experts own the model axis; expert FFN local
        else:
            expert = None   # too few experts: replicate them, TP d_ff
    return ShardingRules(
        embed="data", vocab="model", heads="model", mlp=mlp,
        expert=expert, layers=None,
        seq="model" if seq_parallel else None, batch=batch)


def sanitize_spec(shape: tuple, spec, mesh) -> PartitionSpec:
    """Drop sharding on dims the mesh cannot divide evenly (vocab 51865,
    batch 1, ...).  For tuple entries keep the largest divisible prefix.
    Production frameworks pad instead; for the dry run's accounting
    dropping is equivalent and keeps the numbers honest."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for n in names:
            if dim % (prod * mesh.shape[n]) == 0:
                kept.append(n)
                prod *= mesh.shape[n]
            else:
                break
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def sanitize_specs(abstract, specs, mesh):
    """``sanitize_spec`` over matching trees: nested mappings of tensors (or
    anything with ``.shape``; a ``Model`` reads as its named parameters) and
    of specs; a non-tensor leaf (the cache's ``pos``) keeps its spec."""
    if hasattr(abstract, "named_parameters"):
        abstract = dict(abstract.named_parameters())
    if isinstance(specs, PartitionSpec):
        return sanitize_spec(tuple(abstract.shape), specs, mesh) \
            if hasattr(abstract, "shape") else specs
    return {k: sanitize_specs(abstract[k], s, mesh) for k, s in specs.items()}


def batch_rules(rules: ShardingRules, mesh, global_batch: int) -> ShardingRules:
    """Shrink the activation batch axes to what the batch size divides."""
    names = rules.batch if isinstance(rules.batch, tuple) else (rules.batch,)
    kept, prod = [], 1
    for n in names:
        if n and global_batch % (prod * mesh.shape[n]) == 0:
            kept.append(n)
            prod *= mesh.shape[n]
        else:
            break
    return dataclasses.replace(rules, batch=tuple(kept) if kept else None)


def local_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of one device's shard of a tensor of ``shape`` under a
    sanitized ``spec``."""
    out = list(shape)
    for i, entry in enumerate(tuple(spec)):
        for n in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[i] //= mesh.shape[n]
    return tuple(out)


def placements(spec, mesh) -> list:
    """DTensor placements of a sanitized ``spec``: one per mesh axis,
    ``Shard(d)`` for the tensor dim ``d`` the axis splits, else
    ``Replicate()`` (an axis of size 1 splits nothing).  A dim split over
    several axes is split major axis first, as JAX's tuple entries are."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.axis_names:
        dim = next((d for d, e in enumerate(tuple(spec))
                    if e == name or (isinstance(e, tuple) and name in e)), None)
        if mesh.shape[name] == 1:
            dim = None
        out.append(Replicate() if dim is None else Shard(dim))
    return out
