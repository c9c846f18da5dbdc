"""The single-controller mesh: the port's stand-in for ``shard_map``.

The JAX package's mesh is ``jax.devices()[:num_shards]`` of one process,
and ``shard_map`` is one controller driving every shard.  Here a
:class:`Mesh` is an explicit list of ``torch.device`` s, one per shard,
and each collective below is a plain tensor operation over a list of
per-shard values (tensors, or dicts / tuples / dataclasses of them, as
``core.engine.tree_sum`` walks them).  Shard order is the list order,
everywhere.  A collective reads each shard's device off its value and
moves values between devices with ``.to(device)`` only, so the same code
drives one card (every shard on ``cuda:0``, as JAX's virtual devices share
one host), several cards, or the CPU; a shard on a card never passes
through the host.  No process group, no ``torch.distributed``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import map_tensors, tensor_leaves, tree_sum


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per shard, in shard order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def mesh_for(num_shards: int, device="cuda") -> Mesh:
    """``num_shards`` shards placed round-robin over ``device``'s kind:
    shard *i* on ``cuda:((base + i) % device_count)`` (``base`` the index
    ``device`` names, else 0), or every shard on the CPU.  Unlike the JAX
    package, which silently keeps ``devices[:num_shards]``, more shards
    than devices share devices."""
    n = int(num_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    dev = torch.device(device)
    if dev.type != "cuda":
        return Mesh((dev,) * n)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA mesh needs a visible CUDA device; open the "
                           "dataset with device='cpu' to shard on the host")
    base = dev.index or 0
    return Mesh(tuple(torch.device("cuda", (base + i) % count)
                      for i in range(n)))


def _to(tree, device):
    return map_tensors(lambda t: t.to(device), tree)


def _device(tree) -> torch.device:
    """The device a shard's value lives on (its first tensor's)."""
    return tensor_leaves(tree)[0].device


def psum(xs: list) -> list:
    """Leafwise sum of every shard's value, in shard order, one copy on each
    shard's device (integer states, so the order is moot; on one card every
    copy is the one sum)."""
    total = xs[0]
    for x in xs[1:]:
        total = tree_sum(total, _to(x, _device(total)))
    return [_to(total, _device(x)) for x in xs]


def shift_tails(xs: list, depth: int) -> list:
    """The ``ppermute`` halo: shard *i* gets shard *i-1*'s last ``depth``
    rows, copied to shard *i*'s device; shard 0 gets ``None``."""
    return [None] + [map_tensors(lambda t, d=_device(nxt): t[-depth:].to(d), x)
                     for x, nxt in zip(xs[:-1], xs[1:])]


def all_gather(xs: list) -> list:
    """Every shard's value stacked in shard order, on each shard's device."""
    return [torch.stack([x.to(mine.device) for x in xs]) for mine in xs]


def all_to_all(bufs: list) -> list:
    """Row *j* of shard *i*'s ``(n, cap)`` buffer goes to row *i* of shard
    *j*."""
    n = len(bufs)
    return [torch.stack([bufs[i][j].to(bufs[j].device) for i in range(n)])
            for j in range(n)]


def pmax(xs: list) -> list:
    """The largest shard value, on each shard's device."""
    top = torch.stack([x.to(xs[0].device) for x in xs]).max(0).values
    return [top.to(x.device) for x in xs]
