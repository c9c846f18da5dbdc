"""Expert-parallel MoE over the port's single-controller mesh.

The JAX package's ``moe_apply_ep`` runs ``shard_map`` over a ``model``
axis: tokens are replicated over it, each model shard owns ``E / n``
experts, routes every token, builds a local (E_loc, C, D) dispatch buffer
with no collective, runs its experts, and one ``psum`` of the (T, D)
partial combines over the shards.  Here the mesh is a
``distributed.mesh.Mesh`` handed in by the caller (one device per shard,
every shard on ``cuda:0`` on one card), each shard's body runs on its
device in shard order, and ``mesh.psum`` sums the partials in shard
order.

The JAX package also FSDP-shards the expert weights on D over a data axis
and all-gathers them inside the body; a 1-D mesh of whole-expert shards
has no data axis, so that gather has no counterpart here: each shard
reads its experts' full weights.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import mesh as mesh_lib

from . import layers as L
from .config import ModelConfig


def _local_moe(xt, router, gate, up, down, *, cfg: ModelConfig, shard: int,
               num_shards: int):
    """One shard's partial (T, D): its experts' share of every token's
    combine.  ``gate`` / ``up`` / ``down`` are the shard's (E_loc, ., .)
    experts; ``xt`` every token."""
    dt = L.torch_dtype(cfg.compute_dtype)
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    e_loc = E // num_shards
    t_loc, D = xt.shape
    gates, idx = L.route(xt, router, cfg)
    cap = L.capacity(cfg, t_loc)
    flat_e = idx.reshape(-1)
    rel = flat_e - shard * e_loc                               # local expert id
    mine = (rel >= 0) & (rel < e_loc)
    rel_c = rel.clamp(0, e_loc - 1)
    slot, keep = L.dispatch_slots(rel_c, e_loc, cap, mine)
    gathered = L.run_experts(xt, rel_c, slot, keep, cap, gate, up, down, dt)
    w = gates.reshape(-1)[:, None].to(dt)
    return (gathered * w).reshape(t_loc, K, D).sum(dim=1)


def moe_apply_ep(p, x, cfg: ModelConfig, mesh: mesh_lib.Mesh | None):
    """Expert-parallel MoE over ``mesh``: shard i owns experts
    [i E / n, (i + 1) E / n).  With no mesh, or a shard count that does not
    divide ``num_experts``, the dense path runs, as in the JAX package.
    The result lies on ``x``'s device."""
    if mesh is None or cfg.num_experts % mesh.size != 0:
        return L.moe_apply_dense(p, x, cfg)
    n = mesh.size
    b, s, D = x.shape
    e_loc = cfg.num_experts // n
    xt = x.reshape(b * s, D).to(L.torch_dtype(cfg.compute_dtype))
    partials = []
    for i, dev in enumerate(mesh.devices):
        experts = slice(i * e_loc, (i + 1) * e_loc)
        partials.append(_local_moe(
            xt.to(dev), p["router"].to(dev), p["gate"][experts].to(dev),
            p["up"][experts].to(dev), p["down"][experts].to(dev),
            cfg=cfg, shard=i, num_shards=n))
    return mesh_lib.psum(partials)[0].to(x.device).reshape(b, s, D)
