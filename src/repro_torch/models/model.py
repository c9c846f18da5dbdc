"""Model API of the dense and MoE families: init / forward / prefill / decode.

``init_params`` builds a ``Model`` (an ``nn.Module`` holding the
parameters, on the creator's device, with one ``Block`` per layer); the
entry points are functions of ``(cfg, model, inputs)`` as in the JAX
package, so the same weights can run under another configuration
(``attn_impl="ref"``, another compute dtype).  Layers run in a Python
loop.  The ``moe`` family serves with the dense family's cache layout, as
the JAX package's ``("dense", "moe", "vlm")`` branches do; its experts run
on one device, or over the shards of a ``distributed.mesh.Mesh`` passed as
``mesh`` when ``cfg.moe_impl == "shard_map"``.  Other families raise
``NotImplementedError`` until their modules are ported.

``forward`` is differentiable (the parameters take gradients; each block
runs under ``cfg.remat_policy``, ``transformer.block_remat``); ``prefill``
and ``decode_step`` are serving's and run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from . import layers as L
from .config import ModelConfig
from .layers import torch_dtype
from .module import Creator, parameter
from .transformer import Block, block_apply, block_decode, block_remat


PORTED_FAMILIES = ("dense", "moe")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, creator: Creator):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet; "
                                      f"the port serves {PORTED_FAMILIES}")
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = parameter(creator("embed", (V, D), ("vocab", "embed"), scale=1.0))
        self.final_norm = parameter(creator("final_norm", (D,), (None,), scale="zeros"))
        if not cfg.tie_embeddings:
            self.head = parameter(creator("head", (D, V), ("embed", "vocab")))
        self.layers = nn.ModuleList(Block(creator, cfg) for _ in range(cfg.num_layers))


def init_params(cfg: ModelConfig, creator: Creator) -> Model:
    return Model(cfg, creator)


def _embed(cfg, params, tokens):
    dt = torch_dtype(cfg.compute_dtype)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return params.embed[tokens.long()].to(dt) * scale


def _head(cfg, params, h):
    dt = torch_dtype(cfg.compute_dtype)
    h = L.rmsnorm(h, params.final_norm)
    w = params.embed.T if cfg.tie_embeddings else params.head
    return (h.to(dt) @ w.to(dt)).to(torch_dtype(cfg.logit_dtype))


def forward(cfg: ModelConfig, params: Model, tokens, *, collect_cache: bool = False,
            mesh=None):
    """Causal-LM forward. Returns logits, or (logits, cache) for prefill."""
    h = _embed(cfg, params, tokens)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    ks, vs = [], []
    for blk, kind in zip(params.layers, cfg.layer_kinds()):
        if collect_cache:
            h, (k, v) = block_apply(blk, h, cfg, kind=kind, positions=positions,
                                    collect=True, mesh=mesh)
            ks.append(k)
            vs.append(v)
        else:
            h = block_remat(blk, h, cfg, kind=kind, positions=positions, mesh=mesh)
    logits = _head(cfg, params, h)
    if collect_cache:
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": S}
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict[str, Any]:
    """Decode state: bf16 K / V caches (L, B, max_len, KVH, hd) on ``device``
    (the card unless named) and the next position ``pos``, a Python int."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    device = torch.device("cuda" if device is None else device)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "pos": 0}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, tokens, mesh=None):
    """Process a prompt; returns (last-token logits, cache at len(prompt))."""
    logits, cache = forward(cfg, params, tokens, collect_cache=True, mesh=mesh)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Model, cache, tokens, mesh=None):
    """One token for every sequence. tokens: (B, 1). Returns (logits, cache).

    The K / V of this step are written into ``cache`` in place; the
    returned cache shares its tensors, with ``pos`` advanced by one."""
    pos = cache["pos"]
    h = _embed(cfg, params, tokens)
    for i, (blk, kind) in enumerate(zip(params.layers, cfg.layer_kinds())):
        h = block_decode(blk, h, cfg, cache["k"][i], cache["v"][i], pos, kind=kind,
                         mesh=mesh)
    logits = _head(cfg, params, h)
    return logits[:, 0], {**cache, "pos": pos + 1}
