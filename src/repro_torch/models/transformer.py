"""Dense transformer blocks, one ``nn.Module`` per layer.

The JAX package scans over stacked layers and selects each layer's window
and RoPE theta inside the scan from a traced ``kind``; the port loops over
its layers in Python and knows each layer's kind statically
(``cfg.layer_kinds()``), so the window reaches attention as a Python
``int | None``.  The MoE, hybrid and xLSTM blocks arrive with their
families.
"""
from __future__ import annotations

from torch import nn

from . import layers as L
from .config import ModelConfig
from .module import Creator, parameter


class Block(nn.Module):
    """rmsnorm -> GQA attention -> residual -> rmsnorm -> SwiGLU -> residual."""

    def __init__(self, c: Creator, cfg: ModelConfig):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError("MoE blocks are not ported yet")
        self.ln1 = parameter(c("ln1", (cfg.d_model,), (None,), scale="zeros"))
        self.attn = nn.ParameterDict(
            {k: parameter(t) for k, t in L.attn_init(c, cfg).items()})
        self.ln2 = parameter(c("ln2", (cfg.d_model,), (None,), scale="zeros"))
        self.mlp = nn.ParameterDict(
            {k: parameter(t) for k, t in L.mlp_init(c, cfg).items()})


def layer_window_theta(cfg: ModelConfig, kind: int):
    """(window, rope theta) of a layer of ``kind`` (0 global, 1 local)."""
    if kind == 1:
        return cfg.local_window or cfg.window or None, cfg.rope_theta
    return cfg.window or None, cfg.global_rope_theta or cfg.rope_theta


def block_apply(p: Block, h, cfg: ModelConfig, *, kind: int, positions,
                kv_len=None, causal=True, collect=False):
    window, theta = layer_window_theta(cfg, kind)
    a = L.attn_apply(p.attn, L.rmsnorm(h, p.ln1), cfg, positions=positions,
                     theta=theta, causal=causal, window=window, kv_len=kv_len,
                     collect=collect)
    if collect:
        a, kv = a
    h = h + a
    h = h + L.mlp_apply(p.mlp, L.rmsnorm(h, p.ln2), cfg.compute_dtype)
    return (h, kv) if collect else h


def block_decode(p: Block, h, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                 kind: int):
    """One decode step of one block; writes K / V at ``pos`` in place."""
    window, theta = layer_window_theta(cfg, kind)
    a = L.attn_decode_apply(p.attn, L.rmsnorm(h, p.ln1), cfg, cache_k, cache_v,
                            pos, theta=theta, window=window)
    h = h + a
    return h + L.mlp_apply(p.mlp, L.rmsnorm(h, p.ln2), cfg.compute_dtype)
