"""Transformer blocks of every family, one ``nn.Module`` per layer.

The JAX package scans over stacked layers and selects each layer's window
and RoPE theta inside the scan from a traced ``kind``; the port loops over
its layers in Python and knows each layer's kind statically
(``cfg.layer_kinds()``), so the window reaches attention as a Python
``int | None``.  A block of a config with ``num_experts`` holds ``moe``
(router and experts, named as the JAX package's ``block_init``) in place
of ``mlp``; ``mesh`` (a ``distributed.mesh.Mesh``) reaches the MoE for
expert parallelism (``cfg.moe_impl == "shard_map"``).  The other
families' blocks hold their parameters under the JAX package's names:
``HybridBlock`` (zamba2's Mamba2 layer), ``SharedAttn`` (its one attention
+ MLP block, shared by every group), ``XLSTMGroup`` (``slstm_every - 1``
mLSTM blocks, their norms as one ``(n_m, D)`` parameter, then one sLSTM
block) and ``DecBlock`` (Whisper's decoder: self attention, cross
attention, MLP).

``remat`` applies ``cfg.remat_policy`` to a function of tensors as the
JAX package's ``_remat`` does around a scan body, through
``torch.utils.checkpoint`` (non-reentrant) and only while grad is enabled:
``"none"`` keeps every activation; ``"full"`` keeps only the function's
inputs and recomputes it in the backward pass, so a training step launches
the flash-attention forward kernel twice an attention call (the forward
pass and the recompute) and the backward kernel once; ``"dots"`` keeps the
matrix products' outputs (``aten.mm`` / ``bmm`` / ``addmm``, JAX's
``checkpoint_dots``) and recomputes the rest, the attention kernel
included.  ``block_remat`` is a ``Block`` under it; ``models.model`` wraps
the other families' bodies at the JAX package's granularity.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from . import layers as L
from . import mamba2 as M
from . import xlstm as X
from .config import ModelConfig
from .module import Creator, parameter


def _dict(params: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: parameter(t) for k, t in params.items()})


class Block(nn.Module):
    """rmsnorm -> GQA attention -> residual -> rmsnorm -> SwiGLU or MoE ->
    residual."""

    def __init__(self, c: Creator, cfg: ModelConfig):
        super().__init__()
        self.ln1 = parameter(c("ln1", (cfg.d_model,), (None,), scale="zeros"))
        self.attn = _dict(L.attn_init(c, cfg))
        self.ln2 = parameter(c("ln2", (cfg.d_model,), (None,), scale="zeros"))
        if cfg.num_experts:
            self.moe = _dict(L.moe_init(c, cfg))
        else:
            self.mlp = _dict(L.mlp_init(c, cfg))


class HybridBlock(nn.Module):
    """rmsnorm -> Mamba2 mixer -> residual (zamba2's backbone layer)."""

    def __init__(self, c: Creator, cfg: ModelConfig):
        super().__init__()
        self.ln = parameter(c("ln", (cfg.d_model,), (None,), scale="zeros"))
        self.mamba = _dict(M.mamba2_init(c, cfg))


class SharedAttn(nn.Module):
    """zamba2's shared block: rmsnorm -> attention -> residual -> rmsnorm ->
    SwiGLU -> residual, one set of weights for every group."""

    def __init__(self, c: Creator, cfg: ModelConfig):
        super().__init__()
        self.ln1 = parameter(c("sln1", (cfg.d_model,), (None,), scale="zeros"))
        self.attn = _dict(L.attn_init(c, cfg, prefix="shared_attn"))
        self.ln2 = parameter(c("sln2", (cfg.d_model,), (None,), scale="zeros"))
        self.mlp = _dict(L.mlp_init(c, cfg))


class XLSTMGroup(nn.Module):
    """One group: ``slstm_every - 1`` mLSTM blocks, then one sLSTM block."""

    def __init__(self, c: Creator, cfg: ModelConfig):
        super().__init__()
        n_m = cfg.slstm_every - 1
        self.mlstm_ln = parameter(c("gln", (n_m, cfg.d_model), ("layers", None),
                                    scale="zeros"))
        self.mlstm = nn.ModuleList(_dict(X.mlstm_init(c, cfg)) for _ in range(n_m))
        self.slstm_ln = parameter(c("sln", (cfg.d_model,), (None,), scale="zeros"))
        self.slstm = _dict(X.slstm_init(c, cfg))


class DecBlock(nn.Module):
    """Whisper's decoder block: self attention, cross attention over the
    encoder output, SwiGLU, each behind an rmsnorm and a residual."""

    def __init__(self, c: Creator, cfg: ModelConfig):
        super().__init__()
        self.ln1 = parameter(c("ln1", (cfg.d_model,), (None,), scale="zeros"))
        self.attn = _dict(L.attn_init(c, cfg))
        self.lnx = parameter(c("lnx", (cfg.d_model,), (None,), scale="zeros"))
        self.xattn = _dict(L.attn_init(c, cfg, prefix="xattn"))
        self.ln2 = parameter(c("ln2", (cfg.d_model,), (None,), scale="zeros"))
        self.mlp = _dict(L.mlp_init(c, cfg))


def _ffn(p: Block, x, cfg: ModelConfig, mesh):
    if cfg.num_experts:
        return L.moe_apply(p.moe, x, cfg, mesh)
    return L.mlp_apply(p.mlp, x, cfg.compute_dtype)


def layer_window_theta(cfg: ModelConfig, kind: int):
    """(window, rope theta) of a layer of ``kind`` (0 global, 1 local)."""
    if kind == 1:
        return cfg.local_window or cfg.window or None, cfg.rope_theta
    return cfg.window or None, cfg.global_rope_theta or cfg.rope_theta


def block_apply(p: Block, h, cfg: ModelConfig, *, kind: int, positions,
                kv_len=None, causal=True, collect=False, mesh=None):
    window, theta = layer_window_theta(cfg, kind)
    a = L.attn_apply(p.attn, L.rmsnorm(h, p.ln1), cfg, positions=positions,
                     theta=theta, causal=causal, window=window, kv_len=kv_len,
                     collect=collect)
    if collect:
        a, kv = a
    h = h + a
    h = h + _ffn(p, L.rmsnorm(h, p.ln2), cfg, mesh)
    return (h, kv) if collect else h


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, cfg: ModelConfig, *args):
    """``fn(*args)`` under ``cfg.remat_policy`` (see the module note)."""
    policy = cfg.remat_policy
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat_policy {policy!r}; expected full, dots or none")


def block_remat(p: Block, h, cfg: ModelConfig, *, kind: int, positions, causal=True,
                mesh=None):
    """``block_apply`` under ``cfg.remat_policy``."""
    return remat(functools.partial(block_apply, cfg=cfg, kind=kind, positions=positions,
                                   causal=causal, mesh=mesh), cfg, p, h)


def block_decode(p: Block, h, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                 kind: int, mesh=None):
    """One decode step of one block; writes K / V at ``pos`` in place."""
    window, theta = layer_window_theta(cfg, kind)
    a = L.attn_decode_apply(p.attn, L.rmsnorm(h, p.ln1), cfg, cache_k, cache_v,
                            pos, theta=theta, window=window)
    h = h + a
    return h + _ffn(p, L.rmsnorm(h, p.ln2), cfg, mesh)
