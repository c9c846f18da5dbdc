"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, GQA attention block.

Parameters come as mappings of tensors (a block's ``nn.ParameterDict``),
named as in the JAX package.  The rounding points are the JAX package's:
inputs cast to the compute dtype before every product, RMSNorm and RoPE in
float32 and cast back, the K / V cache in bf16 whatever the compute dtype.
Plain products stay ``torch.matmul``, as the JAX package leaves them to
XLA.  The MoE and cross-attention parts arrive with their families.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import attention, attention_decode
from .config import ModelConfig
from .module import Creator


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ----------------------------------------------------------------- basics
def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (n * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, D). Rotates pairs (d, d + D/2)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq                   # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- MLP
def mlp_init(c: Creator, cfg: ModelConfig, d_ff: int | None = None):
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    return {
        "gate": c("mlp.gate", (D, F_), ("embed", "mlp")),
        "up": c("mlp.up", (D, F_), ("embed", "mlp")),
        "down": c("mlp.down", (F_, D), ("mlp", "embed")),
    }


def mlp_apply(p, x, compute_dtype):
    dt = torch_dtype(compute_dtype)
    x = x.to(dt)
    g = x @ p["gate"].to(dt)
    u = x @ p["up"].to(dt)
    return (F.silu(g) * u) @ p["down"].to(dt)


# ------------------------------------------------------- attention block
def attn_init(c: Creator, cfg: ModelConfig, prefix="attn"):
    D = cfg.d_model
    return {
        "wq": c(f"{prefix}.wq", (D, cfg.q_dim), ("embed", "heads")),
        "wk": c(f"{prefix}.wk", (D, cfg.kv_dim), ("embed", "heads")),
        "wv": c(f"{prefix}.wv", (D, cfg.kv_dim), ("embed", "heads")),
        "wo": c(f"{prefix}.wo", (cfg.q_dim, D), ("heads", "embed")),
    }


def attn_qkv(p, x, cfg: ModelConfig, positions, theta):
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    x = x.to(dt)
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, s, cfg.num_kv_heads, hd)
    if theta is not None:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, *, positions, theta, causal=True,
               window=None, kv_len=None, collect=False):
    q, k, v = attn_qkv(p, x, cfg, positions, theta)
    pdt = None if cfg.attn_p_dtype == "float32" else torch_dtype(cfg.attn_p_dtype)
    o = attention(q, k, v, impl=cfg.attn_impl, causal=causal, window=window,
                  kv_len=kv_len, chunk=cfg.attn_chunk, p_dtype=pdt)
    b, s = o.shape[:2]
    out = o.reshape(b, s, -1) @ p["wo"].to(torch_dtype(cfg.compute_dtype))
    if collect:
        return out, (k.to(torch.bfloat16), v.to(torch.bfloat16))
    return out


def attn_decode_apply(p, x, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                      theta, window=None):
    """One-token decode against a (B, S, KVH, hd) cache.

    Writes this token's K / V at ``pos`` into ``cache_k`` / ``cache_v`` in
    place (the JAX package returns updated copies) and returns the block's
    output.  Past the cache the write lands on the last slot, where JAX's
    ``dynamic_update_slice`` clamps it; RoPE and ``kv_len`` keep ``pos``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = attn_qkv(p, x, cfg, positions, theta)
    slot = min(pos, cache_k.shape[1] - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    o = attention_decode(q, cache_k, cache_v, pos + 1, window=window)
    return o.reshape(b, 1, -1) @ p["wo"].to(torch_dtype(cfg.compute_dtype))
