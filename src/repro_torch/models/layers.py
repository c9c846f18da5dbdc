"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, MoE, GQA attention block.

Parameters come as mappings of tensors (a block's ``nn.ParameterDict``),
named as in the JAX package.  The rounding points are the JAX package's:
inputs cast to the compute dtype before every product, RMSNorm and RoPE in
float32 and cast back, the K / V cache in ``CACHE_DTYPE`` (bf16, as the JAX
package keeps it) whatever the compute dtype.
Plain products stay ``torch.matmul``, as the JAX package leaves them to
XLA, the MoE's batched expert products included.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import attention, attention_decode
from .config import ModelConfig
from .module import Creator


# the dtype of every cached K / V, the JAX package's bf16
CACHE_DTYPE = torch.bfloat16


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


def moe_init(c: Creator, cfg: ModelConfig):
    D, E = cfg.d_model, cfg.num_experts
    F_ = cfg.moe_d_ff or cfg.d_ff
    return {
        "router": c("moe.router", (D, E), ("embed", None)),
        "gate": c("moe.gate", (E, D, F_), ("expert", "embed", "mlp")),
        "up": c("moe.up", (E, D, F_), ("expert", "embed", "mlp")),
        "down": c("moe.down", (E, F_, D), ("expert", "mlp", "embed")),
    }


def moe_apply(p, x, cfg: ModelConfig, mesh=None):
    """MoE front door: the dense dispatch, or expert parallelism over
    ``mesh`` (``distributed.mesh.Mesh``) when ``cfg.moe_impl ==
    "shard_map"``, as the JAX package's ``moe_apply`` chooses."""
    if cfg.moe_impl == "shard_map":
        from .moe_ep import moe_apply_ep
        return moe_apply_ep(p, x, cfg, mesh)
    return moe_apply_dense(p, x, cfg)


def top_k_lower_first(logits, k: int):
    """(values, indices) of the k largest entries of each row, ties broken
    by the lower index first as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among equal values): a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, router, cfg: ModelConfig):
    """Router of (T, D) tokens: float32 gates (T, K), softmax over the top k
    logits, and their expert ids (T, K).  The logits are computed in the
    compute dtype and cast to float32, as in the JAX package."""
    dt = torch_dtype(cfg.compute_dtype)
    logits = (xt @ router.to(dt)).float()
    gates, idx = top_k_lower_first(logits, cfg.num_experts_per_tok)
    return torch.softmax(gates, dim=-1), idx


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert: ``max(8, int(capacity_factor * T * K / E))``."""
    return max(8, int(cfg.capacity_factor * tokens * cfg.num_experts_per_tok
                      / cfg.num_experts))


def dispatch_slots(expert, num: int, cap: int, mine=None):
    """Each (token, k) row's slot in its expert's capacity buffer: the
    exclusive running count of earlier rows sent to the same expert (of
    ``num``); rows at or past ``cap``, and rows not ``mine``, are dropped.
    Returns (slot clamped to ``cap - 1`` where dropped, keep)."""
    onehot = F.one_hot(expert, num).to(torch.int32)
    if mine is not None:
        onehot = onehot * mine[:, None]
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = pos.gather(1, expert[:, None])[:, 0]
    keep = slot < cap
    if mine is not None:
        keep = keep & mine
    return torch.where(keep, slot, cap - 1), keep


def run_experts(xt, expert, slot, keep, cap: int, gate, up, down, dt):
    """Each (token, k) row's expert output, (T*K, D) in ``dt``, 0 where the
    row was dropped: the kept rows written into an (E, cap, D) buffer (each
    (expert, slot) at most once, so an exact write in any order), the
    SwiGLU experts as three batched products over the expert dim, and the
    rows gathered back.  ``expert`` / ``slot`` / ``keep`` are per row, rows
    in (token, k) order.

    Under autograd every gradient is written once a slot or reduced in a
    fixed order: the kept rows are read from the (T, K, D) broadcast of
    ``xt``, each (token, k) once, so a token's gradient is the broadcast's
    backward, a reduction over the K axis (reading ``xt[kept // K]``
    would accumulate the repeated tokens' rows by an indexed add, whose
    order on a card is unspecified); a dropped row adds exactly 0 to the
    (expert, ``cap - 1``) slot it is clamped to."""
    E, K = gate.shape[0], expert.shape[0] // xt.shape[0]
    kept = torch.arange(expert.shape[0], device=xt.device)[keep]
    disp = torch.zeros((E, cap, xt.shape[1]), dtype=dt, device=xt.device)
    disp[expert[kept], slot[kept]] = xt[:, None].expand(-1, K, -1)[kept // K, kept % K]
    g = torch.bmm(disp, gate.to(dt))
    u = torch.bmm(disp, up.to(dt))
    out = torch.bmm(F.silu(g) * u, down.to(dt))
    return torch.where(keep[:, None], out[expert, slot], 0)


def moe_apply_dense(p, x, cfg: ModelConfig):
    """Capacity-bounded scatter dispatch with static shapes, as the JAX
    package's ``moe_apply_dense``: tokens flattened to (T, D), routed top-k,
    written into an (E, C, D) buffer (C = ``capacity``), run through the
    experts as batched products, and combined with the router weights.
    Tokens past an expert's capacity are dropped (their row adds 0).

    The combine folds each token's K contributions in k order (the JAX
    package's scatter-add onto zeros over ``src = repeat(arange(T), K)``),
    not with ``index_add_``, whose order on a card is unspecified."""
    dt = torch_dtype(cfg.compute_dtype)
    b, s, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = b * s
    C = capacity(cfg, T)
    xt = x.reshape(T, D).to(dt)
    gates, idx = route(xt, p["router"], cfg)
    flat_e = idx.reshape(-1)                                   # (T*K,)
    slot, keep = dispatch_slots(flat_e, E, C)
    gathered = run_experts(xt, flat_e, slot, keep, C, p["gate"], p["up"], p["down"], dt)
    w = gates.reshape(-1)[:, None].to(dt)
    contrib = (gathered * w).reshape(T, K, D)
    combined = torch.zeros((T, D), dtype=dt, device=x.device)
    for k in range(K):
        combined = combined + contrib[:, k]
    return combined.reshape(b, s, D)


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
        return out, (k.to(CACHE_DTYPE), v.to(CACHE_DTYPE))
    return out


def attn_apply_cross(p, x, enc_h, cfg: ModelConfig, kv: tuple | None = None):
    """Cross attention: queries from x, keys / values from the encoder
    output ``enc_h`` (or a precomputed (k, v) pair, the bf16 cache of a
    prefill).  No RoPE, not causal; on a CUDA tensor ``attention`` reaches
    the flash-attention kernel.  The kernel takes one dtype, so a cached
    bf16 (k, v) is widened to float32 queries' dtype, which is exact (the
    JAX package's attention widens every operand to float32)."""
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x.to(dt) @ p["wq"].to(dt)).reshape(b, s, cfg.num_heads, hd)
    if kv is None:
        e = enc_h.to(dt)
        k = (e @ p["wk"].to(dt)).reshape(b, -1, cfg.num_kv_heads, hd)
        v = (e @ p["wv"].to(dt)).reshape(b, -1, cfg.num_kv_heads, hd)
    else:
        k, v = kv
    o = attention(q, k.to(q.dtype), v.to(q.dtype), impl=cfg.attn_impl, causal=False,
                  window=None, chunk=cfg.attn_chunk)
    return o.reshape(b, s, -1) @ p["wo"].to(dt)


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
