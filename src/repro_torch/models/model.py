"""Model API of every family: init / forward / prefill / decode.

``init_params`` builds a ``Model`` (an ``nn.Module`` holding the
parameters, on the creator's device, under the JAX package's names); the
entry points are functions of ``(cfg, model, inputs)`` as in the JAX
package, so the same weights can run under another configuration
(``attn_impl="ref"``, another compute dtype).  Layers run in a Python
loop.  The families:

* ``dense`` / ``moe`` / ``vlm`` -- ``layers``, one ``Block`` each.  The
  ``moe`` experts run on one device, or over the shards of a
  ``distributed.mesh.Mesh`` passed as ``mesh`` when ``cfg.moe_impl ==
  "shard_map"``.  ``vlm`` prepends its ``frontend`` (patch embeddings,
  ``(B, num_patches, D)``) to the token embeddings; positions and the
  cache run over patches + tokens.
* ``hybrid`` (zamba2) -- ``layers`` of ``HybridBlock`` and one
  ``shared`` attention block run before the last layer of every group of
  ``shared_attn_every``; layers past the last whole group are Mamba2 alone.
* ``ssm`` (xLSTM) -- ``groups`` of ``XLSTMGroup``; no attention.
* ``audio`` (Whisper) -- ``enc_layers`` (non-causal ``Block``), ``enc_norm``
  over the ``frontend`` frames, then ``layers`` of ``DecBlock``.

Cache layouts (``init_cache``) are the JAX package's: K / V of every
attention layer in ``layers.CACHE_DTYPE``, bf16 (hybrid: one per group;
audio: also the cross K / V at ``enc_seq``), float32 recurrent states,
``pos`` a Python int.  The launch tooling reads the same structure without
an allocation: ``abstract_params`` (``meta`` parameters carrying their
logical axes), ``param_specs`` (a ``PartitionSpec`` per ``state_dict`` key),
``cache_specs`` and ``init_cache(..., device="meta")``.

``forward`` is differentiable (the parameters take gradients) and runs
under ``cfg.remat_policy`` (``transformer.remat``) at the JAX package's
granularity: a dense / MoE / vlm block, a hybrid group with its shared
attention (not the tail layers past the last group), an xLSTM group, a
Whisper encoder block and decoder block;
``prefill`` and ``decode_step`` are serving's and run under
``torch.no_grad``.  ``forward`` of the hybrid, ssm and audio families
returns logits only, as in the JAX package (their caches come from
``prefill``).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn

from . import layers as L
from . import mamba2 as M
from . import xlstm as X
from .config import ModelConfig
from .layers import torch_dtype
from .module import P, AbstractCreator, Creator, ShardingRules, SpecCreator, parameter
from .transformer import (Block, DecBlock, HybridBlock, SharedAttn, XLSTMGroup,
                          block_apply, block_decode, block_remat, remat)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, creator: Creator):
        super().__init__()
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = parameter(creator("embed", (V, D), ("vocab", "embed"), scale=1.0))
        self.final_norm = parameter(creator("final_norm", (D,), (None,), scale="zeros"))
        if not cfg.tie_embeddings:
            self.head = parameter(creator("head", (D, V), ("embed", "vocab")))
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            self.layers = nn.ModuleList(Block(creator, cfg) for _ in range(cfg.num_layers))
        elif fam == "hybrid":
            self.layers = nn.ModuleList(HybridBlock(creator, cfg)
                                        for _ in range(cfg.num_layers))
            self.shared = SharedAttn(creator, cfg)
        elif fam == "ssm":
            self.groups = nn.ModuleList(XLSTMGroup(creator, cfg)
                                        for _ in range(cfg.num_layers // cfg.slstm_every))
        elif fam == "audio":
            self.enc_layers = nn.ModuleList(Block(creator, cfg)
                                            for _ in range(cfg.enc_layers))
            self.enc_norm = parameter(creator("enc_norm", (D,), (None,), scale="zeros"))
            self.layers = nn.ModuleList(DecBlock(creator, cfg)
                                        for _ in range(cfg.num_layers))
        else:
            raise ValueError(fam)


def init_params(cfg: ModelConfig, creator: Creator) -> Model:
    return Model(cfg, creator)


def abstract_params(cfg: ModelConfig, device="meta") -> Model:
    """The model with no storage (``meta`` tensors in ``cfg.param_dtype``),
    each parameter carrying its ``logical_axes``: shapes, dtypes and axes
    without an allocation."""
    return init_params(cfg, AbstractCreator(cfg.param_dtype, device))


def param_specs(cfg: ModelConfig, rules: ShardingRules,
                model: Model | None = None) -> dict[str, P]:
    """One ``PartitionSpec`` per parameter, keyed like ``Model.state_dict()``
    (of ``model`` when given, else of ``abstract_params(cfg)``).  A JAX
    leaf of stacked layers has one more entry, the leading ``"layers"``
    axis (``None``), than the port's per-layer key."""
    spec = SpecCreator(rules)
    model = abstract_params(cfg) if model is None else model
    return {name: spec(name, tuple(p.shape), p.logical_axes)
            for name, p in model.named_parameters()}


def _embed(cfg, params, tokens):
    dt = torch_dtype(cfg.compute_dtype)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return params.embed[tokens.long()].to(dt) * scale


def _head(cfg, params, h):
    dt = torch_dtype(cfg.compute_dtype)
    h = L.rmsnorm(h, params.final_norm)
    w = params.embed.T if cfg.tie_embeddings else params.head
    return (h.to(dt) @ w.to(dt)).to(torch_dtype(cfg.logit_dtype))


# what the frontend of each family that takes one holds
FRONTENDS = {"audio": "encoder frame embeddings", "vlm": "patch embeddings"}


def _frontend(cfg, frontend):
    if frontend is None:
        raise ValueError(f"the {cfg.family} family ({cfg.name}) needs a frontend: "
                         f"{FRONTENDS[cfg.family]}")
    return frontend.to(torch_dtype(cfg.compute_dtype))


def forward(cfg: ModelConfig, params: Model, tokens, *, frontend=None,
            collect_cache: bool = False, mesh=None):
    """Causal-LM forward. Returns logits, or (logits, cache) for prefill
    (dense / moe / vlm; the other families' caches come from ``prefill``).
    ``frontend``: vlm patch embeddings or audio frames."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _forward_stack(cfg, params, tokens, frontend, collect_cache, mesh)
    if collect_cache:
        raise NotImplementedError(f"{fam} prefill uses prefill()")
    if fam == "hybrid":
        return _forward_hybrid(cfg, params, tokens)
    if fam == "ssm":
        return _forward_xlstm(cfg, params, tokens)
    if fam == "audio":
        return _forward_encdec(cfg, params, tokens, frontend)
    raise ValueError(fam)


def _forward_stack(cfg, params, tokens, frontend, collect, mesh):
    h = _embed(cfg, params, tokens)
    if cfg.family == "vlm":
        h = torch.cat([_frontend(cfg, frontend).to(h.device), h], dim=1)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    ks, vs = [], []
    for blk, kind in zip(params.layers, cfg.layer_kinds()):
        if collect:
            h, (k, v) = block_apply(blk, h, cfg, kind=kind, positions=positions,
                                    collect=True, mesh=mesh)
            ks.append(k)
            vs.append(v)
        else:
            h = block_remat(blk, h, cfg, kind=kind, positions=positions, mesh=mesh)
    logits = _head(cfg, params, h)
    if collect:
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": S}
    return logits


# ------------------------------------------------------------------ hybrid
def _shared_slot(cfg, i: int) -> int | None:
    """The group whose shared attention runs before layer ``i``, or None."""
    every = cfg.shared_attn_every
    if i < cfg.num_layers // every * every and i % every == every - 1:
        return i // every
    return None


def _shared_attn_apply(sp: SharedAttn, h, cfg, positions, collect=False):
    a = L.attn_apply(sp.attn, L.rmsnorm(h, sp.ln1), cfg, positions=positions,
                     theta=cfg.rope_theta, causal=True, window=None, collect=collect)
    if collect:
        a, kv = a
    h = h + a
    h = h + L.mlp_apply(sp.mlp, L.rmsnorm(h, sp.ln2), cfg.compute_dtype)
    return (h, kv) if collect else h


def _hybrid_layers(cfg, params, lo: int, hi: int, h, positions, collect=False):
    """Layers ``lo`` .. ``hi - 1``, each group's shared attention before its
    last layer; with ``collect`` also (their Mamba2 states, the attention's
    K / V)."""
    states, kvs = [], []
    for i in range(lo, hi):
        if _shared_slot(cfg, i) is not None:
            out = _shared_attn_apply(params.shared, h, cfg, positions, collect)
            h, kv = out if collect else (out, None)
            kvs.append(kv)
        blk = params.layers[i]
        out = M.mamba2_apply(blk.mamba, L.rmsnorm(h, blk.ln), cfg, return_state=collect)
        y, st = out if collect else (out, None)
        states.append(st)
        h = h + y
    return (h, states, kvs) if collect else h


def _forward_hybrid(cfg, params, tokens, collect=False):
    """Each whole group of ``shared_attn_every`` layers (the shared attention
    included) runs under ``cfg.remat_policy``, the tail layers past the last
    group without, as the JAX package's scan over groups."""
    h = _embed(cfg, params, tokens)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    every = cfg.shared_attn_every
    G = cfg.num_layers // every
    spans = [(g * every, (g + 1) * every) for g in range(G)]
    if G * every < cfg.num_layers:
        spans.append((G * every, cfg.num_layers))
    states, kvs = [], []
    for g, (lo, hi) in enumerate(spans):
        if collect:
            h, st, kv = _hybrid_layers(cfg, params, lo, hi, h, positions, collect=True)
            states += st
            kvs += kv
        elif g < G:
            h = remat(functools.partial(_hybrid_layers, cfg, params, lo, hi,
                                        positions=positions), cfg, h)
        else:
            h = _hybrid_layers(cfg, params, lo, hi, h, positions)
    logits = _head(cfg, params, h)
    if collect:
        return logits, {"mamba_h": torch.stack([st["h"] for st in states]),
                        "mamba_conv": torch.stack([st["conv"] for st in states]),
                        "k": torch.stack([k for k, _ in kvs]),
                        "v": torch.stack([v for _, v in kvs]), "pos": S}
    return logits


# -------------------------------------------------------------------- ssm
def _xlstm_group(cfg, grp: XLSTMGroup, h, collect=False):
    """One group: its mLSTM blocks, then its sLSTM block; with ``collect``
    also (the mLSTM states, the sLSTM state)."""
    m_sts = []
    for j, blk in enumerate(grp.mlstm):
        out = X.mlstm_apply(blk, L.rmsnorm(h, grp.mlstm_ln[j]), cfg, return_state=collect)
        y, st = out if collect else (out, None)
        m_sts.append(st)
        h = h + y
    y, s_st = X.slstm_apply(grp.slstm, L.rmsnorm(h, grp.slstm_ln), cfg)
    h = h + y
    return (h, m_sts, s_st) if collect else h


def _forward_xlstm(cfg, params, tokens, collect=False):
    """Each group runs under ``cfg.remat_policy``, as the JAX package's scan
    over groups."""
    h = _embed(cfg, params, tokens)
    m_sts, s_sts = [], []
    for grp in params.groups:
        if collect:
            h, m_st, s_st = _xlstm_group(cfg, grp, h, collect=True)
            m_sts += m_st
            s_sts.append(s_st)
        else:
            h = remat(functools.partial(_xlstm_group, cfg, grp), cfg, h)
    logits = _head(cfg, params, h)
    if collect:
        G, nm = len(params.groups), cfg.slstm_every - 1

        def mstack(key):
            t = torch.stack([st[key] for st in m_sts])
            return t.reshape(G, nm, *t.shape[1:])

        cache = {"mlstm_h": mstack("h"), "mlstm_m": mstack("m"),
                 "pos": tokens.shape[1]}
        for key in ("h", "c", "n", "m"):
            cache[f"slstm_{key}"] = torch.stack([st[key] for st in s_sts])
        return logits, cache
    return logits


# ------------------------------------------------------------------ audio
def _encode(cfg, params, frames):
    """The encoder, each block under ``cfg.remat_policy``."""
    enc_h = _frontend(cfg, frames)
    enc_pos = torch.arange(enc_h.shape[1], device=enc_h.device)
    for blk in params.enc_layers:
        enc_h = block_remat(blk, enc_h, cfg, kind=0, positions=enc_pos, causal=False)
    return L.rmsnorm(enc_h, params.enc_norm)


def _dec_block(cfg, blk: DecBlock, h, enc_h, positions, collect=False):
    """One decoder block; with ``collect`` also (its self-attention K / V,
    its cross K / V rounded to the cache's dtype, which it attends over)."""
    a = L.attn_apply(blk.attn, L.rmsnorm(h, blk.ln1), cfg, positions=positions,
                     theta=cfg.rope_theta, causal=True, window=None, collect=collect)
    xkv = None
    if collect:
        a, kv = a
        b, hd, kvh = h.shape[0], cfg.resolved_head_dim, cfg.num_kv_heads
        xp = blk.xattn
        xkv = tuple((enc_h @ xp[w].to(enc_h.dtype)).reshape(b, -1, kvh, hd).to(L.CACHE_DTYPE)
                    for w in ("wk", "wv"))
    h = h + a
    h = h + L.attn_apply_cross(blk.xattn, L.rmsnorm(h, blk.lnx), enc_h, cfg, kv=xkv)
    h = h + L.mlp_apply(blk.mlp, L.rmsnorm(h, blk.ln2), cfg.compute_dtype)
    return (h, kv, xkv) if collect else h


def _forward_encdec(cfg, params, tokens, frames, collect=False):
    """Whisper; each decoder block under ``cfg.remat_policy``.  ``forward``
    computes the cross K / V in the compute dtype; ``prefill`` rounds them
    to the cache's bf16 and attends over the rounded ones, as the JAX
    package does (so the two differ by that rounding there too)."""
    enc_h = _encode(cfg, params, frames)
    h = _embed(cfg, params, tokens)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    kvs, xkvs = [], []
    for blk in params.layers:
        if collect:
            h, kv, xkv = _dec_block(cfg, blk, h, enc_h, positions, collect=True)
            kvs.append(kv)
            xkvs.append(xkv)
        else:
            h = remat(functools.partial(_dec_block, cfg, blk, positions=positions), cfg,
                      h, enc_h)
    logits = _head(cfg, params, h)
    if collect:
        return logits, {"k": torch.stack([k for k, _ in kvs]),
                        "v": torch.stack([v for _, v in kvs]),
                        "xk": torch.stack([k for k, _ in xkvs]),
                        "xv": torch.stack([v for _, v in xkvs]), "pos": S}
    return logits


# ---------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict[str, Any]:
    """Decode state of ``cfg``'s family on ``device`` (the card unless
    named), zeros: K / V caches (layers, B, max_len, KVH, hd) in
    ``layers.CACHE_DTYPE`` (bf16), float32
    recurrent states, and the next position ``pos``, a Python int.
    ``device="meta"`` is the abstract cache (the JAX package's
    ``abstract=True``): the same shapes and dtypes with no storage."""
    device = torch.device("cuda" if device is None else device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    hd, KVH, B = cfg.resolved_head_dim, cfg.num_kv_heads, batch
    fam = cfg.family
    cache: dict[str, Any] = {"pos": 0}
    if fam in ("dense", "moe", "vlm", "audio"):
        kv = (cfg.num_layers, B, max_len, KVH, hd)
        cache["k"], cache["v"] = z(kv, L.CACHE_DTYPE), z(kv, L.CACHE_DTYPE)
        if fam == "audio":
            xkv = (cfg.num_layers, B, cfg.enc_seq, KVH, hd)
            cache["xk"], cache["xv"] = z(xkv, L.CACHE_DTYPE), z(xkv, L.CACHE_DTYPE)
    elif fam == "hybrid":
        H, N = cfg.resolved_ssm_heads, cfg.ssm_state
        G = cfg.num_layers // cfg.shared_attn_every
        cache["mamba_h"] = z((cfg.num_layers, B, H, N, cfg.d_inner // H), torch.float32)
        cache["mamba_conv"] = z((cfg.num_layers, B, M.CONV_K - 1, cfg.d_inner + 2 * N),
                                torch.float32)
        kv = (G, B, max_len, KVH, hd)
        cache["k"], cache["v"] = z(kv, L.CACHE_DTYPE), z(kv, L.CACHE_DTYPE)
    elif fam == "ssm":
        G = cfg.num_layers // cfg.slstm_every
        nm = cfg.slstm_every - 1
        H = cfg.num_heads
        Pm, Ps = 2 * cfg.d_model // H, cfg.d_model // H
        cache["mlstm_h"] = z((G, nm, B, H, Pm, Pm + 1), torch.float32)
        cache["mlstm_m"] = z((G, nm, B, H), torch.float32)
        for key in ("h", "c", "n", "m"):
            # slstm_m starts at 0 here and at -30 in slstm_init_state, as in JAX
            cache[f"slstm_{key}"] = z((G, B, H, Ps), torch.float32)
    else:
        raise ValueError(fam)
    return cache


def cache_specs(cfg: ModelConfig, rules: ShardingRules) -> dict[str, P]:
    """``PartitionSpec``s mirroring ``init_cache``, the JAX package's: K / V
    caches sharded on the sequence over the heads' mesh axis (the
    flash-decoding layout) and on the batch over the batch axes, whatever
    the kv-head count; the SSM states on their heads or memory dim."""
    bx, sx = rules.batch, rules.heads  # seq dim of caches -> model axis
    fam = cfg.family
    specs: dict[str, Any] = {"pos": P()}
    if fam in ("dense", "moe", "vlm", "audio"):
        specs["k"] = P(None, bx, sx, None, None)
        specs["v"] = P(None, bx, sx, None, None)
        if fam == "audio":
            specs["xk"] = P(None, bx, sx, None, None)
            specs["xv"] = P(None, bx, sx, None, None)
    elif fam == "hybrid":
        specs["mamba_h"] = P(None, bx, sx, None, None)      # shard SSM heads
        specs["mamba_conv"] = P(None, bx, None, sx)
        specs["k"] = P(None, bx, sx, None, None)
        specs["v"] = P(None, bx, sx, None, None)
    elif fam == "ssm":
        specs["mlstm_h"] = P(None, None, bx, None, sx, None)  # shard memory P
        specs["mlstm_m"] = P(None, None, bx, None)
        for key in ("h", "c", "n", "m"):
            specs[f"slstm_{key}"] = P(None, bx, None, sx)
    else:
        raise ValueError(fam)
    return specs


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, tokens, *, frontend=None, mesh=None):
    """Process a prompt; returns (last-token logits, cache at len(prompt)).
    ``frontend``: vlm patch embeddings or audio frames."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        logits, cache = _forward_stack(cfg, params, tokens, frontend, True, mesh)
    elif fam == "hybrid":
        logits, cache = _forward_hybrid(cfg, params, tokens, collect=True)
    elif fam == "ssm":
        logits, cache = _forward_xlstm(cfg, params, tokens, collect=True)
    elif fam == "audio":
        logits, cache = _forward_encdec(cfg, params, tokens, frontend, collect=True)
    else:
        raise ValueError(fam)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Model, cache, tokens, mesh=None):
    """One token for every sequence. tokens: (B, 1). Returns (logits, cache).

    The K / V of this step are written into ``cache`` in place; recurrent
    states come back as new tensors (``cache``'s are not written, so a step
    can be repeated from the same cache).  The returned cache shares the
    K / V tensors, with ``pos`` advanced by one."""
    fam = cfg.family
    pos = cache["pos"]
    h = _embed(cfg, params, tokens)
    new = {**cache, "pos": pos + 1}
    if fam in ("dense", "moe", "vlm"):
        for i, (blk, kind) in enumerate(zip(params.layers, cfg.layer_kinds())):
            h = block_decode(blk, h, cfg, cache["k"][i], cache["v"][i], pos, kind=kind,
                             mesh=mesh)
    elif fam == "hybrid":
        sp = params.shared
        new_h, new_conv = torch.empty_like(cache["mamba_h"]), torch.empty_like(
            cache["mamba_conv"])
        for i, blk in enumerate(params.layers):
            g = _shared_slot(cfg, i)
            if g is not None:
                h = h + L.attn_decode_apply(sp.attn, L.rmsnorm(h, sp.ln1), cfg,
                                            cache["k"][g], cache["v"][g], pos,
                                            theta=cfg.rope_theta)
                h = h + L.mlp_apply(sp.mlp, L.rmsnorm(h, sp.ln2), cfg.compute_dtype)
            st = {"h": cache["mamba_h"][i], "conv": cache["mamba_conv"][i]}
            y, st = M.mamba2_step(blk.mamba, L.rmsnorm(h, blk.ln), st, cfg)
            h = h + y
            new_h[i], new_conv[i] = st["h"], st["conv"]
        new.update(mamba_h=new_h, mamba_conv=new_conv)
    elif fam == "ssm":
        for key in ("mlstm_h", "mlstm_m", "slstm_h", "slstm_c", "slstm_n", "slstm_m"):
            new[key] = torch.empty_like(cache[key])
        for g, grp in enumerate(params.groups):
            for j, blk in enumerate(grp.mlstm):
                st = {"h": cache["mlstm_h"][g, j], "m": cache["mlstm_m"][g, j]}
                y, st = X.mlstm_step(blk, L.rmsnorm(h, grp.mlstm_ln[j]), st, cfg)
                h = h + y
                new["mlstm_h"][g, j], new["mlstm_m"][g, j] = st["h"], st["m"]
            st = {key: cache[f"slstm_{key}"][g] for key in ("h", "c", "n", "m")}
            y, st = X.slstm_step(grp.slstm, L.rmsnorm(h, grp.slstm_ln), st, cfg)
            h = h + y
            for key in ("h", "c", "n", "m"):
                new[f"slstm_{key}"][g] = st[key]
    elif fam == "audio":
        for i, blk in enumerate(params.layers):
            h = h + L.attn_decode_apply(blk.attn, L.rmsnorm(h, blk.ln1), cfg, cache["k"][i],
                                        cache["v"][i], pos, theta=cfg.rope_theta)
            h = h + L.attn_apply_cross(blk.xattn, L.rmsnorm(h, blk.lnx), None, cfg,
                                       kv=(cache["xk"][i], cache["xv"][i]))
            h = h + L.mlp_apply(blk.mlp, L.rmsnorm(h, blk.ln2), cfg.compute_dtype)
    else:
        raise ValueError(fam)
    logits = _head(cfg, params, h)
    return logits[:, 0], new
