"""Attention implementations: ref / chunked (the flash algorithm in plain
PyTorch) / the CUDA kernel, plus cache-decode attention.

Layouts are the JAX package's: q (B, S, H, D), k / v (B, S, KVH, D).  The
causal rows of ``attention_ref`` and ``attention_chunked`` are offset by
``sk - sq`` (the JAX model's convention); the kernel counts them from 0,
so a causal call reaches it only when ``sq == sk`` (every prefill).

Dispatch of ``attention(impl=...)`` goes by the tensors' device:

* ``"ref"`` -- the materialized plain version, on any device;
* ``"chunked"`` -- on a CUDA tensor the hand-written flash-attention
  kernel, on a CPU tensor the plain chunked scan;
* ``"pallas"`` -- ``kernels.flash_attention.ops.flash_attention``: the
  kernel on a card, its plain version (``flash_attention_ref``) on the CPU,
  as the JAX package's ``"pallas"`` takes ``ref.py`` off a TPU.

On a CUDA tensor the kernel launches or raises; nothing moves a CUDA
tensor onto a plain path.  ``p_dtype`` (``attn_p_dtype``) bfloat16 or
float16 reaches the kernel, which rounds P to it before P.V; any other
type raises with the type named.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import backend
from repro_torch.kernels.flash_attention import ops as kops

NEG_INF = -1e30
NO_WINDOW = 1 << 30


def _mask(rows, cols, causal: bool, window, kv_len):
    """``window=None`` makes the window clause a no-op (``NO_WINDOW``)."""
    m = cols < kv_len
    if causal:
        m = m & (rows >= cols)
    return m & (cols > rows - (NO_WINDOW if window is None else window))


def attention_ref(q, k, v, *, causal=True, window=None, kv_len=None):
    """Materialized-score GQA attention (oracle). q:(B,S,H,D) k/v:(B,S,KVH,D)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = (q.float() * (d ** -0.5)).reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq if causal else 0)
    cols = torch.arange(sk, device=q.device)[None, :]
    m = _mask(rows, cols, causal, window, sk if kv_len is None else kv_len)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=None, kv_len=None,
                      chunk=1024, p_dtype=None):
    """The flash algorithm as a loop over KV chunks (no S^2 scores), in
    plain PyTorch: the JAX package's ``lax.scan`` written as a Python loop."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nkv = (sk + pad) // chunk
    kv_len = sk if kv_len is None else kv_len

    qf = (q.float() * (d ** -0.5)).reshape(b, sq, kvh, g, d)
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq if causal else 0)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32, device=q.device)
    m_prev = torch.full((b, kvh, g, sq, 1), NEG_INF, device=q.device)
    l_prev = torch.zeros((b, kvh, g, sq, 1), device=q.device)
    for ci in range(nkv):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
        cols = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        s = torch.where(_mask(rows, cols, causal, window, kv_len), s, NEG_INF)
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_prev - m_new)
        l_prev = alpha * l_prev + p.sum(dim=-1, keepdim=True)
        if p_dtype is not None:   # store/stream P at reduced precision
            p = p.to(p_dtype).float()
        acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m_prev = m_new
    o = acc / torch.clamp(l_prev, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def attention_decode(q, k_cache, v_cache, kv_len, *, window=None):
    """Single-step decode: q:(B,1,H,D) against cache:(B,S,KVH,D).

    ``kv_len`` is an int or a 0-d tensor; plain PyTorch, as the JAX package
    computes it outside any kernel."""
    b, _, h, d = q.shape
    sk, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qf = (q.float() * (d ** -0.5)).reshape(b, kvh, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    cols = torch.arange(sk, device=q.device)[None, :]
    m = (cols < kv_len) & (cols > kv_len - 1 - (NO_WINDOW if window is None else window))
    s = torch.where(m[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def _flash(q, k, v, *, causal, window, kv_len, p_dtype=None):
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal attention with {q.shape[1]} query rows over "
                         f"{k.shape[1]} keys: the flash-attention kernel counts "
                         f"causal rows from 0, the model from sk - sq")
    o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             kv_len, causal=causal, window=window, p_dtype=p_dtype)
    return o.transpose(1, 2)


def attention(q, k, v, *, impl="chunked", causal=True, window=None,
              kv_len=None, chunk=1024, p_dtype=None):
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window, kv_len=kv_len)
    if impl == "pallas":
        return _flash(q, k, v, causal=causal, window=window, kv_len=kv_len)
    if impl == "chunked":
        if backend.resolve(q.device) == "cuda":
            return _flash(q, k, v, causal=causal, window=window, kv_len=kv_len,
                          p_dtype=p_dtype)
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len, chunk=chunk, p_dtype=p_dtype)
    raise ValueError(f"unknown attention impl {impl!r}")
