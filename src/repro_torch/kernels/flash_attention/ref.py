"""Plain PyTorch version of flash attention: materialized-score GQA attention,
forward and backward.

The parity oracle of the CUDA kernels (``flash_attention.py``) and the
counterpart of the JAX package's ``kernels/flash_attention/ref.py``: scores
in float32, causal rows counted from 0, an optional sliding window and a
ragged ``kv_len`` (an int or a 0-d tensor, read on the tensor's device).
A row with no valid column is 0, its log-sum-exp -inf and its gradients 0.
It materializes the (Sq, Sk) scores, so it is for tests and checks, never
the serving or training path on a card.  Float64 inputs are computed in
float64 (``torch.autograd.gradcheck``); every other type in float32.
"""
from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the accumulation type: float32, or float64 for float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _masked_scores(q, k, v, kv_len, causal, window):
    """Scaled scores (B, H, Sq, Sk), -inf where masked, and k / v repeated
    over each KV head's query heads, all in the accumulation type."""
    _, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    kf = _acc(k).repeat_interleave(g, dim=1)
    vf = _acc(v).repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), kf) * (d ** -0.5)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= cols > rows - window
    if kv_len is not None:
        mask = mask & (cols < kv_len)
    return s.masked_fill(~mask, float("-inf")), kf, vf


def _attend(s, vf, dtype):
    """softmax(s) . v in ``dtype``; a row with no valid column is 0."""
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len=None, *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q (B, H, Sq, D), k / v (B, KVH, Sk, D) -> (B, H, Sq, D) in q's dtype."""
    s, _, vf = _masked_scores(q, k, v, kv_len, causal, window)
    return _attend(s, vf, q.dtype)


def flash_attention_lse_ref(q, k, v, kv_len=None, *, causal=True, window=None):
    """``(flash_attention_ref(...), lse)``: the output and each row's
    log-sum-exp of the scaled scores, (B, H, Sq) in the accumulation type
    (-inf for a row with no valid column)."""
    s, _, vf = _masked_scores(q, k, v, kv_len, causal, window)
    return _attend(s, vf, q.dtype), torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, kv_len=None, *, causal=True,
                            window=None):
    """(dq, dk, dv) of attention at the forward's ``o`` and ``lse``, given
    the output's gradient ``do``: the backward kernel's formulas with a
    materialized P, dq / dk / dv in the inputs' dtypes and shapes.

        P = exp(s - lse) (0 where masked), Delta = sum_d dO o,
        dV = P^T dO, dP = dO V^T, dS = P (dP - Delta),
        dQ = dS K D^-1/2, dK = dS^T Q D^-1/2,

    dK and dV summed over each KV head's group of query heads."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    s, kf, vf = _masked_scores(q, k, v, kv_len, causal, window)
    lse = _acc(lse)
    # a row with no valid column: every s is -inf, so P = exp(-inf - 0) = 0
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    dof = _acc(do)
    delta = (dof * _acc(o)).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    scale = d ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    g = h // kvh
    dk = dk.reshape(b, kvh, g, sk, d).sum(2)
    dv = dv.reshape(b, kvh, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
