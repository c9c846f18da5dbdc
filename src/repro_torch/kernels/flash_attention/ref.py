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


def _rounded(p, p_dtype):
    """P rounded to ``p_dtype`` and back (``attn_p_dtype``), or P itself."""
    if p_dtype is None or p_dtype == torch.float32:
        return p
    return p.to(p_dtype).to(p.dtype)


def _attend(s, vf, dtype, p_dtype=None):
    """softmax(s) . v in ``dtype``; a row with no valid column is 0.  With
    ``p_dtype``, exp(s - max) is rounded to it before the product and the
    row sum taken unrounded, the kernels' rounding point."""
    if p_dtype is None or p_dtype == torch.float32:
        p = torch.softmax(s, dim=-1)
        p = torch.where(torch.isnan(p), 0.0, p)
        return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(dtype)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", _rounded(e, p_dtype), vf)
    return torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0).to(dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len=None, *, causal: bool = True,
                        window: int | None = None, p_dtype=None) -> torch.Tensor:
    """q (B, H, Sq, D), k / v (B, KVH, Sk, D) -> (B, H, Sq, D) in q's dtype."""
    s, _, vf = _masked_scores(q, k, v, kv_len, causal, window)
    return _attend(s, vf, q.dtype, p_dtype)


def flash_attention_lse_ref(q, k, v, kv_len=None, *, causal=True, window=None,
                            p_dtype=None):
    """``(flash_attention_ref(...), lse)``: the output and each row's
    log-sum-exp of the scaled scores, (B, H, Sq) in the accumulation type
    (-inf for a row with no valid column)."""
    s, _, vf = _masked_scores(q, k, v, kv_len, causal, window)
    return _attend(s, vf, q.dtype, p_dtype), torch.logsumexp(s, dim=-1)


def _probs(q, k, v, lse, kv_len, causal, window):
    """P = exp(s - lse), 0 where masked, and k / v repeated over each KV
    head's query heads, in the accumulation type."""
    s, kf, vf = _masked_scores(q, k, v, kv_len, causal, window)
    lse = _acc(lse)
    # a row with no valid column: every s is -inf, so P = exp(-inf - 0) = 0
    return torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None]), kf, vf


def _group_sum(x, kvh):
    """(B, H, S, D) -> (B, KVH, S, D), summed over each KV head's group."""
    b, h, s, d = x.shape
    return x.reshape(b, kvh, h // kvh, s, d).sum(2)


def flash_attention_bwd_ref(q, k, v, o, lse, do, kv_len=None, *, causal=True,
                            window=None, p_dtype=None):
    """(dq, dk, dv) of attention at the forward's ``o`` and ``lse``, given
    the output's gradient ``do``: the backward kernel's formulas with a
    materialized P, dq / dk / dv in the inputs' dtypes and shapes.

        P = exp(s - lse) (0 where masked), Delta = sum_d dO o,
        dV = P^T dO, dP = dO V^T, dS = P (dP - Delta),
        dQ = dS K D^-1/2, dK = dS^T Q D^-1/2,

    dK and dV summed over each KV head's group of query heads; with
    ``p_dtype`` dV takes P rounded to it, as the forward's P.V did."""
    p, kf, vf = _probs(q, k, v, lse, kv_len, causal, window)
    dof = _acc(do)
    delta = (dof * _acc(o)).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    scale = q.shape[-1] ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = _group_sum(torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q)) * scale, k.shape[1])
    dv = _group_sum(torch.einsum("bhqk,bhqd->bhkd", _rounded(p, p_dtype), dof), k.shape[1])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_magnitudes(q, k, v, o, lse, do, kv_len=None, *, causal=True,
                                   window=None, dp_error=False):
    """(A_dq, A_dk, A_dv): the magnitude products of the backward's three
    gradient products, in the accumulation type and the gradients' shapes,

        A_dv = |P|^T |dO|,  A_dk = D^-1/2 |dS|^T |Q|,  A_dq = D^-1/2 |dS| |K|

    (A_dk and A_dv summed over each KV head's query heads), with P and dS
    as ``flash_attention_bwd_ref`` forms them.  Rounding P or dS to bf16
    moves a gradient by at most 2^-8 of its A; a 3xTF32 product is within
    2^-20 of it.  ``dp_error`` adds the magnitudes through which dS carries
    the errors of dP and Delta: dS = P (dP - Delta) cancels, so an error of
    dP or Delta within a fraction of their magnitude products (|dO| |V|^T,
    sum_d |dO| |o|) moves dS by that fraction of P M, M their sum, however
    small dS is (a causal row's first key has dS = 0 exactly); A_dq gains
    D^-1/2 (P M) |K| and A_dk D^-1/2 (P M)^T |Q|.  For tolerances in tests
    and checks only."""
    p, kf, vf = _probs(q, k, v, lse, kv_len, causal, window)
    dof = _acc(do)
    delta = (dof * _acc(o)).sum(-1)
    ds = (p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])).abs()
    if dp_error:
        ds = ds + p * (torch.einsum("bhqd,bhkd->bhqk", dof.abs(), vf.abs())
                       + (dof * _acc(o)).abs().sum(-1)[..., None])
    scale = q.shape[-1] ** -0.5
    a_dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf.abs()) * scale
    a_dk = _group_sum(torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q).abs()) * scale, k.shape[1])
    a_dv = _group_sum(torch.einsum("bhqk,bhqd->bhkd", p, dof.abs()), k.shape[1])
    return a_dq, a_dk, a_dv
