"""Public entry point for fused attention: the CUDA kernels on a card, the
plain versions elsewhere, chosen by the tensors' device as
``core.backend.resolve`` chooses for every primitive of the port.

``FlashAttention`` is the autograd function around them: its forward keeps
each row's log-sum-exp beside the output, and its backward is the
backward kernel on a card (``flash_attention_bwd_cuda``) or the plain
backward (``flash_attention_bwd_ref``) elsewhere.  ``flash_attention``
goes through it only when autograd will ask for a gradient, so serving
under ``torch.inference_mode`` launches the forward alone and stores no
log-sum-exp.
"""
from __future__ import annotations

import torch

from repro_torch.core import backend

from .flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, kv_len, causal, window, impl=None, p_dtype=None)`` ->
    (B, H, Sq, D); gradients for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, window, impl=None, p_dtype=None):
        kw = dict(causal=causal, window=window, p_dtype=p_dtype)
        ctx.cuda = backend.resolve(q.device, impl) == "cuda"
        if ctx.cuda:
            o, lse = flash_attention_cuda(q, k, v, kv_len, return_lse=True, **kw)
        else:
            o, lse = flash_attention_lse_ref(q, k, v, kv_len, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kv_len, ctx.kw = kv_len, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if ctx.cuda else flash_attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.kv_len, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_len=None, *, causal=True, window=None, impl=None,
                    p_dtype=None):
    """q (B, H, Sq, D), k / v (B, KVH, Sk, D) -> (B, H, Sq, D).

    ``impl="ref"`` forces the plain version; otherwise a CUDA tensor takes
    the kernel and a CPU tensor the plain version.  With grad enabled and
    an input that requires grad, the call goes through ``FlashAttention``.
    ``p_dtype`` rounds P before P.V (``attn_p_dtype``).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, kv_len, causal, window, impl, p_dtype)
    kw = dict(causal=causal, window=window, p_dtype=p_dtype)
    if backend.resolve(q.device, impl) == "cuda":
        return flash_attention_cuda(q, k, v, kv_len, **kw)
    return flash_attention_ref(q, k, v, kv_len, **kw)
