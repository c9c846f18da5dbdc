"""Public entry point for fused attention: the CUDA kernel on a card, the
plain version elsewhere, chosen by the tensors' device as
``core.backend.resolve`` chooses for every primitive of the port."""
from __future__ import annotations

from repro_torch.core import backend

from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(q, k, v, kv_len=None, *, causal=True, window=None, impl=None):
    """q (B, H, Sq, D), k / v (B, KVH, Sk, D) -> (B, H, Sq, D).

    ``impl="ref"`` forces the plain version; otherwise a CUDA tensor takes
    the kernel and a CPU tensor the plain version.
    """
    if backend.resolve(q.device, impl) == "cuda":
        return flash_attention_cuda(q, k, v, kv_len, causal=causal, window=window)
    return flash_attention_ref(q, k, v, kv_len, causal=causal, window=window)
