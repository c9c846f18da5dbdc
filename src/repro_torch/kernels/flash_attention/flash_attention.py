"""Flash attention forward: the CUDA kernel's wrapper.

The counterpart of the JAX package's ``flash_attention_pallas``: causal
GQA online-softmax attention with an optional sliding window and a ragged
``kv_len``, q (B, H, Sq, D) against k / v (B, KVH, Sk, D), bf16 or float32
in, out in q's dtype.  The kernel (``kernels/csrc/flash_attention.cu``)
gives each 64-row query tile of one head to a block that streams 64-key
K / V tiles through shared memory and keeps the running softmax state in
registers; a KV head serves ``H // KVH`` query heads in place (no
repeated K / V in memory).  bf16 runs both products on the tensor cores
(``wgmma``, float32 accumulators) with K / V fed by TMA, and rounds the
softmax weights P to bf16 before P.V (each weight within 2^-9 of itself);
float32 runs both products on the tensor cores as 3xTF32 (``mma.sync``:
each operand split into a TF32 part and a TF32 remainder, three products
summed in float32), each product within 2^-20 of itself.

Semantics are the JAX kernel's (causal rows counted from 0) except for a
row with no valid column (``kv_len = 0``, or a window that leaves a row
nothing): it is 0 here, as in the JAX package's ``ref.py``; the TPU kernel
returns the mean of V over the tiles it visited there.

On a CPU tensor the wrapper takes the plain version
(``ref.flash_attention_ref``); on CUDA tensors it launches the kernel on
the current stream or raises.  ``flash_attention_cuda.launches`` counts
the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 18
             + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib, fn


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place, else a dense copy.

    A unit last stride always.  float32 rows are read as 4-element vectors:
    strides in multiples of 4 and a 16-byte-aligned base.  bf16 goes through
    TMA, which takes a 16-byte-aligned base and strides in multiples of 16
    bytes (8 elements), nonzero wherever a dimension is longer than 1."""
    if t.dtype == torch.bfloat16:
        ok = all(s % 8 == 0 and (s > 0 or n == 1)
                 for s, n in zip(t.stride()[:3], t.shape[:3]))
    else:
        ok = all(s % 4 == 0 for s in t.stride()[:3])
    if t.stride(-1) == 1 and ok and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"flash_attention: {h} query heads over {k.shape[1]} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"the kernel takes one of {tuple(DTYPES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d}; the kernel takes {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: inputs on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len=None, *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """(B, H, Sq, D) attention output in q's dtype (see module docstring).

    ``kv_len`` is None (all of k), an int, or a 0-d integer tensor, read on
    the card without a host sync.  The output has q's memory layout when q
    is dense (a (B, S, H, D) buffer viewed as (B, H, S, D) stays one).
    """
    _check(q, k, v, window)
    device = q.device
    if device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_len, causal=causal, window=window)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {device}")
    q, k, v = _readable(q), _readable(k), _readable(v)
    out = _readable(torch.empty_like(q))
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if out.numel() == 0:
        return out
    len_ptr, len_value = None, sk
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1:
            raise ValueError("flash_attention: kv_len must be a scalar")
        if kv_len.device.type == "cuda":
            kv_len = kv_len.to(device=device, dtype=torch.int32).reshape(())
            len_ptr = kv_len.data_ptr()
        else:
            len_value = int(kv_len)
    elif kv_len is not None:
        len_value = int(kv_len)
    lib, fn = _launcher()
    with torch.cuda.device(device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, kvh, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 len_ptr, len_value, int(bool(causal)),
                 -1 if window is None else int(window), d ** -0.5,
                 DTYPES[q.dtype], _build.stream_of(out))
    _build.check(lib, err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
