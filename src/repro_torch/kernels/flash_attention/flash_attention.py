"""Flash attention forward and backward: the CUDA kernels' wrappers.

The counterpart of the JAX package's ``flash_attention_pallas``: causal
GQA online-softmax attention with an optional sliding window and a ragged
``kv_len``, q (B, H, Sq, D) against k / v (B, KVH, Sk, D), bf16 or float32
in, out in q's dtype.  The kernel (``kernels/csrc/flash_attention.cu``)
gives each 64-row query tile of one head to a block that streams 64-key
K / V tiles through shared memory and keeps the running softmax state in
registers; a KV head serves ``H // KVH`` query heads in place (no
repeated K / V in memory).  bf16 runs both products on the tensor cores
(``wgmma``, float32 accumulators) with K / V fed by TMA, and rounds the
softmax weights P to bf16 before P.V (bf16 keeps 8 significant bits, so
each weight moves by at most 2^-8 of itself); float32 runs both products
on the tensor cores as 3xTF32 (``mma.sync``: each operand split into a
TF32 part and a TF32 remainder, three products summed in float32), each
product within 2^-20 of itself.

Head dims: any ``d`` with ``8 <= d <= 256`` and ``d % 8 == 0``
(``head_dim_ok``), as the JAX kernel states head_dim <= 256; the kernels
are instantiated at 16, 32, 64, 128 and 256 and ``d`` runs on the smallest
one at least ``d``, its columns past ``d`` read as zeros and never stored,
the scale ``d ** -0.5``.  ``p_dtype`` (``attn_p_dtype``) bfloat16 or
float16 rounds P to that type before P.V on the float32 route, the row
sum keeping P unrounded, as the JAX package's chunked attention does; the
backward rounds the recomputed P the same way for dV = P^T dO.  The bf16
route rounds P to bf16 whatever ``p_dtype`` says (float16's 11 bits are
finer than bf16's 8, so the bf16 bound covers it).

Semantics are the JAX kernel's (causal rows counted from 0) except for a
row with no valid column (``kv_len = 0``, or a window that leaves a row
nothing): it is 0 here, as in the JAX package's ``ref.py``; the TPU kernel
returns the mean of V over the tiles it visited there.

Training asks the forward for each row's log-sum-exp as well
(``return_lse=True``), and ``flash_attention_bwd_cuda`` takes it back with
the output's gradient: three kernels (``kernels/csrc/flash_attention_bwd.cu``:
Delta = rowsum(dO o), then dK / dV per 64-key tile summed over each KV
head's query heads, then dQ per 64-row query tile) recompute P from the lse
and write dq, dk and dv once each, with no atomics, so two calls give the
same bits.  This replaces a first version whose products ran as SIMT
float32 loops.  bf16 runs all seven products a tile pair on ``wgmma`` with
the tiles fed by TMA, and rounds P and dS to bf16 before the three
gradient products (dV = P^T dO, dK = dS^T Q, dQ = dS K), where the plain
backward keeps them in float32: a gradient moves by at most 2^-8 of its
magnitude product A (``flash_attention_bwd_magnitudes``), and the card
gate against the plain backward is 2^-7 (1 + |want|) + 2 * 2^-8 A.
float32 runs every product as 3xTF32 on ``mma.sync`` (each within 2^-20
of its magnitude product), gate 1e-5 (1 + |want|) + 2^-19 A, A carrying
dP's error into dS (``dp_error``: dS = P (dP - Delta) cancels).  Both routes
are bounded by the tensor cores' rate on this card (five products' worth
of work is the least; the split does seven).

On a CPU tensor each wrapper takes its plain version (``ref.py``); on CUDA
tensors it launches its kernel on the current stream or raises.
``flash_attention_cuda.launches`` and ``flash_attention_bwd_cuda.launches``
count the calls that launched (a backward call is three kernel nodes and
counts one).

Each launch is a ``torch.library`` custom op (``repro_torch::flash_attention``,
``repro_torch::flash_attention_bwd``) whose CUDA implementation is the
ctypes launch above; its abstract form (``register_fake``) gives the
outputs' shapes on ``meta`` and fake tensors, and its FLOP formula
(``attention_flops``, registered with ``torch.utils.flop_counter``) counts
the products the kernel runs: ``2 * 2 * d`` a (query, key) pair forward and
``5 * 2 * d`` backward, over the pairs its mask admits (causal rows from 0,
the window, ``kv_len``), never an S x S score tensor.  So
``FlopCounterMode`` counts a real step's kernels, and the launch tooling's
dry run (``launch.account``) traces them on tensors with no storage.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
P_ROUND = {None: 0, torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_TAIL = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
         ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def head_dim_ok(d: int) -> bool:
    """Whether the kernels take head dim ``d``: a multiple of 8 from 8 to 256."""
    return 8 <= d <= 256 and d % 8 == 0


def p_round(p_dtype) -> int:
    """The kernels' code for ``p_dtype``; raises on a type they cannot round to."""
    if p_dtype not in P_ROUND:
        raise NotImplementedError(f"flash_attention: p_dtype {p_dtype}; the kernels "
                                  f"round P to one of {tuple(P_ROUND)}")
    return P_ROUND[p_dtype]
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 18 + _TAIL
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 30 + _TAIL


def _launcher(name="flash_attention", symbol="repro_flash_attention", argtypes=_ARGTYPES):
    lib = _build.load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


def _check(q, k, v, window, p_dtype=None):
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
    if not head_dim_ok(d):
        raise ValueError(f"flash_attention: head_dim {d}; the kernels take a multiple "
                         f"of 8 from 8 to 256")
    p_round(p_dtype)
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: inputs on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def _kv_len_args(kv_len_t, kv_len_v: int, sk: int, device):
    """(device pointer or None, value) of ``kv_len`` for the C launchers,
    and the int32 tensor the pointer lives in (kept alive by the caller):
    a CUDA tensor is read on the card, else the int stands."""
    if kv_len_t is not None:
        kv_len = kv_len_t.to(device=device, dtype=torch.int32).reshape(())
        return kv_len.data_ptr(), sk, kv_len
    return None, kv_len_v, None


def _kv_len_parts(kv_len, sk: int):
    """``kv_len`` as the custom ops take it: (a 0-d CUDA tensor or None,
    the int that stands for it otherwise)."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1:
            raise ValueError("flash_attention: kv_len must be a scalar")
        if kv_len.device.type != "cpu":
            return kv_len, sk
        return None, int(kv_len)
    return None, sk if kv_len is None else int(kv_len)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len=None, *, causal: bool = True,
                         window: int | None = None, return_lse: bool = False,
                         p_dtype=None):
    """(B, H, Sq, D) attention output in q's dtype (see module docstring);
    with ``return_lse`` also each row's log-sum-exp of the scaled scores,
    (B, H, Sq) float32, -inf for a row with no valid column.

    ``kv_len`` is None (all of k), an int, or a 0-d integer tensor, read on
    the card without a host sync.  The output has q's memory layout when q
    is dense (a (B, S, H, D) buffer viewed as (B, H, S, D) stays one).  A
    ``meta`` tensor takes the custom op's abstract form.
    """
    _check(q, k, v, window, p_dtype)
    device = q.device
    kw = dict(causal=causal, window=window, p_dtype=p_dtype)
    if device.type == "cpu":
        if return_lse:
            return flash_attention_lse_ref(q, k, v, kv_len, **kw)
        return flash_attention_ref(q, k, v, kv_len, **kw)
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {device}")
    len_t, len_v = _kv_len_parts(kv_len, k.shape[2])
    out, lse = torch.ops.repro_torch.flash_attention(
        q, k, v, len_t, len_v, bool(causal), -1 if window is None else int(window),
        p_round(p_dtype), bool(return_lse))
    return (out, lse) if return_lse else out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len_t: Optional[torch.Tensor], kv_len_v: int, causal: bool,
                        window: int, p_code: int,
                        return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_launch(q, k, v, kv_len_t, kv_len_v, causal, window, p_code,
                                  return_lse)


def flash_attention_launch(q, k, v, kv_len_t, kv_len_v: int, causal: bool, window: int,
                           p_code: int, return_lse: bool):
    """The forward kernel's launch (the custom op's CUDA implementation,
    callable bare); ``lse`` is empty unless asked for."""
    device = q.device
    q, k, v = _readable(q), _readable(k), _readable(v)
    out = _readable(torch.empty_like(q))
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    lse = torch.empty((b, h, sq) if return_lse else (0,), dtype=torch.float32,
                      device=device)
    if out.numel() == 0:
        return out, lse
    len_ptr, len_value, _len = _kv_len_args(kv_len_t, kv_len_v, sk, device)
    lib, fn = _launcher()
    with torch.cuda.device(device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 b, h, kvh, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 len_ptr, len_value, int(causal), window, d ** -0.5, p_code,
                 DTYPES[q.dtype], _build.stream_of(out))
    _build.check(lib, err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out, lse


@_flash_attention_op.register_fake
def _(q, k, v, kv_len_t, kv_len_v, causal, window, p_code, return_lse):
    b, h, sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq) if return_lse else (0,), dtype=torch.float32))


def attention_pairs(sq: int, sk: int, causal: bool, window: int | None,
                    kv_len: int | None = None) -> int:
    """The (query, key) pairs the kernels' mask admits: row i (counted from
    0) sees key j < min(sk, kv_len), j <= i when causal, j > i - window
    with a window."""
    n = sk if kv_len is None else max(0, min(sk, kv_len))
    total = 0
    for i in range(sq):
        hi = min(n, i + 1) if causal else n
        lo = max(0, i - window + 1) if window is not None and window >= 0 else 0
        total += max(0, hi - lo)
    return total


def attention_flops(q_shape, k_shape, causal: bool, window: int | None,
                    kv_len: int | None = None, backward: bool = False) -> int:
    """The products the kernels run: 2 * 2 * d a pair forward (S = Q K^T and
    P V), 5 * 2 * d backward (S again, dP, dV, dK, dQ), over
    ``attention_pairs`` of every (batch, query head); the formula of the
    card's tensor-core bound in ``chip_smoke.py``."""
    b, h, sq, d = q_shape
    per_pair = (5 if backward else 2) * 2 * d
    return per_pair * b * h * attention_pairs(sq, k_shape[2], causal, window, kv_len)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _fwd_flops(q_shape, k_shape, v_shape, kv_len_t, kv_len_v, causal, window, p_code,
               return_lse, *args, **kwargs) -> int:
    return attention_flops(q_shape, k_shape, causal, None if window < 0 else window,
                           None if kv_len_t is not None else kv_len_v)


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_len=None, *, causal: bool = True,
                             window: int | None = None, p_dtype=None):
    """(dq, dk, dv) of ``flash_attention_cuda(q, k, v, kv_len, causal=...,
    window=...)`` at its output ``o`` and log-sum-exp ``lse``, given the
    output's gradient ``do`` (B, H, Sq, D).  Each gradient has its input's
    dtype, shape and, for a dense input, memory layout; dk and dv are
    summed over each KV head's query heads.  One call launches three
    kernels on the current stream and counts one launch; with no query row
    or no key every gradient is 0 and nothing launches (TMA takes no empty
    dimension).  A ``meta`` tensor takes the custom op's abstract form."""
    _check(q, k, v, window, p_dtype)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}; "
                         f"expected {tuple(q.shape[:3])} float32")
    device = q.device
    if not all(t.device == device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: inputs on different devices")
    if device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, kv_len, causal=causal,
                                       window=window, p_dtype=p_dtype)
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device {device}")
    len_t, len_v = _kv_len_parts(kv_len, k.shape[2])
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, o, lse, do, len_t, len_v, bool(causal),
        -1 if window is None else int(window), p_round(p_dtype))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            kv_len_t: Optional[torch.Tensor], kv_len_v: int, causal: bool,
                            window: int,
                            p_code: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_attention_bwd_launch(q, k, v, o, lse, do, kv_len_t, kv_len_v, causal,
                                      window, p_code)


def flash_attention_bwd_launch(q, k, v, o, lse, do, kv_len_t, kv_len_v: int, causal: bool,
                               window: int, p_code: int):
    """The backward kernels' launch (three kernel nodes, one count; the
    custom op's CUDA implementation, callable bare)."""
    device = q.device
    q, k, v, o, do = (_readable(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = (_readable(torch.empty_like(t)) for t in (q, k, v))
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if dq.numel() == 0 or dk.numel() == 0:
        # no row or no key: every gradient is 0, and no kernel runs
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=device)
    len_ptr, len_value, _len = _kv_len_args(kv_len_t, kv_len_v, sk, device)
    lib, fn = _launcher("flash_attention_bwd", "repro_flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, kvh, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
                 len_ptr, len_value, int(causal), window, d ** -0.5, p_code,
                 DTYPES[q.dtype], _build.stream_of(dq))
    _build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


@_flash_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, kv_len_t, kv_len_v, causal, window, p_code):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, kv_len_t, kv_len_v,
               causal, window, p_code, *args, **kwargs) -> int:
    return attention_flops(q_shape, k_shape, causal, None if window < 0 else window,
                           None if kv_len_t is not None else kv_len_v, backward=True)


flash_attention_bwd_cuda.launches = 0
