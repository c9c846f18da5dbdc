"""Variants (distinct activity sequences per case) on EventFrames.

The paper lists "statistics for cases/variants" among the dataframe-specific
techniques taken into PM4Py.  A variant is the sequence of activities of a
case; it is fingerprinted with *two* independent 32-bit polynomial rolling
hashes — O(N), no per-case Python loop.  Collision probability ~
n_cases^2 / 2^64.

Both inner loops are ``repro_torch.kernels.segment_ops`` primitives: the
rolling hash is ``segmented_scan(op="polyhash")`` (uint32 arithmetic is
exact mod 2^32, so the CUDA kernel and the plain fold are bitwise
identical), and scattering each case's fingerprint at its last event is an
unsigned ``segment_reduce(op="max")`` over the global segment ids.  The
scan is a left fold, so it streams: :func:`variants_kernel` carries the
open case's hash state across chunk boundaries (``core.engine``) — the
whole-log ``variant_fingerprints`` is the single-chunk special case.

uint32 in this module: the state and the carry's ``h1``/``h2`` are int32
tensors holding the uint32 bit patterns (what the kernels read and write);
the fingerprints handed to the caller are int64 values in ``[0, 2^32)``,
numerically the JAX package's uint32 fingerprints.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.kernels.segment_ops import (segment_reduce, segmented_affine,
                                             segmented_scan)
from repro_torch.kernels.segment_ops.ref import u32_values

from . import engine, ops
from .eventframe import ACTIVITY, CASE, EventFrame
from .polyhash import BASE1 as _BASE1, BASE2 as _BASE2
from .polyhash import SK_ADD1, SK_ADD2, SK_MUL1, SK_MUL2
from .stats import _impl, _seg_carry

_SIGN = -2**31          # flips the sign bit: unsigned order as signed order


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned max of uint32 bit patterns held in int32."""
    return torch.where((a ^ _SIGN) < (b ^ _SIGN), b, a)


def _umax_at_(vec: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``vec.at[idx].max(val, mode="drop")`` on uint32 bit patterns, in place,
    for a 0-d ``idx`` and with no host sync.  An out-of-range index (``-1``
    before the first case) is sent to slot 0 with the value 0, which an
    unsigned max ignores: the update is dropped, where a torch index of -1
    would wrap to the last slot."""
    n = vec.shape[0]
    if n == 0:
        return vec
    i = idx.long().reshape(1)
    ok = (i >= 0) & (i < n)
    i = torch.where(ok, i, 0)
    v = torch.where(ok, val.reshape(1).to(vec.dtype), 0)
    return vec.index_put_((i,), _umax(vec[i], v))


def _sketch(chunk: EventFrame, name: str) -> torch.Tensor:
    col = chunk[name]
    return col.view(torch.int32) if col.dtype == torch.uint32 else col.to(torch.int32)


def _hash_scan(act: torch.Tensor, starts: torch.Tensor, h0, impl: str | None):
    """Segmented rolling hash pair ``h <- h * BASE + (act + 1)`` (mod 2^32),
    restarting where ``starts`` is set; ``h0 = (h1, h2)`` (int32 bit
    patterns) seeds the first segment.  Returns ``((e1, e2), (hs1, hs2))`` —
    final carries + per-row inclusive hashes, bitwise the sequential fold."""
    a = act.to(torch.int32) + 1
    hs1, e1 = segmented_scan(a, starts, h0[0], "polyhash", base=_BASE1,
                             impl=impl)
    hs2, e2 = segmented_scan(a, starts, h0[1], "polyhash", base=_BASE2,
                             impl=impl)
    return (e1, e2), (hs1, hs2)


def _case_max(hs: torch.Tensor, ends: torch.Tensor, seg: torch.Tensor,
              num_cases: int, impl: str | None) -> torch.Tensor:
    """Each case's hash at its last row (unsigned ``segment_reduce`` max;
    cases with no end in the rows hold 0)."""
    vals = torch.where(ends, hs, 0).view(torch.uint32)
    return segment_reduce(vals, seg, num_cases, "max", impl=impl).view(torch.int32)


# ------------------------------------------------------------ chunk kernel
def variants_kernel(num_cases: int, backend: str | None = None) -> engine.ChunkKernel:
    """Per-case variant fingerprints as a mergeable chunk-kernel.

    State: ``(fp1, fp2)`` uint32 bit patterns indexed by global segment id.
    Carry: the open case's rolling hash pair + its segment id.  A case's
    fingerprint is scattered when its last event is identified — within the
    chunk, at the next chunk's first row, or at ``finalize`` for the final
    case of the stream.  Hashing ignores row validity, matching the
    whole-log ``variant_fingerprints``.  A ghost chunk (one row per case
    segment of a skipped run, carrying the segments' composed affine maps in
    the ``polyhash.SK_*`` columns) is folded through ``segmented_affine``
    instead of hashing rows, reproducing the skipped runs' hashes bitwise.
    """
    return _variants_kernel(num_cases, _impl(backend))


@lru_cache(maxsize=None)
def _variants_kernel(num_cases: int, impl: str | None) -> engine.ChunkKernel:

    def init(device):
        state = (torch.zeros(num_cases, dtype=torch.int32, device=device),
                 torch.zeros(num_cases, dtype=torch.int32, device=device))
        carry = _seg_carry(device)
        carry["h1"] = torch.zeros((), dtype=torch.int32, device=device)
        carry["h2"] = torch.zeros((), dtype=torch.int32, device=device)
        return state, carry

    def update(state, carry, chunk):
        fp1, fp2 = state
        adj = engine.adjacent(chunk, carry)
        seg = engine.global_segments(adj, carry)
        if SK_MUL1 in chunk:
            # ghost chunk: each row is a whole case run collapsed to its
            # composed affine map (padding rows are the identity) — fold
            # the maps instead of hashing rows
            hs1, e1 = segmented_affine(_sketch(chunk, SK_MUL1),
                                       _sketch(chunk, SK_ADD1), adj.new_seg,
                                       carry["h1"], impl=impl)
            hs2, e2 = segmented_affine(_sketch(chunk, SK_MUL2),
                                       _sketch(chunk, SK_ADD2), adj.new_seg,
                                       carry["h2"], impl=impl)
        else:
            (e1, e2), (hs1, hs2) = _hash_scan(adj.act, adj.new_seg,
                                              (carry["h1"], carry["h2"]), impl)
        # in-chunk case ends: rows whose successor starts a new segment
        ends = torch.cat([adj.new_seg[1:],
                          torch.zeros(1, dtype=torch.bool, device=seg.device)])
        fp1 = _umax(fp1, _case_max(hs1, ends, seg, num_cases, impl))
        fp2 = _umax(fp2, _case_max(hs2, ends, seg, num_cases, impl))
        # the carry case ended iff this chunk opens a new segment at row 0
        closed = adj.new_seg[0] & carry["exists"]
        _umax_at_(fp1, carry["seg"], torch.where(closed, carry["h1"], 0))
        _umax_at_(fp2, carry["seg"], torch.where(closed, carry["h2"], 0))
        carry = engine.next_row_carry(carry, chunk, seg=seg[-1], h1=e1, h2=e2)
        return (fp1, fp2), carry

    def merge(a, b):
        return (_umax(a[0], b[0]), _umax(a[1], b[1]))

    def finalize(state, carry):
        """Returns (fp1, fp2, ncases): int64 fingerprints in [0, 2^32) and
        the number of segments seen (a 0-d tensor)."""
        keep = carry["exists"]
        fp1, fp2 = (
            u32_values(_umax_at_(fp.clone(), carry["seg"],
                                  torch.where(keep, carry[h], 0)))
            for fp, h in zip(state, ("h1", "h2")))
        return fp1, fp2, torch.clamp(carry["seg"] + 1, min=0)

    return engine.ChunkKernel(f"variants[{num_cases},{impl or 'auto'}]",
                              init, update, merge, finalize,
                              columns=(ACTIVITY, CASE))


# ------------------------------------------------- whole-log entry points
def variant_fingerprints(frame: EventFrame, backend: str | None = None):
    """Per-case (fp1, fp2) fingerprints + segment ids.

    Frame must be sorted by (case, time).  Returns tensors of length nrows;
    entries [0..ncases) of the first two are the per-case fingerprints
    (int64 values in [0, 2^32), scattered by segment id) — the single-chunk
    form of :func:`variants_kernel` with nrows as the case capacity.
    """
    impl = _impl(backend)
    case = frame[CASE]
    seg, starts = ops.segment_ids_sorted(case)
    zero = torch.zeros((), dtype=torch.int32, device=case.device)
    (_, _), (hs1, hs2) = _hash_scan(frame[ACTIVITY], starts, (zero, zero), impl)
    is_end = torch.cat([case[1:] != case[:-1],
                        torch.ones(min(case.shape[0], 1), dtype=torch.bool,
                                   device=case.device)])
    n = hs1.shape[0]
    fp1 = _case_max(hs1, is_end, seg, n, impl)
    fp2 = _case_max(hs2, is_end, seg, n, impl)
    return u32_values(fp1), u32_values(fp2), seg


def _counts_from_fps(fp1, fp2, ncases: int) -> dict[tuple[int, int], int]:
    pairs = np.stack([fp1.cpu().numpy()[:ncases], fp2.cpu().numpy()[:ncases]],
                     axis=1)
    vals, counts = np.unique(pairs, axis=0, return_counts=True)
    return {(int(v[0]), int(v[1])): int(c) for v, c in zip(vals, counts)}


def variant_counts(frame: EventFrame) -> dict[tuple[int, int], int]:
    """Host-side: {fingerprint: number of cases} — the paper's 'Variants'."""
    fp1, fp2, seg = variant_fingerprints(frame)
    ncases = int(seg.max()) + 1 if seg.numel() else 0
    return _counts_from_fps(fp1, fp2, ncases)


def streaming_variant_counts(chunks, num_cases: int) -> dict[tuple[int, int], int]:
    """Out-of-core 'Variants': one pass over the chunk stream."""
    fp1, fp2, ncases = engine.run_streaming(variants_kernel(num_cases), chunks)
    return _counts_from_fps(fp1, fp2, min(int(ncases), num_cases))


engine.register_kernel(engine.KernelSpec(
    "variants",
    make=lambda dims, backend=None: variants_kernel(dims.num_cases, backend),
    columns=(ACTIVITY, CASE),
    doc="per-case variant fingerprints (validity-blind hashing; ghost chunks "
        "fold skipped runs' composed sketch maps)"))
