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
from .polyhash import BASE1 as _BASE1, BASE2 as _BASE2, M32
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


def _umax_slot(vec: torch.Tensor, slot: int, val: torch.Tensor) -> torch.Tensor:
    """``vec.at[slot].max(val, mode="drop")`` for a host ``slot``, into a new
    tensor (``vec`` is a merged state's and is never written)."""
    out = vec.clone()
    if 0 <= slot < out.shape[0]:
        out[slot:slot + 1] = _umax(out[slot:slot + 1], val.reshape(1))
    return out


def _set_slot(vec: torch.Tensor, slot: int, val: int) -> torch.Tensor:
    """``vec.at[slot].set(val, mode="drop")`` for a host ``slot``, into a new
    tensor."""
    out = vec.clone()
    if 0 <= slot < out.shape[0]:
        out[slot] = val
    return out


def _bits(h: int) -> int:
    """A uint32 value as the int32 bit pattern the state holds."""
    return h - (1 << 32) if h >= 1 << 31 else h


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

    def stitch(ctx):
        afp1, afp2 = ctx.a.state
        bfp1, bfp2 = ctx.b.state
        off = ctx.offset
        ac = ctx.a.carry
        if not ctx.straddle:
            # the concatenation closes a's open case at b's first row
            # (new_seg): the deferred carry hash lands in a's last slot —
            # exactly the carry-close scatter update() runs at chunk joins
            slot = ctx.a.segments - 1
            afp1 = _umax_slot(afp1, slot, ac["h1"])
            afp2 = _umax_slot(afp2, slot, ac["h2"])
            return (_umax(afp1, engine.shift_segments(bfp1, off)),
                    _umax(afp2, engine.shift_segments(bfp2, off))), {}
        # the boundary splits one case: b's fresh fold hashed its lead run
        # from h=0, but the true hash threads a's open carry through the
        # lead run's composed affine map (validity-blind — for ghost units
        # the map came from header sketches, same bits either way).  The
        # carry is a uint32 bit pattern: read it unsigned before the map.
        m1, a1, m2, a2 = ctx.b.head["affine"]
        h1c = _bits((m1 * (int(ac["h1"]) & M32) + a1) & M32)
        h2c = _bits((m2 * (int(ac["h2"]) & M32) + a2) & M32)
        sb1 = engine.shift_segments(bfp1, off)
        sb2 = engine.shift_segments(bfp2, off)
        if ctx.b.segments > 1:
            # the straddling case closed inside b: rewrite its slot with
            # the corrected hash (a's fold left that slot untouched, and
            # b's slot 0 held the seed-0 hash)
            sb1 = _set_slot(sb1, off, h1c)
            sb2 = _set_slot(sb2, off, h2c)
            return (_umax(afp1, sb1), _umax(afp2, sb2)), {}
        # b is entirely the straddling case — still open; fix the carry
        dev = ac["h1"].device
        return (_umax(afp1, sb1), _umax(afp2, sb2)), {
            "h1": torch.tensor(h1c, dtype=torch.int32, device=dev),
            "h2": torch.tensor(h2c, dtype=torch.int32, device=dev)}

    # hashing ignores row validity (whole-log parity); pruning stays exact
    # because ghost chunks carry the skipped runs' composed sketch maps
    # (ghost_sketch=True asks the query layer to attach them)
    return engine.ChunkKernel(f"variants[{num_cases},{impl or 'auto'}]",
                              init, update, merge, finalize,
                              columns=(ACTIVITY, CASE), ghost_sketch=True,
                              stitch=stitch)


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
    sharded_state="variants",
    from_sharded=lambda state, **_: state,
    doc="per-case variant fingerprints (validity-blind hashing; ghost chunks "
        "fold skipped runs' composed sketch maps)"))
