"""Distributed variants: affine hash maps sharded over the mesh.

The rolling variant hash is a left fold, which looks sequential, but every
row of the stream is an *affine map* ``h -> h*m + b`` over uint32 (real
rows: ``(BASE, act+1)``; ghost rows of pruned scans: the composed
per-segment sketch maps of ``core.polyhash``; padding rows: the identity).
Affine maps compose associatively, so the fold shards:

1. each shard runs the segmented affine scan twice, seeded with ``h=0``
   and ``h=1``; the two evaluations of an affine function recover its
   coefficients, ``ys(h) = mr*h + ys0`` with ``mr = ys1 - ys0`` (``mr``
   self-zeroes at the first segment restart inside the shard);
2. one ``all_gather`` of each shard's whole-shard map ``(mr[-1],
   ys0[-1])`` and an O(shards) fold give every shard its true incoming
   carry: no halo depth constraint, a shard may hold less than a case;
3. per-row hashes ``mr*h_in + ys0``; each case's hash at its end row is
   scattered by global segment id (``segment_reduce`` max on the uint32
   route) and one ``psum`` assembles the fingerprint table (every end row
   lives on exactly one shard, so each slot has one nonzero term).

uint32 as everywhere in the port: the scans take and return int32 bit
patterns; the fold and the per-row hashes are int64 values in [0, 2^32),
every product and difference taken mod 2^32 (``_mul32`` keeps products
below 2^49).  Bitwise equal to the streaming ``variants_kernel`` and the
whole-log ``variant_fingerprints``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_ops import segment_reduce, segmented_affine
from repro_torch.kernels.segment_ops.ref import M32, _mul32, u32_bits, \
    u32_values

from .mesh import all_gather, psum


def _base_fingerprints(m, b, starts, seg, ends, num_cases: int) -> list:
    """One base's per-case hash table (int32 bit patterns), one copy a
    shard; every argument is a per-shard list."""
    ys0, mr = [], []
    for mi, bi, si in zip(m, b, starts):
        y0 = u32_values(segmented_affine(mi, bi, si, 0)[0])
        y1 = u32_values(segmented_affine(mi, bi, si, 1)[0])
        ys0.append(y0)
        mr.append((y1 - y0) & M32)  # shard-prefix slope (0 after a restart)
    maps = all_gather([torch.stack([r[-1], y[-1]]) for r, y in zip(mr, ys0)])
    fps = []
    for i, g in enumerate(maps):
        h_in = torch.zeros((), dtype=torch.int64, device=g.device)
        for j in range(i):      # compose the preceding shards' maps, in order
            h_in = (_mul32(h_in, g[j, 0]) + g[j, 1]) & M32
        hs = (_mul32(mr[i], h_in) + ys0[i]) & M32   # the true per-row hashes
        vals = torch.where(ends[i], u32_bits(hs), 0).view(torch.uint32)
        fps.append(segment_reduce(vals, seg[i], num_cases, "max")
                   .view(torch.int32))
    return psum(fps)


def run_sharded_variants(m1, b1, m2, b2, starts, seg, ends,
                         num_cases: int) -> list:
    """Per-case ``(fp1, fp2)`` fingerprint tables (int32 bit patterns), one
    pair a shard.  ``starts`` / ``seg`` / ``ends`` are the *global* segment
    markers (host-derived from the padded case column) cut per shard."""
    fp1 = _base_fingerprints(m1, b1, starts, seg, ends, num_cases)
    fp2 = _base_fingerprints(m2, b2, starts, seg, ends, num_cases)
    return list(zip(fp1, fp2))
