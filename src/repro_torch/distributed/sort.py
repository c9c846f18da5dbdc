"""Distributed sort-by-case: all-to-all bucket exchange.

The paper's shifting-and-counting *assumes the dataframe is sorted by case
id*.  At cluster scale the log arrives time-ordered and distributed, so the
sort itself must be distributed: each shard buckets its events by ``case %
n_shards``, an ``all_to_all`` exchanges the buckets (each case lands wholly
on one shard), and a local lexsort finishes.  One collective pass, O(N/p
log N/p) local work.

Fixed bucket capacity, as in the JAX package: ``cap = int(N/p * slack / p
+ 1)`` slots per (source, destination) pair; overflow is detected and
reported (``slack=2`` by default).  At overflow the clamped scatter writes
several rows into slot ``cap - 1`` in no defined order, so only the flag
is meaningful then.
"""
from __future__ import annotations

import torch

from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame

from .dfg import shard_columns
from .mesh import Mesh, all_to_all, pmax


def _bucketize(case, act, ts, n: int, cap: int):
    """One shard's ``(n, cap)`` buckets of ``case % n`` (fill -1 / -1 /
    inf) and its overflow flag."""
    tgt = (case % n).long()                                 # destination
    # (n, rows): the scan runs along the contiguous axis (a cumsum down the
    # rows of a (rows, n) one-hot is n sequential scans on a card)
    onehot = torch.nn.functional.one_hot(tgt, n).to(torch.int32).T.contiguous()
    pos = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
    slot = pos[tgt, torch.arange(tgt.shape[0], device=tgt.device)].long()
    overflow = (slot >= cap).any().to(torch.int32)
    slot = torch.clamp(slot, max=cap - 1)
    out = []
    for x, fill in ((case, -1), (act, -1), (ts, float("inf"))):
        buf = torch.full((n, cap), fill, dtype=x.dtype, device=x.device)
        buf[tgt, slot] = x
        out.append(buf)
    return out, overflow


def _local_sort(bc, ba, bt):
    """Flatten the received buckets and lexsort them: case major, ts
    minor, stable (as ``jnp.lexsort((ts, case))``)."""
    cc, aa, tt = bc.reshape(-1), ba.reshape(-1), bt.reshape(-1)
    order = torch.sort(tt, stable=True).indices
    order = order[torch.sort(cc[order], stable=True).indices]
    return cc[order], aa[order], tt[order]


def sort_by_case_sharded(frame: EventFrame, mesh: Mesh, slack: float = 2.0):
    """Returns per-shard lists ``(case, act, ts)`` of case-sorted arrays
    (shard *i* on its device; their concatenation is the JAX package's
    sharded output) and the overflow flag (0-d int32 on shard 0's device).

    Empty slots carry case == -1 and sort to the front of each shard; they
    never equal a real case id."""
    n = mesh.size
    cap = int(frame.nrows // n * slack / n + 1)
    case, act, ts = shard_columns(
        mesh, frame[CASE].to(torch.int32), frame[ACTIVITY].to(torch.int32),
        frame[TIMESTAMP].to(torch.float32))
    bucks, flags = zip(*(_bucketize(c, a, t, n, cap)
                         for c, a, t in zip(case, act, ts)))
    overflow = pmax(list(flags))[0]
    got = [all_to_all([b[k] for b in bucks]) for k in range(3)]
    out = [_local_sort(*cols) for cols in zip(*got)]
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out],
            overflow)
