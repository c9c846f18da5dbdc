"""Distributed DFG: the streaming chunk-kernel with ``psum`` as its merge.

Events are sharded over the mesh (columns cut into equal contiguous
ranges, as ``P("data")`` cuts them in the JAX package).  Each shard runs
the *same* ``core.dfg.dfg_kernel`` update that the single-shot and
out-of-core paths use; the one-row halo that stitches the pair straddling
a shard boundary is exactly the kernel's carry, recovered from the
previous shard's last row (``mesh.shift_tails``, the ``ppermute``).  The
reduce phase merges the per-shard states with one ``psum`` of the (A, A)
count matrix and the two (A,) histograms: the paper's Spark shuffle
collapses into one all-reduce whose payload is independent of N.

Carry construction and boundary semantics live in ``core.engine`` and are
shared verbatim with the streaming engine, so sharded == streamed ==
single-shot, bitwise.  On a card every shard's update launches the
counting kernels; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfg import DFG, _add_at, dfg_kernel
from repro_torch.core.eventframe import ACTIVITY, CASE, EventFrame

from .mesh import Mesh, mesh_for, psum, shift_tails


def shard_columns(mesh: Mesh, *cols: torch.Tensor) -> list[list[torch.Tensor]]:
    """Each column cut into ``mesh.size`` equal contiguous slices, slice
    *i* copied to shard *i*'s device.  Like ``shard_map``, refuses a row
    count the shard count does not divide."""
    n = mesh.size
    rows = cols[0].shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows do not split into {n} equal shards; "
                         f"pad the frame to a multiple of {n} rows")
    per = rows // n
    return [[c[i * per:(i + 1) * per].to(mesh.devices[i]) for i in range(n)]
            for c in cols]


def frame_shards(frame: EventFrame, mesh: Mesh):
    """A (case, time)-sorted frame's ``(case, act, rows_valid)`` shards."""
    return shard_columns(mesh, frame[CASE], frame[ACTIVITY],
                         frame.rows_valid())


def shard_halo_carry(carry: dict, tail, *, depth: int = 1) -> dict:
    """This shard's carry from the previous shard's last ``depth`` rows
    ``tail = (case, act, valid)`` (``mesh.shift_tails``); shard 0 (``tail
    is None``) keeps the kernel's init carry, whose exists flags are False
    and mask everything.  ``depth=2`` also fills the two-back halo keys of
    ``discovery_kernel`` carries.  Case ids stay int64, as in every carry
    of the port."""
    if tail is None:
        return carry
    case, act, valid = tail
    exists = torch.ones((), dtype=torch.bool, device=case.device)
    carry = dict(carry, case=case[-1].to(torch.int64),
                 act=act[-1].to(torch.int32), rv=valid[-1], exists=exists)
    if depth >= 2:
        carry.update(case2=case[-2].to(torch.int64),
                     act2=act[-2].to(torch.int32), rv2=valid[-2],
                     exists2=exists)
    return carry


def fix_trailing_end(state: DFG, carry: dict, last_end) -> DFG:
    """Resolve the stream's final end activity on the shard that owns it
    (every other shard's trailing end is resolved by its successor)."""
    return DFG(state.counts, state.starts,
               _add_at(state.ends, carry["act"], last_end))


def _check_depth(name: str, rows: int, depth: int) -> None:
    if rows < depth:
        raise ValueError(
            f"{name}: {rows} row(s) per shard < halo depth {depth}; use "
            f"fewer shards or a larger frame")


def _update_shards(kernel, halo, fix_end, case, act, valid) -> list:
    """One kernel update a shard, from its halo carry, then the end fix:
    ``halo(i, carry)`` builds shard *i*'s carry, ``fix_end(state, carry,
    last_end)`` resolves the trailing end on the last shard."""
    n = len(case)
    states = []
    for i in range(n):
        state, carry = kernel.init(case[i].device)
        chunk = EventFrame({CASE: case[i], ACTIVITY: act[i]}, {}, valid[i])
        state, carry = kernel.update(state, halo(i, carry), chunk)
        states.append(fix_end(state, carry, i == n - 1))
    return states


def run_sharded_kernel(kernel, fix_end, case, act, valid, *,
                       halo_depth: int = 1) -> list:
    """Driver shared by the DFG and discovery lowerings over per-shard
    column lists: init, halo carry, one kernel update a shard, last-shard
    end fix, ``psum`` merge (one copy a shard).  Every shard must hold >=
    ``halo_depth`` rows: a tiny frame on a wide mesh raises instead of
    silently clamping the halo index."""
    _check_depth(kernel.name, case[0].shape[0], halo_depth)
    tails = shift_tails(list(zip(case, act, valid)), halo_depth)
    states = _update_shards(
        kernel, lambda i, c: shard_halo_carry(c, tails[i], depth=halo_depth),
        lambda s, c, last: fix_end(s, c, c["rv"] & last), case, act, valid)
    return psum(states)


def run_sharded_composed(kernel, fix_ends: dict, case, act, valid) -> list:
    """Fused multi-state twin of :func:`run_sharded_kernel` for a
    ``core.engine.compose`` kernel: each member's halo at *its* depth (the
    composed carry is a dict of member carries), ONE composed update a
    shard, each member's end fix, one leafwise ``psum``."""
    _, carry0 = kernel.init(case[0].device)
    depths = {m: (2 if "case2" in c else 1) for m, c in carry0.items()}
    _check_depth(kernel.name, case[0].shape[0], max(depths.values()))
    cols = list(zip(case, act, valid))
    tails = {d: shift_tails(cols, d) for d in set(depths.values())}

    def halo(i, carry):
        return {m: shard_halo_carry(c, tails[depths[m]][i], depth=depths[m])
                for m, c in carry.items()}

    def fix(state, carry, last):
        return {m: fix_ends[m](state[m], carry[m], carry[m]["rv"] & last)
                for m in state}

    return psum(_update_shards(kernel, halo, fix, case, act, valid))


def dfg_sharded(frame: EventFrame, num_activities: int, mesh: Mesh) -> DFG:
    """Full DFG (counts + start/end histograms) of a (case, time)-sorted
    frame sharded over ``mesh``; the copy on shard 0's device."""
    case, act, valid = frame_shards(frame, mesh)
    return run_sharded_kernel(dfg_kernel(num_activities), fix_trailing_end,
                              case, act, valid)[0]


def dfg_sharded_host(frame: EventFrame, num_activities: int,
                     num_shards: int) -> DFG:
    """CPU validation path: ``num_shards`` shards, every one on the CPU."""
    return dfg_sharded(frame, num_activities, mesh_for(num_shards, "cpu"))
