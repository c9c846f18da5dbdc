"""Distributed pruned scans: the surviving row groups sharded over a mesh.

The query layer's pruned stream (``repro_torch.query.exec.pruned_source``)
collapses zone-map-refuted row groups to O(segments) ghost rows; this
module decodes that stream on the host and concatenates it (as the JAX
package concatenates it in numpy), cuts it into equal contiguous shards,
copies each shard once to its device and reuses the ``distributed.dfg``
drivers verbatim: one kernel update a shard, the boundary row recovered as
the halo, the mergeable state combined with one ``psum``.  Ghost rows ride
along as ordinary all-masked rows, so the halo a shard hands its successor
is exactly the carry the streaming path would have built, and sharded ==
streamed == filter-then-mine, bitwise.

The one boundary the shards cannot resolve is the *stream's* final end
activity: the last physical row is padding (all-masked), so the trailing
end is re-applied from the true tail row after the ``psum``.

**Fused collection** (:func:`query_sharded_multi`) mines several *distinct*
mergeable states (``"dfg"``, ``"discovery"``, ``"variants"``) from ONE
gathered stream: the halo-carry state kernels are ``core.engine.compose``-d
(each member's halo at its own depth), and variants rides beside them with
its own lowering (``distributed.variants``: per-row affine hash maps and an
``all_gather`` boundary fold, so ghost rows and shards smaller than a case
both work).  ``query_sharded_dfg`` / ``query_sharded_discovery`` are its
single-state special cases.

:func:`merge_tree_sharded` shards every other stitchable verb as a literal
merge-tree instance of the group-state algebra.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.dfg import DFG, dfg_kernel
from repro_torch.core.discovery import DiscoveryState, discovery_kernel
from repro_torch.core.eventframe import ACTIVITY, CASE
from repro_torch.core.polyhash import BASE1, BASE2, SKETCH_COLUMNS, SK_MUL1
from repro_torch.kernels.segment_ops.ref import u32_values
from repro_torch.query.exec import pruned_source
from repro_torch.query.plan import MultiPlan, Plan

from .dfg import fix_trailing_end, run_sharded_composed, shard_columns
from .discovery import _fix_end as fix_discovery_end
from .mesh import Mesh, mesh_for
from .variants import run_sharded_variants

# every halo-carry distributed lowering a KernelSpec.sharded_state can name:
# state name -> (kernel factory(num_activities, method), shard-end fix)
STATE_DRIVERS = {
    "dfg": (dfg_kernel, fix_trailing_end),
    "discovery": (discovery_kernel, fix_discovery_end),
}

# every sharded state, halo-carry or bespoke ("variants" gathers affine
# hash maps and folds shard boundaries with an all_gather)
SHARDED_STATES = frozenset(STATE_DRIVERS) | {"variants"}


def _bits(col: torch.Tensor) -> np.ndarray:
    """A uint32 sketch column as int32 bit patterns, on the host."""
    if col.dtype == torch.uint32:
        return col.view(torch.int32).numpy()
    return col.to(torch.int32).numpy()


def _gather(plan: "Plan | MultiPlan", prune: bool, sketch: bool = False):
    """The pruned stream's (case int64, activity int32, rows_valid),
    decoded on the host and concatenated.

    Multi-file plans concatenate every file's pruned scan in path order, so
    the shards of a dataset-wide mine see one contiguous sorted log with
    ghost rows standing in for every skipped row group of every file.  With
    ``sketch`` the gather also returns per-row affine hash maps ``(m1, b1,
    m2, b2)`` as int32 bit patterns: real rows hash as ``(BASE, act+1)``,
    ghost rows carry their composed sketch maps.
    """
    src, report = pruned_source(plan.project((ACTIVITY, CASE)), prune=prune,
                                mask_exact=True, sketch=sketch, device="cpu")
    case_parts, act_parts, rv_parts, map_parts = [], [], [], []
    for chunk in src:
        if chunk.nrows == 0:
            continue
        case_parts.append(chunk[CASE].numpy().astype(np.int64, copy=False))
        act = chunk[ACTIVITY].numpy().astype(np.int32, copy=False)
        act_parts.append(act)
        rv_parts.append(chunk.rows_valid().numpy())
        if sketch:
            if SK_MUL1 in chunk:
                map_parts.append(tuple(_bits(chunk[c])
                                       for c in SKETCH_COLUMNS))
            else:
                v = act + 1
                map_parts.append((np.full(v.shape, BASE1, np.int32), v,
                                  np.full(v.shape, BASE2, np.int32), v))
    if not case_parts:
        maps = tuple(np.zeros(0, np.int32) for _ in range(4)) \
            if sketch else None
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, bool), maps, report)
    maps = tuple(np.concatenate([p[i] for p in map_parts])
                 for i in range(4)) if sketch else None
    return (np.concatenate(case_parts), np.concatenate(act_parts),
            np.concatenate(rv_parts), maps, report)


def _pad_to_shards(case, act, rv, n_dev: int, maps=None):
    """Pad with >= 1 all-masked copies of the last row so every shard is
    equally sized and the trailing end is *never* resolved on a shard.
    Hash map padding is the *identity* map (1, 0): the padded rows extend
    the final case without touching its hash."""
    if case.shape[0] == 0:
        case = np.zeros(1, np.int64)
        act = np.zeros(1, np.int32)
        rv = np.zeros(1, bool)
        if maps is not None:
            maps = tuple(np.zeros(1, np.int32) for _ in range(4))
    pad = (-(case.shape[0] + 1)) % n_dev + 1
    case = np.concatenate([case, np.full(pad, case[-1], case.dtype)])
    act = np.concatenate([act, np.full(pad, act[-1], act.dtype)])
    rv = np.concatenate([rv, np.zeros(pad, bool)])
    if maps is not None:
        maps = tuple(np.concatenate([m, np.full(pad, 1 - i % 2, np.int32)])
                     for i, m in enumerate(maps))
    return case, act, rv, maps


def _segment_markers(case):
    """Global ``(starts, seg, ends)`` of the padded case column: the
    variants lowering's segment geometry (derived once on the host, cut
    per shard)."""
    n = case.shape[0]
    starts = np.zeros(n, bool)
    starts[0] = True
    starts[1:] = case[1:] != case[:-1]
    seg = np.cumsum(starts, dtype=np.int64).astype(np.int32) - 1
    ends = np.zeros(n, bool)
    ends[:-1] = starts[1:]
    ends[-1] = True
    return starts, seg, ends


def _apply_tail_end(dfg: DFG, tail) -> DFG:
    if tail is None or not tail[2]:
        return dfg
    ends = dfg.ends.clone()
    if 0 <= tail[1] < ends.shape[0]:
        ends[tail[1]] += 1
    return DFG(dfg.counts, dfg.starts, ends)


def _finish_state(name: str, state, tail):
    """The tail fix per distributed state (the stream's true last row is
    padding on the shards; see module docstring)."""
    if name == "dfg":
        return _apply_tail_end(state, tail)
    if name == "discovery":
        return DiscoveryState(_apply_tail_end(state["dfg"], tail),
                              state["l2"])
    if name == "variants":
        return state            # no end-activity concept, nothing to fix
    raise KeyError(f"no distributed lowering named {name!r}; "
                   f"known: {sorted(SHARDED_STATES)}")


def query_sharded_multi(plan: "Plan | MultiPlan", states,
                        num_activities: int, mesh: Mesh, *,
                        prune: bool = True, method: str = "auto",
                        num_cases: int | None = None):
    """Mine every distributed state in ``states`` (distinct names from
    :data:`SHARDED_STATES`) from ONE gathered pruned stream: one copy of
    each shard's slice to its device, one composed update a shard, the
    variants lowering beside it, one ``psum``.  Returns ``({state_name:
    state}, ScanReport)``, each state on shard 0's device and bitwise
    equal to its separate ``query_sharded_*`` run.  ``"variants"`` needs
    ``num_cases`` (its fingerprint table capacity) and yields ``(fp1, fp2,
    ncases)`` like the streaming kernel's finalize."""
    states = tuple(dict.fromkeys(states))       # dedupe, keep order
    unknown = set(states) - SHARDED_STATES
    if not states or unknown:
        raise KeyError(f"distributed states must be a non-empty subset of "
                       f"{sorted(SHARDED_STATES)}; got {list(states)}")
    want_var = "variants" in states
    if want_var and num_cases is None:
        raise ValueError("states including 'variants' need num_cases= "
                         "(the fingerprint table capacity)")
    halo_states = tuple(s for s in states if s in STATE_DRIVERS)
    case, act, rv, maps, report = _gather(plan, prune, sketch=want_var)
    tail = (int(case[-1]), int(act[-1]), bool(rv[-1])) if case.size else None
    empty = case.size == 0
    case, act, rv, maps = _pad_to_shards(case, act, rv, mesh.size, maps)
    var_dev = want_var and num_cases > 0
    out = {}
    dev = mesh.devices[0]
    if halo_states or var_dev:
        cols = [case, act, rv]
        if var_dev:
            starts, seg, ends = _segment_markers(case)
            ncases_seen = 0 if empty else int(seg[-1]) + 1
            cols += [*maps, starts, seg, ends]
        shards = shard_columns(mesh, *(torch.from_numpy(c) for c in cols))
        if halo_states:
            kernel = engine.compose({s: STATE_DRIVERS[s][0](num_activities,
                                                            method)
                                     for s in halo_states})
            out.update(run_sharded_composed(
                kernel, {s: STATE_DRIVERS[s][1] for s in halo_states},
                *shards[:3])[0])
        if var_dev:
            fp1, fp2 = run_sharded_variants(*shards[3:], num_cases)[0]
            out["variants"] = (u32_values(fp1), u32_values(fp2), torch.tensor(
                min(ncases_seen, num_cases), dtype=torch.int32, device=dev))
    if want_var and not var_dev:
        zero = torch.zeros(0, dtype=torch.int64, device=dev)
        out["variants"] = (zero, zero, torch.zeros((), dtype=torch.int32,
                                                   device=dev))
    return {s: _finish_state(s, out[s], tail) for s in states}, report


def merge_tree_sharded(plan: "Plan | MultiPlan", kernel, num_shards: int,
                       *, prune: bool = True, prefetch: int | None = None,
                       device="cuda"):
    """Shard a pruned scan as a merge tree over the group-state algebra.

    The halo + ``psum`` drivers above are a lowering only states with
    hand-written distributed drivers have.  With mergeable group states
    (``core.engine.GroupState``) the ``psum`` *is* a merge-tree instance:
    split the pruned chunk stream into ``num_shards`` contiguous spans,
    fold each span fresh on ``device`` (what a shard's local pass
    computes), ``merge_tree`` the span states and finalize once.  Every
    kernel with a ``stitch`` gains a sharded schedule this way (case sizes,
    durations, activity counts, eventually-follows), bitwise equal to the
    streamed fold.  Returns ``(result, ScanReport)``.
    """
    if not engine.mergeable(kernel):
        raise ValueError(f"kernel {kernel.name!r} defines no stitch — no "
                         f"merge-tree sharding (and no distributed state)")
    src, report = pruned_source(
        plan, prune=prune, mask_exact=getattr(kernel, "mask_exact", True),
        sketch=getattr(kernel, "ghost_sketch", False), prefetch=prefetch,
        device=device)
    chunks = [c for c in src if c.nrows]
    n = max(int(num_shards), 1)
    bounds = np.linspace(0, len(chunks), n + 1).round().astype(int)
    states = [engine.fold_group(kernel, chunks[lo:hi], device)
              for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    merged = engine.merge_tree(kernel, states, device)
    return engine.finalize_group(kernel, merged), report


def query_sharded_dfg(plan: "Plan | MultiPlan", num_activities: int,
                      mesh: Mesh, *, prune: bool = True,
                      method: str = "auto"):
    """Full DFG of a filtered log, mined from the pruned scan sharded over
    ``mesh``.  Returns ``(DFG, ScanReport)``; counts/starts/ends are
    bitwise equal to ``dfg(filter(read(path)))``."""
    out, report = query_sharded_multi(plan, ("dfg",), num_activities, mesh,
                                      prune=prune, method=method)
    return out["dfg"], report


def query_sharded_discovery(plan: "Plan | MultiPlan", num_activities: int,
                            mesh: Mesh, *, prune: bool = True,
                            method: str = "auto"):
    """DFG + L2-loop discovery state over the pruned, sharded scan (feeds
    ``discover_alpha`` / ``discover_heuristics``)."""
    out, report = query_sharded_multi(plan, ("discovery",), num_activities,
                                      mesh, prune=prune, method=method)
    return out["discovery"], report


def query_sharded_dfg_host(plan: "Plan | MultiPlan", num_activities: int,
                           num_shards: int, **kw):
    """CPU validation path: ``num_shards`` shards, every one on the CPU."""
    return query_sharded_dfg(plan, num_activities,
                             mesh_for(num_shards, "cpu"), **kw)


def query_sharded_discovery_host(plan: "Plan | MultiPlan",
                                 num_activities: int, num_shards: int, **kw):
    """CPU validation path, as :func:`query_sharded_dfg_host`."""
    return query_sharded_discovery(plan, num_activities,
                                   mesh_for(num_shards, "cpu"), **kw)
