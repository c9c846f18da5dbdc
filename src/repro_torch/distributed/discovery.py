"""Distributed discovery: the discovery chunk-kernel with ``psum`` merge.

Same shape as ``distributed.dfg``: both lowerings run through
``distributed.dfg.run_sharded_kernel`` (init, halo carry, one kernel
update a shard, last-shard end fix, ``psum`` merge).  The only variation
is the halo depth: L2-loop triples (``a, b, a``) can straddle a shard
boundary by *two* rows, so the carry is recovered from each shard's last
two rows.  The miners (``discover_alpha`` / ``discover_heuristics``) run
on the merged state; they are pure finalize and never see events.

Precondition: every shard holds at least two rows (it raises otherwise).
"""
from __future__ import annotations

from repro_torch.core.discovery import (AlphaModel, DiscoveryState,
                                        HeuristicsNet, discover_alpha,
                                        discover_heuristics, discovery_kernel)
from repro_torch.core.eventframe import EventFrame

from .dfg import fix_trailing_end, frame_shards, run_sharded_kernel
from .mesh import Mesh, mesh_for


def _fix_end(state, carry, last_end):
    return {"dfg": fix_trailing_end(state["dfg"], carry, last_end),
            "l2": state["l2"]}


def discovery_state_sharded(frame: EventFrame, num_activities: int,
                            mesh: Mesh) -> DiscoveryState:
    """DFG + L2 counts of a (case, time)-sorted frame sharded over
    ``mesh``; the copy on shard 0's device."""
    case, act, valid = frame_shards(frame, mesh)
    out = run_sharded_kernel(discovery_kernel(num_activities), _fix_end,
                             case, act, valid, halo_depth=2)[0]
    return DiscoveryState(out["dfg"], out["l2"])


def alpha_sharded(frame: EventFrame, num_activities: int, mesh: Mesh,
                  min_count: int = 1) -> AlphaModel:
    """Distributed alpha miner: psum-merged DFG state + host finalize."""
    state = discovery_state_sharded(frame, num_activities, mesh)
    return discover_alpha(state.dfg, min_count)


def heuristics_sharded(frame: EventFrame, num_activities: int, mesh: Mesh,
                       **thresholds) -> HeuristicsNet:
    """Distributed heuristics miner: psum-merged state + dense finalize."""
    state = discovery_state_sharded(frame, num_activities, mesh)
    return discover_heuristics(state, **thresholds)


def discovery_state_sharded_host(frame: EventFrame, num_activities: int,
                                 num_shards: int) -> DiscoveryState:
    """CPU validation path: ``num_shards`` shards, every one on the CPU."""
    return discovery_state_sharded(frame, num_activities,
                                   mesh_for(num_shards, "cpu"))
