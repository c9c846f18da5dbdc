"""Graph-query verbs over the :class:`~repro_torch.graph.ir.ProcessGraph` IR.

All three verbs are *finalize-over-state* computations: the heavy part of
a collect is still the one mergeable DFG fold, and the query itself is a
handful of dense (N, N) semiring closures and products on the
``repro_torch.kernels.graph_ops`` primitives (N = alphabet + 2; on a card
each closure is one launch of the closure kernel up to ``CLOSURE_MAX_N``
nodes, the plain versions on the CPU; ``impl="ref"`` forces the plain
versions on either device, as ``impl`` picks the JAX package's lowering).

Exactness contract (what the parity tests assert):

* ``reachability`` — 0/1 operands through the thresholded ``plus_times``
  product: exact, bitwise identical to the JAX package and across the
  kernel / plain lowerings.
* ``bottleneck_paths`` — tropical (min/max) reductions over single-op
  candidates: bitwise across lowerings for any weights; with the default
  frequency weights every value is integer-valued float32, so the
  distances also match a host Floyd–Warshall bit for bit.
* ``node_centrality`` — degrees are exact integer sums; the power-method
  flow vector is a fixed op sequence over the same merged state, so it is
  chunking-invariant, but its ``plus_times`` matvecs and normalizing sums
  add floats in a lowering's own order: across lowerings (and against the
  JAX package) it agrees within float32 rounding, not bitwise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.graph_ops import (bool_closure, maxmin_closure,
                                           minplus_closure, semiring_matmul)

from .ir import ProcessGraph


# ------------------------------------------------------------ reachability
@dataclasses.dataclass(frozen=True)
class Reachability:
    """``mask[i, j]`` — j reachable from i in at most ``k`` edge steps."""

    k: int
    mask: torch.Tensor           # (N, N) bool


def reachability(g: ProcessGraph, k: int | None = None, *,
                 impl: str | None = None) -> Reachability:
    """k-step boolean closure of the observed adjacency (``k=None`` =
    full closure).  Artificial source/sink rows answer "reachable from
    process start" / "can still reach process end"."""
    n = g.num_nodes
    k_eff = max(n - 1, 1) if k is None else max(int(k), 0)
    k_eff = min(k_eff, max(n - 1, 1))
    return Reachability(k=k_eff,
                        mask=bool_closure(g.adjacency, k_eff, impl=impl))


# ------------------------------------------------------- bottleneck paths
@dataclasses.dataclass(frozen=True)
class BottleneckPaths:
    """All-pairs path structure of the process graph.

    ``shortest[i, j]`` — min-plus distance (hop count for
    ``weights="frequency"``, summed mean waiting time for
    ``weights="performance"``; ``+inf`` = unreachable).
    ``widest[i, j]`` — max-min bottleneck capacity over the frequency
    weights (the rarest edge on the best path; ``-inf`` = unreachable,
    ``+inf`` on the diagonal).  ``path`` is the source → sink widest
    path (node ids, host-reconstructed), ``bottleneck`` its capacity —
    the process's busiest end-to-end corridor and the edge that throttles
    it.
    """

    weights: str
    shortest: torch.Tensor       # (N, N) float32
    widest: torch.Tensor         # (N, N) float32
    path: tuple[int, ...]
    bottleneck: float


def _edge_costs(g: ProcessGraph, weights: str) -> torch.Tensor:
    adj = g.adjacency
    if weights == "frequency":
        return torch.where(adj, 1.0, math.inf)          # hop count
    if weights == "performance":
        if g.perf is None:
            raise ValueError(
                'bottleneck_paths(weights="performance") needs a '
                'performance-compiled graph (graph_kernel(timed=True) / '
                'bottleneck_paths_kernel(weights="performance"))')
        return torch.where(adj, g.perf, math.inf)
    raise ValueError(f"unknown weights {weights!r}; "
                     f"one of ('frequency', 'performance')")


def _widest_path(freq: np.ndarray, widest: np.ndarray, src: int,
                 dst: int) -> tuple[int, ...]:
    """Reconstruct one widest src → dst path, deterministically.

    The bottleneck value ``v = widest[src, dst]`` is known; every edge on
    a widest path has capacity ≥ v, and no path beats v, so a BFS over
    the ``cap >= v`` subgraph returns a hop-shortest path whose min-edge
    is exactly v (BFS visits successors in node-id order — stable)."""
    v = widest[src, dst]
    if not np.isfinite(v) or v <= 0:
        return ()
    allowed = freq.astype(np.float64) >= v
    prev: dict[int, int | None] = {src: None}
    frontier = [src]
    while frontier and dst not in prev:
        nxt = []
        for u in frontier:
            for j in np.nonzero(allowed[u])[0]:
                j = int(j)
                if j not in prev:
                    prev[j] = u
                    nxt.append(j)
        frontier = nxt
    if dst not in prev:
        return ()
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    return tuple(reversed(path))


def bottleneck_paths(g: ProcessGraph, weights: str = "frequency", *,
                     impl: str | None = None) -> BottleneckPaths:
    """Min-plus shortest + max-min widest all-pairs paths (module doc)."""
    costs = _edge_costs(g, weights)
    cap = torch.where(g.adjacency, g.freq.to(torch.float32), -math.inf)
    shortest = minplus_closure(costs, impl=impl)
    widest = maxmin_closure(cap, impl=impl)
    w_host = widest.cpu().numpy()
    path = _widest_path(g.freq.cpu().numpy(), w_host, g.source, g.sink)
    bott = float(w_host[g.source, g.sink]) if path else 0.0
    return BottleneckPaths(weights=weights, shortest=shortest,
                           widest=widest, path=path, bottleneck=bott)


# ----------------------------------------------------------- centrality
@dataclasses.dataclass(frozen=True)
class Centrality:
    """Per-node centrality over the frequency-weighted graph.

    ``in_degree`` / ``out_degree`` — exact traversal totals (column/row
    sums of ``freq``).  ``flow`` — power-method flow centrality: the
    L1-normalized fixed point of ``x <- x P`` (P the row-normalized
    transition matrix, sink mass recycled to the source so the chain has
    a stationary distribution), after ``iters`` matvec steps on the
    ``plus_times`` primitive.
    """

    in_degree: torch.Tensor      # (N,) int32
    out_degree: torch.Tensor     # (N,) int32
    flow: torch.Tensor           # (N,) float32
    iters: int


def node_centrality(g: ProcessGraph, iters: int = 16, *,
                    impl: str | None = None) -> Centrality:
    f = g.freq.to(torch.float32)
    n = g.num_nodes
    in_deg = torch.sum(g.freq, dim=0).to(torch.int32)
    out_deg = torch.sum(g.freq, dim=1).to(torch.int32)
    # row-stochastic transition matrix; dead ends (the sink, unobserved
    # activities) hand their mass back to the artificial source so the
    # walk restarts instead of leaking
    rowsum = torch.sum(f, dim=1, keepdim=True)
    p = torch.where(rowsum > 0, f / torch.clamp(rowsum, min=1.0), 0.0)
    restart = torch.zeros(n, dtype=torch.float32, device=f.device)
    restart[g.source] = 1.0
    p = torch.where(rowsum > 0, p, restart[None, :])
    x = torch.full((1, n), 1.0 / n, dtype=torch.float32, device=f.device)
    for _ in range(max(int(iters), 0)):
        x = semiring_matmul(x, p, "plus_times", impl=impl)
        x = x / torch.clamp(torch.sum(x), min=1e-30)
    return Centrality(in_degree=in_deg, out_degree=out_deg,
                      flow=x[0], iters=max(int(iters), 0))
