"""Conformance checking against DFG footprints and discovered models.

The paper positions DFGs as the basis for discovery (IMDF [13]) and for
conversion to Petri nets for conformance [14]. Three dataframe-native
checks, all masked matrix ops on dense count/relation matrices:

* **footprint fitness** — given a *model* DFG (allowed directly-follows
  relations), the fraction of observed pair occurrences the model allows;
* **footprint conformance** — cell-wise agreement between a log's footprint
  relations and a discovered :class:`~repro_torch.core.discovery.AlphaModel`'s
  footprint (the classic footprint-matrix comparison);
* **heuristics fitness** — replay of the observed pair mass against a
  :class:`~repro_torch.core.discovery.HeuristicsNet`'s dependency graph.

Every check consumes only the mergeable DFG state, so it scores streamed
and whole-log accumulations identically.  Scores are 0-d float32 tensors
on the state's device; the sums are of integer-valued float32 below 2^24,
so they are exact in any order.
"""
from __future__ import annotations

import torch

from .dfg import DFG


def footprint_fitness(log_dfg: DFG, model_allowed: torch.Tensor) -> torch.Tensor:
    """Fraction of observed pair occurrences permitted by ``model_allowed``
    (A, A) bool. 1.0 == perfectly conformant.

    An empty (or fully-filtered) log observes nothing, so it deviates from
    nothing: vacuous conformance scores 1.0, not 0.0.
    """
    c = log_dfg.counts.to(torch.float32)
    tot = c.sum()
    ok = torch.where(model_allowed, c, 0.0).sum()
    return torch.where(tot > 0.0, ok / torch.clamp(tot, min=1.0),
                       torch.ones((), dtype=torch.float32, device=c.device))


def footprint_deviations(log_dfg: DFG, model_allowed: torch.Tensor) -> torch.Tensor:
    """Count matrix restricted to disallowed pairs (where deviations happen)."""
    return torch.where(model_allowed, 0, log_dfg.counts)


def discover_model(log_dfg: DFG, noise_threshold: float = 0.0) -> torch.Tensor:
    """IMDF-style noise filtering: keep edges with count > threshold * max
    outgoing count of their source (the DFG-cleaning step of [13])."""
    c = log_dfg.counts.to(torch.float32)
    row_max = torch.clamp(c.amax(dim=1, keepdim=True), min=1.0)
    return c > noise_threshold * row_max


# ------------------------------------------------ discovered-model replay
def _footprint_agreement(log_direct: torch.Tensor, model_direct: torch.Tensor):
    agree = (log_direct == model_direct) & (log_direct.T == model_direct.T)
    # the JAX package's ``agree.mean()`` lowers to sum * float32(1 / n),
    # not a correctly rounded sum / n: the same two float32 operations
    # give its bits
    n = torch.tensor(float(agree.numel()), dtype=torch.float32,
                     device=agree.device)
    return agree, agree.to(torch.float32).sum() * n.reciprocal()


def footprint_conformance(log_dfg: DFG, model) -> torch.Tensor:
    """Footprint-matrix conformance of a log against an alpha model (or any
    object with a ``.footprint``, or a raw :class:`Footprint`).

    Every (a, b) cell carries one of the alpha relation classes (causal /
    reverse-causal / parallel / choice), fully determined by the ordered
    pair ``(direct[a, b], direct[b, a])``; the score is the fraction of
    cells whose class in the log matches the model.  1.0 == the log's
    footprint is exactly the model's.
    """
    from .discovery import footprint

    fp = getattr(model, "footprint", model)
    _, score = _footprint_agreement(footprint(log_dfg).direct, fp.direct)
    return score


def footprint_disagreements(log_dfg: DFG, model) -> torch.Tensor:
    """(A, A) bool matrix of footprint cells where log and model disagree."""
    from .discovery import footprint

    fp = getattr(model, "footprint", model)
    agree, _ = _footprint_agreement(footprint(log_dfg).direct, fp.direct)
    return ~agree


def alpha_fitness(log_dfg: DFG, model) -> torch.Tensor:
    """Replay fitness of a log against an alpha model: the fraction of
    observed directly-follows mass on relations the model's footprint
    permits (causal or parallel — i.e. its ``direct`` matrix)."""
    fp = getattr(model, "footprint", model)
    return footprint_fitness(log_dfg, fp.direct)


def heuristics_fitness(log_dfg: DFG, net) -> torch.Tensor:
    """Dependency-graph fitness of a log against a heuristics net: the
    fraction of observed directly-follows mass that travels kept edges of
    ``net.graph`` (L1 loops are diagonal entries and count as kept)."""
    return footprint_fitness(log_dfg, net.graph)
