"""Process discovery on the columnar substrate — alpha + heuristics miners.

The paper positions DFGs as the basis for discovery; both miners here
consume nothing but the dense matrices the chunk-kernel engine already
accumulates:

* **alpha miner** — footprint relations (``a -> b`` causality, ``a || b``
  parallelism, ``a # b`` choice) derived as masked matrix ops over the
  ``pair_count``-built DFG plus start/end histograms; places are the maximal
  (A, B) pairs of the classic algorithm (host-side set search over the
  boolean footprint — the only non-vectorized step, O(places), not O(N)).
* **heuristics miner** — dependency measure ``(a->b − b->a)/(a->b + b->a + 1)``
  with L1-loop (``a,a``) and L2-loop (``a,b,a``) handling, all dense (A, A)
  tensor math; AND/XOR split bindings as one (A, A, A) broadcast.

Both are the *finalize* step of a chunk kernel (``core.engine``): the alpha
miner finalizes the existing ``dfg_kernel`` state verbatim, the heuristics
miner finalizes :func:`discovery_kernel` — the DFG state extended with the
(A, A) L2-loop triple counts, carried across chunk boundaries by a two-row
carry.  Discovery therefore works out-of-core over ``ChunkedEventFrame``
streams with bitwise whole-log parity (integer counting is order-exact);
each chunk makes two ``pair_count`` calls (the DFG and the triples), the
CUDA kernel on a card.  The heuristics measures are one IEEE division per
entry, so they are bitwise the JAX package's.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels.segment_ops import pair_count

from . import engine
from .dfg import DFG, _method_impl, dfg_kernel, stitch_dfg_state
from .eventframe import ACTIVITY, CASE, EventFrame


# ----------------------------------------------------------- footprint
@dataclasses.dataclass
class Footprint:
    """The alpha relations as dense (A, A) boolean matrices.

    Every cell is classified by ``(direct[a, b], direct[b, a])``:
    ``causal`` = ``(1, 0)``, ``parallel`` = ``(1, 1)``, ``choice`` =
    ``(0, 0)`` — a partition, so two footprints agree on a cell iff their
    ``direct`` matrices agree in both orientations.
    """

    direct: torch.Tensor    # a > b  (b directly follows a >= min_count times)
    causal: torch.Tensor    # a -> b
    parallel: torch.Tensor  # a || b
    choice: torch.Tensor    # a # b

    @property
    def num_activities(self) -> int:
        return self.direct.shape[-1]


def footprint(source: DFG | torch.Tensor, min_count: int = 1) -> Footprint:
    """Alpha relations of a DFG (or a raw (A, A) count matrix); edges with
    fewer than ``min_count`` observations are treated as absent (noise)."""
    counts = source.counts if isinstance(source, DFG) else source
    d = counts >= int(min_count)
    return Footprint(direct=d, causal=d & ~d.T, parallel=d & d.T,
                     choice=~d & ~d.T)


# ---------------------------------------------------------- alpha miner
@dataclasses.dataclass(frozen=True)
class AlphaModel:
    """Result of the alpha miner: a Petri net in (A, B)-pair form.

    ``places`` are the maximal pairs of activity sets ``(A, B)`` with every
    ``a in A`` causal to every ``b in B`` and both sets internally in
    choice; plus the implicit source place (into ``start_activities``) and
    sink place (out of ``end_activities``).  ``footprint`` keeps the
    relation matrices the model was built from — the footprint-matrix
    conformance object (``core.conformance.footprint_conformance``).
    """

    num_activities: int
    places: tuple[tuple[frozenset[int], frozenset[int]], ...]
    start_activities: frozenset[int]
    end_activities: frozenset[int]
    footprint: Footprint

    @property
    def num_places(self) -> int:
        return len(self.places) + 2  # + source/sink


def _maximal_pairs(causal: np.ndarray, choice: np.ndarray):
    """Classic alpha steps 3–4: the maximal (A, B) pairs.

    Any valid pair decomposes into valid singleton pairs (sub-pairs of a
    valid pair are valid), so the closure of singleton pairs under
    pairwise union reaches every element of X_L; Y_L is its maximal
    antichain.  Host-side over the boolean footprint — the alphabet is
    small and fixed, the log size never enters here.
    """
    a_n = causal.shape[0]
    base = [(frozenset((a,)), frozenset((b,)))
            for a in range(a_n) for b in range(a_n)
            if causal[a, b] and choice[a, a] and choice[b, b]]

    def ok(aa, bb):
        al, bl = sorted(aa), sorted(bb)
        return (causal[np.ix_(al, bl)].all()
                and choice[np.ix_(al, al)].all()
                and choice[np.ix_(bl, bl)].all())

    seen = set(base)
    frontier = list(base)
    while frontier:
        fresh = []
        for a1, b1 in frontier:
            for a2, b2 in base:
                cand = (a1 | a2, b1 | b2)
                if cand not in seen and ok(*cand):
                    seen.add(cand)
                    fresh.append(cand)
        frontier = fresh

    maximal = [p for p in seen
               if not any(q != p and p[0] <= q[0] and p[1] <= q[1]
                          for q in seen)]
    return tuple(sorted(maximal, key=lambda p: (sorted(p[0]), sorted(p[1]))))


def _nonzero_set(v: torch.Tensor) -> frozenset[int]:
    return frozenset(int(i)
                     for i in np.nonzero(trace.host_read(v).numpy())[0])


def discover_alpha(d: DFG, min_count: int = 1) -> AlphaModel:
    """Alpha miner over an accumulated DFG state (whole-log or streamed —
    the miner is pure finalize, it never sees events)."""
    fp = footprint(d, min_count)
    places = _maximal_pairs(fp.causal.cpu().numpy(), fp.choice.cpu().numpy())
    return AlphaModel(num_activities=d.num_activities, places=places,
                      start_activities=_nonzero_set(d.starts),
                      end_activities=_nonzero_set(d.ends), footprint=fp)


# ----------------------------------------------------- heuristics miner
@dataclasses.dataclass(frozen=True)
class HeuristicsNet:
    """Result of the heuristics miner — all dense (A, A)/(A, A, A) tensors.

    ``dependency``'s off-diagonal is ``(a->b − b->a)/(a->b + b->a + 1)``;
    its diagonal is the L1-loop measure ``a->a / (a->a + 1)``.  ``l2`` is
    the symmetric L2-loop measure over ``a,b,a`` triple counts.  ``graph``
    is the thresholded dependency graph (L2 edges added in both directions
    for loop pairs where neither side already has an L1 loop).
    ``and_bindings[a, b1, b2]`` marks successor pairs of ``a`` that split
    as AND (concurrent) rather than XOR.
    """

    dependency: torch.Tensor     # (A, A) float32
    l2: torch.Tensor             # (A, A) float32
    graph: torch.Tensor          # (A, A) bool
    and_bindings: torch.Tensor   # (A, A, A) bool
    start_activities: frozenset[int]
    end_activities: frozenset[int]

    @property
    def num_activities(self) -> int:
        return self.graph.shape[-1]

    def edges(self):
        """Host-side sparse view of the dependency graph."""
        g = self.graph.cpu().numpy()
        dep = self.dependency.cpu().numpy()
        return [((int(a), int(b)), float(dep[a, b]))
                for a, b in zip(*np.nonzero(g))]


def _heuristics_measures(counts: torch.Tensor, l2_counts: torch.Tensor):
    c = counts.to(torch.float32)
    dep = (c - c.T) / (c + c.T + 1.0)
    l1 = torch.diag(c) / (torch.diag(c) + 1.0)
    eye = torch.eye(c.shape[0], dtype=torch.bool, device=c.device)
    dep = torch.where(eye, l1[:, None], dep)
    c2 = l2_counts.to(torch.float32)
    l2 = torch.where(eye, 0.0, (c2 + c2.T) / (c2 + c2.T + 1.0))
    # AND-split measure m[a, b1, b2] = (b1<->b2 mass) / (a's output mass)
    and_m = (c + c.T)[None, :, :] / (c[:, :, None] + c[:, None, :] + 1.0)
    return dep, l2, and_m


def _f32(x: float, device) -> torch.Tensor:
    # thresholds compare in float32, as the JAX package's jnp.float32(x)
    return trace.to_device(x, device, torch.float32)


def _heuristics_graph(counts, l2_counts, dep, l2, and_m, dependency_threshold,
                      l2_threshold, min_count, and_threshold):
    a = counts.shape[0]
    dev = counts.device
    eye = torch.eye(a, dtype=torch.bool, device=dev)
    dth = _f32(dependency_threshold, dev)
    keep = (dep >= dth) & ~eye & (counts >= min_count)
    loops1 = (torch.diag(dep) >= dth) & (torch.diag(counts) >= min_count)
    no_l1 = ~loops1[:, None] & ~loops1[None, :]
    sym2 = l2_counts + l2_counts.T
    keep2 = ((l2 >= _f32(l2_threshold, dev)) & (sym2 >= min_count) & no_l1
             & ~eye)
    graph = keep | (eye & loops1[:, None]) | keep2 | keep2.T
    both = graph[:, :, None] & graph[:, None, :] & ~eye[None, :, :]
    and_b = both & (and_m >= _f32(and_threshold, dev))
    return graph, and_b


def discover_heuristics(state: "DiscoveryState | DFG",
                        l2_counts: torch.Tensor | None = None, *,
                        dependency_threshold: float = 0.5,
                        l2_threshold: float = 0.5,
                        and_threshold: float = 0.65,
                        min_count: int = 1) -> HeuristicsNet:
    """Heuristics miner over an accumulated :class:`DiscoveryState` (or a
    bare DFG plus its ``l2_counts``) — pure finalize, dense tensor math."""
    if isinstance(state, DiscoveryState):
        d, l2c = state.dfg, state.l2_counts
    else:
        d = state
        l2c = (torch.zeros_like(d.counts) if l2_counts is None
               else torch.as_tensor(l2_counts, device=d.counts.device))
    dep, l2, and_m = _heuristics_measures(d.counts, l2c)
    graph, and_b = _heuristics_graph(
        d.counts, l2c, dep, l2, and_m, dependency_threshold, l2_threshold,
        int(min_count), and_threshold)
    return HeuristicsNet(dependency=dep, l2=l2, graph=graph,
                         and_bindings=and_b,
                         start_activities=_nonzero_set(d.starts),
                         end_activities=_nonzero_set(d.ends))


# ------------------------------------------------------------ chunk kernel
@dataclasses.dataclass
class DiscoveryState:
    """Mergeable discovery accumulator: DFG + (A, A) L2-loop triple counts
    (``l2_counts[a, b]`` = #occurrences of the pattern ``a, b, a`` within a
    case).  ``merge`` is leafwise addition."""

    dfg: DFG
    l2_counts: torch.Tensor

    @classmethod
    def from_numpy(cls, dfg_counts: np.ndarray, starts: np.ndarray,
                   ends: np.ndarray, l2_counts: np.ndarray,
                   device) -> "DiscoveryState":
        """A discovery state from numpy arrays — e.g. the JAX package's
        merged state, so the port's finalize steps can run on it."""
        d = DFG.from_numpy({"counts": dfg_counts, "starts": starts,
                            "ends": ends}, device)
        return cls(d, torch.from_numpy(np.array(l2_counts, np.int32)).to(device))


def init_l2_carry(carry: engine.Carry) -> engine.Carry:
    """Extend a row carry with the two-back halo row (``exists2=False``
    masks every triple that would straddle the stream start)."""
    dev = carry["case"].device
    for k, v in (("case2", -1), ("act2", 0), ("rv2", False),
                 ("exists2", False)):
        carry[k] = trace.to_device(v, dev, engine.CARRY_DTYPES[k])
    return carry


def _two_back(head2: torch.Tensor, head1: torch.Tensor,
              col: torch.Tensor) -> torch.Tensor:
    n = col.shape[0]
    return torch.cat([head2.reshape(1).to(col.dtype),
                      head1.reshape(1).to(col.dtype), col[:-2]])[:n]


def l2_triple_hits(chunk: engine.Chunk, carry: engine.Carry):
    """Per-row ``a, b, a`` detection with a two-row halo.

    Returns ``(prev2_act, prev_act, hit)``: row ``i`` contributes one
    ``l2_counts[act[i-2], act[i-1]]`` when all three rows share a case, are
    valid, and ``act[i] == act[i-2]`` — the carry supplies rows ``-1``/``-2``
    so any chunking yields the whole-log counts.  The one-row halo comes
    from ``engine.adjacent`` (the shared boundary semantics); only the
    two-back tensors are derived here.  Nothing is read back to the host.
    """
    adj = engine.adjacent(chunk, carry)
    case, act, rv = adj.case, adj.act, adj.rv
    n = case.shape[0]
    prev2_case = _two_back(carry["case2"], carry["case"], case)
    prev2_act = _two_back(carry["act2"], carry["act"], act)
    prev2_rv = _two_back(carry["rv2"], carry["rv"], rv)
    prev2_exists = torch.cat([carry["exists2"].reshape(1),
                              carry["exists"].reshape(1),
                              torch.ones(max(n - 2, 0), dtype=torch.bool,
                                         device=case.device)])[:n]
    hit = (adj.pair & (case == prev2_case)
           & prev2_rv & prev2_exists & (act == prev2_act))
    return prev2_act, adj.prev_act, hit


def next_l2_carry(carry: engine.Carry, old: engine.Carry,
                  chunk: engine.Chunk) -> engine.Carry:
    """Slide the two-back halo: the new two-back row is this chunk's
    second-to-last row (or, for a one-row chunk, the previous one-back).
    The branch is on the chunk's shape, never on a tensor value."""
    case = chunk[CASE]
    if case.shape[0] >= 2:
        carry.update(case2=case[-2].to(torch.int64),
                     act2=chunk[ACTIVITY][-2].to(torch.int32),
                     rv2=chunk.rows_valid()[-2],
                     exists2=torch.ones((), dtype=torch.bool,
                                        device=case.device))
    else:
        carry.update(case2=old["case"], act2=old["act"], rv2=old["rv"],
                     exists2=old["exists"])
    return carry


@lru_cache(maxsize=None)
def discovery_kernel(num_activities: int,
                     method: str = "auto") -> engine.ChunkKernel:
    """DFG + L2-loop counts as one mergeable chunk-kernel.

    The state is a dict ``{"dfg": DFG, "l2": (A, A) int32}`` and finalizes
    to a :class:`DiscoveryState`; the carry is the DFG kernel's one-row
    halo extended with the two-back row, so ``a, b, a`` triples split
    across chunk boundaries are counted exactly once.  ``method`` names the
    ``pair_count`` lowering as ``dfg_kernel``'s does (``"auto"``: the CUDA
    kernel on a card, the plain version on the CPU).
    """
    a = num_activities
    impl = _method_impl(method)
    dk = dfg_kernel(a, method)

    def init(device):
        state, carry = dk.init(device)
        return ({"dfg": state,
                 "l2": torch.zeros((a, a), dtype=torch.int32, device=device)},
                init_l2_carry(carry))

    def update(state, carry, chunk):
        p2, p1, hit = l2_triple_hits(chunk, carry)
        l2 = pair_count(p2, p1, a, weights=hit, into=state["l2"], impl=impl)
        dfg_state, ncarry = dk.update(state["dfg"], carry, chunk)
        return ({"dfg": dfg_state, "l2": l2},
                next_l2_carry(ncarry, carry, chunk))

    def finalize(state, carry):
        return DiscoveryState(dk.finalize(state["dfg"], carry), state["l2"])

    def stitch(ctx):
        # the DFG half shares the one-row-halo stitch; the L2 half needs
        # the *two*-row halo: triples landing on b's first two rows were
        # invisible to b's fresh fold (its two-back carry had exists=False)
        at = ctx.a.tail
        ac = ctx.a.carry
        rows_b = ctx.b.head["rows"]
        b0 = rows_b[0]
        dfg_s = stitch_dfg_state(ctx.a.state["dfg"], ctx.b.state["dfg"],
                                 at, b0, ctx.straddle)
        l2 = ctx.a.state["l2"] + ctx.b.state["l2"]      # a new tensor

        def add(i, j):
            if 0 <= i < a and 0 <= j < a:
                l2[i, j] += 1

        if ctx.straddle and at["rv"] and b0["rv"]:
            # triple (a[-2], a[-1], b0): a's two-back halo is in its carry
            exists2, rv2, case2, act2 = torch.stack([
                ac["exists2"].to(torch.int64), ac["rv2"].to(torch.int64),
                ac["case2"].to(torch.int64),
                ac["act2"].to(torch.int64)]).tolist()
            if exists2 and rv2 and case2 == b0["case"] and act2 == b0["act"]:
                add(act2, at["act"])
            # triple (a[-1], b0, b1): needs b's second leading row
            if ctx.b.rows >= 2:
                b1 = rows_b[1]
                if (b1["case"] == b0["case"] and b1["rv"]
                        and b1["case"] == at["case"]
                        and b1["act"] == at["act"]):
                    add(at["act"], b0["act"])
        overrides = {}
        if ctx.b.rows == 1:
            # the merged two-back row is a's last row, which b's one-row
            # fold could not know
            dev = ac["case"].device
            overrides = {
                k: torch.tensor(v, dtype=engine.CARRY_DTYPES[k], device=dev)
                for k, v in (("case2", at["case"]), ("act2", at["act"]),
                             ("rv2", at["rv"]), ("exists2", True))}
        return {"dfg": dfg_s, "l2": l2}, overrides

    return engine.ChunkKernel(f"discovery[{method}]", init, update,
                              engine.tree_sum, finalize,
                              columns=(ACTIVITY, CASE), stitch=stitch)


def alpha_kernel(num_activities: int, min_count: int = 1,
                 method: str = "auto") -> engine.ChunkKernel:
    """The alpha miner as the finalize of the *existing* DFG kernel state."""
    dk = dfg_kernel(num_activities, method)
    return engine.ChunkKernel(
        f"alpha[{dk.name}]", dk.init, dk.update, dk.merge,
        lambda s, c: discover_alpha(dk.finalize(s, c), min_count),
        mask_exact=dk.mask_exact, columns=dk.columns, stitch=dk.stitch)


def heuristics_kernel(num_activities: int, method: str = "auto",
                      **thresholds) -> engine.ChunkKernel:
    """The heuristics miner as the finalize of the discovery kernel state."""
    k = discovery_kernel(num_activities, method)
    return engine.ChunkKernel(
        f"heuristics[{k.name}]", k.init, k.update, k.merge,
        lambda s, c: discover_heuristics(k.finalize(s, c), **thresholds),
        mask_exact=k.mask_exact, columns=k.columns, stitch=k.stitch)


# ------------------------------------------------- whole-log entry points
def discovery_state(frame: EventFrame, num_activities: int,
                    method: str = "auto") -> DiscoveryState:
    """DFG + L2 counts of a (case,time)-sorted frame: the single-chunk
    special case of :func:`discovery_kernel`."""
    return engine.run_single(discovery_kernel(num_activities, method), frame)


def alpha(frame: EventFrame, num_activities: int, min_count: int = 1,
          method: str = "auto") -> AlphaModel:
    """Whole-log alpha miner (single-chunk special case)."""
    return engine.run_single(
        alpha_kernel(num_activities, min_count, method), frame)


def heuristics(frame: EventFrame, num_activities: int, method: str = "auto",
               **thresholds) -> HeuristicsNet:
    """Whole-log heuristics miner (single-chunk special case)."""
    return engine.run_single(
        heuristics_kernel(num_activities, method, **thresholds), frame)


# --------------------------------------------------------- streaming API
def streaming_discovery_state(chunks, num_activities: int,
                              method: str = "auto") -> DiscoveryState:
    """Out-of-core DFG + L2 accumulation: one pass, O(chunk) residency."""
    return engine.run_streaming(discovery_kernel(num_activities, method),
                                chunks)


def streaming_alpha(chunks, num_activities: int, min_count: int = 1,
                    method: str = "auto") -> AlphaModel:
    """Out-of-core alpha miner — bitwise-identical to the whole-log pass
    for any chunking (integer counting is order-exact)."""
    return engine.run_streaming(
        alpha_kernel(num_activities, min_count, method), chunks)


def streaming_heuristics(chunks, num_activities: int, method: str = "auto",
                         **thresholds) -> HeuristicsNet:
    """Out-of-core heuristics miner — bitwise-identical to whole-log."""
    return engine.run_streaming(
        heuristics_kernel(num_activities, method, **thresholds), chunks)


engine.register_kernel(engine.KernelSpec(
    "discovery",
    make=lambda dims, method="auto": discovery_kernel(
        dims.num_activities, method),
    columns=(ACTIVITY, CASE),
    sharded_state="discovery",
    from_sharded=lambda state, **_: state,
    doc="DFG + L2-loop triple counts (feeds alpha/heuristics host-side)"))
engine.register_kernel(engine.KernelSpec(
    "alpha",
    make=lambda dims, min_count=1, method="auto": alpha_kernel(
        dims.num_activities, min_count, method),
    columns=(ACTIVITY, CASE),
    sharded_state="dfg",
    from_sharded=lambda state, min_count=1, **_: discover_alpha(
        state, min_count),
    doc="alpha miner (finalize of the DFG state)"))
engine.register_kernel(engine.KernelSpec(
    "heuristics",
    make=lambda dims, method="auto", **thresholds: heuristics_kernel(
        dims.num_activities, method, **thresholds),
    columns=(ACTIVITY, CASE),
    sharded_state="discovery",
    from_sharded=lambda state, method="auto", **thresholds:
        discover_heuristics(state, **thresholds),
    doc="heuristics miner (finalize of the discovery state)"))
