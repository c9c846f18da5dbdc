"""The ``ProcessGraph`` IR: mined state compiled into one dense graph.

Every mergeable DFG-backed state the port accumulates (``core.dfg.DFG``,
``core.discovery.DiscoveryState``, a performance overlay) compiles into
the same intermediate representation: a dense weighted adjacency over the
dictionary-encoded activity alphabet **plus two artificial nodes** —

* node ``A``     — the artificial source ``▶`` (edges ``▶ -> a`` weighted
  by the start-activity histogram);
* node ``A + 1`` — the artificial sink ``■`` (edges ``a -> ■`` weighted by
  the end-activity histogram).

The artificial nodes turn per-activity start/end histograms into ordinary
edges, so "from process start" / "to process end" questions are plain
(source, sink) entries of the all-pairs query answers in
``repro_torch.graph.queries``.  Frequencies are the exact int32 counts of
the underlying state — compiling is a pure reshaping of already-merged
state on the state's device, so a graph built from whole-log or streamed
state is bitwise identical whenever the states are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dfg import DFG

START_LABEL = "▶"
END_LABEL = "■"


@dataclasses.dataclass(frozen=True)
class ProcessGraph:
    """Dense process graph over ``num_activities + 2`` nodes.

    ``freq[i, j]`` is the exact directly-follows count (start/end
    histogram counts on the artificial rows/columns); ``perf`` — present
    only when compiled with a performance overlay — is the mean waiting
    time per edge (0 on artificial edges: the source/sink are
    instantaneous bookkeeping).  ``labels`` is attached by the caller
    (kernels never see dictionary tables); kernels produce ``labels=None``.
    """

    freq: torch.Tensor                   # (N, N) int32
    num_activities: int
    perf: torch.Tensor | None = None     # (N, N) float32 mean waits
    labels: tuple[str, ...] | None = None

    @property
    def num_nodes(self) -> int:
        return self.num_activities + 2

    @property
    def source(self) -> int:
        return self.num_activities

    @property
    def sink(self) -> int:
        return self.num_activities + 1

    @property
    def adjacency(self) -> torch.Tensor:
        """(N, N) bool — at least one observed traversal."""
        return self.freq > 0

    def node_labels(self) -> tuple[str, ...]:
        if self.labels is not None:
            return self.labels + (START_LABEL, END_LABEL)
        return tuple(f"a{i}" for i in range(self.num_activities)) + \
            (START_LABEL, END_LABEL)

    def with_labels(self, labels) -> "ProcessGraph":
        labels = tuple(str(x) for x in labels)
        if len(labels) != self.num_activities:
            raise ValueError(f"{len(labels)} labels for "
                             f"{self.num_activities} activities")
        return dataclasses.replace(self, labels=labels)

    def edges(self):
        """Host-side sparse view: ((src, dst), count [, mean_wait])."""
        f = self.freq.cpu().numpy()
        p = None if self.perf is None else self.perf.cpu().numpy()
        out = []
        for a, b in zip(*np.nonzero(f)):
            e = ((int(a), int(b)), int(f[a, b]))
            out.append(e if p is None else e + (float(p[a, b]),))
        return out

    @classmethod
    def from_numpy(cls, freq: np.ndarray, num_activities: int,
                   perf: np.ndarray | None = None, *,
                   device) -> "ProcessGraph":
        """A graph from numpy arrays — e.g. the JAX package's compiled
        ``np.asarray(g.freq)`` — so the port's queries can run on it."""
        f = torch.from_numpy(np.array(freq, np.int32)).to(device)
        p = None if perf is None else \
            torch.from_numpy(np.array(perf, np.float32)).to(device)
        return cls(freq=f, num_activities=int(num_activities), perf=p)


def compile_graph(state: "DFG | object", perf: torch.Tensor | None = None,
                  labels=None) -> ProcessGraph:
    """Compile mined state into a :class:`ProcessGraph`.

    ``state`` is a :class:`~repro_torch.core.dfg.DFG` or anything carrying
    one (``DiscoveryState.dfg``); ``perf`` is an optional (A, A) mean-wait
    matrix (``performance_dfg``'s second output) embedded on the real
    edges.
    """
    dfg = state.dfg if hasattr(state, "dfg") else state
    if not isinstance(dfg, DFG):
        raise TypeError(f"cannot compile a {type(state).__name__} into a "
                        f"ProcessGraph (expected DFG-backed state)")
    a = dfg.num_activities
    n = a + 2
    dev = dfg.counts.device
    freq = torch.zeros((n, n), dtype=torch.int32, device=dev)
    freq[:a, :a] = dfg.counts.to(torch.int32)
    freq[a, :a] = dfg.starts.to(torch.int32)
    freq[:a, a + 1] = dfg.ends.to(torch.int32)
    pw = None
    if perf is not None:
        pw = torch.zeros((n, n), dtype=torch.float32, device=dev)
        pw[:a, :a] = torch.as_tensor(perf, device=dev).to(torch.float32)
    g = ProcessGraph(freq=freq, num_activities=a, perf=pw)
    return g.with_labels(labels) if labels is not None else g
