"""Graph verbs as registered chunk kernels.

Each verb is the alpha-miner pattern one level up: the chunk-side work is
the *existing* mergeable DFG fold (``core.dfg.dfg_kernel``), and the verb
is a new ``finalize`` that compiles the merged state into a
:class:`~repro_torch.graph.ir.ProcessGraph` and (for the query verbs) runs
the semiring closure over it.  State, update, merge and stitch are shared
verbatim with the DFG kernel, so every graph verb streams, prunes and
merges per-group states as the DFG does.

``impl`` (the query verbs) is handed down to the closures and products:
``"ref"`` runs the loop of plain products on either device.
``timed=True`` (the performance overlay) composes the DFG kernel with
``performance_dfg_kernel``; its float32 wait totals are folded in row
order, so the timed graph is bitwise the JAX package's too, and it has no
stitch (regrouping the float sums is not bitwise-stable) and no sharded
lowering: ``engine="sharded"`` raises for it, as in the JAX package.
"""
from __future__ import annotations

from repro_torch.core import engine
from repro_torch.core.dfg import dfg_kernel
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP

from .ir import ProcessGraph, compile_graph
from .queries import (BottleneckPaths, Centrality, Reachability,
                      bottleneck_paths, node_centrality, reachability)


def _timed_base(num_activities: int, method: str) -> engine.ChunkKernel:
    # one fused pass accumulating DFG counts + float32 wait totals
    from repro_torch.core.performance import performance_dfg_kernel

    return engine.compose({"dfg": dfg_kernel(num_activities, method),
                           "perf": performance_dfg_kernel(num_activities)})


def _wrap(base: engine.ChunkKernel, name: str, finalize) -> engine.ChunkKernel:
    return engine.ChunkKernel(
        f"{name}[{base.name}]", base.init, base.update, base.merge, finalize,
        mask_exact=base.mask_exact, columns=base.columns, stitch=base.stitch)


def graph_kernel(num_activities: int, timed: bool = False,
                 method: str = "auto") -> engine.ChunkKernel:
    """Compile the stream into a :class:`ProcessGraph` (``timed=True`` adds
    the mean-wait performance overlay; see module docstring)."""
    if timed:
        base = _timed_base(num_activities, method)

        def finalize(state, carry):
            out = base.finalize(state, carry)
            return compile_graph(out["dfg"], perf=out["perf"][1])

        return _wrap(base, "graph+perf", finalize)
    dk = dfg_kernel(num_activities, method)
    return _wrap(dk, "graph",
                 lambda s, c: compile_graph(dk.finalize(s, c)))


def reachability_kernel(num_activities: int, k: int | None = None,
                        method: str = "auto",
                        impl: str | None = None) -> engine.ChunkKernel:
    """k-step reachability closure of the compiled graph."""
    dk = dfg_kernel(num_activities, method)
    return _wrap(dk, "reachability",
                 lambda s, c: reachability(compile_graph(dk.finalize(s, c)),
                                           k, impl=impl))


def bottleneck_paths_kernel(num_activities: int, weights: str = "frequency",
                            method: str = "auto",
                            impl: str | None = None) -> engine.ChunkKernel:
    """All-pairs shortest/widest paths + the source→sink bottleneck."""
    if weights == "performance":
        base = _timed_base(num_activities, method)

        def finalize(state, carry):
            out = base.finalize(state, carry)
            g = compile_graph(out["dfg"], perf=out["perf"][1])
            return bottleneck_paths(g, weights, impl=impl)

        return _wrap(base, "bottleneck_paths+perf", finalize)
    dk = dfg_kernel(num_activities, method)
    return _wrap(dk, "bottleneck_paths",
                 lambda s, c: bottleneck_paths(
                     compile_graph(dk.finalize(s, c)), weights, impl=impl))


def node_centrality_kernel(num_activities: int, iters: int = 16,
                           method: str = "auto",
                           impl: str | None = None) -> engine.ChunkKernel:
    """Degree + power-method flow centrality of the compiled graph."""
    dk = dfg_kernel(num_activities, method)
    return _wrap(dk, "node_centrality",
                 lambda s, c: node_centrality(compile_graph(dk.finalize(s, c)),
                                              iters, impl=impl))


# --------------------------------------------------------- registration
def _no_sharded_perf(what: str) -> ValueError:
    return ValueError(
        f"{what} has no exact distributed lowering (order-sensitive f32 "
        f"wait totals); use engine='streaming' or 'eager'")


def _graph_from_sharded(state, timed=False, **_) -> ProcessGraph:
    if timed:
        raise _no_sharded_perf("graph(timed=True)")
    return compile_graph(state)


def _reach_from_sharded(state, k=None, impl=None, **_) -> Reachability:
    return reachability(compile_graph(state), k, impl=impl)


def _bott_from_sharded(state, weights="frequency", impl=None,
                       **_) -> BottleneckPaths:
    if weights == "performance":
        raise _no_sharded_perf('bottleneck_paths(weights="performance")')
    return bottleneck_paths(compile_graph(state), weights, impl=impl)


def _cent_from_sharded(state, iters=16, impl=None, **_) -> Centrality:
    return node_centrality(compile_graph(state), iters, impl=impl)


engine.register_kernel(engine.KernelSpec(
    "graph",
    make=lambda dims, timed=False, method="auto": graph_kernel(
        dims.num_activities, timed, method),
    # TIMESTAMP serves only timed=True; the untimed kernel never reads it
    columns=(ACTIVITY, CASE, TIMESTAMP),
    sharded_state="dfg",
    from_sharded=_graph_from_sharded,
    doc="DFG state compiled into a weighted process graph "
        "(artificial start/end nodes; timed=True adds mean waits)"))
engine.register_kernel(engine.KernelSpec(
    "reachability",
    make=lambda dims, k=None, method="auto", impl=None: reachability_kernel(
        dims.num_activities, k, method, impl),
    columns=(ACTIVITY, CASE),
    sharded_state="dfg",
    from_sharded=_reach_from_sharded,
    doc="k-step boolean reachability closure of the process graph"))
engine.register_kernel(engine.KernelSpec(
    "bottleneck_paths",
    make=lambda dims, weights="frequency", method="auto",
    impl=None: bottleneck_paths_kernel(dims.num_activities, weights,
                                       method, impl),
    columns=(ACTIVITY, CASE, TIMESTAMP),
    sharded_state="dfg",
    from_sharded=_bott_from_sharded,
    doc="min-plus shortest / max-min widest paths + source→sink bottleneck"))
engine.register_kernel(engine.KernelSpec(
    "node_centrality",
    make=lambda dims, iters=16, method="auto",
    impl=None: node_centrality_kernel(dims.num_activities, iters,
                                      method, impl),
    columns=(ACTIVITY, CASE),
    sharded_state="dfg",
    from_sharded=_cent_from_sharded,
    doc="in/out degree + power-method flow centrality per node"))
