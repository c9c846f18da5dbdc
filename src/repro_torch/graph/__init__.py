"""Graph analytics: mined state → weighted process graph → dense semiring
queries, plus PM4Py-compatible model export.

``ir`` compiles any DFG-backed state into the :class:`ProcessGraph` IR;
``queries`` answers reachability / bottleneck-path / centrality questions
over it with the ``kernels.graph_ops`` semiring products (the CUDA kernel
on a card); ``verbs`` registers all of it as ordinary mining verbs
(importing this package is what puts ``graph``/``reachability``/
``bottleneck_paths``/``node_centrality`` in the kernel registry);
``export`` serializes models to PNML / DOT / process-tree / dfg.json / XES.
"""
from . import export, ir, queries, verbs  # noqa: F401 (verbs registers specs)
from .export import (alpha_to_pnml, dfg_from_json, dfg_to_json,
                     discover_process_tree, frame_from_xes, frame_to_xes,
                     graph_to_dot, heuristics_to_dot, pnml_places, read_pnml)
from .ir import END_LABEL, START_LABEL, ProcessGraph, compile_graph
from .queries import (BottleneckPaths, Centrality, Reachability,
                      bottleneck_paths, node_centrality, reachability)
from .verbs import (bottleneck_paths_kernel, graph_kernel,
                    node_centrality_kernel, reachability_kernel)

__all__ = [
    "ProcessGraph", "compile_graph", "START_LABEL", "END_LABEL",
    "Reachability", "BottleneckPaths", "Centrality",
    "reachability", "bottleneck_paths", "node_centrality",
    "graph_kernel", "reachability_kernel", "bottleneck_paths_kernel",
    "node_centrality_kernel",
    "alpha_to_pnml", "read_pnml", "pnml_places", "heuristics_to_dot",
    "graph_to_dot", "discover_process_tree", "dfg_to_json", "dfg_from_json",
    "frame_to_xes", "frame_from_xes",
]
