"""Core library: the paper's event-dataframe abstraction, the DFG path, the
case/event statistics, the event- and case-level filters, the variants,
the performance overlays (timed DFG, eventually-follows), discovery (alpha,
heuristics) and conformance."""
from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame, concat_frames
from .dfg import (DFG, dfg, dfg_kernel, dfg_matmul, dfg_segment,
                  dfg_shift_count, stitch_dfg_state)
from .engine import ChunkKernel, compose, run_single, run_streaming
from .chunked import ChunkedEventFrame
# discovery registers its verbs right after the DFG's, so the registry
# (and ``Dataset.profile``'s verb order) lists them as the JAX package does
from .discovery import (AlphaModel, DiscoveryState, Footprint, HeuristicsNet,
                        alpha_kernel, discovery_kernel, heuristics_kernel)
from .stats import stats_kernel
from .variants import variants_kernel
from .performance import eventually_follows_kernel, performance_dfg_kernel
from .classic_log import ClassicEventLog, make_classic_log
from . import (backend, classic_log, conformance, discovery, engine,
               filtering, ops, performance, polyhash, stats, variants)

__all__ = [
    "ACTIVITY", "CASE", "TIMESTAMP", "EventFrame", "concat_frames",
    "DFG", "dfg", "dfg_kernel", "dfg_matmul", "dfg_segment",
    "dfg_shift_count", "stitch_dfg_state", "ChunkKernel", "compose",
    "run_single", "run_streaming", "ChunkedEventFrame", "stats_kernel",
    "variants_kernel", "eventually_follows_kernel", "performance_dfg_kernel",
    "ClassicEventLog", "make_classic_log", "AlphaModel", "DiscoveryState",
    "Footprint", "HeuristicsNet", "alpha_kernel", "discovery_kernel",
    "heuristics_kernel",
    "backend", "classic_log", "conformance", "discovery", "engine",
    "filtering", "ops", "performance", "polyhash", "stats", "variants",
]
