"""Core library: the paper's event-dataframe abstraction, the DFG path, the
case/event statistics and the event- and case-level filters."""
from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame, concat_frames
from .dfg import (DFG, dfg, dfg_kernel, dfg_matmul, dfg_segment,
                  dfg_shift_count, stitch_dfg_state)
from .engine import ChunkKernel, compose, run_single, run_streaming
from .chunked import ChunkedEventFrame
from .stats import stats_kernel
from . import backend, engine, filtering, ops, polyhash, stats

__all__ = [
    "ACTIVITY", "CASE", "TIMESTAMP", "EventFrame", "concat_frames",
    "DFG", "dfg", "dfg_kernel", "dfg_matmul", "dfg_segment",
    "dfg_shift_count", "stitch_dfg_state", "ChunkKernel", "compose",
    "run_single", "run_streaming", "ChunkedEventFrame", "stats_kernel",
    "backend", "engine", "filtering", "ops", "polyhash", "stats",
]
