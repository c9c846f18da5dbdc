"""Core library: the paper's event-dataframe abstraction and the DFG path."""
from .eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame, concat_frames
from .dfg import (DFG, dfg, dfg_kernel, dfg_matmul, dfg_segment,
                  dfg_shift_count, stitch_dfg_state)
from .engine import ChunkKernel, run_single, run_streaming
from .chunked import ChunkedEventFrame
from . import backend, engine, ops, polyhash

__all__ = [
    "ACTIVITY", "CASE", "TIMESTAMP", "EventFrame", "concat_frames",
    "DFG", "dfg", "dfg_kernel", "dfg_matmul", "dfg_segment",
    "dfg_shift_count", "stitch_dfg_state", "ChunkKernel", "run_single",
    "run_streaming", "ChunkedEventFrame", "backend", "engine", "ops",
    "polyhash",
]
