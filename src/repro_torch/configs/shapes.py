"""Assigned input shapes and per-arch applicability (see DESIGN.md §4)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic attention: SSM / hybrid / windowed archs only.
LONG_CONTEXT_OK = {"mixtral-8x7b", "zamba2-7b", "gemma3-4b", "xlstm-1.3b"}


def cells(arch: str):
    """Runnable (arch, shape) cells; documented skips excluded."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_OK:
        out.append("long_500k")
    return out
