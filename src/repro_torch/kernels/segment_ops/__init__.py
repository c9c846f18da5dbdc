"""Segmented columnar primitives on the DFG path — the paper's §5.3/5.4
counting operations, lowered twice (hand-written CUDA kernels + plain
PyTorch versions) behind one device-driven dispatch (``core.backend``)."""
from . import ops, ref
from .histogram import histogram_cuda
from .ops import histogram, pair_count, pair_count_matmul
from .pair_count import pair_count_cuda
from .ref import histogram_ref, pair_count_ref

__all__ = [
    "ops", "ref",
    "histogram", "pair_count", "pair_count_matmul",
    "histogram_cuda", "pair_count_cuda",
    "histogram_ref", "pair_count_ref",
]
