"""Segmented columnar primitives — the paper's §5.3/5.4 grouping and
counting operations, lowered twice (hand-written CUDA kernels + plain
PyTorch versions) behind one device-driven dispatch (``core.backend``)."""
from . import ops, ref
from .histogram import histogram_cuda
from .ops import (histogram, pair_count, pair_count_matmul, segment_reduce,
                  segmented_affine, segmented_scan)
from .ordered_histogram import ordered_histogram_cuda
from .pair_count import pair_count_cuda
from .ref import (histogram_ref, ordered_histogram_ref, pair_count_ref,
                  reduce_identity, segment_reduce_ref, segmented_affine_ref,
                  segmented_scan_ref)
from .segment_reduce import segment_reduce_cuda
from .segmented_scan import (segmented_affine_cuda, segmented_polyhash_cuda,
                             segmented_sum_scan_cuda)

__all__ = [
    "ops", "ref",
    "histogram", "pair_count", "pair_count_matmul", "segment_reduce",
    "segmented_affine", "segmented_scan",
    "histogram_cuda", "ordered_histogram_cuda", "pair_count_cuda",
    "segment_reduce_cuda", "segmented_affine_cuda", "segmented_polyhash_cuda",
    "segmented_sum_scan_cuda",
    "histogram_ref", "ordered_histogram_ref", "pair_count_ref",
    "reduce_identity", "segment_reduce_ref", "segmented_affine_ref",
    "segmented_scan_ref",
]
