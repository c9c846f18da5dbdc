"""Graph semiring primitive — dense matrix queries over process graphs,
lowered twice (a hand-written CUDA kernel + the plain PyTorch version)
behind the same device-driven dispatch as the segmented primitives."""
from . import ops, ref
from .ops import bool_closure, maxmin_closure, minplus_closure, semiring_matmul
from .ref import IDENTITY, SEMIRINGS, semiring_matmul_ref
from .semiring import semiring_matmul_cuda

__all__ = [
    "ops", "ref",
    "semiring_matmul", "bool_closure", "minplus_closure", "maxmin_closure",
    "semiring_matmul_cuda", "semiring_matmul_ref", "SEMIRINGS", "IDENTITY",
]
