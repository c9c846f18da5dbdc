"""Graph semiring primitive — dense matrix queries over process graphs,
lowered twice (a hand-written CUDA kernel + the plain PyTorch version)
behind the same device-driven dispatch as the segmented primitives; a
whole closure of a graph of at most ``CLOSURE_MAX_N`` nodes is one launch
of a second kernel on a card."""
from . import ops, ref
from .ops import bool_closure, maxmin_closure, minplus_closure, semiring_matmul
from .ref import (CLOSURES, IDENTITY, SEMIRINGS, semiring_closure_ref,
                  semiring_matmul_ref)
from .semiring import (CLOSURE_CAPACITY, CLOSURE_MAX_N, closure_plan,
                       semiring_closure_cuda, semiring_matmul_cuda)

__all__ = [
    "ops", "ref",
    "semiring_matmul", "bool_closure", "minplus_closure", "maxmin_closure",
    "semiring_matmul_cuda", "semiring_matmul_ref", "SEMIRINGS", "IDENTITY",
    "semiring_closure_cuda", "semiring_closure_ref", "closure_plan",
    "CLOSURES", "CLOSURE_MAX_N", "CLOSURE_CAPACITY",
]
