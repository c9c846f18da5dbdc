from . import ops
from .dfg_count import dfg_count_cuda
from .ref import dfg_count_ref

__all__ = ["ops", "dfg_count_cuda", "dfg_count_ref"]
