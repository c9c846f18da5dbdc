from .dfg_count import dfg_count_cuda
from .ref import dfg_count_ref

__all__ = ["dfg_count_cuda", "dfg_count_ref"]
