"""Flash attention: the hand-written CUDA kernel, its plain PyTorch version
and the device-dispatched entry point."""
from . import ops
from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref

__all__ = ["ops", "flash_attention_cuda", "flash_attention_ref"]
