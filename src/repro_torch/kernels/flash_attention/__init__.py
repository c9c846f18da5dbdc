"""Flash attention: the hand-written CUDA kernels (forward and backward),
their plain PyTorch versions and the device-dispatched entry point."""
from . import ops
from .flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import (flash_attention_bwd_magnitudes, flash_attention_bwd_ref,
                  flash_attention_lse_ref, flash_attention_ref)

__all__ = ["ops", "flash_attention_cuda", "flash_attention_bwd_cuda",
           "flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "flash_attention_bwd_magnitudes"]
