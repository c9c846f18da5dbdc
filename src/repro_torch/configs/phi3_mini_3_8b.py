"""Phi3-mini-3.8B: RoPE SwiGLU MHA [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8_192, vocab_size=32_064,
)
