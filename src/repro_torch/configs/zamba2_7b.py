"""Zamba2-7B: Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14_336, vocab_size=32_000,
    ssm_state=64, ssm_expand=2, ssm_chunk=128, shared_attn_every=6,
)
