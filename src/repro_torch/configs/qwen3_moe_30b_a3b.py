"""Qwen3-30B-A3B: 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, moe_d_ff=768, vocab_size=151_936,
    num_experts=128, num_experts_per_tok=8,
    rope_theta=1_000_000.0,
)
