"""Mixtral-8x7B: 8-expert top-2 MoE with SWA-4096 [arXiv:2401.04088].

8 experts < 16-way model axis => expert weights are TP-sharded on d_ff
(experts replicated), see DESIGN.md §4."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14_336, moe_d_ff=14_336, vocab_size=32_000,
    num_experts=8, num_experts_per_tok=2,
    window=4_096, rope_theta=1_000_000.0,
)
