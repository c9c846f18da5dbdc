"""DeepSeek-67B: llama-arch GQA, 95 layers (deepest) [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22_016, vocab_size=102_400,
)
