"""Yi-6B: llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11_008, vocab_size=64_000,
)
