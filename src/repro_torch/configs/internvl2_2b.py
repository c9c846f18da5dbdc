"""InternVL2-2B: InternViT frontend is a STUB (precomputed patch embeddings);
backbone = InternLM2-2B [arXiv:2404.16821]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8_192, vocab_size=92_553,
    num_patches=256,
)
