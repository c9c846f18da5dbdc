"""Gemma3-4B: 5:1 local(1024):global interleave, 262k vocab, tied embeddings
[hf:google/gemma-3-4b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10_240, vocab_size=262_144,
    local_window=1024, global_every=6,
    rope_theta=10_000.0, global_rope_theta=1_000_000.0,
    tie_embeddings=True,
)
