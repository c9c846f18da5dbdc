"""Whisper-medium: enc-dec; conv frontend is a STUB (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4_096, vocab_size=51_865,
    enc_layers=24, enc_seq=1500,
)
