"""xLSTM-1.3B: 48 blocks in 6 groups of (7 mLSTM + 1 sLSTM) [arXiv:2405.04517]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50_304,
    slstm_every=8, ssm_chunk=128,
)
