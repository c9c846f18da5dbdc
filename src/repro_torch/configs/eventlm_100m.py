"""EventLM-100M: the paper-side model — a ~100M dense LM trained on
next-activity prediction over EventFrame token streams (examples/train)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="eventlm-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3_072, vocab_size=4_096,
)
