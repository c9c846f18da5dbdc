"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from .shapes import SHAPES, LONG_CONTEXT_OK, Shape, cells

_ARCHS = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "zamba2-7b": "zamba2_7b",
    "gemma3-4b": "gemma3_4b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "deepseek-67b": "deepseek_67b",
    "yi-6b": "yi_6b",
    "whisper-medium": "whisper_medium",
    "internvl2-2b": "internvl2_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "eventlm-100m": "eventlm_100m",
}

ARCH_IDS = tuple(k for k in _ARCHS if k != "eventlm-100m")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving shrink for CPU smoke tests."""
    kw = dict(
        num_layers=max(4, (cfg.global_every or cfg.shared_attn_every or
                           cfg.slstm_every or 2) * 2),
        d_model=64, num_heads=4, num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16, d_ff=128, vocab_size=128,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_chunk=16)
    if cfg.family == "ssm":
        kw.update(num_heads=4, num_kv_heads=4, head_dim=16, d_ff=0, ssm_chunk=16)
        kw["num_layers"] = 2 * cfg.slstm_every
    if cfg.enc_layers:
        kw.update(enc_layers=2, enc_seq=16)
    if cfg.num_patches:
        kw.update(num_patches=4)
    if cfg.local_window:
        kw.update(local_window=8)
    if cfg.window:
        kw.update(window=8)
    kw.update(compute_dtype="float32", param_dtype="float32", attn_chunk=32)
    return cfg.with_overrides(**kw)
