"""Storage-less stand-ins for every model input (no device allocation).

The JAX package's ``launch/specs.py`` with ``meta`` tensors in place of
``ShapeDtypeStruct``: each function returns (inputs, partition specs) for an
(arch, input-shape) cell.  Modality frontends are stubs, as in the JAX
package: the audio / vlm entries carry precomputed frame / patch
embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.models import model as Mdl
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import P, ShardingRules


def _abstract(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: Shape, rules: ShardingRules):
    B, S = shape.batch, shape.seq
    toks = S
    batch = {}
    specs = {}
    if cfg.family == "vlm":
        toks = S - cfg.num_patches
        batch["frontend"] = _abstract((B, cfg.num_patches, cfg.d_model), torch.bfloat16)
        specs["frontend"] = P(rules.batch, None, None)
    if cfg.family == "audio":
        batch["frontend"] = _abstract((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        specs["frontend"] = P(rules.batch, None, None)
    batch["tokens"] = _abstract((B, toks), torch.int32)
    batch["targets"] = _abstract((B, toks), torch.int32)
    batch["loss_mask"] = _abstract(batch["targets"].shape, torch.float32)
    for k in ("tokens", "targets", "loss_mask"):
        specs[k] = P(rules.batch, None)
    return batch, specs


def prefill_specs(cfg: ModelConfig, shape: Shape, rules: ShardingRules):
    B, S = shape.batch, shape.seq
    toks = S - (cfg.num_patches if cfg.family == "vlm" else 0)
    inputs = {"tokens": _abstract((B, toks), torch.int32)}
    specs = {"tokens": P(rules.batch, None)}
    if cfg.family == "vlm":
        inputs["frontend"] = _abstract((B, cfg.num_patches, cfg.d_model), torch.bfloat16)
        specs["frontend"] = P(rules.batch, None, None)
    if cfg.family == "audio":
        inputs["frontend"] = _abstract((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        specs["frontend"] = P(rules.batch, None, None)
    return inputs, specs


def decode_specs(cfg: ModelConfig, shape: Shape, rules: ShardingRules):
    """decode_* cells: one new token with a cache of ``seq`` positions
    (``init_cache`` on ``meta``; its ``pos`` is a Python int, the port's
    cache convention, where JAX's is a 0-d int32)."""
    B, S = shape.batch, shape.seq
    cache = Mdl.init_cache(cfg, B, S, device="meta")
    cspecs = Mdl.cache_specs(cfg, rules)
    inputs = {"cache": cache, "tokens": _abstract((B, 1), torch.int32)}
    specs = {"cache": cspecs, "tokens": P(rules.batch, None)}
    return inputs, specs
