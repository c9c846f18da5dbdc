"""Batched serving engine: prefill + decode loop with a preallocated KV cache.

Prefill runs the whole prompt through the model (on a card, each layer's
attention is the flash-attention kernel) and copies its bf16 K / V into a
cache preallocated at ``max(max_len, prompt length)``; each decode step
then writes one position of that cache in place.  Tokens stay on the
device until the loop ends.

Past the cache the shapes are the JAX package's: a prompt longer than
``max_len`` keeps a cache of its own length, and a decode step at a
position past the cache writes its K / V onto the last slot (as
``dynamic_update_slice`` clamps there) while attending over every slot
and taking RoPE at its true position.  So tokens past the cache are
computed on an overwritten last slot, exactly as in JAX.  Sampling draws from ``torch.multinomial`` with the caller's
generator: the same distribution as the JAX package's
``jax.random.categorical``, not its bits.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.models import model as Mdl
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import Empty


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, steps) int32
    prefill_logits: np.ndarray  # (B, V): the last logits computed, as the
                                # JAX engine returns them (the prefill's when steps == 0)


class Engine:
    """``params_or_model`` is a ``Model`` (moved to ``device``) or a
    ``state_dict`` (``models.convert.params_from_jax``), loaded into a new
    model on ``device``.  ``mesh`` (``distributed.mesh.Mesh``) shards a MoE
    model's experts when ``cfg.moe_impl == "shard_map"``."""

    def __init__(self, cfg: ModelConfig, params_or_model, max_len: int = 512,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        if isinstance(params_or_model, Mapping):
            model = Mdl.init_params(cfg, Empty(cfg.param_dtype, self.device))
            model.load_state_dict(params_or_model)
        else:
            model = params_or_model.to(self.device)
        self.model = model
        self.max_len = max_len

    @torch.inference_mode()
    def prefill(self, prompts):
        """(last-token logits, cache preallocated at ``max(max_len, prompt
        length)``)."""
        tokens = torch.as_tensor(prompts, device=self.device).long()
        logits, cache = Mdl.prefill(self.cfg, self.model, tokens, mesh=self.mesh)
        s = cache["pos"]
        full = Mdl.init_cache(self.cfg, tokens.shape[0], max(self.max_len, s),
                              self.device)
        full["k"][:, :, :s] = cache["k"]
        full["v"][:, :, :s] = cache["v"]
        full["pos"] = s
        return logits, full

    @torch.inference_mode()
    def decode(self, cache, tok):
        """One step: ``tok`` (B, 1) -> (logits (B, V), cache)."""
        return Mdl.decode_step(self.cfg, self.model, cache, tok, mesh=self.mesh)

    @torch.inference_mode()
    def generate(self, prompts, steps: int, *, greedy: bool = True,
                 generator: torch.Generator | None = None) -> GenerationResult:
        logits, cache = self.prefill(prompts)
        toks = []
        tok = logits.argmax(-1)[:, None]
        for _ in range(steps):
            toks.append(tok[:, 0])
            logits, cache = self.decode(cache, tok)
            if greedy:
                tok = logits.argmax(-1)[:, None]
            else:
                probs = torch.softmax(logits.float(), dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
        b = logits.shape[0]
        tokens = (torch.stack(toks, 1) if toks
                  else torch.zeros((b, 0), dtype=torch.long, device=self.device))
        return GenerationResult(tokens.to(torch.int32).cpu().numpy(),
                                logits.float().cpu().numpy())
