"""Batched serving engine: prefill + decode loop with a preallocated KV cache.

Prefill runs the whole prompt through the model (on a card, each layer's
attention is the flash-attention kernel) and copies its bf16 K / V into a
cache preallocated at ``max(max_len, prompt length)``; each decode step
then writes one position of that cache in place.  The other entries of a
family's cache (``models.model.init_cache``) are not grown, as in the JAX
package's ``_grow_cache``: recurrent states are O(1), and Whisper's cross
K / V keep ``enc_seq`` rows.  The vlm and audio families take a
``frontend`` (patch embeddings / encoder frames, ``(B, n, d_model)``) at
prefill.  Tokens stay on the device until the loop ends.

Past the cache the shapes are the JAX package's: a prompt longer than
``max_len`` keeps a cache of its own length, and a decode step at a
position past the cache writes its K / V onto the last slot (as
``dynamic_update_slice`` clamps there) while attending over every slot
and taking RoPE at its true position.  So tokens past the cache are
computed on an overwritten last slot, exactly as in JAX, with no error.
A vlm prompt's cache holds its ``num_patches`` patch positions before its
tokens, so its ``max_len`` counts them too: ``num_patches + prompt length
+ steps`` keeps every decode step in the cache.  Sampling draws from
``torch.multinomial`` with the caller's generator: the same distribution
as the JAX package's ``jax.random.categorical``, not its bits.
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
    model's experts when ``cfg.moe_impl == "shard_map"``.  ``max_len`` is
    the cache's positions: for the vlm family, the patch prefix's
    ``num_patches`` are among them (past the cache, decode overwrites its
    last slot, as the module docstring says)."""

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
    def prefill(self, prompts, frontend=None):
        """(last-token logits, cache with its K / V preallocated at
        ``max(max_len, prompt length)``)."""
        tokens = torch.as_tensor(prompts, device=self.device).long()
        if frontend is not None:
            frontend = torch.as_tensor(frontend, device=self.device)
        logits, cache = Mdl.prefill(self.cfg, self.model, tokens, frontend=frontend,
                                    mesh=self.mesh)
        full = dict(cache)
        for name in ("k", "v"):
            if name in cache:
                t = cache[name]
                s = t.shape[2]
                full[name] = t.new_zeros((*t.shape[:2], max(self.max_len, s), *t.shape[3:]))
                full[name][:, :, :s] = t
        return logits, full

    @torch.inference_mode()
    def decode(self, cache, tok):
        """One step: ``tok`` (B, 1) -> (logits (B, V), cache)."""
        return Mdl.decode_step(self.cfg, self.model, cache, tok, mesh=self.mesh)

    @torch.inference_mode()
    def generate(self, prompts, steps: int, *, frontend=None, greedy: bool = True,
                 generator: torch.Generator | None = None) -> GenerationResult:
        logits, cache = self.prefill(prompts, frontend)
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
