"""Gradient compression for the slow all-reduce: int8 with error feedback.

The JAX package's ``train/compression.py``.  int8 quantization with one
scale a tensor and **error feedback**: the quantization residual is carried
to the next step, so the compression error averages out over steps.
``psum_compressed`` is the cross-shard mean over the single-controller
mesh of ``distributed/mesh.py`` (per-shard lists, shard order), as the JAX
package runs it inside ``shard_map``: the shards agree on a scale through
``pmax`` of their local abs-maxima, the int8 payloads are summed in int32
(no fan-in overflow), and the sum is scaled back and divided by the shard
count.  Trees are dicts of tensors; ``torch.round`` rounds half to even, as
``jnp.round`` does, so every value is the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.distributed import mesh as M


def quantize(x: torch.Tensor):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Mapping[str, torch.Tensor], errors: Mapping[str, torch.Tensor]):
    """Quantize (grads + carried errors); return (q_tree, scales, new_errors)."""
    qs, ss, es = {}, {}, {}
    for k, g in grads.items():
        x = g.to(torch.float32) + errors[k]
        qs[k], ss[k] = quantize(x)
        es[k] = x - dequantize(qs[k], ss[k])
    return qs, ss, es


def psum_compressed(grads_per_shard: list, errors_per_shard: list):
    """Error-feedback int8 mean over the shards: ``(means, new_errors)``,
    each a per-shard list of dicts on the shards' devices."""
    n = len(grads_per_shard)
    means = [{} for _ in range(n)]
    errs = [{} for _ in range(n)]
    for k in grads_per_shard[0]:
        xs = [g[k].to(torch.float32) + e[k] for g, e in zip(grads_per_shard, errors_per_shard)]
        scales = [torch.clamp(s / 127.0, min=1e-12)
                  for s in M.pmax([x.abs().max() for x in xs])]
        qs = [torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
              for x, s in zip(xs, scales)]
        sums = M.psum([q.to(torch.int32) for q in qs])
        for i in range(n):
            errs[i][k] = xs[i] - qs[i].to(torch.float32) * scales[i]
            means[i][k] = sums[i].to(torch.float32) * scales[i] / n
    return means, errs


def init_errors(params: Mapping[str, torch.Tensor]) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
