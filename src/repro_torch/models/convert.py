"""Carry the JAX package's parameters over to the port.

The JAX model keeps each per-layer leaf stacked on a leading ``layers``
axis (``{"layers": {"attn": {"wq": (L, D, Hd)}}}``); the port keeps one
``Block`` per layer.  ``params_from_jax`` unstacks that axis into the
port's ``state_dict`` names (``layers.3.attn.wq``) and keeps every value
bitwise.  Checkpoints written by the JAX package name their arrays by JAX
``keystr`` paths (``['params']['layers']['attn']['wq']``);
``unflatten_keystr`` turns such a flat mapping back into the nested tree.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_KEY = re.compile(r"\['([^']*)'\]")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a dense model from the JAX parameter
    pytree (nested dicts of numpy arrays or anything ``np.asarray`` takes)."""
    state = {}
    for name, leaf in tree.items():
        if name == "layers":
            continue
        if isinstance(leaf, Mapping):
            raise ValueError(f"unexpected parameter group {name!r}")
        state[name] = _tensor(leaf)

    def walk(prefix, node):
        for key, leaf in node.items():
            if isinstance(leaf, Mapping):
                walk(f"{prefix}{key}.", leaf)
                continue
            arr = np.asarray(leaf)
            for i in range(arr.shape[0]):
                state[f"layers.{i}.{prefix}{key}"] = _tensor(arr[i])

    walk("", tree.get("layers", {}))
    return state


def unflatten_keystr(flat: Mapping[str, Any]) -> dict:
    """``{"['params']['embed']": a, ...}`` -> ``{"params": {"embed": a}}``.

    The JAX package's train state is nested dicts, so every path is a chain
    of ``['name']`` keys."""
    out: dict = {}
    for path, leaf in flat.items():
        keys, pos = [], 0
        for m in _KEY.finditer(path):
            if m.start() != pos:
                break
            keys.append(m.group(1))
            pos = m.end()
        if not keys or pos != len(path):
            raise ValueError(f"not a JAX keystr path of dict keys: {path!r}")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out
