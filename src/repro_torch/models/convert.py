"""Carry the JAX package's parameters over to the port.

The JAX model keeps each per-layer leaf stacked on a leading ``layers``
axis (``{"layers": {"attn": {"wq": (L, D, Hd)}}}``); the port keeps one
``Block`` per layer.  ``params_from_jax`` unstacks that axis into the
port's ``state_dict`` names (``layers.3.attn.wq``) and keeps every value
bitwise.  ``params_to_jax`` is its inverse: the per-layer leaves stacked
back on the leading ``layers`` axis, bitwise.  ``opt_to_jax`` /
``opt_from_jax`` carry the AdamW state (``m`` and ``v`` keyed like the
parameters, ``step``) across the same way, so either package resumes the
other's training.  Checkpoints written by the JAX package name their
arrays by JAX ``keystr`` paths (``['params']['layers']['attn']['wq']``);
``unflatten_keystr`` turns such a flat mapping back into the nested tree
and ``flatten_keystr`` makes one.
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
    """The port's ``state_dict`` of a dense or MoE model from the JAX
    parameter pytree (nested dicts of numpy arrays or anything
    ``np.asarray`` takes): ``["layers"]["moe"]["gate"]`` (L, E, D, F) becomes
    ``layers.{i}.moe.gate`` (E, D, F), bitwise."""
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


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def params_to_jax(params) -> dict:
    """The JAX parameter pytree (nested dicts of numpy arrays) of a ``Model``
    or of a mapping keyed by the port's parameter names (a ``state_dict``,
    or AdamW's ``m`` / ``v``): ``layers.{i}.attn.wq`` leaves stacked in
    layer order into ``["layers"]["attn"]["wq"]``, every value bitwise."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    out: dict = {}
    layers: dict[str, dict[int, Any]] = {}
    for name, t in params.items():
        head, _, rest = name.partition(".")
        if head == "layers":
            i, _, leaf = rest.partition(".")
            layers.setdefault(leaf, {})[int(i)] = t
        else:
            out[name] = _host(t)
    for leaf, by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"layers of {leaf!r} are not 0..{len(by_layer) - 1}")
        node = out.setdefault("layers", {})
        *groups, key = leaf.split(".")
        for g in groups:
            node = node.setdefault(g, {})
        node[key] = np.stack([_host(by_layer[i]) for i in range(len(by_layer))])
    return out


def opt_to_jax(opt: Mapping[str, Any]) -> dict:
    """AdamW state ``{"m", "v", "step"}`` in the JAX package's layout
    (``step`` an int32 scalar)."""
    return {"m": params_to_jax(opt["m"]), "v": params_to_jax(opt["v"]),
            "step": np.asarray(_host(opt["step"]), np.int32)}


def opt_from_jax(tree: Mapping[str, Any], device="cpu") -> dict:
    """The port's AdamW state from the JAX package's: ``m`` / ``v`` keyed by
    the port's parameter names, ``step`` a 0-d int32 tensor, on ``device``."""
    dev = torch.device(device)
    return {"m": {k: t.to(dev) for k, t in params_from_jax(tree["m"]).items()},
            "v": {k: t.to(dev) for k, t in params_from_jax(tree["v"]).items()},
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                                 device=dev)}


def flatten_keystr(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """``{"params": {"embed": a}}`` -> ``{"['params']['embed']": a}``: the
    JAX ``keystr`` path of every leaf of a tree of nested dicts."""
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}['{key}']"
        if isinstance(leaf, Mapping):
            out.update(flatten_keystr(leaf, path))
        else:
            out[path] = leaf
    return out


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
