"""Carry the JAX package's parameters over to the port.

The JAX model keeps each per-layer leaf stacked on a leading axis
(``{"layers": {"attn": {"wq": (L, D, Hd)}}}``, and ``enc_layers``,
``groups``); the port keeps one module per layer.  ``params_from_jax``
unstacks those axes into the port's ``state_dict`` names
(``layers.3.attn.wq``, ``groups.1.mlstm.4.up``) and keeps every value
bitwise.  ``params_to_jax`` is its inverse: the per-layer leaves stacked
back, bitwise.  ``opt_to_jax`` /
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


# The JAX parameter groups stacked on a leading axis, each mapped to the
# groups stacked again inside it: the xLSTM's mLSTM blocks sit on a second
# axis, (G, n_m, ...), beside their norms, one (G, n_m, D) leaf.
STACKED = {"layers": {}, "enc_layers": {}, "groups": {"mlstm": {}}}


def _walk(state, prefix, node, stacked):
    for key, leaf in node.items():
        if key in stacked:
            arrs = _leaves(leaf)
            n = next(iter(arrs.values())).shape[0]
            for i in range(n):
                _walk(state, f"{prefix}{key}.{i}.", _nest({k: a[i] for k, a in arrs.items()}),
                      stacked[key])
        elif isinstance(leaf, Mapping):
            _walk(state, f"{prefix}{key}.", leaf, {})
        else:
            state[prefix + key] = _tensor(leaf)


def _leaves(node, prefix=()):
    out = {}
    for key, leaf in node.items():
        if isinstance(leaf, Mapping):
            out.update(_leaves(leaf, (*prefix, key)))
        else:
            out[(*prefix, key)] = np.asarray(leaf)
    return out


def _nest(flat):
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the JAX parameter pytree (nested dicts
    of numpy arrays or anything ``np.asarray`` takes), bitwise: each group
    of ``STACKED`` unstacked into a module list (``["layers"]["moe"]["gate"]``
    (L, E, D, F) becomes ``layers.{i}.moe.gate`` (E, D, F);
    ``["groups"]["mlstm"]["up"]`` (G, n_m, ...) becomes
    ``groups.{g}.mlstm.{j}.up``), every other leaf kept whole
    (``shared.attn.wq``, ``enc_norm``)."""
    state: dict[str, torch.Tensor] = {}
    _walk(state, "", tree, STACKED)
    return state


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _stack(name, by_index: dict) -> np.ndarray:
    """The leaves keyed by their module-list indices, stacked on as many
    leading axes as there are indices."""
    if list(by_index) == [()]:
        return _host(by_index[()])
    firsts = sorted({i[0] for i in by_index})
    if firsts != list(range(len(firsts))):
        raise ValueError(f"layers of {name!r} are not 0..{len(firsts) - 1}")
    return np.stack([_stack(name, {i[1:]: t for i, t in by_index.items() if i[0] == f})
                     for f in firsts])


def params_to_jax(params) -> dict:
    """The JAX parameter pytree (nested dicts of numpy arrays) of a ``Model``
    or of a mapping keyed by the port's parameter names (a ``state_dict``,
    or AdamW's ``m`` / ``v``): the inverse of ``params_from_jax``.  Each
    index of a module list in a name is a stacked axis, in the order of the
    name (``groups.{g}.mlstm.{j}.up`` -> ``["groups"]["mlstm"]["up"][g, j]``),
    every value bitwise."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    leaves: dict[tuple, dict[tuple, Any]] = {}
    for name, t in params.items():
        parts = name.split(".")
        path = tuple(p for p in parts if not p.isdigit())
        leaves.setdefault(path, {})[tuple(int(p) for p in parts if p.isdigit())] = t
    return _nest({path: _stack(".".join(path), by_index)
                  for path, by_index in leaves.items()})


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
