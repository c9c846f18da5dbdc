"""Checkpointing in the JAX package's format: atomic saves, async writes,
keep-K, restore of either package's checkpoints.

A checkpoint is ``<dir>/step_<9 digits>/arrays.npz`` plus ``meta.json``.
Arrays are keyed by JAX ``keystr`` paths of the JAX package's train state
(``['params']['layers']['attn']['wq']``, ``['opt']['m'][...]``,
``['opt']['step']``), each per-layer leaf stacked on a leading ``layers``
axis (``models.convert.params_to_jax`` / ``opt_to_jax``), so the JAX
package's ``CheckpointManager.restore_latest(like)`` reads what the port
writes, and ``restore`` here reads what the JAX package writes, bitwise
both ways.

The fault-tolerance contract is the JAX package's: a save writes
``step_N.tmp`` and renames it into place with ``os.replace``, so a failure
mid-save never corrupts the latest checkpoint and ``latest_step`` sees
only complete ones; async mode copies the state to the host synchronously
and writes on a worker thread; ``keep`` newest checkpoints survive.
``load_train_state`` puts a restored tree into a new ``Model`` and AdamW
state on a given device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models import model as Mdl
from repro_torch.models.convert import (flatten_keystr, opt_from_jax, opt_to_jax,
                                        params_from_jax, params_to_jax,
                                        unflatten_keystr)
from repro_torch.models.module import Empty


def state_to_jax(state: dict) -> dict:
    """The JAX package's train-state tree (nested dicts of numpy arrays) of
    the port's ``{"params": Model, "opt": {...}}``."""
    return {"params": params_to_jax(state["params"]), "opt": opt_to_jax(state["opt"])}


def load_train_state(cfg, tree: dict, device="cuda") -> dict:
    """``{"params": Model, "opt": {...}}`` on ``device`` from a restored
    tree (``CheckpointManager.restore``); every value bitwise."""
    model = Mdl.init_params(cfg, Empty(cfg.param_dtype, device))
    with torch.no_grad():
        model.load_state_dict(params_from_jax(tree["params"]))
    return {"params": model, "opt": opt_from_jax(tree["opt"], device)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: dict, extra: dict | None = None):
        """Save the port's train state ``{"params": Model, "opt": {...}}``
        as ``step``."""
        host = flatten_keystr(state_to_jax(state))   # device -> host, synchronous
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def _write(self, step: int, host: dict, extra: dict):
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **extra}, f)
        os.replace(tmp, final) if not os.path.exists(final) else shutil.rmtree(tmp)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int) -> dict:
        """The nested tree of numpy arrays saved at ``step``."""
        path = os.path.join(self.dir, f"step_{step:09d}", "arrays.npz")
        with np.load(path) as z:
            return unflatten_keystr({k: z[k] for k in z.files})

    def restore_latest(self):
        s = self.latest_step()
        if s is None:
            return None, None
        return s, self.restore(s)
