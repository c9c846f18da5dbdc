"""Checkpoint restore: read what the JAX package's ``CheckpointManager``
writes.

A checkpoint is ``<dir>/step_<9 digits>/arrays.npz`` plus ``meta.json``
(the ``.tmp`` directory of an unfinished save is ignored); the arrays are
keyed by JAX ``keystr`` paths, which ``models.convert.unflatten_keystr``
turns back into the nested tree.  ``restore`` returns that tree of numpy
arrays; ``models.convert.params_from_jax`` maps its ``"params"`` onto a
model, whose strict ``load_state_dict`` checks every name and shape.
Saving, async writes and keep-K come with the training slice.
"""
from __future__ import annotations

import os
import numpy as np

from repro_torch.models.convert import unflatten_keystr


class CheckpointManager:
    def __init__(self, directory: str):
        self.dir = directory

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
