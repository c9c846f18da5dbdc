"""Fault tolerance: failure injection, straggler mitigation, elastic re-mesh.

The JAX package's ``train/ft.py``.  Around the train loop:

* **Failure detection**: a step that raises marks the step failed.
* **Restart policy**: reload the latest complete checkpoint
  (``checkpoint.py``) and continue; the data pipeline is a pure function of
  (epoch, step), so it re-seeks deterministically.
* **Straggler mitigation**: per-step wall times feed an EWMA; a step slower
  than ``factor`` x EWMA is logged and counted.
* **Elastic re-mesh**: on permanent device loss, rebuild a (data, model)
  grid from the surviving devices (the largest that keeps the model axis
  whole) and restore the checkpoint into it (checkpoints are
  topology-free).

Tests drive these with a ``FailureInjector`` that raises on chosen steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


class FailureInjector:
    """Deterministically raise at chosen steps (simulated node failure)."""

    def __init__(self, fail_at: set[int]):
        self.fail_at = set(fail_at)
        self.failed: list[int] = []

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failed.append(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 2.0
    alpha: float = 0.2
    ewma: float | None = None
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        is_straggler = self.ewma is not None and dt > self.factor * self.ewma
        self.ewma = dt if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * dt
        if is_straggler:
            self.stragglers += 1
        return is_straggler


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A (data, model) grid of ``torch.device`` s, the 2-D counterpart of
    ``distributed.mesh.Mesh``: ``devices[i][j]`` is data shard *i*, model
    shard *j*."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}


def elastic_mesh(num_devices: int, model_parallel: int, devices=None) -> GridMesh:
    """Largest (data, model) mesh from surviving devices; drops remainders.

    Keeps the model axis intact (a model shard cannot run degraded) and
    shrinks the data axis: throughput degrades, correctness does not.
    ``devices`` defaults to every visible card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)[:num_devices]
    data = max(1, len(devices) // model_parallel)
    usable = devices[: data * model_parallel]
    if len(usable) < data * model_parallel:
        raise ValueError(f"{len(devices)} devices cannot hold a model axis of "
                         f"{model_parallel}")
    return GridMesh(tuple(tuple(usable[i * model_parallel:(i + 1) * model_parallel])
                          for i in range(data)))


def run_with_restarts(train_loop: Callable[[int], int], *, max_restarts: int = 5,
                      on_restart: Callable[[int], None] | None = None) -> int:
    """Drive ``train_loop(start_step) -> last_step`` through failures.

    ``train_loop`` must checkpoint internally and raise on failure; it is
    resumed with ``start = -1``, the sentinel for "re-read the latest
    checkpoint"."""
    restarts = 0
    start = 0
    while True:
        try:
            return train_loop(start)
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(restarts)
            start = -1
