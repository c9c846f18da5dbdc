"""Repeated units of the model code: ``scan``.

``scan(n, body, carry, xs, axis)`` runs ``body(carry, *x_i) -> (carry, y)``
for ``i`` in ``range(n)``, ``x_i`` the ``i``-th slice of each tensor of
``xs`` along ``axis``, and returns the last carry and the outputs stacked
along ``axis`` (a tuple of stacks when ``y`` is a tuple): the JAX
package's ``lax.scan``, written as a Python loop (the SSD chunks of
``mamba2``, the mLSTM chunks and the sLSTM tokens of ``xlstm``).  Each step
runs the same operations on tensors of the same shapes.

``WEIGHER`` is None except inside the launch tooling's accounting
(``launch.account.Account.weigh_loops``), which traces the body once and
counts it ``n`` times, as the JAX package's ``launch/hlo.py`` weights a
``while`` body by its trip count, and returns outputs of the same shapes.
"""
from __future__ import annotations

import torch

WEIGHER = None


def scan(n: int, body, carry, xs: tuple = (), axis: int = 1):
    if WEIGHER is not None and n > 1:
        return WEIGHER(n, body, carry, xs, axis)
    ys = []
    for i in range(n):
        carry, y = body(carry, *(x.select(axis, i) for x in xs))
        ys.append(y)
    if isinstance(ys[0], tuple):
        return carry, tuple(torch.stack(list(y), axis) for y in zip(*ys))
    return carry, torch.stack(ys, axis)
