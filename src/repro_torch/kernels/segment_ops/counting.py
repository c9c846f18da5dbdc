"""What ``histogram_cuda`` and ``pair_count_cuda`` share: the input checks
and the launch plan of the counting kernels (``kernels/csrc/counting.cuh``).

A call on the shared-memory route is two kernel nodes.  ``count_rows``
walks the rows in 4-row groups (one 16-byte load of each id column a
group, after ``head`` rows that reach a 16-byte boundary), split into
``grid`` contiguous shares of ``per_block`` groups; each block adds into
its bins in shared memory and stores them as row ``g`` of ``partials``
(grid, bins).  ``count_finish`` then stores ``out[b] = into[b] + sum_g
partials[g, b]`` once per bin.  Rows outside the whole groups (the
``head`` rows and up to 3 after the last group) are block 0's.
:func:`count_plan` is that plan; the CPU tests replay it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

THREADS = 512                  # count_rows' block
SHARED_BYTES = 232_448         # opt-in shared memory a block may use
BLOCKS_PER_SM = 2              # count_rows blocks an SM, while their bins fit
GLOBAL_BLOCKS_PER_SM = 8       # the global route's grid

_SMS: dict[int, int] = {}


class Plan(NamedTuple):
    grid: int        # count_rows blocks: partials is (grid, bins)
    head: int        # rows before the first 16-byte-aligned group
    vec: bool        # groups read 16 bytes a load (else four scalar loads)
    groups: int      # whole 4-row groups after the head
    per_block: int   # groups a block walks
    tail: int        # rows after the last whole group


def shared_route(num_bins: int) -> bool:
    """Whether one copy of the bins fits a block's shared memory."""
    return 4 * num_bins <= SHARED_BYTES


def count_plan(n: int, num_bins: int, sms: int, head: int | None) -> Plan:
    """The shared route's plan for ``n`` rows on a card of ``sms`` SMs.

    ``head`` is the number of rows before the inputs all reach a 16-byte
    boundary (0-3, from :func:`head_rows`), or None when they never do
    together (then every group is four scalar loads).  The grid covers the
    groups once, about one group a thread, at most two blocks an SM (one
    when two blocks' bins would not fit an SM)."""
    vec = head is not None
    head = min(head, n) if vec else 0
    groups = (n - head) // 4
    fits = 4 * num_bins <= SHARED_BYTES // BLOCKS_PER_SM - 1024
    per_sm = BLOCKS_PER_SM if fits else 1
    grid = max(1, min(-(-groups // THREADS), per_sm * sms))
    per_block = -(-groups // grid)
    return Plan(grid, head, vec, groups, per_block,
                n - head - 4 * groups)


def head_rows(*tensors: torch.Tensor) -> int | None:
    """Rows before every one of ``tensors`` (1-D, int32 or bool) reaches a
    16-byte boundary for its ids (4 bytes a row) and a 4-byte one for its
    bools, or None when their offsets differ."""
    off = None
    for t in tensors:
        o = (t.data_ptr() // t.element_size()) % 4
        if off is None:
            off = o
        elif o != off:
            return None
    return (4 - off) % 4


def sm_count(index: int) -> int:
    """The SM count of card ``index``, read once."""
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def check_inputs(what: str, ids: dict, weights: torch.Tensor,
                 into: torch.Tensor | None, shape: tuple) -> torch.device:
    """Validate a counting kernel's inputs and return their device: ``ids``
    1-D contiguous int32, ``weights`` int32 or bool of the same length, all
    on one device; ``into`` None or a contiguous int32 tensor of ``shape``
    on that device."""
    device = weights.device
    n = weights.shape[0] if weights.dim() == 1 else None
    for name, t in (*ids.items(), ("weights", weights)):
        if t.device != device:
            raise ValueError(f"{what}: inputs on different devices "
                             f"{t.device} and {device}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{what}: inputs must be 1-D of one length, got "
                             f"{name} {tuple(t.shape)} and weights "
                             f"{tuple(weights.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if name != "weights" and t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
    if weights.dtype not in (torch.int32, torch.bool):
        raise TypeError(f"{what}: weights must be int32 or bool, got "
                        f"{weights.dtype}")
    if into is not None:
        if into.dtype != torch.int32:
            raise TypeError(f"{what}: into must be int32, got {into.dtype}")
        if into.device != device:
            raise ValueError(f"{what}: into on {into.device}, inputs on {device}")
        if tuple(into.shape) != tuple(shape) or not into.is_contiguous():
            raise ValueError(f"{what}: into must be a contiguous {tuple(shape)} "
                             f"tensor, got {tuple(into.shape)}")
    return device


def buffers(shape: tuple, num_bins: int, n: int, into: torch.Tensor | None,
            device: torch.device, sms: int, tensors: tuple):
    """``(out, partials, plan)`` for a launch: on the shared route ``out``
    and the ``(grid, num_bins)`` partials come from ``torch.empty`` (the
    kernels write every element); on the global route ``out`` holds
    ``into`` (or zeros), ``partials`` is None and ``plan.grid`` is the
    global kernel's grid."""
    if shared_route(num_bins):
        plan = count_plan(n, num_bins, sms, head_rows(*tensors))
        out = torch.empty(shape, dtype=torch.int32, device=device)
        partials = torch.empty((plan.grid, num_bins), dtype=torch.int32,
                               device=device)
        return out, partials, plan
    out = (torch.zeros(shape, dtype=torch.int32, device=device) if into is None
           else into.clone())
    grid = max(1, min(-(-n // THREADS), GLOBAL_BLOCKS_PER_SM * sms))
    return out, None, Plan(grid, 0, False, 0, 0, n)


def launch(lib, fn, what: str, ids: tuple, weights: torch.Tensor,
           shape: tuple, into: torch.Tensor | None) -> torch.Tensor:
    """Allocate, launch ``fn`` (the C entry point, which takes the id
    pointers, the weights, ``n`` and ``shape``) on the current stream of the
    inputs' card and raise on a launch error; returns ``out``."""
    device = weights.device
    index = device.index
    n = weights.shape[0]
    num_bins = 1
    for s in shape:
        num_bins *= s
    out, partials, plan = buffers(shape, num_bins, n, into, device,
                                  sm_count(index), (*ids, weights))
    args = (*(t.data_ptr() for t in ids), weights.data_ptr(),
            weights.dtype == torch.bool, n, *shape,
            None if into is None else into.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(), plan.grid,
            plan.head if plan.vec else -1, index,
            torch.cuda.current_stream(device).cuda_stream)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    _build.check(lib, err, what)
    return out
