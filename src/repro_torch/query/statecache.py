"""Process-wide LRU cache of folded per-group kernel states.

The group-state algebra (``repro_torch.core.engine``) makes the fresh fold
of a row group a first-class, re-mergeable value: this module keeps those
:class:`~repro_torch.core.engine.GroupState` values resident so a collect
after an append only decodes *fresh* groups.

Keys are fully content-addressed::

    (kernel-spec fingerprint, scan device type, lowering, file path,
     group index, group content signature, residual-predicate fingerprint)

* the *spec fingerprint* (:func:`spec_fingerprint`) covers the verb name,
  its kwargs and both capacity dims;
* the *scan device type* and the lowering ``core.backend.resolve`` picks on
  it are added per unit by ``query.exec`` — a state folded on the CPU is
  never served to a CUDA collect (or the other way round);
* the *group signature* (``EDFReader.group_signature``) hashes the group's
  content metadata, never offsets, so appends that leave old groups' bytes
  alone keep old entries valid while any rewrite invalidates them;
* the *residual fingerprint* is ``""`` for groups folded unfiltered **or**
  proved entirely by zone maps, and the predicate repr for groups that
  fold under a residual row mask.

Capacity is bounded in bytes (``REPRO_STATE_CACHE_BYTES``, default 256 MiB,
``0`` disables caching), charged as ``element_size() * numel()`` of every
tensor of the state and carry; eviction is LRU.  Cached states are the
exact tensors the fold produced — a hit is a reference, never a recompute,
and the group-state algebra never writes into them.

Each cache counts its ``hits``, ``misses`` and ``evictions`` (``clear``
starts them again); ``TOTALS`` sums them over every cache since the process
started and is never reset (``repro_torch.trace``'s ``state_cache_*``).
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Hashable

from repro_torch.core.engine import Dims, GroupState, tensor_leaves

ENV_VAR = "REPRO_STATE_CACHE_BYTES"
DEFAULT_BYTES = 256 * 1024 * 1024

# per-entry bookkeeping overhead charged on top of the tensor payload
_ENTRY_OVERHEAD = 512

TOTALS = {"hits": 0, "misses": 0, "evictions": 0}
_TOTALS_LOCK = threading.Lock()


def _total(kind: str) -> None:
    with _TOTALS_LOCK:
        TOTALS[kind] += 1


def spec_fingerprint(verb: str, dims: Dims, kwargs: dict | None = None) -> tuple:
    """Content fingerprint of one kernel spec: what makes two folded group
    states interchangeable on one device.  Includes both capacity dims
    (state shapes); the device type and its lowering go into each unit's
    key (``query.exec._unit_key``), which knows the scan's device."""
    items = tuple(sorted((k, repr(v)) for k, v in (kwargs or {}).items()))
    return (verb, int(dims.num_activities), int(dims.num_cases), items)


def state_nbytes(gs: GroupState) -> int:
    """Resident bytes of one cached group state (tensor payload + halo)."""
    total = _ENTRY_OVERHEAD
    for leaf in tensor_leaves((gs.state, gs.carry)):
        total += leaf.element_size() * leaf.numel()
    return total


class StateCache:
    """Thread-safe byte-bounded LRU of :class:`GroupState` values."""

    def __init__(self, capacity_bytes: int = DEFAULT_BYTES):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: OrderedDict[Hashable, tuple[GroupState, int]] = \
            OrderedDict()
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Hashable) -> GroupState | None:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                _total("misses")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            _total("hits")
            return hit[0]

    def contains(self, key: Hashable) -> bool:
        """Probe without touching LRU order or hit/miss counters."""
        with self._lock:
            return key in self._entries

    def put(self, key: Hashable, gs: GroupState) -> None:
        if self.capacity_bytes <= 0:
            return
        nbytes = state_nbytes(gs)
        if nbytes > self.capacity_bytes:
            return                      # larger than the whole cache
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self._entries[key] = (gs, nbytes)
            self.bytes += nbytes
            while self.bytes > self.capacity_bytes and self._entries:
                _, (_, evicted) = self._entries.popitem(last=False)
                self.bytes -= evicted
                self.evictions += 1
                _total("evictions")

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0
            self.hits = 0
            self.misses = 0
            self.evictions = 0


_CACHE: StateCache | None = None
_CACHE_LOCK = threading.Lock()


def state_cache() -> StateCache:
    """The process-wide cache (capacity from ``REPRO_STATE_CACHE_BYTES``)."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            raw = os.environ.get(ENV_VAR)
            capacity = int(raw) if raw not in (None, "") else DEFAULT_BYTES
            _CACHE = StateCache(capacity)
        return _CACHE
