"""Spans and counters of the collect path.

Spans are ``torch.profiler`` ranges: while a profiler records,
``span(name)`` enters ``record_function("repro_torch." + name)``, so the
span is an event of the profiler's own trace, on the clock of the device's
kernels and copies and nested under the span that caused it.  With no
profiler running it returns one shared no-op context, after a single check
of the profiler's state (``record_function`` itself costs microseconds a
call even with no profiler running).  There is no switch: run
``torch.profiler`` around the calls to see the spans.

Counters are integer attributes of the functions that do the work, as the
kernel wrappers' ``.launches`` are.  :func:`host_read` and
:func:`to_device` make the collect path's copies between host and device
and count each as a host sync (the host waits for the device's stream)
with its bytes; they count on every device, so a CPU run counts what a run
on the card does.  :func:`counters` takes one snapshot of these and of
every mining kernel wrapper's ``.launches``; the difference of two
snapshots is what the calls between them did.

The spans of the in-memory collect path (every name under ``repro_torch.``)::

    collect / collect_many's root      collect
      the capacities (Dims)              facade.dims
      the filter chain                   filter
        a row predicate                    filter.rows
        a case predicate                   filter.case
          its phase one                      filter.case.phase1
          its keep mask back on the rows     filter.case.keep
      the fold and finalize              fold
        a chunk's halo reads               fold.halo
        a verb's carry and state           fold.init.<verb>
        a verb's update                    fold.update.<verb>
          a hand-written kernel's launch     kernel.<name>
        a verb's finalize                  fold.finalize.<verb>
      the answer into host memory        collect.deliver

``collect.deliver`` (``dataset.engines._deliver``) copies a card answer's
tensors into page-locked host memory; its counters are apart from the
fold's own copies: ``answer_tensors`` and ``answer_d2h_bytes`` (what it
copied) and ``answer_pinned_new`` (the blocks the caching host allocator
pinned anew rather than served from its cache: its ``num_host_alloc``,
read once a snapshot; the delivery is the port's only pinned allocation,
so a snapshot's difference is the delivery's).

The spans of the file path (a ``Dataset`` over EDF files; every span on
the thread that calls ``collect``, none held across a ``yield``; the
read-ahead's decode threads open none)::

    collect / collect_many's root      collect
      auto's zone-map estimate           scan.plan
      the streaming engine               scan
        the plan and its compile           scan.plan
        waiting for a read-ahead group     scan.wait
        a group read on this thread        scan.read
        a decoded group to the device      scan.h2d
        a ghost chunk built (and folded)   scan.ghost
          its copy to the device             scan.h2d
        a verb's carry and state           fold.init.<verb>
        a verb's update                    fold.update.<verb>
          a hand-written kernel's launch     kernel.<name>
        a verb's finalize                  fold.finalize.<verb>
        the grouped path's merge           scan.merge
      the answer into host memory        collect.deliver

``scan.read`` opens where the consumer reads itself (the read-ahead off,
the grouped path, the single-pass case filter); a case filter's keep mask
goes to the device in a ``scan.h2d`` too.  Its counters:
``scan_groups_read``, ``scan_groups_cached``, ``scan_groups_skipped``,
``scan_rows_read`` and ``scan_bytes_read`` (compressed), the sums of each
streaming collect's ``ScanReport``; ``scan_h2d_bytes``, what the scan copied
to the device (not a host sync: ``host_syncs`` keeps its meaning);
``edf_decode_ns``, the time in ``EDFReader.read_group_numpy`` (fetch plus
decode) summed over the threads that ran it: the read-ahead decodes several
groups at once on a pool of host threads, so this is thread time, which
can exceed the wall time it overlaps; ``scan_ahead_ready`` and
``scan_ahead_waited``, the read-ahead groups whose decode had finished when
the scan asked for them and those it waited on (``scan.wait``: their share
says how often the pool keeps ahead); ``state_cache_hits``,
``state_cache_misses`` and ``state_cache_evictions`` of the group-state
cache; ``memo_hits`` and ``memo_misses`` of the result memo (file datasets
only).
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range ``repro_torch.<name>`` while a profiler
    records; a shared no-op context otherwise."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def host_read(t: torch.Tensor, convert=torch.Tensor.cpu):
    """``convert(t)``: a read of ``t`` back to the host (``Tensor.cpu``,
    ``Tensor.tolist``, ``int``), counted as one host sync and ``t``'s
    bytes."""
    host_read.host_syncs += 1
    host_read.d2h_bytes += t.numel() * t.element_size()
    return convert(t)


def to_device(data, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)``: a host value
    (a Python number, a numpy array) copied to ``device``, counted as one
    host sync and its bytes."""
    t = torch.as_tensor(data, dtype=dtype, device=device)
    to_device.host_syncs += 1
    to_device.h2d_bytes += t.numel() * t.element_size()
    return t


host_read.host_syncs = 0
host_read.d2h_bytes = 0
to_device.host_syncs = 0
to_device.h2d_bytes = 0


def counters() -> dict[str, int]:
    """One snapshot: ``host_syncs``, ``d2h_bytes``, ``h2d_bytes``, the
    delivery's ``answer_tensors``, ``answer_d2h_bytes`` and
    ``answer_pinned_new``, ``launches.<kernel>`` for each mining kernel
    wrapper, and the file path's ``scan_*``, ``edf_decode_ns``,
    ``state_cache_*`` and ``memo_*``."""
    from repro_torch.dataset.engines import (SCAN_FIELDS, _count_scan,
                                             _deliver, _memo_get)
    from repro_torch.kernels import segment_ops as k
    from repro_torch.query import statecache
    from repro_torch.query.exec import _h2d, _read_ahead
    from repro_torch.storage.edf import EDFReader

    wrappers = {
        "pair_count": k.pair_count_cuda,
        "histogram": k.histogram_cuda,
        "segment_reduce": k.segment_reduce_cuda,
        "ordered_histogram": k.ordered_histogram_cuda,
        "segmented_polyhash": k.segmented_polyhash_cuda,
        "segmented_affine": k.segmented_affine_cuda,
        "segmented_sum_scan": k.segmented_sum_scan_cuda,
    }
    out = {"host_syncs": host_read.host_syncs + to_device.host_syncs,
           "d2h_bytes": host_read.d2h_bytes,
           "h2d_bytes": to_device.h2d_bytes,
           "answer_tensors": _deliver.answer_tensors,
           "answer_d2h_bytes": _deliver.answer_d2h_bytes,
           "answer_pinned_new": torch.cuda.host_memory_stats().get(
               "num_host_alloc", 0)}
    out.update({f"launches.{k}": fn.launches for k, fn in wrappers.items()})
    out.update({f"scan_{f}": getattr(_count_scan, f) for f in SCAN_FIELDS})
    out["scan_h2d_bytes"] = _h2d.nbytes
    out["edf_decode_ns"] = EDFReader.decode_ns
    out["scan_ahead_ready"] = _read_ahead.ready
    out["scan_ahead_waited"] = _read_ahead.waited
    out.update({f"state_cache_{k}": v
                for k, v in statecache.TOTALS.items()})
    out.update(memo_hits=_memo_get.hits, memo_misses=_memo_get.misses)
    return out
