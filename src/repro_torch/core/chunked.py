"""ChunkedEventFrame — a re-iterable stream of device-sized log chunks.

The out-of-core substrate for ``core.engine``: a source of (case,time)-sorted
``EventFrame`` chunks that never holds more than one chunk's columns on the
device at a time.  Constructors cover the paper's Table-6 scenario:

* :meth:`from_edf`        — stream the row groups of an EDF file with
                            per-group column projection (disk -> device);
* :meth:`from_frame` / :meth:`from_cuts` — slice an in-memory frame
                            (the testing / re-chunking path);
* :meth:`from_synthetic`  — generate the log case-batch by case-batch, so a
                            log larger than device memory is *born* chunked.

Every source names the device its chunks land on; ``run_streaming`` builds
the kernel state there.  The stream is re-iterable, ordered, and chunk
boundaries may split a case anywhere — the engine's carries stitch them
back together.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator

import torch

from .eventframe import CASE, EventFrame


def _slice(frame: EventFrame, lo: int, hi: int, device) -> EventFrame:
    out = EventFrame(
        {k: v[lo:hi] for k, v in frame.columns.items()},
        {k: v[lo:hi] for k, v in frame.valid.items()},
        frame.row_valid[lo:hi] if frame.row_valid is not None else None,
    )
    return out if device == frame.device else out.to(device)


class ChunkedEventFrame:
    """Re-iterable source of (case,time)-sorted EventFrame chunks on ``device``."""

    def __init__(self, factory: Callable[[], Iterable[EventFrame]], device,
                 num_chunks: int | None = None,
                 tables: dict[str, list] | None = None):
        self._factory = factory
        self.device = torch.device(device)
        self.num_chunks = num_chunks
        self.tables = tables or {}

    def __iter__(self) -> Iterator[EventFrame]:
        return iter(self._factory())

    def __len__(self) -> int:
        if self.num_chunks is None:
            raise TypeError("chunk count unknown for this source")
        return self.num_chunks

    # ----------------------------------------------------------- sources
    @classmethod
    def from_frame(cls, frame: EventFrame, chunk_rows: int, *,
                   device=None) -> "ChunkedEventFrame":
        """Slice an in-memory frame into contiguous chunks of ``chunk_rows``,
        each copied to ``device`` (default: the frame's own device) — a
        host-resident log streams to the card one chunk at a time."""
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        n = frame.nrows
        num = max(1, -(-n // chunk_rows))
        device = frame.device if device is None else torch.device(device)

        def gen():
            for lo in range(0, max(n, 1), chunk_rows):
                yield _slice(frame, lo, min(lo + chunk_rows, n), device)

        return cls(gen, device, num_chunks=num)

    @classmethod
    def from_cuts(cls, frame: EventFrame, cuts, *,
                  device=None) -> "ChunkedEventFrame":
        """Arbitrary chunking at the given sorted row offsets, each chunk on
        ``device`` (default: the frame's) — the testing aid: chunk-invariance
        properties exercise adversarial cut points."""
        n = frame.nrows
        edges = sorted(set([0] + [int(c) for c in cuts if 0 < int(c) < n] + [n]))
        device = frame.device if device is None else torch.device(device)

        def gen():
            for lo, hi in zip(edges[:-1], edges[1:]):
                yield _slice(frame, lo, hi, device)

        return cls(gen, device, num_chunks=len(edges) - 1)

    @classmethod
    def from_edf(cls, path: str, columns: Iterable[str] | None = None, *,
                 device="cuda") -> "ChunkedEventFrame":
        """Stream an EDF file row-group by row-group with column projection;
        each group is decoded on the host and copied to ``device``.

        EDFV0002/3 files yield one chunk per row group; legacy EDFV0001
        files (no groups) degrade to a single chunk.
        """
        from repro_torch.storage import edf

        columns = tuple(columns) if columns is not None else None
        header, _ = edf.read_header(path)
        num = edf.num_row_groups_header(header)
        tables = {c["name"]: list(c["table"]) for c in header["columns"]
                  if "table" in c}

        def gen():
            for frame, _tables in edf.read_streaming(path, columns=columns,
                                                     device=device):
                yield frame

        return cls(gen, device, num_chunks=num, tables=tables)

    @classmethod
    def from_synthetic(cls, num_cases: int, cases_per_chunk: int,
                       num_activities: int = 26, seed: int = 0, *,
                       device="cuda", **gen_kwargs) -> "ChunkedEventFrame":
        """Generate a Markov-chain log (``data.synthetic``) one case-batch at
        a time; case ids are offset per batch so the stream stays globally
        (case,time)-sorted without ever holding the full log."""
        from repro_torch.data import synthetic

        if cases_per_chunk <= 0:
            raise ValueError("cases_per_chunk must be positive")
        num = max(1, -(-num_cases // cases_per_chunk))

        def gen():
            done = 0
            batch_idx = 0
            while done < num_cases:
                batch = min(cases_per_chunk, num_cases - done)
                cols, _ = synthetic.generate_numpy(
                    num_cases=batch, num_activities=num_activities,
                    seed=seed + 1_000_003 * batch_idx, **gen_kwargs)
                cols[CASE] = cols[CASE] + done
                yield EventFrame.from_numpy(cols, device=device)
                done += batch
                batch_idx += 1

        tables = {"concept:name": [f"act_{i:03d}" for i in range(num_activities)]}
        return cls(gen, device, num_chunks=num, tables=tables)

    # ----------------------------------------------------------- utility
    def materialize(self) -> EventFrame:
        """Concatenate the stream into one frame on the source's device
        (small logs / testing)."""
        chunks = list(self)
        cols = {k: torch.cat([c.columns[k] for c in chunks])
                for k in chunks[0].columns}
        valid = {k: torch.cat([c.valid[k] for c in chunks])
                 for k in chunks[0].valid}
        rv = None
        if any(c.row_valid is not None for c in chunks):
            rv = torch.cat([c.rows_valid() for c in chunks])
        return EventFrame(cols, valid, rv)

