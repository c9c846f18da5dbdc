"""Resilient batch ETL: tail a source of event batches into EDF partitions.

The :class:`Ingestor` drains a *source* — a directory of batch ``.edf``
files, or any callable — into partitioned EDFV0003 files under ``out_dir``
(``part_00000.edf``, ``part_00001.edf``, ...), appending row groups to the
current partition (``storage.edf.append``) until it reaches
``partition_rows``, then sealing it and starting the next.

Crash safety is a write-ahead skip-index (``_ingest_index.json`` in
``out_dir``, rewritten atomically):

1. record the batch as *pending* — batch id, target partition, row count,
   and the partition's row count *before* the apply;
2. apply the batch (create the partition via temp file + ``os.replace``,
   or append to it — both atomic), retrying with exponential backoff on
   transient ``OSError``;
3. move the batch from *pending* to *done*.

Because step 2 is atomic, a crash anywhere leaves the partition either
pre- or post-apply, never torn; on resume the pending entry is resolved
by comparing the partition's header row count against
``nrows_before + rows`` — landed appends are acknowledged, lost ones
redone, and re-delivered batches in ``done`` are skipped.  Batches must
arrive in case-major order across the whole stream (each partition stays
(case, time)-sorted; ``append`` enforces it per file).  The partitions and
the index are byte-identical to the JAX package's ``Ingestor``'s for the
same batches.

Env knobs (constructor arguments win):

* ``REPRO_SERVICE_PARTITION_ROWS`` — rows before a partition seals
  (default 500000);
* ``REPRO_SERVICE_ROW_GROUP_ROWS`` — row-group size inside a partition
  (default 8192);
* ``REPRO_SERVICE_RETRIES`` / ``REPRO_SERVICE_BACKOFF`` — transient-write
  retry count (default 5) and initial backoff seconds (default 0.05).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Iterable, Mapping

from repro_torch.core.eventframe import EventFrame
from repro_torch.storage import edf

INDEX_NAME = "_ingest_index.json"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return float(raw) if raw not in (None, "") else default


def directory_source(batch_dir: str) -> Callable:
    """A source that tails ``batch_dir`` for ``*.edf`` batch files.

    Returns a callable ``poll(done_ids) -> [(batch_id, frame, tables)]``
    yielding not-yet-processed batches in sorted filename order (name
    your batches monotonically — e.g. zero-padded sequence numbers — so
    arrival order is ingest order).  Batch files are left in place; the
    skip-index is what marks them processed.
    """
    def poll(done_ids) -> list:
        out = []
        try:
            names = sorted(os.listdir(batch_dir))
        except FileNotFoundError:
            return out
        for name in names:
            if not name.endswith(".edf") or name in done_ids:
                continue
            path = os.path.join(batch_dir, name)
            try:
                # host-side by design: ingest only rewrites files and mines
                # nothing, so a batch never visits the card
                frame, tables = edf.read(path, device="cpu")
            except (OSError, ValueError):
                continue            # partially-written drop: next poll
            out.append((name, frame, tables))
        return out

    return poll


class Ingestor:
    """Drain a batch source into partitioned EDFV0003 files (module doc).

    ``source`` is a directory path (tailed via :func:`directory_source`)
    or a callable ``poll(done_ids) -> iterable[(batch_id, frame, tables)]``.
    ``run_once()`` drains what is currently available; ``start()`` /
    ``stop()`` run the loop on a daemon thread with ``poll_interval``
    sleeps between empty polls.
    """

    def __init__(self, out_dir: str, source,
                 partition_rows: int | None = None,
                 row_group_rows: int | None = None,
                 max_retries: int | None = None,
                 backoff: float | None = None,
                 poll_interval: float = 0.2):
        self.out_dir = out_dir
        self.poll = (directory_source(source) if isinstance(source, str)
                     else source)
        self.partition_rows = (partition_rows if partition_rows is not None
                               else _env_int("REPRO_SERVICE_PARTITION_ROWS",
                                             500_000))
        self.row_group_rows = (row_group_rows if row_group_rows is not None
                               else _env_int("REPRO_SERVICE_ROW_GROUP_ROWS",
                                             8192))
        self.max_retries = (max_retries if max_retries is not None
                            else _env_int("REPRO_SERVICE_RETRIES", 5))
        self.backoff = (backoff if backoff is not None
                        else _env_float("REPRO_SERVICE_BACKOFF", 0.05))
        self.poll_interval = poll_interval
        os.makedirs(out_dir, exist_ok=True)
        self.index_path = os.path.join(out_dir, INDEX_NAME)
        self._index = self._load_index()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()   # run_once is single-flight
        self.ingested = 0               # batches applied by this instance
        self.retried = 0                # transient-write retries performed
        self._resume_pending()

    # ----------------------------------------------------------- index
    def _load_index(self) -> dict:
        try:
            with open(self.index_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {"done": {}, "pending": None}
        except (OSError, json.JSONDecodeError):
            # a torn index write never happens (atomic replace), but an
            # unreadable file should not brick the service: start over and
            # let partition row counts resolve what actually landed
            return {"done": {}, "pending": None}

    def _save_index(self) -> None:
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.index_path)

    def _resume_pending(self) -> None:
        """Resolve a crash that happened between the pending record and the
        done record: the apply itself is atomic, so the partition's row
        count says whether the batch landed."""
        pending = self._index.get("pending")
        if not pending:
            return
        path = os.path.join(self.out_dir, pending["partition"])
        landed = False
        try:
            header, _ = edf.read_header(path)
            landed = header["nrows"] >= pending["nrows_before"] + pending["rows"]
        except (OSError, ValueError):
            landed = False
        if landed:
            self._index["done"][pending["batch"]] = {
                "partition": pending["partition"], "rows": pending["rows"]}
        self._index["pending"] = None
        self._save_index()
        # a lost apply is redone naturally: the batch is not in done, so
        # the next poll re-delivers it

    # ------------------------------------------------------- partitions
    @property
    def done_ids(self) -> set:
        return set(self._index["done"])

    @property
    def paths(self) -> list[str]:
        """Current partition files, in partition (= case-major) order."""
        try:
            names = sorted(n for n in os.listdir(self.out_dir)
                           if n.startswith("part_") and n.endswith(".edf"))
        except FileNotFoundError:
            return []
        return [os.path.join(self.out_dir, n) for n in names]

    def _target_partition(self) -> tuple[str, int]:
        """(partition name, its current row count) for the next batch."""
        paths = self.paths
        if paths:
            last = paths[-1]
            try:
                header, _ = edf.read_header(last)
                if header["nrows"] < self.partition_rows:
                    return os.path.basename(last), int(header["nrows"])
            except (OSError, ValueError):
                pass                    # unreadable partial: next number
            n = int(os.path.basename(last)[5:10]) + 1
        else:
            n = 0
        return f"part_{n:05d}.edf", 0

    def _apply(self, path: str, frame: EventFrame, tables, fresh: bool
               ) -> None:
        """Create or extend one partition, retrying transient OS errors
        with exponential backoff.  Both arms land via ``os.replace``, so
        a retry after a half-failure never observes a torn file."""
        delay = self.backoff
        for attempt in range(self.max_retries + 1):
            try:
                if fresh:
                    tmp = f"{path}.create.{os.getpid()}.tmp"
                    try:
                        edf.write(tmp, frame, tables, version=3,
                                  row_group_rows=self.row_group_rows)
                        os.replace(tmp, path)
                    finally:
                        if os.path.exists(tmp):
                            try:
                                os.remove(tmp)
                            except OSError:
                                pass
                else:
                    edf.append(path, frame, tables,
                               row_group_rows=self.row_group_rows)
                return
            except OSError:
                if attempt == self.max_retries:
                    raise
                self.retried += 1
                time.sleep(delay)
                delay *= 2

    # -------------------------------------------------------- the loop
    def run_once(self, limit: int | None = None) -> int:
        """Ingest up to ``limit`` currently-available batches; returns how
        many were applied (0 = source drained)."""
        with self._lock:
            count = 0
            for batch_id, frame, tables in self.poll(self.done_ids):
                if limit is not None and count >= limit:
                    break
                if batch_id in self._index["done"]:
                    continue
                name, nrows_before = self._target_partition()
                self._index["pending"] = {
                    "batch": batch_id, "partition": name,
                    "rows": frame.nrows, "nrows_before": nrows_before}
                self._save_index()
                self._apply(os.path.join(self.out_dir, name), frame, tables,
                            fresh=nrows_before == 0 and not os.path.exists(
                                os.path.join(self.out_dir, name)))
                self._index["done"][batch_id] = {
                    "partition": name, "rows": frame.nrows}
                self._index["pending"] = None
                self._save_index()
                count += 1
                self.ingested += 1
            return count

    def run(self, stop: threading.Event | None = None) -> None:
        """Blocking ingest loop until ``stop`` (or :meth:`stop`) is set."""
        stop = stop or self._stop
        while not stop.is_set():
            if self.run_once() == 0:
                stop.wait(self.poll_interval)

    def start(self) -> "Ingestor":
        """Run the loop on a daemon thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self.run, daemon=True,
                                            name="repro-torch-ingestor")
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
