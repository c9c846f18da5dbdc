"""EventFrame -> packed next-activity-prediction batches.

The bridge between the paper's data substrate and the training runtime:
cases (traces) become token sequences ``<bos> a1 .. an <eos>`` packed
back-to-back into fixed (batch, seq) buffers (no padding waste), with a loss
mask that excludes pad positions. Packing, like everything else here, is a
columnar operation: one pass over the case-sorted activity column.

Multi-host sharding: each data-parallel host keeps cases with
``case_id % num_hosts == host_id`` — deterministic, stateless, resumable
(the FT story needs the pipeline to re-seek after restart, which a pure
function of (epoch, step) gives us for free).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.core.eventframe import ACTIVITY, CASE, EventFrame
from .tokenizer import ActivityTokenizer, BOS, EOS, PAD


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray      # (B, S) int32 — model input
    targets: np.ndarray     # (B, S) int32 — next-token labels
    loss_mask: np.ndarray   # (B, S) float32


def frame_to_token_stream(frame: EventFrame, tok: ActivityTokenizer,
                          host_id: int = 0, num_hosts: int = 1) -> np.ndarray:
    """Flatten the case-sorted frame into one token stream with BOS/EOS.

    The frame's columns come to the host (``.cpu().numpy()``) from any
    device; the stream is a host numpy array."""
    case = frame[CASE].cpu().numpy()
    act = frame[ACTIVITY].cpu().numpy()
    rv = frame.rows_valid().cpu().numpy()
    case, act = case[rv], act[rv]
    if num_hosts > 1:
        keep = (case % num_hosts) == host_id
        case, act = case[keep], act[keep]
    if len(case) == 0:
        return np.zeros((0,), np.int32)
    starts = np.concatenate([[True], case[1:] != case[:-1]])
    toks = tok.encode(act)
    # splice BOS before each case and EOS after: build via offsets
    n = len(toks)
    ncases = int(starts.sum())
    out = np.empty(n + 2 * ncases, np.int32)
    case_idx = np.cumsum(starts) - 1            # which case each event is in
    pos = np.arange(n) + 2 * case_idx + 1       # +1 BOS per case started
    out[pos] = toks
    ends = np.concatenate([case[1:] != case[:-1], [True]])
    bos_pos = pos[starts] - 1
    eos_pos = pos[ends] + 1
    out[bos_pos] = BOS
    out[eos_pos] = EOS
    return out


def batches(stream: np.ndarray, batch_size: int, seq_len: int,
            drop_last: bool = True) -> Iterator[Batch]:
    """Pack the stream into (B, S) with next-token targets."""
    per = batch_size * seq_len
    n_full = (len(stream) - 1) // per
    for i in range(n_full):
        chunk = stream[i * per: i * per + per + 1]
        x = chunk[:-1].reshape(batch_size, seq_len)
        y = chunk[1:].reshape(batch_size, seq_len)
        mask = ((x != PAD) & (y != PAD)).astype(np.float32)
        yield Batch(x.copy(), y.copy(), mask)


class Prefetcher:
    """Double-buffered background prefetch (host-side input pipeline)."""

    def __init__(self, it: Iterator[Batch], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        for b in self._it:
            self._q.put(b)
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        b = self._q.get()
        if b is None:
            raise StopIteration
        return b
