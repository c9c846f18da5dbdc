"""Row-based event-log storage (the Avro role of the paper): JSONL (+gzip).

Each line is one event's full attribute map — reading any single attribute
requires parsing every row in its entirety, which is precisely the access
pattern the paper contrasts against columnar projection.  The files are
the JAX package's: the same log writes the same bytes.
"""
from __future__ import annotations

import gzip
import json

from repro_torch.core.classic_log import ClassicEventLog


def write(path: str, log: ClassicEventLog, compress: bool = False) -> None:
    op = gzip.open if compress else open
    with op(path, "wt") as f:
        for e in log.events:
            f.write(json.dumps(e) + "\n")


def read(path: str, compress: bool = False) -> ClassicEventLog:
    op = gzip.open if compress else open
    with op(path, "rt") as f:
        return ClassicEventLog([json.loads(line) for line in f])
