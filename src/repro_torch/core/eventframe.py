"""EventFrame: the paper's dataframe abstraction (Def. 3) as a dataclass of
PyTorch tensors.

A dataframe is ``D = (I, N, T, V, chi_val, chi_type)``:

* ``I``     — row indexes, implicit ``0..nrows-1``; projection keeps ``I``
              lazy through a ``row_valid`` mask instead of compacting.
* ``N``     — attribute (column) names: the keys of ``columns``.
* ``T``     — attribute types: the tensors' dtypes, which are the numpy
              dtypes the frame was built from (case ids stay int64).
* ``V``     — attribute values. Strings are dictionary-encoded to dense
              integer ids at the host boundary; the device only sees
              numeric columns.
* ``chi_val``  — per-cell valuation ``columns[name][i]``; ``epsilon``
              (missing) is a per-column validity mask, so integer columns
              stay integer.
* ``chi_type`` — ``columns[name].dtype``.

Every tensor of a frame lives on one device, chosen explicitly when the
frame is built (``from_numpy(..., device=)``) or moved (``to``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

# Canonical column names (XES vocabulary, dictionary-encoded on device).
CASE = "case:concept:name"
ACTIVITY = "concept:name"
TIMESTAMP = "time:timestamp"


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclasses.dataclass
class EventFrame:
    """Columnar event dataframe. All columns share a common length ``nrows``.

    ``valid`` holds per-column epsilon masks only for columns that can have
    missing values (absent key => column is total). ``row_valid`` is the lazy
    projection mask: ``proj`` marks rows instead of compacting them;
    ``compact`` materializes at the host boundary.
    """

    columns: dict[str, torch.Tensor]
    valid: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    row_valid: torch.Tensor | None = None

    # ------------------------------------------------------------ helpers
    @property
    def nrows(self) -> int:
        return int(next(iter(self.columns.values())).shape[0]) if self.columns else 0

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self.columns))

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def cell_valid(self, name: str) -> torch.Tensor:
        """epsilon mask for a column, combined with the row projection mask."""
        v = self.valid.get(name)
        if v is None:
            v = torch.ones(self.nrows, dtype=torch.bool, device=self.device)
        if self.row_valid is not None:
            v = v & self.row_valid
        return v

    def rows_valid(self) -> torch.Tensor:
        if self.row_valid is not None:
            return self.row_valid
        return torch.ones(self.nrows, dtype=torch.bool, device=self.device)

    def with_column(self, name: str, values: torch.Tensor,
                    valid: torch.Tensor | None = None) -> "EventFrame":
        cols = dict(self.columns)
        cols[name] = values
        vals = dict(self.valid)
        if valid is not None:
            vals[name] = valid
        return EventFrame(cols, vals, self.row_valid)

    def select(self, names: Iterable[str]) -> "EventFrame":
        """Column projection — the paper's load-time attribute selection."""
        names = tuple(names)
        return EventFrame(
            {k: self.columns[k] for k in names},
            {k: v for k, v in self.valid.items() if k in names},
            self.row_valid,
        )

    def take(self, idx: torch.Tensor) -> "EventFrame":
        return EventFrame(
            {k: v[idx] for k, v in self.columns.items()},
            {k: v[idx] for k, v in self.valid.items()},
            self.row_valid[idx] if self.row_valid is not None else None,
        )

    def compact(self) -> "EventFrame":
        """Materialize the lazy projection mask (dynamic shape: syncs)."""
        if self.row_valid is None:
            return self
        idx = torch.nonzero(self.row_valid).reshape(-1)
        return EventFrame(
            {k: v[idx] for k, v in self.columns.items()},
            {k: v[idx] for k, v in self.valid.items()},
            None,
        )

    def to(self, device) -> "EventFrame":
        """The same frame on ``device`` (a copy unless it is already there)."""
        return EventFrame(
            {k: v.to(device) for k, v in self.columns.items()},
            {k: v.to(device) for k, v in self.valid.items()},
            self.row_valid.to(device) if self.row_valid is not None else None,
        )

    # --------------------------------------------------------- construct
    @staticmethod
    def from_numpy(columns: Mapping[str, np.ndarray],
                   valid: Mapping[str, np.ndarray] | None = None, *,
                   device) -> "EventFrame":
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged columns: {lens}")
        return EventFrame(
            {k: _to_tensor(v, device) for k, v in columns.items()},
            {k: _to_tensor(v, device) for k, v in (valid or {}).items()},
        )

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.columns.items()}


def concat_frames(parts) -> EventFrame:
    """Row-wise concatenation of same-schema frames (on the first part's
    device).

    Epsilon masks and the lazy ``row_valid`` projection mask concatenate
    *separately* — folding ``row_valid`` into per-column validity would
    change what ``rows_valid()`` means to the kernels.  A column missing
    a part's epsilon mask contributes all-valid rows.
    """
    parts = list(parts)
    if not parts:
        raise ValueError("concat_frames() needs at least one frame")
    names = set(parts[0].names)
    for p in parts[1:]:
        if set(p.names) != names:
            raise ValueError(f"concat of frames with different columns: "
                             f"{sorted(names)} vs {sorted(p.names)}")
    device = parts[0].device
    cols = {k: torch.cat([p.columns[k].to(device) for p in parts])
            for k in parts[0].names}
    valid_names = set().union(*(set(p.valid) for p in parts))
    valid = {k: torch.cat([
        p.valid[k].to(device) if k in p.valid
        else torch.ones(p.nrows, dtype=torch.bool, device=device)
        for p in parts]) for k in valid_names}
    rv = None
    if any(p.row_valid is not None for p in parts):
        rv = torch.cat([p.rows_valid().to(device) for p in parts])
    return EventFrame(cols, valid, rv)
