"""The plain reference: what each answer of the program must be.

Plain PyTorch over the benchmark's own generated columns; it imports
nothing of the program and takes nothing it made.  It works out again
what the program derives: the filter's row mask (the case-level filter's
per-case keep mask included), the case segments, the directly-follows
pairs.  Integer results are computed in int64; float sums in float64 and
the heuristics miner's measures in float32, the precision it states.  The
control (``lower=True``) computes every float in bfloat16, the precision
below float32.

Semantics, as the paper's dataframe operations define them (the lazy
projection of Def. 3 marks rows instead of dropping them):

* a filter narrows the row mask ``rv``; case segments follow the case
  column and ignore ``rv``;
* a directly-follows pair is two adjacent rows of one case, both kept;
* a case starts / ends at its first / last row, when that row is kept;
* a case's variant fingerprint hashes every row of the case, kept or not.

Each verb's reference is ``pmbench/verbs/<verb>.py``'s ``reference(view)``.
"""
from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from .gen import ACTIVITY, CASE, TIMESTAMP


class Log:
    """The generated columns and the structure that does not depend on a
    request: case segments."""

    def __init__(self, cols: dict, num_activities: int):
        self.cols = cols
        self.case = cols[CASE]
        self.act = cols[ACTIVITY].to(torch.int64)
        self.ts = cols[TIMESTAMP]
        self.num_activities = int(num_activities)
        self.n = int(self.case.shape[0])
        dev = self.case.device
        change = self.case[1:] != self.case[:-1]
        one = torch.ones(1, dtype=torch.bool, device=dev)
        self.first = torch.cat([one, change])         # row opens a case
        self.last = torch.cat([change, one])          # row closes a case
        self.seg = torch.cumsum(self.first, 0) - 1    # case segment id
        self.num_cases = int(self.seg[-1]) + 1 if self.n else 0

    def view(self, kind: str, params: tuple, lower: bool = False):
        """The log as one request's filter leaves it (``lower``: the
        control's precision)."""
        return View(self, self.row_mask(kind, params), lower)

    def row_mask(self, kind: str, params: tuple) -> torch.Tensor:
        if kind == "none":
            return torch.ones(self.n, dtype=torch.bool, device=self.case.device)
        if kind == "attr_lt":
            column, k = params
            return self.cols[column] < k
        if kind == "case_band":
            lo, hi = params
            return (self.case >= lo) & (self.case <= hi)
        if kind == "cases_containing":
            (a,) = params
            hit = torch.zeros(self.num_cases, dtype=torch.int64,
                              device=self.case.device)
            hit.index_add_(0, self.seg, (self.act == a).to(torch.int64))
            return (hit > 0)[self.seg]
        raise ValueError(f"unknown filter kind {kind!r}")


class View:
    """One request's view: the log, its row mask ``rv``, the float type of
    sums (``f``) and of the miner's measures (``measure``)."""

    def __init__(self, log: Log, rv: torch.Tensor, lower: bool = False):
        self.log = log
        self.rv = rv
        self.f = torch.bfloat16 if lower else torch.float64
        self.measure = torch.bfloat16 if lower else torch.float32
        self.A = log.num_activities
        self.act = log.act
        self.seg = log.seg
        self.num_cases = log.num_cases

    def bincount(self, keys: torch.Tensor, size: int) -> torch.Tensor:
        return torch.bincount(keys, minlength=size)[:size]

    @cached_property
    def pair(self) -> torch.Tensor:
        """``pair[i]``: rows ``i`` and ``i + 1`` are a directly-follows pair."""
        log = self.log
        return (log.case[1:] == log.case[:-1]) & self.rv[1:] & self.rv[:-1]

    @cached_property
    def ts(self) -> torch.Tensor:
        return self.log.ts.to(self.f)

    @cached_property
    def wait(self) -> torch.Tensor:
        """The waiting time of each row after its predecessor, in ``f``."""
        return self.ts[1:] - self.ts[:-1]

    def dfg_counts(self) -> torch.Tensor:
        a = self.A
        keys = (self.act[:-1] * a + self.act[1:])[self.pair]
        return self.bincount(keys, a * a).reshape(a, a)

    def per_case(self, values: torch.Tensor, how: str, fill) -> torch.Tensor:
        """``how`` (``amin`` / ``amax``) of ``values`` per case segment."""
        out = torch.full((self.num_cases,), fill, dtype=values.dtype,
                         device=values.device)
        return out.scatter_reduce(0, self.seg, values, how)


def host(x) -> np.ndarray:
    """A reference result as a numpy array (bfloat16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compare(program: dict, reference: dict) -> tuple[int, float]:
    """(integer and boolean values that differ, the largest float error).

    Every reference key must be present in ``program`` with its shape; a
    missing or misshapen array counts all its values as differing.  A float
    array's error is its largest absolute difference over the largest
    magnitude of the reference array; a NaN counts as infinite.
    """
    mismatches = 0
    err = 0.0
    for key, ref in reference.items():
        r = host(ref)
        p = program.get(key)
        p = None if p is None else np.asarray(p)
        if p is None or p.shape != r.shape:
            mismatches += max(r.size, 1)
            continue
        if np.issubdtype(r.dtype, np.floating):
            if not r.size:
                continue
            d = np.abs(p.astype(np.float64) - r.astype(np.float64))
            scale = max(float(np.abs(r).max()), 1e-30)
            e = float(d.max()) / scale if np.isfinite(d).all() else np.inf
            err = max(err, e)
        else:
            mismatches += int(np.count_nonzero(p != r))
    return mismatches, err
