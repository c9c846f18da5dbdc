"""Requests from a traffic mix: one general generator for every mix file.

A mix (``pmbench/traffic/<name>.json``) is data: the verbs and their shares
(``verbs``), or one fused set (``collect_many``); the filter kinds and their
shares (``filters``) with each kind's parameters; the deck size; and how
many answers of each stratum the check keeps.  Every mix is a closed loop
of one client with no think time; a key the generator does not read is
refused, never ignored.  Requests come in decks of
``deck``: each deck holds every verb and filter kind at exactly its share,
shuffled from the seed, so every seed asks for the same work in another
order.  Filter parameters are drawn from the seed per request.

Filter kinds (``Request.kind``), the vocabulary a mix combines:

* ``none`` -- the whole log;
* ``cases_containing`` -- cases holding an activity drawn uniformly
  (the case-level two-pass filter);
* ``attr_lt`` -- ``col(column) < k``, ``k`` uniform over ``[k_min, k_max]``;
* ``case_band`` -- ``col(case).between(lo, hi)``, a band of a share of the
  cases drawn uniformly from ``[min_share, max_share]``, its edge uniform.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator

import numpy as np

FILTER_KINDS = ("none", "cases_containing", "attr_lt", "case_band")
KEYS = {"name", "why", "deck", "verbs", "collect_many", "filters",
        "sample_per_stratum"} | set(FILTER_KINDS)


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    kind: str
    params: tuple
    verbs: tuple
    fused: bool          # one collect_many of ``verbs`` (else one collect)

    @property
    def stratum(self) -> str:
        return f"{self.kind}:{'+'.join(self.verbs)}"


def load(root: Path, name: str) -> dict:
    with open(Path(root) / "pmbench" / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    unknown = set(mix["filters"]) - set(FILTER_KINDS)
    if unknown:
        raise ValueError(f"traffic {name!r}: unknown filter kinds "
                         f"{sorted(unknown)}; known: {FILTER_KINDS}")
    unknown = set(mix) - KEYS
    if unknown:
        raise ValueError(f"traffic {name!r}: keys the generator does not "
                         f"read: {sorted(unknown)}; known: {sorted(KEYS)}")
    if ("verbs" in mix) == ("collect_many" in mix):
        raise ValueError(f"traffic {name!r} needs exactly one of 'verbs' "
                         f"and 'collect_many'")
    return mix


def verb_names(mix: dict) -> tuple:
    """Every verb the mix asks for."""
    return tuple(mix["collect_many"]) if "collect_many" in mix \
        else tuple(mix["verbs"])


def _deck(weights: dict, size: int) -> list:
    """``size`` entries holding each key at its share (largest remainder)."""
    keys = list(weights)
    w = np.array([weights[k] for k in keys], float)
    exact = w / w.sum() * size
    counts = np.floor(exact).astype(int)
    for i in np.argsort(counts - exact)[:size - counts.sum()]:
        counts[i] += 1
    return [k for k, c in zip(keys, counts) for _ in range(c)]


def _params(kind: str, mix: dict, cfg: dict, rng) -> tuple:
    if kind == "none":
        return ()
    if kind == "cases_containing":
        return (int(rng.integers(int(cfg["num_activities"]))),)
    if kind == "attr_lt":
        p = mix["attr_lt"]
        return (p["column"], int(rng.integers(p["k_min"], p["k_max"] + 1)))
    p = mix["case_band"]
    n = int(cfg["num_cases"])
    width = max(1, int(round(rng.uniform(p["min_share"], p["max_share"]) * n)))
    lo = int(rng.integers(0, n - width + 1))
    return (lo, lo + width - 1)


def _rng(seed: int, stream: int):
    return np.random.default_rng([int(seed) % 2**64, stream])


def requests(mix: dict, cfg: dict, seed: int) -> Iterator[Request]:
    """The endless request stream of a run (deck after deck)."""
    rng = _rng(seed, 1)
    fused = "collect_many" in mix
    size = int(mix["deck"])
    i = 0
    while True:
        kinds = _deck(mix["filters"], size)
        rng.shuffle(kinds)
        if fused:
            verbs = [tuple(mix["collect_many"])] * size
        else:
            verbs = [(v,) for v in _deck(mix["verbs"], size)]
            rng.shuffle(verbs)
        for kind, vs in zip(kinds, verbs):
            yield Request(i, kind, _params(kind, mix, cfg, rng), tuple(vs),
                          fused)
            i += 1


def warm_requests(mix: dict, cfg: dict) -> list:
    """One request of every (filter kind, verb) pair of the mix, with
    parameters from a fixed stream: the set-up's warm-up."""
    rng = _rng(0, 2)
    fused = "collect_many" in mix
    sets = [tuple(mix["collect_many"])] if fused else \
        [(v,) for v in mix["verbs"]]
    return [Request(-1, kind, _params(kind, mix, cfg, rng), vs, fused)
            for kind in mix["filters"] for vs in sets]
