"""Unified ``Dataset`` facade: one fluent API over eager, lazy and
multi-log mining on the card (see ``repro_torch.dataset.dataset`` for the
full story).

    import repro_torch
    ds = repro_torch.open(["jan.edf", "feb.edf"])      # device="cuda"
    ds.filter(repro_torch.col("concept:name") == 3).dfg()
"""
from .dataset import Dataset, open_dataset  # noqa: F401
from .engines import (ENGINES, CollectResult, CostEstimate,  # noqa: F401
                      choose, clear_result_cache, estimate)
from .window import Windows, WindowResult  # noqa: F401

open = open_dataset  # the facade's entry point: ``repro_torch.open(...)``

__all__ = [
    "CollectResult", "CostEstimate", "Dataset", "ENGINES", "WindowResult",
    "Windows", "choose", "clear_result_cache", "estimate", "open",
    "open_dataset",
]
