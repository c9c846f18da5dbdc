"""PyTorch / CUDA port of the event-dataframe process-mining system.

A package of its own beside the JAX package ``repro``: it imports neither
JAX nor ``repro``.  Entry points run on the card (``device="cuda"``) unless
the caller names the CPU; the mining paths' primitives are hand-written
CUDA kernels for Hopper (``kernels/csrc``).

The public surface is the ``Dataset`` facade::

    import repro_torch
    from repro_torch import col, cases_containing, case_size

    ds = repro_torch.open(["jan.edf", "feb.edf"])    # or one path, or a frame
    graph = ds.filter(col("concept:name") == 3).dfg()
    stats = ds.stats(engine="streaming")

Everything below it stays importable directly (``repro_torch.core``
kernels, ``repro_torch.query`` plans, ``repro_torch.storage.edf`` files);
the attributes here are loaded lazily, so ``import repro_torch`` builds
nothing and touches no device.
"""
from __future__ import annotations

_EXPORTS = {
    "open": ("repro_torch.dataset", "open_dataset"),
    "open_dataset": ("repro_torch.dataset", "open_dataset"),
    "Dataset": ("repro_torch.dataset", "Dataset"),
    "CollectResult": ("repro_torch.dataset.engines", "CollectResult"),
    "Windows": ("repro_torch.dataset.window", "Windows"),
    "WindowResult": ("repro_torch.dataset.window", "WindowResult"),
    "StateCache": ("repro_torch.query.statecache", "StateCache"),
    "state_cache": ("repro_torch.query.statecache", "state_cache"),
    "col": ("repro_torch.query.expr", "col"),
    "cases_containing": ("repro_torch.query.expr", "cases_containing"),
    "case_size": ("repro_torch.query.expr", "case_size"),
    "variant_in": ("repro_torch.query.expr", "variant_in"),
    "variant_of": ("repro_torch.query.expr", "variant_of"),
    "Ingestor": ("repro_torch.service.ingest", "Ingestor"),
    "MiningService": ("repro_torch.service.server", "MiningService"),
    "serve": ("repro_torch.service.server", "serve"),
    "ProcessGraph": ("repro_torch.graph", "ProcessGraph"),
    "compile_graph": ("repro_torch.graph", "compile_graph"),
    "alpha_to_pnml": ("repro_torch.graph", "alpha_to_pnml"),
    "heuristics_to_dot": ("repro_torch.graph", "heuristics_to_dot"),
    "discover_process_tree": ("repro_torch.graph", "discover_process_tree"),
    "dfg_to_json": ("repro_torch.graph", "dfg_to_json"),
    "dfg_from_json": ("repro_torch.graph", "dfg_from_json"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch' has no attribute "
                             f"{name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value         # cache: next access skips the import
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
