"""Lazy columnar query subsystem: ``scan -> filter -> project -> mine``.

The paper's scalability argument rests on filtering and attribute
selection being cheap *columnar* operations; this package decides — from
EDFV0003 zone maps, before any data I/O — which row groups cannot
possibly contribute and never reads their bytes.  Plans compile down to
the chunk-kernel engine, so every miner (DFG, stats, variants, alpha,
heuristics) runs over a pruned scan with results bitwise identical to
filter-then-mine on the whole log.  A :class:`MultiPlan` widens a scan to
an ordered *set* of EDF files (one logical plan, N pruned scans, one
kernel driven across all of them).  Every entry point runs on the card
unless it is given ``device="cpu"``::

    from repro_torch.query import Plan, col, execute
    plan = Plan("log.edf").filter(col("concept:name") == 3)
    graph, report = execute(plan, mine=dfg_kernel(num_activities))
"""
from .exec import (ScanReport, count_cases, execute,  # noqa: F401
                   execute_frame, merge_reports, multi_pruned_source,
                   pruned_source)
from .expr import (CasePredicate, Col, Expr, SketchPredicate,  # noqa: F401
                   case_size, cases_containing, col, variant_in, variant_of)
from .optimize import PhysicalPlan, compile_plan  # noqa: F401
from .plan import MultiPlan, Plan, scan, scan_many  # noqa: F401

__all__ = [
    "CasePredicate", "Col", "Expr", "MultiPlan", "Plan", "PhysicalPlan",
    "ScanReport", "SketchPredicate", "case_size", "cases_containing", "col",
    "compile_plan", "count_cases", "execute", "execute_frame",
    "merge_reports", "multi_pruned_source", "pruned_source", "scan",
    "scan_many", "variant_in", "variant_of",
]
