"""EDF columnar storage (the port's reader, writer and atomic append), the
row-log JSONL store and XES."""
from . import edf, rowlog, xes

__all__ = ["edf", "rowlog", "xes"]
