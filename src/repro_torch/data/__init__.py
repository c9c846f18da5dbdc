"""Synthetic event logs (the paper's Table-6 family)."""
