"""stats: activity counts, case sizes, case durations and the mean waiting
time after each source activity, in one answer."""
import torch

from pmbench.gen import ACTIVITY, CASE, TIMESTAMP
from pmbench.verbs import activity_counts, case_durations, case_sizes

COLUMNS = (CASE, ACTIVITY, TIMESTAMP)


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 8 * num_activities + 8 * num_cases


def sojourn(v):
    src = v.act[:-1][v.pair]
    total = torch.zeros(v.A, dtype=v.f, device=src.device)
    total.index_add_(0, src, v.wait[v.pair])
    return total / v.bincount(src, v.A).clamp(min=1).to(v.f)


def reference(v) -> dict:
    return {"activity_counts": activity_counts.counts(v),
            "case_sizes": case_sizes.sizes(v),
            "case_durations": case_durations.durations(v),
            "sojourn_times": sojourn(v)}


def program(answer) -> dict:
    return {k: answer[k] for k in ("activity_counts", "case_sizes",
                                   "case_durations", "sojourn_times")}
