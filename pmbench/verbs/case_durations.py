"""case_durations: last minus first kept timestamp per case (0 when a
case keeps no event)."""
import torch

from pmbench.gen import CASE, TIMESTAMP

COLUMNS = (CASE, TIMESTAMP)


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 4 * num_cases


def durations(v):
    inf = float("inf")
    tmin = v.per_case(torch.where(v.rv, v.ts, inf), "amin", inf)
    tmax = v.per_case(torch.where(v.rv, v.ts, -inf), "amax", -inf)
    return torch.where(tmax >= tmin, tmax - tmin, 0.0)


def reference(v) -> dict:
    return {"durations": durations(v)}


def program(answer) -> dict:
    return {"durations": answer}
