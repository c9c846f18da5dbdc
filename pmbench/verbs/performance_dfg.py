"""performance_dfg: directly-follows counts and the mean waiting time of
each edge (0 where an edge never occurs)."""
import torch

from pmbench.gen import ACTIVITY, CASE, TIMESTAMP

COLUMNS = (CASE, ACTIVITY, TIMESTAMP)


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 8 * num_activities ** 2


def reference(v) -> dict:
    a = v.A
    counts = v.dfg_counts()
    keys = (v.act[:-1] * a + v.act[1:])[v.pair]
    total = torch.zeros(a * a, dtype=v.f, device=keys.device)
    total.index_add_(0, keys, v.wait[v.pair])
    return {"counts": counts,
            "mean_wait": total.reshape(a, a) / counts.clamp(min=1).to(v.f)}


def program(answer) -> dict:
    return dict(zip(("counts", "mean_wait"), answer))
