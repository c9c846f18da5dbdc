"""eventually_follows: pairs of kept events (a before b) within one case,
counted per (a, b)."""
import torch

from pmbench.gen import ACTIVITY, CASE

COLUMNS = (CASE, ACTIVITY)


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 4 * num_activities ** 2


def reference(v) -> dict:
    a, case, act, rv = v.A, v.log.case, v.act, v.rv
    counts = torch.zeros(a * a, dtype=torch.int64, device=act.device)
    for d in range(1, v.log.n):
        same = case[d:] == case[:-d]
        if not bool(same.any()):        # cases are contiguous: none longer
            break
        both = same & rv[d:] & rv[:-d]
        counts += v.bincount((act[:-d] * a + act[d:])[both], a * a)
    return {"counts": counts.reshape(a, a)}


def program(answer) -> dict:
    return {"counts": answer}
