"""case_sizes: kept events per case, by case segment."""
import torch

from pmbench.gen import CASE

COLUMNS = (CASE,)


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 4 * num_cases


def sizes(v):
    out = torch.zeros(v.num_cases, dtype=torch.int64, device=v.act.device)
    return out.index_add_(0, v.seg, v.rv.to(torch.int64))


def reference(v) -> dict:
    return {"sizes": sizes(v)}


def program(answer) -> dict:
    return {"sizes": answer}
