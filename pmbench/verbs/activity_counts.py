"""activity_counts: kept events per activity."""
from pmbench.gen import ACTIVITY

COLUMNS = (ACTIVITY,)


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 4 * num_activities


def counts(v):
    return v.bincount(v.act[v.rv], v.A)


def reference(v) -> dict:
    return {"counts": counts(v)}


def program(answer) -> dict:
    return {"counts": answer}
