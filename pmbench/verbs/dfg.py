"""dfg: directly-follows counts with the start and end activity histograms."""
from pmbench.gen import ACTIVITY, CASE

COLUMNS = (CASE, ACTIVITY)


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 4 * (num_activities ** 2 + 2 * num_activities)


def reference(v) -> dict:
    log = v.log
    return {"counts": v.dfg_counts(),
            "starts": v.bincount(v.act[log.first & v.rv], v.A),
            "ends": v.bincount(v.act[log.last & v.rv], v.A)}


def program(answer) -> dict:
    return {k: answer[k] for k in ("counts", "starts", "ends")}
