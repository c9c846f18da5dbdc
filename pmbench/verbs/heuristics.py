"""heuristics: the heuristics miner's net over the directly-follows counts
c and the a-b-a loop counts l2 (Weijters and van der Aalst): the dependency
(c[a,b] - c[b,a]) / (c[a,b] + c[b,a] + 1), on the diagonal c[a,a] /
(c[a,a] + 1); the loop measure (l2[a,b] + l2[b,a]) / (that + 1); the graph
of edges at dependency >= 0.5 (loops of length two at >= 0.5 where neither
end loops on itself), each at least one count; and the AND bindings of two
successors b1, b2 of a at (c[b1,b2] + c[b2,b1]) / (c[a,b1] + c[a,b2] + 1)
>= 0.65.  The measures and thresholds are in float32, the precision the
miner states (bfloat16 in the control)."""
import torch

from pmbench.gen import ACTIVITY, CASE

COLUMNS = (CASE, ACTIVITY)
DEPENDENCY, L2, AND = 0.5, 0.5, 0.65
MIN_COUNT = 1


def result_bytes(num_activities: int, num_cases: int) -> int:
    a = num_activities
    return 8 * a * a + a * a + a ** 3 + 8 * a


def loop_counts(v):
    """l2[a, b]: rows a, b, a in a row within one case, all kept."""
    a, case, act, rv = v.A, v.log.case, v.act, v.rv
    hit = ((case[2:] == case[1:-1]) & (case[1:-1] == case[:-2])
           & rv[2:] & rv[1:-1] & rv[:-2] & (act[2:] == act[:-2]))
    return v.bincount((act[:-2] * a + act[1:-1])[hit], a * a).reshape(a, a)


def reference(v) -> dict:
    m = v.measure
    counts = v.dfg_counts()
    l2c = loop_counts(v)
    th = {k: torch.tensor(x, dtype=m, device=counts.device)
          for k, x in (("dep", DEPENDENCY), ("l2", L2), ("and", AND))}
    c, c2 = counts.to(m), l2c.to(m)
    eye = torch.eye(v.A, dtype=torch.bool, device=counts.device)
    dep = (c - c.T) / (c + c.T + 1.0)
    dep = torch.where(eye, (torch.diag(c) / (torch.diag(c) + 1.0))[:, None],
                      dep)
    l2 = torch.where(eye, 0.0, (c2 + c2.T) / (c2 + c2.T + 1.0))
    and_m = (c + c.T)[None, :, :] / (c[:, :, None] + c[:, None, :] + 1.0)
    keep = (dep >= th["dep"]) & ~eye & (counts >= MIN_COUNT)
    loops1 = (torch.diag(dep) >= th["dep"]) & (torch.diag(counts) >= MIN_COUNT)
    no_l1 = ~loops1[:, None] & ~loops1[None, :]
    keep2 = ((l2 >= th["l2"]) & (l2c + l2c.T >= MIN_COUNT) & no_l1 & ~eye)
    graph = keep | (eye & loops1[:, None]) | keep2 | keep2.T
    both = graph[:, :, None] & graph[:, None, :] & ~eye[None, :, :]
    log = v.log
    starts = v.bincount(v.act[log.first & v.rv], v.A)
    ends = v.bincount(v.act[log.last & v.rv], v.A)
    return {"dependency": dep, "l2": l2, "graph": graph,
            "and_bindings": both & (and_m >= th["and"]),
            "start_activities": torch.nonzero(starts).reshape(-1),
            "end_activities": torch.nonzero(ends).reshape(-1)}


def program(answer) -> dict:
    return {k: answer[k] for k in ("dependency", "l2", "graph", "and_bindings",
                                   "start_activities", "end_activities")}
