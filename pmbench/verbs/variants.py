"""variants: each case's two 32-bit polynomial fingerprints of its activity
sequence, ``h <- h * BASE + (activity + 1)`` mod 2^32 over every row of the
case (kept or not), and the number of cases."""
import torch

from pmbench.gen import ACTIVITY, CASE

COLUMNS = (CASE, ACTIVITY)
BASES = (1_000_003, 16_777_619)
M32 = 0xFFFFFFFF


def result_bytes(num_activities: int, num_cases: int) -> int:
    return 8 * num_cases + 8


def fingerprint(v, base: int) -> torch.Tensor:
    """sum over a case's rows of (activity + 1) * base^(rows after it),
    mod 2^32: the fold written out."""
    dev = v.act.device
    idx = torch.arange(v.log.n, device=dev)
    last = v.per_case(idx, "amax", -1)
    after = last[v.seg] - idx
    pw, p = [], 1
    for _ in range(int(after.max()) + 1 if v.log.n else 0):
        pw.append(p)
        p = p * base & M32
    pw = torch.tensor(pw, dtype=torch.int64, device=dev)
    term = (v.act + 1) * pw[after] & M32
    fp = torch.zeros(v.num_cases, dtype=torch.int64, device=dev)
    return fp.index_add_(0, v.seg, term) & M32


def reference(v) -> dict:
    return {"fp1": fingerprint(v, BASES[0]), "fp2": fingerprint(v, BASES[1]),
            "ncases": torch.tensor(v.num_cases)}


def program(answer) -> dict:
    return dict(zip(("fp1", "fp2", "ncases"), answer))
