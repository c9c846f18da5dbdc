"""fold_roofline: the least time the traced requests' verbs need over
the device time of every kernel inside their fold spans.

The least time counts, for each request, every input column its verbs
read (once, whatever the number of verbs: a fused pass may read each
column once), the row mask when the request filters, and each verb's
answer written once, at the card's memory bandwidth (``pmbench.peaks``).
The columns and answer sizes are each verb's own table
(``pmbench/verbs/<verb>.py``), not the program's, so the share reads the
same work whatever kernels a later program implements it with.
"""
from pmbench import gen, harness, peaks


def least_bytes(req, cfg: dict, rows: int, num_cases: int) -> int:
    columns = set()
    out = 0
    for name in req.verbs:
        v = harness.verb(name)
        columns.update(v.COLUMNS)
        out += v.result_bytes(int(cfg["num_activities"]), num_cases)
    per_row = sum(gen.DTYPES[cfg["columns"][c]].itemsize for c in columns)
    per_row += 0 if req.kind == "none" else 1
    return per_row * rows + out


def read(t):
    spent = t.device_s_in.get("fold", 0.0)
    if not t.has_device or spent <= 0 or not t.requests:
        return None
    least = sum(peaks.least_seconds(least_bytes(r, t.cfg, t.rows,
                                                t.num_cases))
                for r in t.requests)
    return 100.0 * least / spent
