"""groups_folded_per_request: the row groups the file path read and folded
-- the program's ``scan_groups_read`` counter (the sum of each streaming
collect's ``ScanReport.groups_read``; groups served from the group-state
cache or skipped are not in it) over the traced window, a request."""


def read(t):
    p = t.program
    if p is None or not p.counters or "scan_groups_read" not in p.counters \
            or not p.requests:
        return None
    return p.counters["scan_groups_read"] / len(p.requests)
