"""scan_wait_ms: host time the collect's thread waits for row groups -- the
program's ``scan.wait`` spans (blocked on the read-ahead's queue) and
``scan.read`` spans (a group read and decoded on that thread), summed over
the traced window, in ms a request; 0.0 where neither opened, nothing for
a program without the file path's counters."""


def read(t):
    p = t.program
    if p is None or not p.counters or "scan_groups_read" not in p.counters \
            or not p.requests:
        return None
    waited = p.host_s.get("scan.wait", 0.0) + p.host_s.get("scan.read", 0.0)
    return waited / len(p.requests) * 1e3
