"""h2d_ms: device time of the scan's copies to the card -- the device ops
launched inside the program's ``scan.h2d`` spans (decoded row groups,
ghost chunks), in ms a request; 0.0 where none ran, nothing without a
device or for a program without the file path's counters."""


def read(t):
    p = t.program
    if not t.has_device or p is None or not p.counters \
            or "scan_h2d_bytes" not in p.counters or not p.requests:
        return None
    return p.device_s_in.get("scan.h2d", 0.0) / len(p.requests) * 1e3
