"""decode_ms: the file path's read and decode on the host -- the program's
``edf_decode_ns`` counter (``EDFReader.read_group_numpy``, fetch plus
decode, on whichever thread runs it: the read-ahead's included) over the
traced window, in ms a request."""


def read(t):
    p = t.program
    if p is None or not p.counters or "edf_decode_ns" not in p.counters \
            or not p.requests:
        return None
    return p.counters["edf_decode_ns"] / len(p.requests) * 1e-6
