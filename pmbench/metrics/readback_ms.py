"""readback_ms: copying a request's answer to host numpy arrays, mean over
the traced requests."""


def read(t):
    if not t.requests or "readback" not in t.spans:
        return None
    return t.spans["readback"] / len(t.requests) * 1e3
