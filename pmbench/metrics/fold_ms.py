"""fold_ms: the engine's and verbs' time a request -- the span around
``dataset.engines._fold_eager`` (``core.engine`` fold and finalize with
each verb's kernels), mean over the traced requests."""


def read(t):
    if not t.requests or "fold" not in t.spans:
        return None
    return t.spans["fold"] / len(t.requests) * 1e3
