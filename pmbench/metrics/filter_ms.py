"""filter_ms: the query filters' time a request -- the span around
``dataset.engines.eager_frame`` (``query.expr`` row masks, the case
filter's phase one and keep mask), mean over the traced requests."""


def read(t):
    if not t.requests or "filter" not in t.spans:
        return None
    return t.spans["filter"] / len(t.requests) * 1e3
