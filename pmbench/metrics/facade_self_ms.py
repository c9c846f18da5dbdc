"""facade_self_ms: the facade's own time a request -- the span around
``Dataset.filter(...).collect(...)`` less its filter and fold spans
(dims, the in-memory ``num_cases``, the kernel spec), mean over the traced
requests."""


def read(t):
    if not t.requests or "facade" not in t.spans:
        return None
    own = t.spans["facade"] - t.spans.get("filter", 0.0) \
        - t.spans.get("fold", 0.0)
    return own / len(t.requests) * 1e3
