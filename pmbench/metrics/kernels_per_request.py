"""kernels_per_request: device kernels the profiler saw in the traced
window, over its requests."""


def read(t):
    if not t.has_device or not t.requests:
        return None
    return t.kernels / len(t.requests)
