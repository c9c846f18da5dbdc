"""fold_idle_ms: device idle time while the host is inside a program
``fold`` span, a request."""
from pmbench import program_spans


def read(t):
    if t.program is None:
        return None
    return program_spans.fold_idle_ms(t.program)
