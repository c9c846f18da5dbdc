"""program_copy_mb: the bytes of the program's own copies between host and
device, both ways, in MB a request (the delivery of the answer is not
among them)."""
from pmbench import program_spans


def read(t):
    if t.program is None:
        return None
    return program_spans.program_copy_mb(t.program)
