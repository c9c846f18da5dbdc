"""host_syncs_per_request: the program's host syncs (its counted reads
back to the host and copies to the device, ``repro_torch.trace``) over
the traced window, a request."""
from pmbench import program_spans


def read(t):
    if t.program is None:
        return None
    return program_spans.host_syncs_per_request(t.program)
