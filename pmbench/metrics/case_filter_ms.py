"""case_filter_ms: the program's case filter (a ``filter.case`` span) from
its start to the end of the last device op launched inside it, mean over
the case-filtered requests."""
from pmbench import program_spans


def read(t):
    if t.program is None:
        return None
    return program_spans.case_filter_ms(t.program)
