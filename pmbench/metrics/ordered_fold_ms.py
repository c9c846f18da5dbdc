"""ordered_fold_ms: device time of the ops launched inside the program's
``kernel.ordered_histogram`` spans (the row-ordered float folds), a
request."""
from pmbench import program_spans


def read(t):
    if t.program is None:
        return None
    return program_spans.ordered_fold_ms(t.program)
