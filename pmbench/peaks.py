"""The card's published peaks, the yardstick of every roofline share.

NVIDIA H100 SXM data sheet, dense rates, at its full 700 W power limit
(a run prints the card's own limit beside every share).
"""

HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float) -> float:
    """The least time work of ``nbytes`` can take on the memory bandwidth
    (the cells' verbs do a few integer or float operations a byte, so the
    bandwidth bounds them)."""
    return nbytes / HBM_BYTES_PER_S
