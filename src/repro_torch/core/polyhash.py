"""Affine polyhash sketches — the header-resident form of the variant hash.

The variant fingerprint of a case is the rolling hash ``h <- h*BASE +
(act+1)`` (mod 2^32) over its activity sequence.  Each row is the affine
map ``h -> h*BASE + (act+1)``; affine maps compose associatively, so any
contiguous *run* of rows collapses to a single pair ``(mul, add)`` with
``h_out = h_in*mul + add`` (exact in uint32 — everything wraps mod 2^32).

:func:`segment_sketch` computes that pair per case *segment* of a row
group (the group-local slice of each case).  The pairs are what the
EDFV0003 header persists per row group (``storage.edf``): the query layer
composes them across groups at header-read time, which is how a pruned
scan reconstructs the exact rolling-hash carry of a skipped run — and how
whole-dataset variant fingerprints are derived without any data I/O.
"""
from __future__ import annotations

import numpy as np

BASE1 = 1_000_003
BASE2 = 16_777_619          # FNV prime
M32 = 0xFFFFFFFF

# ghost-chunk column names carrying per-segment composed maps (the query
# executor attaches these to synthetic chunks; real chunks never have them)
SK_MUL1, SK_ADD1 = "__sk_mul1__", "__sk_add1__"
SK_MUL2, SK_ADD2 = "__sk_mul2__", "__sk_add2__"
SKETCH_COLUMNS = (SK_MUL1, SK_ADD1, SK_MUL2, SK_ADD2)
SKETCH_KEYS = ("mul1", "add1", "mul2", "add2")
_KEY_TO_COLUMN = dict(zip(SKETCH_KEYS, SKETCH_COLUMNS))


def _powers(base: int, n: int) -> np.ndarray:
    """``pw[k] = base**k mod 2^32`` for k in [0, n]."""
    pw = np.ones(n + 1, np.uint32)
    if n:
        np.cumprod(np.full(n, base, np.uint32), out=pw[1:])
    return pw


def segment_sketch(act: np.ndarray, case: np.ndarray) -> dict:
    """Per-segment affine maps of one contiguous (case,time)-sorted slice.

    Returns ``{"mul1", "add1", "mul2", "add2"}`` uint32 arrays, one entry
    per case segment, such that folding the rows of segment ``j`` through
    the rolling hash maps ``h`` to ``h*mul[j] + add[j]`` (per base).
    """
    act = np.asarray(act)
    case = np.asarray(case)
    n = act.shape[0]
    if n == 0:
        z = np.zeros(0, np.uint32)
        return {k: z.copy() for k in SKETCH_KEYS}
    starts = np.flatnonzero(
        np.concatenate([[True], case[1:] != case[:-1]]))
    ends = np.concatenate([starts[1:] - 1, [n - 1]])
    lens = ends - starts + 1
    # row i of segment j contributes (act_i+1) * base^(end_j - i): the
    # reduceat sums those weighted addends per segment, mod 2^32
    exp = np.repeat(ends, lens) - np.arange(n)
    v = act.astype(np.uint32) + np.uint32(1)
    out = {}
    for base, mk, ak in ((BASE1, "mul1", "add1"), (BASE2, "mul2", "add2")):
        pw = _powers(base, int(lens.max()))
        out[mk] = pw[lens].astype(np.uint32)
        out[ak] = np.add.reduceat(v * pw[exp], starts).astype(np.uint32)
    return out


def compose(m1: int, a1: int, m2: int, a2: int) -> tuple[int, int]:
    """Compose two affine maps (apply map 1, then map 2), mod 2^32."""
    return (m1 * m2) & M32, (a1 * m2 + a2) & M32


def sequence_fingerprint(seq) -> tuple[int, int]:
    """The (fp1, fp2) fingerprint pair of an explicit activity-id sequence
    — what :func:`repro.query.expr.variant_of` matches cases against."""
    h1 = h2 = 0
    for a in seq:
        h1 = (h1 * BASE1 + int(a) + 1) & M32
        h2 = (h2 * BASE2 + int(a) + 1) & M32
    return h1, h2


def sketch_columns(sketch: dict, segments: int, size: int) -> dict:
    """Materialize ghost-chunk sketch columns: per-segment maps on rows
    ``[0, segments)``, the identity map ``(1, 0)`` on padding rows."""
    cols = {}
    for key, name in _KEY_TO_COLUMN.items():
        fill = 1 if key.startswith("mul") else 0
        arr = np.full(size, fill, np.uint32)
        arr[:segments] = sketch[key]
        cols[name] = arr
    return cols
