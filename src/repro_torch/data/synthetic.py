"""Synthetic event-log generator (the paper's Table-6 L1..L5 family).

Cases are sampled from a random first-order process model (a Markov chain
over activities with designated start/end distributions), vectorized across
cases: step t draws the t-th event of *every* still-active case at once, so
generating 10^7 events takes seconds, not minutes. Output is an EventFrame
sorted by (case, time) plus the activity dictionary.

Pure numpy: the same seed gives the same columns, bit for bit, as the JAX
package's generator; only the frame that wraps them is PyTorch's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame


def random_process_model(num_activities: int, seed: int = 0, sparsity: float = 0.3):
    """(start_probs, trans_probs, end_probs) of a random process model."""
    rng = np.random.default_rng(seed)
    a = num_activities
    start = rng.dirichlet(np.ones(min(a, 3)))
    start = np.concatenate([start, np.zeros(a - len(start))])
    mask = rng.random((a, a)) < sparsity
    mask |= np.eye(a, k=1, dtype=bool)          # ensure a path forward
    trans = rng.random((a, a)) * mask
    trans /= np.maximum(trans.sum(1, keepdims=True), 1e-9)
    end = rng.beta(1, 6, size=a)                # per-activity stop probability
    return start, trans, end


def generate(num_cases: int, num_activities: int = 26, seed: int = 0,
             max_len: int = 64, extra_numeric_attrs: int = 2,
             mean_len_target: float = 7.0, *, device="cuda"
             ) -> tuple[EventFrame, dict[str, list]]:
    """Markov-chain log on ``device``. Mean case length ~= mean_len_target
    (via end probs)."""
    cols, tables = generate_numpy(num_cases, num_activities, seed, max_len,
                                  extra_numeric_attrs, mean_len_target)
    return EventFrame.from_numpy(cols, device=device), tables


def generate_numpy(num_cases: int, num_activities: int = 26, seed: int = 0,
                   max_len: int = 64, extra_numeric_attrs: int = 2,
                   mean_len_target: float = 7.0
                   ) -> tuple[dict[str, np.ndarray], dict[str, list]]:
    """The columns of :func:`generate` as host numpy arrays."""
    rng = np.random.default_rng(seed)
    start, trans, end = random_process_model(num_activities, seed)
    # calibrate stop probability to hit the target mean length
    end = np.full(num_activities, 1.0 / mean_len_target)

    cur = rng.choice(num_activities, size=num_cases, p=start)
    active = np.ones(num_cases, bool)
    acts_steps = [cur.copy()]
    active_steps = [active.copy()]
    cum_trans = trans.cumsum(axis=1)
    for t in range(1, max_len):
        stop = rng.random(num_cases) < end[cur]
        active = active & ~stop
        if not active.any():
            break
        u = rng.random(num_cases)
        nxt = (u[:, None] > cum_trans[cur]).sum(axis=1).clip(0, num_activities - 1)
        cur = np.where(active, nxt, cur)
        acts_steps.append(cur.copy())
        active_steps.append(active.copy())

    acts = np.stack(acts_steps, axis=1)          # (cases, T)
    alive = np.stack(active_steps, axis=1)
    lengths = alive.sum(axis=1).astype(np.int64)

    case_ids = np.repeat(np.arange(num_cases, dtype=np.int64), lengths)
    flat_mask = alive.reshape(-1)
    flat_acts = acts.reshape(-1)[flat_mask].astype(np.int32)
    # timestamps: case start + unit gaps (position within case)
    pos = _positions(lengths)
    t0 = rng.random(num_cases) * 1e6
    ts = (t0[case_ids] + pos).astype(np.float32)

    cols = {CASE: case_ids, ACTIVITY: flat_acts, TIMESTAMP: ts}
    for k in range(extra_numeric_attrs):
        cols[f"attr{k}"] = rng.integers(0, 1000, size=len(case_ids)).astype(np.int32)
    tables = {ACTIVITY: [f"act_{i:03d}" for i in range(num_activities)]}
    return cols, tables


def _positions(lengths: np.ndarray) -> np.ndarray:
    """Vectorized concatenate([arange(l) for l in lengths])."""
    total = int(lengths.sum())
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return np.arange(total, dtype=np.int64) - starts


def paper_table6_config(level: int) -> dict:
    """L1..L5 scaling points of Table 6 (cases; events follow ~7x)."""
    return {"num_cases": level * 1_000_000, "num_activities": 26,
            "mean_len_target": 7.0, "seed": level}
