"""The paper's Table-6 event logs, made on the device from a seed.

The same Markov-chain model as ``repro_torch.data.synthetic`` (a random
first-order process model: start distribution, sparse transition matrix, a
constant stop probability of ``1 / mean_len_target``, cases capped at
``max_len`` events), rewritten so that every per-event draw runs on the
device: 5 M cases take a second on the card instead of tens of seconds of
numpy.  Step ``t`` draws the ``t``-th event of every case at once, as the
original does.  The columns are not bitwise those of ``generate_numpy``:
the model is the same, the random streams are torch's.

The process model itself (26 x 26 transition matrix, and the mean wait of
each of its edges) comes from the configuration's ``model_seed`` -- the
paper's log -- so every run seed draws a new sample of the same process,
and the work a verb does (rows, the busiest activity's share) stays the
same from seed to seed.  The waits differ from edge to edge (log-uniform
means), so a fold that pairs a wait with the wrong edge, or averages over
the wrong rows, gives another answer.
"""
from __future__ import annotations

import numpy as np
import torch

# XES column names, as the program's EventFrame names them
CASE = "case:concept:name"
ACTIVITY = "concept:name"
TIMESTAMP = "time:timestamp"

DTYPES = {"int64": torch.int64, "int32": torch.int32,
          "float32": torch.float32}


def random_process_model(num_activities: int, seed: int,
                         sparsity: float = 0.3):
    """(start_probs, trans_probs) of a random process model: the draw of
    ``repro_torch.data.synthetic.random_process_model``."""
    rng = np.random.default_rng(seed)
    a = num_activities
    start = rng.dirichlet(np.ones(min(a, 3)))
    start = np.concatenate([start, np.zeros(a - len(start))])
    mask = rng.random((a, a)) < sparsity
    mask |= np.eye(a, k=1, dtype=bool)          # a path forward
    trans = rng.random((a, a)) * mask
    trans /= np.maximum(trans.sum(1, keepdims=True), 1e-9)
    return start, trans


def wait_means(cfg: dict) -> np.ndarray:
    """The mean wait (s) of each directly-follows edge ``(a, b)``:
    log-uniform over ``[wait_mean_min_s, wait_mean_max_s]``, drawn from
    ``model_seed``."""
    a = int(cfg["num_activities"])
    rng = np.random.default_rng([int(cfg["model_seed"]), 1])
    lo, hi = np.log(float(cfg["wait_mean_min_s"])), \
        np.log(float(cfg["wait_mean_max_s"]))
    return np.exp(rng.uniform(lo, hi, (a, a)))


def generate(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The log's columns on ``device``, sorted by (case, time): case ids
    ``0 .. num_cases - 1`` (int64), activities (int32), timestamps (case
    start uniform over ``timestamp_span_s``; an event ``b`` after ``a``
    waits ``wait_floor_s`` plus an exponential draw of mean
    ``wait_means(cfg)[a, b]``; float32) and ``extra_numeric_attrs``
    columns ``attr<k>`` uniform over ``[0, attr_range)`` (int32)."""
    a = int(cfg["num_activities"])
    n = int(cfg["num_cases"])
    max_len = int(cfg["max_len"])
    start, trans = random_process_model(a, int(cfg["model_seed"]),
                                        float(cfg["sparsity"]))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    cdf_start = torch.as_tensor(start.cumsum(), **f64)
    cdf_start /= cdf_start[-1].clone()
    cum = torch.as_tensor(trans.cumsum(axis=1), **f64)
    p_stop = 1.0 / float(cfg["mean_len_target"])

    # numpy's choice(p=...): the first cdf entry above a uniform draw
    cur = torch.searchsorted(cdf_start, torch.rand(n, generator=g, **f64),
                             right=True).clamp_(max=a - 1)
    acts = torch.empty((max_len, n), dtype=torch.uint8, device=device)
    alive = torch.empty((max_len, n), dtype=torch.bool, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    acts[0] = cur
    alive[0] = True
    for t in range(1, max_len):
        stop = torch.rand(n, generator=g, **f64) < p_stop
        active &= ~stop
        u = torch.rand(n, generator=g, **f64)
        nxt = (u[:, None] > cum[cur]).sum(1).clamp_(max=a - 1)
        cur = torch.where(active, nxt, cur)
        acts[t] = cur
        alive[t] = active
    alive = alive.T.contiguous()                # (cases, steps): case-major
    lengths = alive.sum(1)
    act = acts.T.contiguous()[alive].to(torch.int32)
    del acts
    case = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=device), lengths)
    del alive
    first = torch.cumsum(lengths, 0) - lengths
    t0 = torch.rand(n, generator=g, **f64) * float(cfg["timestamp_span_s"])
    means = torch.as_tensor(wait_means(cfg), **f64).reshape(-1)
    wait = torch.empty(case.shape[0], **f64).exponential_(generator=g)
    wait[1:] *= means[act[:-1].long() * a + act[1:].long()]
    wait += float(cfg["wait_floor_s"])
    wait[first] = 0.0                           # a case's first event
    elapsed = torch.cumsum(wait, 0)
    del wait
    ts = (t0[case] + (elapsed - elapsed[first][case])).to(torch.float32)
    del elapsed, t0, means
    cols = {CASE: case, ACTIVITY: act, TIMESTAMP: ts}
    for k in range(int(cfg["extra_numeric_attrs"])):
        cols[f"attr{k}"] = torch.randint(
            0, int(cfg["attr_range"]), (case.shape[0],), generator=g,
            dtype=torch.int32, device=device)
    return cols


def digest(cols: dict[str, torch.Tensor]) -> list[int]:
    """A position-sensitive checksum of each column (its bit patterns
    weighted by row index modulo a prime): shows whether anything wrote
    into the inputs while the program held them."""
    out = []
    for name in sorted(cols):
        c = cols[name]
        bits = c.view(torch.int32) if c.dtype == torch.float32 else c
        w = torch.arange(c.shape[0], device=c.device) % 65521 + 1
        out.append(int((bits.to(torch.int64) * w).sum()))
    return out


def tables(cfg: dict) -> dict[str, list]:
    """The activity dictionary the program is handed with the frame."""
    return {ACTIVITY: [f"act_{i:03d}" for i in range(int(cfg["num_activities"]))]}
