"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's eager engine, where the window's
requests are answered, and the rest of the run is the harness's own (on
the CPU, past the look for a card): a fold that returns its state
unchanged, a fold that leaves half of the rows out, an answer altered
where it is produced (an integer by one, a float by 5 %), a
filter dropped, and the waits of the ordered float folds
(``performance_dfg``, ``stats``' sojourn times) routed to the wrong edge
and activity: each pair's wait added under another pair's key, so the
counts and the total of all waits stay right.  The cells run on one card, so there is no exchange
between cards to leave out.
"""
import dataclasses
import time

import pytest
import torch

from repro_torch.core import performance, stats
from repro_torch.dataset import engines

from pmbench import harness

CELLS = ["L5-widgets", "L5-panel", "L1-panel"]


def unchanged(fold):
    def fault(kernel, frame):
        return kernel.finalize(*kernel.init(frame.device))
    return fault


def half_the_rows(fold):
    def fault(kernel, frame):
        return fold(kernel, frame.take(torch.arange(frame.nrows // 2)))
    return fault


def _bump(x, how):
    """The answer with its first value of the kind ``how`` changed."""
    done = [False]

    def walk(v):
        if isinstance(v, torch.Tensor) and not done[0] and v.numel():
            if how == "int" and not v.is_floating_point() and \
                    v.dtype != torch.bool:
                done[0] = True
                v = v.clone()
                v.view(-1)[0] += 1
            elif how == "float" and v.is_floating_point() and \
                    bool(v.abs().max() > 0):
                done[0] = True
                v = v.clone()
                i = int(v.abs().view(-1).argmax())
                v.view(-1)[i] *= 1.05
            return v
        if isinstance(v, dict):
            return {k: walk(w) for k, w in v.items()}
        if isinstance(v, tuple):
            return tuple(walk(w) for w in v)
        if hasattr(v, "__dataclass_fields__"):
            return dataclasses.replace(v, **{
                f: walk(getattr(v, f)) for f in v.__dataclass_fields__
                if isinstance(getattr(v, f), torch.Tensor)})
        return v
    return walk(x)


def altered(how):
    def plant(fold):
        def fault(kernel, frame):
            return _bump(fold(kernel, frame), how)
        return fault
    return plant


def misrouted(count):
    """A counting kernel with its float weights (the waits) rotated by one
    among the rows that carry one: each wait lands on the edge (or source
    activity) of the pair before it."""
    def fault(*args, weights=None, **kw):
        if weights is not None and weights.is_floating_point():
            weights = weights.clone()
            hit = weights != 0
            weights[hit] = weights[hit].roll(1)
        return count(*args, weights=weights, **kw)
    return fault


def drop_filter(eager_frame):
    return lambda ds: eager_frame(dataclasses.replace(ds, steps=()))


# fault -> [(module, attribute, plant)]
FAULTS = {"unchanged": [(engines, "_fold_eager", unchanged)],
          "half_the_rows": [(engines, "_fold_eager", half_the_rows)],
          "int_altered": [(engines, "_fold_eager", altered("int"))],
          "float_altered": [(engines, "_fold_eager", altered("float"))],
          "filter_dropped": [(engines, "eager_frame", drop_filter)],
          "waits_misrouted": [(performance, "pair_count", misrouted),
                              (stats, "histogram", misrouted)]}


def run(root, cell):
    # long enough for the widgets' sample to hold every verb
    seconds = 1.5 if cell == "L5-widgets" else 0.4
    return harness.run_cell(root, cell, 2**31 + 21, seconds, False, "cpu",
                            time.time()).line


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    assert run(tiny_root, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    for module, name, plant in FAULTS[fault]:
        monkeypatch.setattr(module, name, plant(getattr(module, name)))
    line = run(tiny_root, cell)
    assert not line["correct"], line["check"]
