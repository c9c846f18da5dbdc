"""The control -- the plain reference in bfloat16, in the program's place --
comes out not correct, at a size a test can hold (on the card it is run by
``python -m pmbench.control`` at the cells' own sizes)."""
import pytest

from pmbench import control, harness

CELLS = ["L5-widgets", "L5-panel", "L1-panel"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_holds(tiny_root, cell):
    limits = harness.load_json(tiny_root / "pmbench" / "limits.json")
    for out in control.readings(tiny_root, cell, [2**31 + 1, 2**31 + 2],
                                2, 0.4, "cpu"):
        prog = dict(out["program"], unanswered=out["failed"],
                    inputs_changed=0)
        ok, _ = harness.verdict(prog, limits)
        assert ok, out
        ctl = dict(out["control"], unanswered=0, inputs_changed=0)
        ok, shown = harness.verdict(ctl, limits)
        assert not ok, shown
