"""The plain reference against the port's CPU path at a small size, for
every verb and filter kind the mixes use."""
import pytest
import torch

import repro_torch
from repro_torch.core.eventframe import EventFrame

from pmbench import gen, harness, traffic
from pmbench.reference import Log, compare
from pmbench.tests.conftest import ROOT

CFG = harness.load_json(ROOT / "pmbench" / "configs" / "table6-L5.json")
CFG = dict(CFG, num_cases=3000)
MIXES = {m: traffic.load(ROOT, m) for m in ("widgets", "panel")}
VERBS = sorted({v for mix in MIXES.values() for v in traffic.verb_names(mix)})
PARAMS = {"none": (), "cases_containing": (4,), "attr_lt": ("attr0", 500),
          "case_band": (700, 2200)}


@pytest.fixture(scope="module")
def setup():
    cols = gen.generate(CFG, 2**31 + 11, "cpu")
    ds = repro_torch.open(EventFrame(dict(cols)), tables=gen.tables(CFG),
                          device="cpu")
    return cols, ds, Log(cols, CFG["num_activities"])


def held(setup, req):
    cols, ds, log = setup
    answers = harness.program_answers(req, harness.to_host(
        harness.ask(ds, req)))
    view = log.view(req.kind, req.params)
    worst = (0, 0.0)
    for name, prog in answers.items():
        m, e = compare(prog, harness.verb(name).reference(view))
        worst = (worst[0] + m, max(worst[1], e))
    return worst


@pytest.mark.parametrize("kind", traffic.FILTER_KINDS)
@pytest.mark.parametrize("verb", VERBS)
def test_reference_matches_the_port_on_the_cpu(setup, verb, kind):
    req = traffic.Request(0, kind, PARAMS[kind], (verb,), False)
    mismatches, err = held(setup, req)
    assert mismatches == 0
    assert err < 1e-6


@pytest.mark.parametrize("kind", traffic.FILTER_KINDS)
def test_reference_matches_the_fused_panel(setup, kind):
    req = traffic.Request(0, kind, PARAMS[kind],
                          tuple(MIXES["panel"]["collect_many"]), True)
    mismatches, err = held(setup, req)
    assert mismatches == 0
    assert err < 1e-6


def test_a_filter_keeps_what_it_says(setup):
    _, _, log = setup
    keep = log.row_mask("cases_containing", (4,))
    per_case = torch.zeros(log.num_cases, dtype=torch.bool)
    per_case[log.seg[log.act == 4]] = True
    assert torch.equal(keep, per_case[log.seg])
    band = log.row_mask("case_band", (10, 19))
    assert set(log.case[band].tolist()) == set(range(10, 20))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_every_warm_request_is_answered_and_held(setup, mix):
    for req in traffic.warm_requests(MIXES[mix], CFG):
        mismatches, err = held(setup, req)
        assert mismatches == 0 and err < 1e-6
