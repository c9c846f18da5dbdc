"""The generator against its configuration, and the bytes per verb that
``fold_roofline`` counts against a hand count."""
import importlib.util

import pytest
import torch

from pmbench import gen, harness, traffic
from pmbench.tests.conftest import ROOT


def config(name):
    return harness.load_json(ROOT / "pmbench" / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", ["table6-L5", "table6-L1"])
def test_generator_follows_the_config(name):
    cfg = dict(config(name), num_cases=20_000)
    cols = gen.generate(cfg, 2**31 + 3, "cpu")
    assert set(cols) == set(cfg["columns"])
    for col, dtype in cfg["columns"].items():
        assert cols[col].dtype == gen.DTYPES[dtype]
    case = cols[gen.CASE]
    assert torch.equal(torch.unique(case), torch.arange(cfg["num_cases"]))
    assert bool((case[1:] >= case[:-1]).all())              # case-sorted
    lengths = torch.bincount(case)
    assert int(lengths.max()) <= cfg["max_len"]
    assert abs(float(lengths.double().mean()) - cfg["mean_len_target"]) < 0.2
    act = cols[gen.ACTIVITY]
    assert 0 <= int(act.min()) and int(act.max()) < cfg["num_activities"]
    same = case[1:] == case[:-1]
    gaps = (cols[gen.TIMESTAMP][1:] - cols[gen.TIMESTAMP][:-1])[same]
    assert float(gaps.min()) >= cfg["wait_floor_s"] - 0.25  # f32 near 2^21
    # each edge waits its own mean (floor + the edge's exponential mean)
    a = cfg["num_activities"]
    edge = (act[:-1].long() * a + act[1:].long())[same]
    n = torch.bincount(edge, minlength=a * a)
    mean = torch.zeros(a * a, dtype=torch.float64).index_add_(
        0, edge, gaps.double()) / n.clamp(min=1)
    want = torch.as_tensor(gen.wait_means(cfg)).reshape(-1) + \
        cfg["wait_floor_s"]
    busy = n >= 400
    assert int(busy.sum()) >= 20
    assert float(((mean - want).abs() / want)[busy].max()) < 0.25
    assert float(want[busy].max() / want[busy].min()) > 10
    for k in range(cfg["extra_numeric_attrs"]):
        a = cols[f"attr{k}"]
        assert 0 <= int(a.min()) and int(a.max()) < cfg["attr_range"]


def test_generator_is_a_function_of_the_seed():
    cfg = dict(config("table6-L5"), num_cases=2000)
    big = 2**31 + 12345
    a, b = gen.generate(cfg, big, "cpu"), gen.generate(cfg, big, "cpu")
    c = gen.generate(cfg, big + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert gen.digest(a) == gen.digest(b) != gen.digest(c)


def test_seeds_draw_the_same_model():
    """The process model is the configuration's: two seeds' activity shares
    agree, so they ask for the same work."""
    cfg = dict(config("table6-L5"), num_cases=50_000)
    shares = [torch.bincount(gen.generate(cfg, s, "cpu")[gen.ACTIVITY],
                             minlength=26).double() for s in (1, 2)]
    shares = [x / x.sum() for x in shares]
    assert float((shares[0] - shares[1]).abs().max()) < 0.01


def least_bytes():
    path = ROOT / "pmbench" / "metrics" / "fold_roofline.py"
    spec = importlib.util.spec_from_file_location("frp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.least_bytes


def test_bytes_per_verb_by_hand():
    """A log of 10 rows, 3 cases, 4 activities: columns case int64 (8 B),
    activity / attrs int32, timestamp float32 (4 B)."""
    cfg = dict(config("table6-L5"), num_activities=4)
    count = least_bytes()

    def req(kind, *verbs):
        return traffic.Request(0, kind, (), verbs, len(verbs) > 1)

    assert count(req("none", "dfg"), cfg, 10, 3) == 10 * 12 + 4 * (16 + 8)
    assert count(req("attr_lt", "dfg"), cfg, 10, 3) == 10 * 13 + 4 * 24
    assert count(req("none", "activity_counts"), cfg, 10, 3) == 40 + 16
    assert count(req("none", "case_sizes"), cfg, 10, 3) == 80 + 12
    assert count(req("none", "case_durations"), cfg, 10, 3) == 120 + 12
    assert count(req("none", "variants"), cfg, 10, 3) == 120 + 24 + 8
    assert count(req("none", "performance_dfg"), cfg, 10, 3) == 160 + 128
    assert count(req("none", "eventually_follows"), cfg, 10, 3) == 120 + 64
    assert count(req("none", "heuristics"), cfg, 10, 3) == \
        120 + 8 * 16 + 16 + 64 + 32
    assert count(req("none", "stats"), cfg, 10, 3) == 160 + 32 + 24
    # a fused pass reads each column once and writes every answer
    assert count(req("case_band", "dfg", "stats"), cfg, 10, 3) == \
        10 * 17 + 4 * 24 + 32 + 24
