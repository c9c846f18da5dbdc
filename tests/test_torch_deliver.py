"""PyTorch port, the front door's delivery of an answer to host memory
(``repro_torch.dataset.engines._deliver``) on the CPU.

A card answer's tensors are copied into page-locked host memory; a CPU
answer is already there, so the delivery returns it as the same objects
and copies, syncs and pins nothing.  The walk that finds the tensors keeps
every container's type, dict keys in their order and tuple order (held
here with ``core.engine.map_tensors``, the walk the delivery uses,
replacing each tensor by a clone as the card's delivery replaces each by
its pinned copy).  The card half is
``tests/test_torch_gpu.py -k deliver``.
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import cases_containing, col, trace  # noqa: E402
from repro_torch.core.engine import map_tensors  # noqa: E402
from repro_torch.core.engine import tensor_leaves as tensors  # noqa: E402
from repro_torch.core.eventframe import CASE  # noqa: E402
from repro_torch.data.synthetic import generate  # noqa: E402
from repro_torch.dataset import engines  # noqa: E402

NC, A = 200, 26


@dataclasses.dataclass
class Plain:
    x: torch.Tensor
    n: int


@dataclasses.dataclass(frozen=True)
class Frozen:
    inner: Plain
    labels: tuple
    seen: frozenset


Pair = collections.namedtuple("Pair", "a b")


def answers() -> dict:
    """Answers of every shape a verb returns: a dataclass (frozen, nested),
    a dict, a tuple, a namedtuple, a 0-d tensor, a set, a list."""
    t = torch.arange(6, dtype=torch.int32)
    return {
        "dataclass": Plain(t, 3),
        "frozen": Frozen(Plain(t.float(), 1), ("a", "b"), frozenset({2, 1})),
        "dict": {"z": t, "a": torch.tensor(1.5), "m": {"k": t[:2]}},
        "tuple": (t, t.long(), 7),
        "namedtuple": Pair(t, None),
        "0-d": torch.tensor(4, dtype=torch.int64),
        "set": {3, 1, 2},
        "list": [t, "s", (t, 2)],
    }


@pytest.mark.parametrize("kind", list(answers()))
def test_a_cpu_answer_comes_back_as_the_same_objects(kind):
    answer = answers()[kind]
    before = trace.counters()
    assert engines._deliver(answer) is answer
    after = trace.counters()
    assert {k: after[k] - before[k] for k in after
            if k.startswith("answer_")} == {
        "answer_tensors": 0, "answer_d2h_bytes": 0, "answer_pinned_new": 0}


def skeleton(x):
    """A structure's containers with their types, keys and order, and each
    tensor as (dtype, shape, values)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", str(x.dtype), tuple(x.shape), x.tolist())
    if dataclasses.is_dataclass(x):
        return (type(x), [(f.name, skeleton(getattr(x, f.name)))
                          for f in dataclasses.fields(x)])
    if isinstance(x, dict):
        return (type(x), [(k, skeleton(v)) for k, v in x.items()])
    if isinstance(x, (tuple, list)):
        return (type(x), [skeleton(v) for v in x])
    return (type(x), x)


@pytest.mark.parametrize("kind", list(answers()))
def test_the_walk_keeps_types_keys_and_order(kind):
    answer = answers()[kind]
    out = map_tensors(torch.clone, answer)
    assert skeleton(out) == skeleton(answer)
    old, new = tensors(answer), tensors(out)
    assert len(new) == len(old)
    assert all(a is not b for a, b in zip(old, new))
    if old:
        assert out is not answer
    if kind == "frozen":            # leaves that are no tensor stay the objects
        assert out.labels == answer.labels and out.seen is answer.seen
        assert out.inner.n is answer.inner.n
    if kind == "tuple":
        assert out[2] == 7


FILTERS = {
    "none": None,
    "cases_containing": cases_containing(3),
    "attr_lt": col("attr0") < 500,
    "case_band": col(CASE).between(20, 120),
}
VERBS = ("dfg", "variants", "performance_dfg", "activity_counts",
         "case_durations", "heuristics", "stats", "alpha", "graph",
         "reachability", "node_centrality")


@pytest.fixture(scope="module")
def ds():
    frame, tables = generate(NC, A, seed=5, device="cpu")
    return repro_torch.open(frame, tables=tables, device="cpu")


@pytest.mark.parametrize("kind", list(FILTERS))
@pytest.mark.parametrize("verb", VERBS)
def test_every_verb_of_a_cpu_dataset_is_delivered_untouched(ds, kind, verb):
    pred = FILTERS[kind]
    d = ds if pred is None else ds.filter(pred)
    raw = engines._collect(d, verb, "eager", None, None, {})
    before = trace.counters()
    assert engines._deliver(raw) is raw
    got = d.collect(verb, engine="eager")
    assert trace.counters()["answer_d2h_bytes"] == before["answer_d2h_bytes"]
    assert skeleton(got) == skeleton(raw)
    assert all(t.device.type == "cpu" for t in tensors(got.result))


def test_a_cpu_panel_is_delivered_untouched(ds):
    verbs = ("dfg", "activity_counts", "case_sizes", "case_durations",
             "variants", "performance_dfg", "eventually_follows", "stats")
    raw = engines._collect_many(ds, verbs, "eager", None, None, {}, {})
    assert engines._deliver(raw) is raw
    assert list(ds.collect_many(verbs).results) == list(verbs)
