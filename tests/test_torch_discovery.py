"""PyTorch port, discovery and conformance: footprint, alpha, heuristics
(thresholds, loops, AND bindings) and the conformance scores, whole-log and
streamed under any chunking, held against ``repro.core.discovery`` /
``repro.core.conformance`` on the same numpy logs with both JAX lowerings
(``method="segment"`` and the Pallas kernels in interpret mode,
``method="kernel"``); the JAX package's discovery carry handed over
mid-stream; the row-oriented ``classic_log`` oracles against JAX's; and the
one pinned shape difference of ``ops.segment_ids_sorted``.

Tolerance 0: the counts are integers, the heuristics measures one IEEE
division per entry, and the conformance sums add integer-valued float32
below 2^24."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import classic_log as jclassic  # noqa: E402
from repro.core import conformance as jconf  # noqa: E402
from repro.core import discovery as jdisc  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import classic_log as tclassic  # noqa: E402
from repro_torch.core import conformance as tconf  # noqa: E402
from repro_torch.core import discovery as tdisc  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402

A = 6
JAX_METHODS = ("segment", "kernel")
THRESHOLDS = [
    {},
    {"dependency_threshold": 0.3, "l2_threshold": 0.2, "and_threshold": 0.4},
    {"dependency_threshold": 0.9, "min_count": 3},
]


def _log(seed, n_cases=30, max_len=10, masked=0.0, loops=True):
    """Sorted log with ``a, b, a`` patterns and self-loops planted."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64), lens)
    act = rng.integers(0, A, case.size).astype(np.int32)
    if loops:
        for i in range(2, case.size):
            if rng.random() < 0.2 and case[i] == case[i - 2]:
                act[i] = act[i - 2]                       # a, b, a
            elif rng.random() < 0.1 and case[i] == case[i - 1]:
                act[i] = act[i - 1]                       # a, a
    ts = np.arange(case.size, dtype=np.float32)
    rv = rng.random(case.size) >= masked if masked else None
    return {CASE: case, ACTIVITY: act, TIMESTAMP: ts}, rv


def _frames(cols, rv):
    jf = jcore.EventFrame.from_numpy(cols)
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    if rv is not None:
        jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
        tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _same(got, want, path="result"):
    """Bitwise structural equality of a port result and a JAX result."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, float, str, frozenset)):
        assert got == want, path
    else:
        g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, \
            f"{path}: {g.dtype}{g.shape} != {w.dtype}{w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("masked", [0.0, 0.25])
@pytest.mark.parametrize("method", JAX_METHODS)
def test_whole_log_miners_match_jax(masked, method):
    cols, rv = _log(1, masked=masked)
    jf, tf = _frames(cols, rv)
    _same(tdisc.discovery_state(tf, A), jdisc.discovery_state(jf, A, method))
    _same(tdisc.alpha(tf, A), jdisc.alpha(jf, A, method=method))
    _same(tdisc.alpha(tf, A, min_count=2), jdisc.alpha(jf, A, 2, method))
    for th in THRESHOLDS:
        _same(tdisc.heuristics(tf, A, **th), jdisc.heuristics(jf, A, method, **th),
              str(th))
    d, jd = tcore.dfg(tf, A), jcore.dfg(jf, A)
    for mc in (1, 2, 5):
        _same(tdisc.footprint(d, mc), jdisc.footprint(jd, mc))
        _same(tdisc.footprint(d.counts, mc), jdisc.footprint(jd.counts, mc))


def _cuts(n, chunking):
    rng = np.random.default_rng(n + 1)
    return {"one_row": list(range(1, n)),
            "two_rows": list(range(2, n, 2)),
            "random": sorted(set(rng.integers(1, n, 7).tolist()))}[chunking]


@pytest.mark.parametrize("chunking", ["one_row", "two_rows", "random"])
@pytest.mark.parametrize("method", JAX_METHODS)
def test_streamed_discovery_matches_jax(chunking, method):
    cols, rv = _log(2, n_cases=10 if chunking != "random" else 30, masked=0.2)
    jf, tf = _frames(cols, rv)
    cuts = _cuts(tf.nrows, chunking)
    src = tcore.ChunkedEventFrame.from_cuts(tf, cuts)
    jsrc = jcore.ChunkedEventFrame.from_cuts(jf, cuts)
    st = tdisc.streaming_discovery_state(src, A)
    _same(st, jdisc.streaming_discovery_state(jsrc, A, method))
    _same(st, tdisc.discovery_state(tf, A))              # streaming == whole log
    _same(tdisc.streaming_alpha(src, A), jdisc.streaming_alpha(jsrc, A, 1, method))
    _same(tdisc.streaming_heuristics(src, A),
          jdisc.streaming_heuristics(jsrc, A, method))
    # the plain pair_count lowerings stream the same state
    for m in ("segment", "matmul"):
        _same(tdisc.streaming_discovery_state(src, A, m), st, m)


def test_heuristics_loops_and_bindings():
    """L1 loops stay diagonal, L2 loops add both directions, and a
    concurrent split gets its AND binding (van der Aalst's examples)."""
    from repro_torch.core.classic_log import make_classic_log

    def log(traces):
        t, cases = 0.0, []
        for i, tr in enumerate(traces):
            timed = []
            for x in tr:
                t += 1.0
                timed.append((x, t))
            cases.append((i, timed))
        return make_classic_log(cases)

    for traces in ([list("abcbcbd")] * 3 + [list("aeeed")] * 2,
                   [list("abcd")] * 4 + [list("acbd")] * 4):
        events = log(traces).events
        tf, tables = tclassic.ClassicEventLog(events).to_eventframe(device="cpu")
        jf, _ = jclassic.ClassicEventLog(events).to_eventframe()
        tf = tcore.ops.sort(tf, (TIMESTAMP, CASE))
        jf = jcore.ops.sort(jf, (TIMESTAMP, CASE))
        a = len(tables[ACTIVITY])
        net = tdisc.heuristics(tf, a)
        _same(net, jdisc.heuristics(jf, a))
        dep, l2, edges = tclassic.heuristics_reference(tclassic.ClassicEventLog(events))
        acts = tables[ACTIVITY]
        kept = {(acts[x], acts[y]) for (x, y), _ in net.edges()}
        assert kept == edges
        for (x, y), v in dep.items():
            assert net.dependency[acts.index(x), acts.index(y)].item() == \
                np.float32(v)
    # the concurrent pair b || c after a is an AND split
    i = {x: acts.index(x) for x in "abcd"}
    assert bool(net.and_bindings[i["a"], i["b"], i["c"]])


def test_conformance_scores_match_jax():
    cols, rv = _log(3, masked=0.1)
    jf, tf = _frames(cols, rv)
    other, _ = _log(4, loops=False)
    jo, to = _frames(other, None)
    d, jd = tcore.dfg(tf, A), jcore.dfg(jf, A)
    model, jmodel = tdisc.alpha(to, A), jdisc.alpha(jo, A)
    net, jnet = tdisc.heuristics(to, A), jdisc.heuristics(jo, A)
    for got, want in (
            (tconf.footprint_fitness(d, net.graph),
             jconf.footprint_fitness(jd, jnet.graph)),
            (tconf.footprint_conformance(d, model),
             jconf.footprint_conformance(jd, jmodel)),
            (tconf.alpha_fitness(d, model), jconf.alpha_fitness(jd, jmodel)),
            (tconf.heuristics_fitness(d, net), jconf.heuristics_fitness(jd, jnet)),
            (tconf.footprint_deviations(d, net.graph),
             jconf.footprint_deviations(jd, jnet.graph)),
            (tconf.footprint_disagreements(d, model),
             jconf.footprint_disagreements(jd, jmodel))):
        _same(got, want)
    for th in (0.0, 0.1, 0.5):
        _same(tconf.discover_model(d, th), jconf.discover_model(jd, th))
    # the log against its own models: footprint exactly self-conformant
    own, jown = tdisc.alpha(tf, A), jdisc.alpha(jf, A)
    assert float(tconf.footprint_conformance(d, own)) == 1.0
    assert float(tconf.alpha_fitness(d, own)) == 1.0
    _same(tconf.heuristics_fitness(d, tdisc.heuristics(tf, A)),
          jconf.heuristics_fitness(jd, jdisc.heuristics(jf, A)))
    _same(tconf.alpha_fitness(d, own), jconf.alpha_fitness(jd, jown))
    # an empty log conforms vacuously
    empty = tcore.DFG(torch.zeros((A, A), dtype=torch.int32),
                      torch.zeros(A, dtype=torch.int32),
                      torch.zeros(A, dtype=torch.int32))
    assert float(tconf.footprint_fitness(empty, net.graph)) == 1.0


@pytest.mark.parametrize("split", [1, 2, 7, 40])
def test_jax_carry_and_state_handed_over(split):
    """JAX folds the first chunks; its state and two-row carry go to the
    port through ``from_numpy`` / ``carry_from_numpy`` (JAX narrows the
    two-back case id to int32, the port holds it in int64), and the port
    folds the rest: the result equals the whole log's in both packages."""
    cols, rv = _log(5, masked=0.15)
    jf, tf = _frames(cols, rv)
    cuts = sorted({split, split + 1, 55, 90})
    jchunks = list(jcore.ChunkedEventFrame.from_cuts(jf, cuts))
    tchunks = list(tcore.ChunkedEventFrame.from_cuts(tf, cuts))
    head = cuts.index(split + 1)
    jk = jdisc.discovery_kernel(A, "segment")
    js, jc = jk.init()
    for ch in jchunks[:head]:
        js, jc = jk.update(js, jc, ch)
    assert np.asarray(jc["case2"]).dtype == np.int32
    d = js["dfg"]
    state = tdisc.DiscoveryState.from_numpy(
        np.asarray(d.counts), np.asarray(d.starts), np.asarray(d.ends),
        np.asarray(js["l2"]), "cpu")
    tk = tdisc.discovery_kernel(A)
    ts_ = {"dfg": state.dfg, "l2": state.l2_counts}
    tc = tengine.carry_from_numpy({k: np.asarray(v) for k, v in jc.items()}, "cpu")
    assert tc["case2"].dtype == torch.int64 and tc["act2"].dtype == torch.int32
    for ch in tchunks[head:]:
        ts_, tc = tk.update(ts_, tc, ch)
    got = tk.finalize(ts_, tc)
    want = jdisc.discovery_state(jf, A, "segment")
    _same(got, want)
    # the merged JAX state, finalized by the port's miners
    w = want
    st = tdisc.DiscoveryState.from_numpy(
        np.asarray(w.dfg.counts), np.asarray(w.dfg.starts), np.asarray(w.dfg.ends),
        np.asarray(w.l2_counts), "cpu")
    _same(tdisc.discover_heuristics(st), jdisc.discover_heuristics(w))
    _same(tdisc.discover_alpha(st.dfg), jdisc.discover_alpha(w.dfg))
    _same(tdisc.discover_heuristics(st.dfg, st.l2_counts, min_count=2),
          jdisc.discover_heuristics(w.dfg, w.l2_counts, min_count=2))


def _events(seed):
    cols, _ = _log(seed, n_cases=12, max_len=6)
    labels = list("abcdef")
    return [{CASE: f"c{c}", ACTIVITY: labels[a], TIMESTAMP: float(t)}
            for c, a, t in zip(cols[CASE], cols[ACTIVITY], cols[TIMESTAMP])]


@pytest.mark.parametrize("seed", [6, 7])
def test_classic_log_oracles_match_jax(seed):
    events = _events(seed)
    tl, jl = tclassic.ClassicEventLog(events), jclassic.ClassicEventLog(events)
    assert tl.dfg_iterative() == jl.dfg_iterative()
    assert tl.dfg_l2_iterative() == jl.dfg_l2_iterative()
    assert tl.start_end_activities() == jl.start_end_activities()
    assert tclassic.footprint_reference(tl) == jclassic.footprint_reference(jl)
    assert tclassic.alpha_reference(tl) == jclassic.alpha_reference(jl)
    assert tclassic.heuristics_reference(tl) == jclassic.heuristics_reference(jl)
    tf, tables = tl.to_eventframe(device="cpu")
    jf, jtables = jl.to_eventframe()
    assert tables == jtables
    for k in jf.names:
        want = np.asarray(jf[k])
        np.testing.assert_array_equal(tf[k].numpy().astype(want.dtype), want)
    # the row oracle agrees with the columnar miner on the port's frame
    tf = tcore.ops.sort(tf, (TIMESTAMP, CASE))
    a = len(tables[ACTIVITY])
    model = tdisc.alpha(tf, a)
    places, starts, ends = tclassic.alpha_reference(tl)
    acts = tables[ACTIVITY]
    assert {(frozenset(acts[i] for i in x), frozenset(acts[i] for i in y))
            for x, y in model.places} == places
    assert frozenset(acts[i] for i in model.start_activities) == starts
    assert frozenset(acts[i] for i in model.end_activities) == ends
    back = tclassic.ClassicEventLog.from_eventframe(tf, tables)
    assert back.events == jclassic.ClassicEventLog.from_eventframe(
        jcore.ops.sort(jf, (TIMESTAMP, CASE)), jtables).events


def test_segment_ids_sorted_on_an_empty_key_differs_from_jax():
    """Pinned difference: on a 0-row key the port returns empty ids and an
    empty start mask; JAX returns a length-1 start mask (longer than its
    column).  On any non-empty key the two agree."""
    ids, starts = tcore.ops.segment_ids_sorted(torch.zeros(0, dtype=torch.int64))
    jids, jstarts = jcore.ops.segment_ids_sorted(jnp.zeros(0, jnp.int32))
    assert ids.shape == (0,) and starts.shape == (0,)
    assert np.asarray(jids).shape == (1,) and np.asarray(jstarts).shape == (1,)
    key = np.array([3, 3, 5, 7, 7, 7], np.int64)
    ids, starts = tcore.ops.segment_ids_sorted(torch.from_numpy(key))
    jids, jstarts = jcore.ops.segment_ids_sorted(jnp.asarray(key.astype(np.int32)))
    _same(ids, jids)
    _same(starts, jstarts)
