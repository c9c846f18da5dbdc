"""PyTorch port, graph analytics: ``compile_graph``, the three queries, the
four streamed graph verbs, the registry and the model exports, held against
``repro.graph`` on the same numpy logs.

The JAX side runs with ``impl="xla"`` and with the Pallas kernels in
interpret mode (``method="kernel"``, ``impl="pallas"``); the port streams
under several chunkings, 1-row chunks included.  Everything is bitwise
except centrality ``flow``: its 16 normalized ``plus_times`` matvecs add
floats in each lowering's own order, so it is held within ``atol=1e-6`` of
values that sum to 1 (the JAX package accepts the same float32 caveat
across its own lowerings)."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.graph as jgraph  # noqa: E402
from repro.core import discovery as jdisc  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.graph as tgraph  # noqa: E402
from repro_torch.core import discovery as tdisc  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY, CASE, TIMESTAMP  # noqa: E402

A = 6
FLOW_ATOL = 1e-6
# JAX (method, impl) per lowering
LOWERINGS = {"xla": ("segment", "xla"), "pallas": ("kernel", "pallas")}


def _log(seed, n_cases=30, max_len=9, masked=0.0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, n_cases)
    case = np.repeat(np.arange(n_cases, dtype=np.int64), lens)
    # a skewed alphabet so the graph has rare edges, loops and a bottleneck
    act = rng.choice(A, case.size, p=[0.3, 0.25, 0.2, 0.12, 0.08, 0.05]
                     ).astype(np.int32)
    ts = np.cumsum(rng.exponential(2.0, case.size)).astype(np.float32)
    rv = rng.random(case.size) >= masked if masked else None
    return {CASE: case, ACTIVITY: act, TIMESTAMP: ts}, rv


def _frames(cols, rv):
    jf = jcore.EventFrame.from_numpy(cols)
    tf = tcore.EventFrame.from_numpy(cols, device="cpu")
    if rv is not None:
        jf = jcore.EventFrame(jf.columns, jf.valid, jnp.asarray(rv))
        tf = tcore.EventFrame(tf.columns, tf.valid, torch.from_numpy(rv))
    return jf, tf


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _same(got, want, path="result"):
    """Structural equality of a port result and a JAX result: bitwise for
    every array except centrality ``flow`` (``FLOW_ATOL``)."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (int, float, str, frozenset)):
        assert got == want, path
    else:
        g, w = _host(got), _host(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path.endswith(".flow"):
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOW_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _jax_kernels(lowering):
    method, impl = LOWERINGS[lowering]
    jv = jgraph.verbs
    return {
        "graph": jv.graph_kernel(A, False, method),
        "graph_timed": jv.graph_kernel(A, True, method),
        "reach_full": jv.reachability_kernel(A, None, method, impl),
        "reach_3": jv.reachability_kernel(A, 3, method, impl),
        "bottleneck": jv.bottleneck_paths_kernel(A, "frequency", method, impl),
        "bottleneck_perf": jv.bottleneck_paths_kernel(A, "performance", method,
                                                      impl),
        "centrality": jv.node_centrality_kernel(A, 16, method, impl),
    }


def _port_kernels():
    tv = tgraph.verbs
    return {
        "graph": tv.graph_kernel(A),
        "graph_timed": tv.graph_kernel(A, timed=True),
        "reach_full": tv.reachability_kernel(A),
        "reach_3": tv.reachability_kernel(A, 3),
        "bottleneck": tv.bottleneck_paths_kernel(A),
        "bottleneck_perf": tv.bottleneck_paths_kernel(A, "performance"),
        "centrality": tv.node_centrality_kernel(A),
    }


def _cuts(n, chunking):
    rng = np.random.default_rng(n)
    return {"one_row": list(range(1, n)),
            "random": sorted(set(rng.integers(1, n, 6).tolist())),
            "whole": []}[chunking]


@pytest.mark.parametrize("lowering", ["xla", "pallas"])
@pytest.mark.parametrize("chunking", ["one_row", "random", "whole"])
def test_streamed_graph_verbs_match_jax(lowering, chunking):
    cols, rv = _log(1, n_cases=8 if chunking == "one_row" else 30, masked=0.15)
    jf, tf = _frames(cols, rv)
    cuts = _cuts(tf.nrows, chunking)
    jk, tk = _jax_kernels(lowering), _port_kernels()
    for name in tk:
        want = jcore.run_streaming(jk[name],
                                   jcore.ChunkedEventFrame.from_cuts(jf, cuts))
        got = tcore.run_streaming(tk[name],
                                  tcore.ChunkedEventFrame.from_cuts(tf, cuts))
        _same(got, want, f"{chunking}:{name}")
        # streaming == whole log, in the port alone
        _same(got, tengine.run_single(tk[name], tf), f"{chunking}:{name}:whole")


def test_compile_graph_embeds_state_exactly():
    cols, rv = _log(2, masked=0.2)
    jf, tf = _frames(cols, rv)
    jd, td = jcore.dfg(jf, A), tcore.dfg(tf, A)
    g, jgr = tgraph.compile_graph(td), jgraph.compile_graph(jd)
    _same(g, jgr)
    assert g.num_nodes == A + 2 and (g.source, g.sink) == (A, A + 1)
    f = g.freq.numpy()
    assert f[A + 1].sum() == 0 and f[:, A].sum() == 0
    assert g.edges() == jgr.edges()
    # a DiscoveryState carries its DFG; a performance overlay lands on the
    # real edges only
    _same(tgraph.compile_graph(tdisc.discovery_state(tf, A)),
          jgraph.compile_graph(jdisc.discovery_state(jf, A)))
    perf = torch.arange(A * A, dtype=torch.float32).reshape(A, A) / 7
    gp = tgraph.compile_graph(td, perf=perf, labels=list("abcdef"))
    _same(gp, jgraph.compile_graph(jd, perf=jnp.asarray(perf.numpy()),
                                   labels=list("abcdef")))
    assert gp.node_labels()[-2:] == ("▶", "■")
    assert gp.edges() == jgraph.compile_graph(
        jd, perf=jnp.asarray(perf.numpy())).edges()
    with pytest.raises(TypeError):
        tgraph.compile_graph(object())
    with pytest.raises(ValueError):
        g.with_labels(("x",))


@pytest.mark.parametrize("seed", [3, 4])
def test_queries_on_the_jax_graph(seed):
    """The JAX package's compiled graph handed over with ``from_numpy``:
    every query equals JAX's under both of its lowerings."""
    cols, _ = _log(seed, n_cases=40)
    jf, _ = _frames(cols, None)
    jgr = jcore.engine.run_single(jgraph.verbs.graph_kernel(A, True, "segment"), jf)
    g = tgraph.ProcessGraph.from_numpy(np.asarray(jgr.freq), A,
                                       np.asarray(jgr.perf), device="cpu")
    for impl in ("xla", "pallas"):
        for k in (None, 0, 1, 2, 3, 7):
            _same(tgraph.reachability(g, k), jgraph.reachability(jgr, k, impl=impl))
        for weights in ("frequency", "performance"):
            _same(tgraph.bottleneck_paths(g, weights),
                  jgraph.bottleneck_paths(jgr, weights, impl=impl))
        for iters in (0, 1, 16):
            _same(tgraph.node_centrality(g, iters),
                  jgraph.node_centrality(jgr, iters, impl=impl))
    bp = tgraph.bottleneck_paths(g)
    f = g.freq.numpy()
    assert bp.path[0] == g.source and bp.path[-1] == g.sink
    assert min(f[a, b] for a, b in zip(bp.path[:-1], bp.path[1:])) == bp.bottleneck
    c = tgraph.node_centrality(g)
    assert abs(float(c.flow.sum()) - 1.0) < 1e-5
    with pytest.raises(ValueError, match="performance-compiled"):
        tgraph.bottleneck_paths(dataclasses.replace(g, perf=None), "performance")
    with pytest.raises(ValueError, match="unknown weights"):
        tgraph.bottleneck_paths(g, "latency")


def test_registry_lookups():
    dims = tengine.Dims(A, 30)
    for name in ("graph", "reachability", "bottleneck_paths", "node_centrality",
                 "discovery", "alpha", "heuristics"):
        spec = tengine.kernel_spec(name)
        jspec = jcore.engine.kernel_spec(name)
        assert spec.columns == jspec.columns, name
        assert spec.doc == jspec.doc, name
        assert callable(spec.make(dims).update), name
    cols, _ = _log(5)
    jf, tf = _frames(cols, None)
    for name, kw in (("reachability", {"k": 2}),
                     ("bottleneck_paths", {"weights": "performance"}),
                     ("node_centrality", {"iters": 4}), ("graph", {"timed": True})):
        got = tengine.run_single(tengine.kernel_spec(name).make(dims, **kw), tf)
        want = jcore.engine.run_single(jcore.engine.kernel_spec(name).make(
            jcore.engine.Dims(A, 30), **kw), jf)
        _same(got, want, name)
    with pytest.raises(KeyError) as ei:
        tengine.kernel_spec("reachabillity")
    assert "did you mean" in str(ei.value) and "'reachability'" in str(ei.value)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_queries_and_verbs_pass_impl_down(monkeypatch, impl):
    """``impl=`` through the queries, the verb factories and the registry's
    ``make``, as JAX passes it: with the kernels chosen (``backend.resolve``
    forced to ``"cuda"`` unless ``impl="ref"``) each closure of the 8-node
    graph is one call of the closure kernel's wrapper and centrality's
    matvecs are products, while ``impl="ref"`` calls no wrapper; every
    result equals JAX's under ``impl="xla"`` and ``"pallas"`` (the wrappers
    run their plain versions on these CPU tensors)."""
    from repro_torch.core import backend
    from repro_torch.kernels.graph_ops import ops

    monkeypatch.setattr(backend, "resolve",
                        lambda device, impl=None: "ref" if impl == "ref" else "cuda")
    calls = []
    for name in ("semiring_closure_cuda", "semiring_matmul_cuda"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _real=real, _name=name:
                            calls.append(_name) or _real(*a))
    cols, _ = _log(6)
    jf, tf = _frames(cols, None)
    jgr = jcore.engine.run_single(jgraph.verbs.graph_kernel(A, True, "segment"), jf)
    g = tgraph.ProcessGraph.from_numpy(np.asarray(jgr.freq), A,
                                       np.asarray(jgr.perf), device="cpu")
    closure = [] if impl == "ref" else ["semiring_closure_cuda"]
    product = [] if impl == "ref" else ["semiring_matmul_cuda"]
    dims, jdims = tengine.Dims(A, 30), jcore.engine.Dims(A, 30)
    cases = (("reachability", {"k": 3}, tgraph.reachability, jgraph.reachability,
              (3,), closure),
             ("bottleneck_paths", {"weights": "performance"}, tgraph.bottleneck_paths,
              jgraph.bottleneck_paths, ("performance",), 2 * closure),
             ("node_centrality", {"iters": 4}, tgraph.node_centrality,
              jgraph.node_centrality, (4,), 4 * product))
    for name, kw, query, jquery, args, want_calls in cases:
        calls.clear()
        got = query(g, *args, impl=impl)
        assert calls == want_calls, name
        calls.clear()
        streamed = tengine.run_single(tengine.kernel_spec(name).make(
            dims, impl=impl, **kw), tf)
        assert calls == want_calls, name
        for jimpl in ("xla", "pallas"):
            _same(got, jquery(jgr, *args, impl=jimpl), f"{name} {jimpl}")
            _same(streamed, jcore.engine.run_single(jcore.engine.kernel_spec(name).make(
                jdims, impl=jimpl, **kw), jf), f"{name} verb {jimpl}")
    factories = (tgraph.reachability_kernel(A, None, "auto", impl),
                 tgraph.bottleneck_paths_kernel(A, "frequency", "auto", impl),
                 tgraph.node_centrality_kernel(A, 16, "auto", impl))
    jfactories = (jgraph.verbs.reachability_kernel(A, None, "segment", "xla"),
                  jgraph.verbs.bottleneck_paths_kernel(A, "frequency", "segment", "xla"),
                  jgraph.verbs.node_centrality_kernel(A, 16, "segment", "xla"))
    for kernel, jkernel, want_calls in zip(factories, jfactories,
                                           (closure, 2 * closure, 16 * product)):
        calls.clear()
        got = tengine.run_single(kernel, tf)
        assert calls == want_calls, kernel.name
        _same(got, jcore.engine.run_single(jkernel, jf), kernel.name)


# ------------------------------------------------------------- exports
def _classic(traces):
    from repro_torch.core.classic_log import make_classic_log

    t, cases = 0.0, []
    for i, tr in enumerate(traces):
        timed = []
        for a in tr:
            t += 1.0
            timed.append((a, t))
        cases.append((f"c{i}", timed))
    return make_classic_log(cases)


TRACES = {
    "choice": [list("abd"), list("acd"), list("abd")],
    "l1": [list("abcd")] * 3 + [list("acbd")] * 2 + [list("aed")],
    "loops": [list("abcbcbd")] * 3 + [list("aeeed")] * 2,
    "sequence": [list("abc"), list("abc")],
}


def _both_frames(traces):
    """The same traces as a port frame and a JAX frame (through each
    package's own classic log and §5.2 conversion)."""
    from repro.core.classic_log import ClassicEventLog as JLog

    log = _classic(traces)
    tf, tables = log.to_eventframe(device="cpu")
    jf, jtables = JLog(log.events).to_eventframe()
    assert tables == jtables
    return tf, jf, tables


@pytest.mark.parametrize("traces", sorted(TRACES))
def test_exports_equal_jax(traces):
    tf, jf, tables = _both_frames(TRACES[traces])
    tf = tcore.ops.sort(tf, (TIMESTAMP, CASE))
    jf = jcore.ops.sort(jf, (TIMESTAMP, CASE))
    a = len(tables[ACTIVITY])
    lab = tables[ACTIVITY]
    model, jmodel = tdisc.alpha(tf, a), jdisc.alpha(jf, a)
    xml = tgraph.alpha_to_pnml(model, labels=lab)
    assert xml == jgraph.alpha_to_pnml(jmodel, labels=lab)
    pairs, starts, ends = tgraph.pnml_places(xml)
    assert (pairs, starts, ends) == (model.places, model.start_activities,
                                     model.end_activities)
    places, transitions, _ = tgraph.read_pnml(xml)
    assert places["source"] == 1 and len(places) == len(model.places) + 2
    assert sorted(transitions.values()) == sorted(lab)
    net, jnet = tdisc.heuristics(tf, a), jdisc.heuristics(jf, a)
    dot = tgraph.heuristics_to_dot(net, labels=lab)
    assert dot == jgraph.heuristics_to_dot(jnet, labels=lab)
    assert dot.startswith("digraph") and "__start ->" in dot and "-> __end" in dot
    d, jd = tcore.dfg(tf, a), jcore.dfg(jf, a)
    g = tgraph.compile_graph(d, labels=lab)
    assert tgraph.graph_to_dot(g) == jgraph.graph_to_dot(
        jgraph.compile_graph(jd, labels=lab))
    tree = tgraph.discover_process_tree(d, labels=lab)
    assert tree == jgraph.discover_process_tree(jd, labels=lab)
    assert tgraph.discover_process_tree(g) == tree
    text = tgraph.dfg_to_json(d, labels=lab)
    assert text == jgraph.dfg_to_json(jd, labels=lab)
    assert set(json.loads(text)) == {"activities", "dfg", "start_activities",
                                     "end_activities"}
    d2, lab2 = tgraph.dfg_from_json(text, device="cpu")
    assert lab2 == list(lab)
    _same(d2, jgraph.dfg_from_json(text)[0])
    _same(d2, d)


def test_process_tree_notation():
    tf, _, tables = _both_frames(TRACES["sequence"])
    tf = tcore.ops.sort(tf, (TIMESTAMP, CASE))
    assert tgraph.discover_process_tree(
        tcore.dfg(tf, 3), labels=tables[ACTIVITY]) == "->( 'a', 'b', 'c' )"
    empty = tcore.DFG(torch.zeros((3, 3), dtype=torch.int32),
                      torch.zeros(3, dtype=torch.int32),
                      torch.zeros(3, dtype=torch.int32))
    assert tgraph.discover_process_tree(empty) == "tau"


def test_xes_bytes_equal_jax_and_remine_bitwise(tmp_path):
    """The port's ``frame_to_xes`` writes the JAX package's bytes, and the
    re-imported frame re-mines to the same DFG state."""
    cols, _ = _log(6, n_cases=20)
    jf, tf = _frames(cols, None)
    tables = {ACTIVITY: [f"act {i}" for i in range(A)]}
    p, jp = tmp_path / "port.xes", tmp_path / "jax.xes"
    tgraph.frame_to_xes(str(p), tf, tables)
    jgraph.frame_to_xes(str(jp), jf, tables)
    assert p.read_bytes() == jp.read_bytes()
    frame2, tables2 = tgraph.frame_from_xes(str(p), device="cpu")
    jframe2, jtables2 = jgraph.frame_from_xes(str(jp))
    assert tables2 == jtables2
    for k in frame2.names:
        # the port keeps the parsed float64 timestamps; JAX (x64 off)
        # narrows them to float32
        want = np.asarray(jframe2[k])
        np.testing.assert_array_equal(frame2[k].numpy().astype(want.dtype), want)
    # realign first-seen activity codes to the original dictionary
    perm = np.array([tables[ACTIVITY].index(x) for x in tables2[ACTIVITY]],
                    np.int32)
    c2 = frame2.to_numpy()
    c2[ACTIVITY] = perm[c2[ACTIVITY]]
    frame2 = tcore.ops.sort(tcore.EventFrame.from_numpy(c2, device="cpu"),
                            (TIMESTAMP, CASE))
    _same(tcore.dfg(frame2, A), tcore.dfg(tf, A))
    _same(tengine.run_single(tgraph.graph_kernel(A), frame2),
          jcore.engine.run_single(jgraph.graph_kernel(A), jf))
