"""PyTorch port, the distributed layer (``repro_torch.distributed``) and the
``Dataset``'s ``engine="sharded"``, held on the CPU against the JAX package.

The port shards on a single-controller mesh (every shard ``"cpu"`` here);
the JAX package runs its eager / single-shot paths in this process (its own
sharded runs need several virtual devices, a flag that must not leak into
this process, so its sort and DFG at 4 devices run in a child).  Every
comparison is bitwise (fingerprints as uint32, centrality ``flow`` within
1e-6): the drivers at 1, 2, 4 and 8 shards, the sharded variants on a
pruned stream with ghost rows and on shards smaller than a case, the
merge-tree sharding of the stitchable verbs, the ``Dataset`` facade's
sharded collects, JAX's error texts, and the bucket-exchange sort against
a numpy oracle of JAX's semantics.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch_scan_helpers import scan_reports_equal  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import discovery as jdisc  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import variants as jvariants  # noqa: E402
from repro.core.dfg import dfg as jdfg  # noqa: E402
from repro.core.eventframe import EventFrame as JFrame  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.dataset import engines as jengines  # noqa: E402
from repro.distributed import discovery as jdd  # noqa: E402
from repro.distributed import query as jdq  # noqa: E402
from repro.storage import edf as jedf  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.eventframe import (ACTIVITY, CASE, TIMESTAMP,  # noqa: E402
                                         EventFrame)
from repro_torch.core.polyhash import BASE1, BASE2  # noqa: E402
from repro_torch.dataset import engines as tengines  # noqa: E402
from repro_torch.distributed import mesh as tmesh  # noqa: E402
from repro_torch.distributed import query as tdq  # noqa: E402
from repro_torch.distributed.dfg import dfg_sharded_host, shard_columns  # noqa: E402
from repro_torch.distributed.discovery import (  # noqa: E402
    alpha_sharded, discovery_state_sharded_host, heuristics_sharded)
from repro_torch.distributed.sort import sort_by_case_sharded  # noqa: E402
from repro_torch.distributed.variants import run_sharded_variants  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHARDS = (1, 2, 4, 8)
A = 7           # activities in the file fixture
NC = 240        # cases in the file fixture
FLOW_ATOL = 1e-6
SHARDED_VERBS = ("dfg", "alpha", "heuristics", "variants", "graph",
                 "reachability", "bottleneck_paths", "node_centrality")
MERGE_VERBS = ("case_sizes", "case_durations", "activity_counts",
               "eventually_follows")


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, path="result"):
    """A port result against a JAX result: bitwise, fingerprints as uint32,
    centrality ``flow`` within ``FLOW_ATOL``."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name),
                  f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (int, float, str, frozenset)):
        assert got == want, path
    else:
        g, w = _host(got), _host(want)
        if w.dtype == np.uint32 and g.dtype == np.int64:
            assert g.min(initial=0) >= 0 and g.max(initial=0) < 2**32, path
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (path, g.dtype, w.dtype, g.shape, w.shape)
        if path.endswith(".flow"):
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOW_ATOL,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def padded():
    """The JAX distributed tests' frame: 5,000 cases, 13 activities, seed 9,
    padded to a multiple of 8 rows with masked ``-1`` rows; the JAX frame
    and the port's copy on the CPU."""
    frame, _ = jsyn.generate(num_cases=5000, num_activities=13, seed=9)
    pad = (-frame.nrows) % 8
    cols = {k: jnp.pad(frame[k], (0, pad), constant_values=-1)
            for k in (CASE, ACTIVITY, TIMESTAMP)}
    jf = JFrame(cols, {}, jnp.pad(frame.rows_valid(), (0, pad)))
    tf = EventFrame.from_numpy({k: np.array(v) for k, v in cols.items()},
                               device="cpu")
    tf = EventFrame(tf.columns, {}, torch.from_numpy(
        np.asarray(jf.rows_valid())))
    return jf, tf


@pytest.fixture(scope="module")
def logset(tmp_path_factory):
    """Three v3 files partitioning one sorted log (JAX's writer, 97-row
    groups) and JAX's eager results of every sharded verb over the case
    band 50..170, which the zone maps refute for some groups."""
    frame, tables = jsyn.generate(num_cases=NC, num_activities=A, seed=3)
    d = tmp_path_factory.mktemp("tdist")
    case = np.asarray(frame[CASE])
    bounds = [0, int(np.searchsorted(case, 80)),
              int(np.searchsorted(case, 160)), frame.nrows]
    paths = []
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        p = str(d / f"part{i}.edf")
        jedf.write(p, frame.take(jnp.arange(lo, hi)), tables,
                   row_group_rows=97)
        paths.append(p)
    jds = _band(repro, repro.open(paths))
    want = {v: jds.collect(v, engine="eager").result
            for v in SHARDED_VERBS + MERGE_VERBS}
    return paths, jds, want


def _band(pkg, ds):
    col = pkg.col
    return ds.filter((col(CASE) >= 50) & (col(CASE) <= 170))


def _tds(paths):
    return _band(repro_torch, repro_torch.open(paths, device="cpu"))


@pytest.fixture(autouse=True)
def _fresh_caches():
    jengines.clear_result_cache()
    tengines.clear_result_cache()
    yield


# ----------------------------------------------------------------- mesh
def test_mesh_and_collectives_on_the_host():
    """Round-robin placement (every shard on the CPU here) and the
    collectives' semantics over per-shard values, in shard order."""
    m = tmesh.mesh_for(3, "cpu")
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="at least one shard"):
        tmesh.mesh_for(0, "cpu")
    xs = [torch.arange(4) + 10 * i for i in range(3)]
    tails = tmesh.shift_tails(xs, 2)
    assert tails[0] is None
    assert [t.tolist() for t in tails[1:]] == [[2, 3], [12, 13]]
    trees = [{"a": x, "b": {"c": x[:1]}} for x in xs]
    for s in tmesh.psum(trees):
        assert s["a"].tolist() == [30, 33, 36, 39]
        assert s["b"]["c"].tolist() == [30]
    for g in tmesh.all_gather([x[:2] for x in xs]):
        assert g.tolist() == [[0, 1], [10, 11], [20, 21]]
    bufs = [torch.arange(6).reshape(3, 2) + 100 * i for i in range(3)]
    got = tmesh.all_to_all(bufs)
    for j in range(3):
        for i in range(3):
            assert torch.equal(got[j][i], bufs[i][j])
    assert [int(v) for v in tmesh.pmax([torch.tensor(0), torch.tensor(1),
                                        torch.tensor(0)])] == [1, 1, 1]


# -------------------------------------------------------------- drivers
@pytest.mark.parametrize("shards", SHARDS)
def test_dfg_and_discovery_sharded_host_match_jax(padded, shards):
    """``dfg_sharded_host`` and ``discovery_state_sharded_host`` (L2 counts
    too) equal JAX's single-shot DFG and discovery state, and the miners'
    finalize of the sharded state equals JAX's."""
    jf, tf = padded
    _same(dfg_sharded_host(tf, 13, shards), jdfg(jf, 13, method="segment"),
          f"dfg@{shards}")
    jstate = jdisc.discovery_state(jf, 13)
    got = discovery_state_sharded_host(tf, 13, shards)
    _same(got, jstate, f"discovery@{shards}")
    assert int(got.l2_counts.sum()) > 0
    mesh = tmesh.mesh_for(shards, "cpu")
    _same(alpha_sharded(tf, 13, mesh), jdisc.discover_alpha(jstate.dfg),
          "alpha")
    _same(heuristics_sharded(tf, 13, mesh),
          jdisc.discover_heuristics(jstate), "heuristics")


@pytest.fixture(scope="module")
def jax_query(logset):
    """JAX's sharded query drivers over the band (one device in this
    process: one shard; the ScanReport does not depend on the shards)."""
    paths, jds, _ = logset
    plan = jds.plan()
    return (jdq.query_sharded_dfg_host(plan, A, 1),
            jdq.query_sharded_discovery_host(plan, A, 1))


@pytest.mark.parametrize("shards", SHARDS)
def test_query_sharded_host_matches_jax(logset, jax_query, shards):
    """The pruned, sharded DFG and discovery state equal JAX's, and so do
    their ScanReports, field by field (some groups refuted)."""
    paths, _, _ = logset
    plan = _tds(paths).plan()
    (jd, jrep), (jdisc_state, jrep2) = jax_query
    d, rep = tdq.query_sharded_dfg_host(plan, A, shards)
    _same(d, jd, f"dfg@{shards}")
    assert rep.groups_skipped > 0
    scan_reports_equal(rep, jrep)
    s, rep2 = tdq.query_sharded_discovery_host(plan, A, shards)
    _same(s, jdisc_state, f"discovery@{shards}")
    scan_reports_equal(rep2, jrep2)


# ------------------------------------------------------------- variants
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_variants_on_a_pruned_stream_match_jax(logset, shards):
    """Sharded variants behind a pruning filter (ghost rows carry composed
    sketch maps into the shards) equal JAX's eager fingerprints, hashes
    at and above 2^31 among them."""
    paths, _, want = logset
    r = _tds(paths).collect("variants", engine="sharded", num_shards=shards)
    assert r.engine == "sharded" and r.report.groups_skipped > 0
    _same(r.result, want["variants"], f"variants@{shards}")
    assert (np.asarray(want["variants"][0]) >= 2**31).any()


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_variants_on_shards_smaller_than_a_case(shards):
    """The affine-map lowering has no halo depth: a 90-row case spans
    several shards, one-row cases sit inside one, and the fingerprint
    tables equal JAX's streaming kernel on the whole stream."""
    rng = np.random.default_rng(5)
    lengths = [1, 90, 2, 5, 1, 33, 3, 7, 1, 12]
    case = np.repeat(np.arange(len(lengths)), lengths).astype(np.int64)
    act = rng.integers(0, 13, case.size).astype(np.int32)
    want = jengine.run_single(
        jvariants.variants_kernel(len(lengths)),
        JFrame({CASE: jnp.asarray(case, jnp.int32),
                ACTIVITY: jnp.asarray(act)}))
    v = act + 1
    maps = (np.full(v.shape, BASE1, np.int32), v,
            np.full(v.shape, BASE2, np.int32), v)
    c, _, _, maps = tdq._pad_to_shards(case, act, np.ones(case.size, bool),
                                       shards, maps)
    cols = shard_columns(tmesh.mesh_for(shards, "cpu"),
                         *(torch.from_numpy(x) for x in
                           (*maps, *tdq._segment_markers(c))))
    if shards == 8:
        assert cols[0][0].shape[0] < 90
    fp1, fp2 = run_sharded_variants(*cols, len(lengths))[0]
    from repro_torch.kernels.segment_ops.ref import u32_values

    _same((u32_values(fp1), u32_values(fp2)), want[:2], f"fps@{shards}")
    assert (np.asarray(want[0]) >= 2**31).any()


# ----------------------------------------------------------- merge tree
@pytest.mark.parametrize("shards", (1, 3, 8))
@pytest.mark.parametrize("verb", MERGE_VERBS)
def test_merge_tree_sharded_matches_jax(logset, verb, shards):
    """Stitchable verbs with no distributed state shard as a merge tree of
    contiguous spans of the pruned stream: equal to JAX's eager result and
    to the Dataset's sharded engine."""
    paths, _, want = logset
    tds = _tds(paths)
    dims = tengine.Dims(tds.num_activities, tds.num_cases)
    spec = tengine.kernel_spec(verb)
    got, rep = tdq.merge_tree_sharded(tds.plan(columns=spec.columns),
                                      spec.make(dims), shards, device="cpu")
    assert rep.groups_skipped > 0
    _same(got, want[verb], f"{verb}@{shards}")
    r = tds.collect(verb, engine="sharded", num_shards=shards)
    assert r.engine == "sharded"
    _same(r.result, want[verb], f"dataset {verb}@{shards}")


# -------------------------------------------------------------- dataset
@pytest.mark.parametrize("shards", SHARDS)
def test_dataset_sharded_collect_and_collect_many_match_jax(logset, shards):
    """``collect`` and ``collect_many`` with ``engine="sharded"`` equal
    JAX's eager results for every verb with a distributed state (the DFG,
    the miners, variants and the four graph verbs); the fused pass mines
    each distinct state once."""
    paths, _, want = logset
    tds = _tds(paths)
    for verb in SHARDED_VERBS:
        r = tds.collect(verb, engine="sharded", num_shards=shards)
        assert r.engine == "sharded" and r.report.groups_skipped > 0
        _same(r.result, want[verb], f"{verb}@{shards}")
    res = tds.collect_many(SHARDED_VERBS, engine="sharded",
                           num_shards=shards)
    assert res.engine == "sharded"
    for verb in SHARDED_VERBS:
        _same(res[verb], want[verb], f"many {verb}@{shards}")


def test_sharded_specs_match_jax_registry():
    """Every registered verb names JAX's distributed state; a fused spec
    shards exactly when every member does."""
    tspecs, jspecs = tengine.kernel_specs(), jengine.kernel_specs()
    for verb, spec in tspecs.items():
        if not spec.members:
            assert spec.sharded_state == jspecs[verb].sharded_state, verb
            assert (spec.from_sharded is None) == \
                (jspecs[verb].from_sharded is None), verb
    for verbs, state in ((("dfg", "alpha"), "fused"),
                         (("dfg", "variants"), "fused"),
                         (("dfg", "stats"), None)):
        fused = tengine.compose_specs({v: tspecs[v] for v in verbs})
        assert fused.sharded_state == state and fused.from_sharded is None
        assert jengine.compose_specs(
            {v: jspecs[v] for v in verbs}).sharded_state == state


# --------------------------------------------------------------- errors
def test_sharded_errors_keep_jax_texts(logset):
    """JAX's ValueErrors, word for word: a shard below the halo depth, an
    in-memory dataset, ``graph(timed=True)``, a verb (or a fused set) with
    no stitch and no distributed state; and the port's own refusal of a
    row count the shards do not divide."""
    paths, jds, _ = logset
    tds = _tds(paths)

    def texts(jcall, tcall):
        with pytest.raises(ValueError) as je:
            jcall()
        with pytest.raises(ValueError) as te:
            tcall()
        assert str(te.value) == str(je.value)
        return str(te.value)

    one = JFrame({CASE: jnp.zeros(1, jnp.int32),
                  ACTIVITY: jnp.zeros(1, jnp.int32)})
    tone = EventFrame.from_numpy({CASE: np.zeros(1, np.int32),
                                  ACTIVITY: np.zeros(1, np.int32)},
                                 device="cpu")
    # the halo text follows the kernel's name, which names its lowering
    # (JAX: "discovery[xla]"; the port resolves by device: "discovery[auto]")
    with pytest.raises(ValueError) as je:
        jdd.discovery_state_sharded_host(one, 3, 1)
    with pytest.raises(ValueError) as te:
        discovery_state_sharded_host(tone, 3, 1)
    jname, jmsg = str(je.value).split(": ", 1)
    tname, tmsg = str(te.value).split(": ", 1)
    assert tmsg == jmsg and tname.split("[")[0] == jname.split("[")[0]
    assert tmsg.startswith("1 row(s) per shard < halo depth 2")
    eight = EventFrame.from_numpy({CASE: np.arange(8, dtype=np.int32),
                                   ACTIVITY: np.zeros(8, np.int32)},
                                  device="cpu")
    with pytest.raises(ValueError, match="1 row.s. per shard < halo depth 2"):
        discovery_state_sharded_host(eight, 3, 8)
    with pytest.raises(ValueError, match="8 rows do not split into 3"):
        dfg_sharded_host(eight, 3, 3)
    frame, tables = jsyn.generate(num_cases=20, num_activities=5, seed=1)
    tmem = repro_torch.open(EventFrame.from_numpy(
        {k: np.array(frame[k]) for k in (CASE, ACTIVITY)}, device="cpu"),
        tables=tables, device="cpu")
    texts(lambda: repro.open(frame, tables=tables).collect(
        "dfg", engine="sharded"),
          lambda: tmem.collect("dfg", engine="sharded"))
    texts(lambda: jds.collect("graph", engine="sharded", timed=True),
          lambda: tds.collect("graph", engine="sharded", timed=True))
    texts(lambda: jds.collect("bottleneck_paths", engine="sharded",
                              weights="performance"),
          lambda: tds.collect("bottleneck_paths", engine="sharded",
                              weights="performance"))
    for verb in ("stats", "sojourn_times", "performance_dfg"):
        texts(lambda: jds.collect(verb, engine="sharded"),
              lambda: tds.collect(verb, engine="sharded"))
    texts(lambda: jds.collect_many(["dfg", "stats", "case_sizes"],
                                   engine="sharded"),
          lambda: tds.collect_many(["dfg", "stats", "case_sizes"],
                                   engine="sharded"))


# ----------------------------------------------------------------- sort
def _sort_oracle(case, act, ts, n, slack):
    """JAX's ``sort_by_case_sharded`` semantics in numpy: per shard and
    destination, the rows in order; the overflow flag; without overflow,
    each destination's buckets flattened and lexsorted (case, ts)."""
    per = case.shape[0] // n
    cap = int(per * slack / n + 1)
    bufs = np.empty((n, n, 3, cap))
    bufs[:, :, :2], bufs[:, :, 2] = -1, np.inf
    overflow = False
    for i in range(n):
        c, a, t = (x[i * per:(i + 1) * per] for x in (case, act, ts))
        for j in range(n):
            rows = np.nonzero(c % n == j)[0]
            overflow |= rows.size > cap
            rows = rows[:cap]
            bufs[i, j, 0, :rows.size] = c[rows]
            bufs[i, j, 1, :rows.size] = a[rows]
            bufs[i, j, 2, :rows.size] = t[rows]
    out = []
    for j in range(n):
        cc, aa, tt = (bufs[:, j, k].reshape(-1) for k in range(3))
        o = np.lexsort((tt, cc))
        out.append((cc[o], aa[o], tt[o]))
    return out, overflow


@pytest.mark.parametrize("shards", SHARDS)
def test_sort_by_case_sharded_matches_numpy_oracle(padded, shards):
    """The scrambled log, bucketed by ``case % shards``, exchanged and
    lexsorted: every shard equals the oracle's, no overflow at slack 2,
    every case wholly on one shard; at slack 0.3 the flag says overflow,
    as the oracle's does."""
    _, tf = padded
    perm = torch.from_numpy(np.random.default_rng(0).permutation(tf.nrows))
    scr = tf.take(perm)
    mesh = tmesh.mesh_for(shards, "cpu")
    c, a, t, overflow = sort_by_case_sharded(scr, mesh)
    want, want_over = _sort_oracle(scr[CASE].numpy(), scr[ACTIVITY].numpy(),
                                   scr[TIMESTAMP].numpy().astype(np.float32),
                                   shards, 2.0)
    assert int(overflow) == int(want_over) == 0
    for j in range(shards):
        assert c[j].dtype == torch.int32 and t[j].dtype == torch.float32
        np.testing.assert_array_equal(c[j].numpy(), want[j][0])
        np.testing.assert_array_equal(a[j].numpy(), want[j][1])
        np.testing.assert_array_equal(t[j].numpy(), want[j][2])
        real = c[j][c[j] >= 0]
        assert bool((real % shards == j).all())
    if shards > 1:
        _, _, _, over = sort_by_case_sharded(scr, mesh, slack=0.3)
        assert int(over) == int(_sort_oracle(
            scr[CASE].numpy(), scr[ACTIVITY].numpy(),
            scr[TIMESTAMP].numpy(), shards, 0.3)[1]) == 1


def test_sort_and_dfg_match_jax_at_four_virtual_devices(padded, tmp_path):
    """JAX's own ``sort_by_case_sharded`` and ``dfg_sharded_host`` at 4
    virtual devices (a child process, as ``tests/test_distributed.py``
    runs them) against the port's at 4 shards, bitwise."""
    out = tmp_path / "jax4.npz"
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core.eventframe import ACTIVITY, CASE, TIMESTAMP, EventFrame
from repro.data import synthetic
from repro.distributed.dfg import dfg_sharded_host
from repro.distributed.sort import sort_by_case_sharded
frame, _ = synthetic.generate(num_cases=5000, num_activities=13, seed=9)
pad = (-frame.nrows) % 8
cols = {{k: jnp.pad(frame[k], (0, pad), constant_values=-1)
        for k in (CASE, ACTIVITY, TIMESTAMP)}}
frame = EventFrame(cols, {{}}, jnp.pad(frame.rows_valid(), (0, pad)))
d = dfg_sharded_host(frame, 13, 4)
perm = np.random.default_rng(0).permutation(frame.nrows)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
c, a, t, over = sort_by_case_sharded(frame.take(jnp.asarray(perm)), mesh)
np.savez({str(out)!r}, counts=d.counts, starts=d.starts, ends=d.ends,
         case=c, act=a, ts=t, overflow=over)
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(out)
    _, tf = padded
    d = dfg_sharded_host(tf, 13, 4)
    for name in ("counts", "starts", "ends"):
        np.testing.assert_array_equal(getattr(d, name).numpy(), want[name])
    perm = torch.from_numpy(np.random.default_rng(0).permutation(tf.nrows))
    c, a, t, over = sort_by_case_sharded(tf.take(perm),
                                         tmesh.mesh_for(4, "cpu"))
    assert int(over) == int(want["overflow"]) == 0
    for got, key in ((c, "case"), (a, "act"), (t, "ts")):
        np.testing.assert_array_equal(torch.cat(got).numpy(), want[key])
