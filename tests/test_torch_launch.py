"""The port's launch tooling against the JAX package's, on the CPU.

Sharding rules and spec sanitizing on the JAX tests' meshes and the H100
mesh (32, 8); parameter, state, cache and input specs and their abstract
shapes and dtypes for every arch and cell, leaf by leaf against JAX's
(nothing allocated on either side); the accounting's weighting of a
repeated unit (traced once, weighted by 7) against the unit unrolled; the
roofline at the H100 constants; the attention counted as the kernel runs it;
a reduced ``eventlm-100m`` train step's dot FLOPs against XLA's HLO of the
JAX step; a real cell through ``python -m repro_torch.launch.dryrun`` in a
child process; and the dashboard example's answers against the JAX
example's.  Tests that start a fake process group run it in a child, since
the group is process-wide state.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.launch.hlo import analyze  # noqa: E402
from repro.models import model as JMdl  # noqa: E402
from repro.models.module import ShardingRules as JRules  # noqa: E402
from repro.train import trainstep as JTS  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, cells  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    attention_flops, attention_pairs)
from repro_torch.launch import account as A  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import model as Mdl  # noqa: E402
from repro_torch.models.attention import attention, attention_ref  # noqa: E402
from repro_torch.models.module import P, ShardingRules  # noqa: E402
from repro_torch.train import trainstep as TS  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [{"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
          {"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8}]
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}


def _same_spec(port, jax_spec, drop: int = 0):
    want = tuple(jax_spec)[drop:]
    assert isinstance(port, P) and tuple(port) == want, (port, jax_spec)


def _jax_rules(rules: ShardingRules) -> JRules:
    return JRules(**{f: getattr(rules, f) for f in
                     ("embed", "vocab", "heads", "mlp", "expert", "layers", "seq", "batch")})


def _leaf(tree, name: str):
    """The JAX leaf of a port name and the count of stacked axes in front."""
    parts = name.split(".")
    node = tree
    for p in parts:
        if not p.isdigit():
            node = node[p]
    return node, sum(p.isdigit() for p in parts)


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: M.mesh_name(s))
def test_make_rules_and_sanitize_match_jax(shape):
    mesh = _FakeMesh(shape)
    for arch in ARCH_IDS + ("eventlm-100m",):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for sp in (False, True):
            got = M.make_rules(mesh, cfg, seq_parallel=sp)
            want = JM.make_rules(mesh, jcfg, seq_parallel=sp)
            assert got.__dict__ == want.__dict__, (arch, shape)
        rules = M.make_rules(mesh, cfg)
        jparams = JMdl.abstract_params(jcfg)
        jspecs = JMdl.param_specs(jcfg, _jax_rules(rules))
        for name, spec in Mdl.param_specs(cfg, rules).items():
            leaf, k = _leaf(jparams, name)
            got = M.sanitize_spec(tuple(leaf.shape), P(*((None,) * k + tuple(spec))), mesh)
            want = JM.sanitize_spec(tuple(leaf.shape), _leaf(jspecs, name)[0], mesh)
            assert tuple(got) == tuple(want), (arch, name)
    # the JAX test's cases, on the port's spec
    m = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert M.sanitize_spec((51865, 1024), P("model", "data"), m) == P(None, "data")
    assert M.sanitize_spec((1, 524288), P(("pod", "data"), "model"), m) == P(None, "model")
    assert M.sanitize_spec((8, 128), P(("pod", "data"), None), m) == P("pod", None)
    assert M.sanitize_spec((512, 4096), P(("pod", "data"), "model"), m) == \
        P(("pod", "data"), "model")


def test_mixtral_takes_expert_parallelism_on_the_h100_mesh():
    """(32, 8): 8 experts % 8 == 0, so mixtral shards its experts where JAX's
    16 x 16 mesh replicates them."""
    h100 = M.make_rules(_FakeMesh(M.SINGLE_POD), get_config("mixtral-8x7b"))
    tpu = JM.make_rules(_FakeMesh({"data": 16, "model": 16}), jget_config("mixtral-8x7b"))
    assert (h100.expert, h100.mlp) == ("model", None)
    assert (tpu.expert, tpu.mlp) == (None, "model")


# ------------------------------------------------- specs and abstract state
@pytest.mark.parametrize("arch", ARCH_IDS + ("eventlm-100m",))
def test_param_cache_and_state_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    rules = M.make_rules(_FakeMesh(M.SINGLE_POD), cfg)
    jrules = _jax_rules(rules)
    # parameters: spec, shape and dtype of every leaf, nothing allocated
    model = Mdl.abstract_params(cfg)
    jparams = JMdl.abstract_params(jcfg)
    jspecs = JMdl.param_specs(jcfg, jrules)
    specs = Mdl.param_specs(cfg, rules)
    names = dict(model.named_parameters())
    assert set(specs) == set(names)
    n_jax = 0
    for name, p in names.items():
        assert p.device.type == "meta"
        leaf, k = _leaf(jparams, name)
        assert tuple(leaf.shape[k:]) == tuple(p.shape), name
        assert leaf.dtype == JAX_DTYPE[str(p.dtype).split(".")[-1]], name
        jspec = _leaf(jspecs, name)[0]
        assert all(e is None for e in tuple(jspec)[:k]), name   # the "layers" axes
        _same_spec(specs[name], jspec, drop=k)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in names.values()) == n_jax
    # train state: params, m / v float32, step a 0-d int32
    state, sspecs = TS.abstract_state(cfg), TS.state_specs(cfg, rules)
    jstate, jsspecs = JTS.abstract_state(jcfg), JTS.state_specs(jcfg, jrules)
    for key in ("m", "v"):
        for name, t in state["opt"][key].items():
            leaf, k = _leaf(jstate["opt"][key], name)
            assert t.dtype == torch.float32 and leaf.dtype == jnp.float32
            assert tuple(leaf.shape[k:]) == tuple(t.shape) and t.device.type == "meta"
            _same_spec(sspecs["opt"][key][name], _leaf(jsspecs["opt"][key], name)[0], k)
    assert state["opt"]["step"].dtype == torch.int32 and state["opt"]["step"].dim() == 0
    assert jstate["opt"]["step"].dtype == jnp.int32 and jstate["opt"]["step"].shape == ()
    _same_spec(sspecs["opt"]["step"], jsspecs["opt"]["step"])
    # the cache: the same layouts; pos is the port's Python int
    cache = Mdl.init_cache(cfg, 4, 64, device="meta")
    jcache = JMdl.init_cache(jcfg, 4, 64, abstract=True)
    cspecs, jcspecs = Mdl.cache_specs(cfg, rules), JMdl.cache_specs(jcfg, jrules)
    assert set(cache) == set(jcache) == set(cspecs) == set(jcspecs)
    for key, t in cache.items():
        _same_spec(cspecs[key], jcspecs[key])
        if key == "pos":
            assert t == 0 and jcache[key].shape == ()
            continue
        assert t.device.type == "meta" and tuple(t.shape) == tuple(jcache[key].shape)
        assert jcache[key].dtype == JAX_DTYPE[str(t.dtype).split(".")[-1]], key


@pytest.mark.parametrize("cell", [(a, s) for a in ARCH_IDS for s in cells(a)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_input_specs_match_jax(cell):
    arch, shape_name = cell
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mesh in (_FakeMesh(M.SINGLE_POD), _FakeMesh(M.MULTI_POD)):
        rules = M.batch_rules(M.make_rules(mesh, cfg), mesh, SHAPES[shape_name].batch)
        jrules = _jax_rules(rules)
        kind = SHAPES[shape_name].kind
        fn, jfn = {"train": (SP.train_batch_specs, JSP.train_batch_specs),
                   "prefill": (SP.prefill_specs, JSP.prefill_specs),
                   "decode": (SP.decode_specs, JSP.decode_specs)}[kind]
        got, gspecs = fn(cfg, SHAPES[shape_name], rules)
        want, wspecs = jfn(jcfg, JSHAPES[shape_name], jrules)
        flat = {k: v for k, v in got.items() if k != "cache"}
        flat.update({f"cache.{k}": v for k, v in got.get("cache", {}).items()})
        jflat = {k: v for k, v in want.items() if k != "cache"}
        jflat.update({f"cache.{k}": v for k, v in want.get("cache", {}).items()})
        assert set(flat) == set(jflat)
        for key, t in flat.items():
            spec = gspecs[key] if "." not in key else gspecs["cache"][key[6:]]
            jspec = wspecs[key] if "." not in key else wspecs["cache"][key[6:]]
            _same_spec(spec, jspec)
            if key == "cache.pos":
                continue
            assert t.device.type == "meta" and tuple(t.shape) == tuple(jflat[key].shape)
            assert jflat[key].dtype == JAX_DTYPE[str(t.dtype).split(".")[-1]], key


# ------------------------------------------------------- the accounting
_LOOP = r"""
import json, sys
sys.path.insert(0, {src!r})
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import account as A, mesh as M
from repro_torch.models import repeat

def run(weighted):
    with M.fake_world(4):
        mesh = M.make_mesh({{"data": 2, "model": 2}})
        dm = mesh.device_mesh
        def mk(shape, pl):       # a DTensor of global ``shape``, its shard on meta
            local = list(shape)
            for p in pl:
                if p.is_shard():
                    local[p.dim] //= 2
            return DTensor.from_local(torch.empty(local, device="meta"), dm, pl,
                                      run_check=False, shape=torch.Size(shape),
                                      stride=torch.empty(shape, device="meta").stride())

        w = mk((16, 8), [Replicate(), Shard(0)]).requires_grad_()   # rows over model
        h0 = mk((4, 16), [Shard(0), Replicate()]).requires_grad_()
        xs = mk((4, 7, 16), [Shard(0), Replicate()]).requires_grad_()
        acct = A.Account(A.group_axes(mesh))

        def body(h, x):
            part = h.redistribute(dm, [Shard(0), Shard(1)]) @ w      # partial sums
            y = torch.tanh(part.redistribute(dm, [Shard(0), Replicate()]))  # all-reduce
            return torch.cat([y, y], -1) * x, y

        with acct, implicit_replication():
            loops = acct.weigh_loops() if weighted else __import__("contextlib").nullcontext()
            with loops:
                h, ys = repeat.scan(7, body, h0, (xs,))
            (h.sum() + ys.sum()).backward()
        return acct.summary()

print(json.dumps([run(True), run(False)]))
"""


def test_weighted_loop_equals_the_loop_unrolled():
    """A unit traced once and weighted by 7 equals the same unit unrolled 7
    times: dot FLOPs, bytes and the all-reduce's bytes, forward and
    backward (twin of the JAX test ``test_hlo_analyze_counts_loops``)."""
    out = subprocess.run([sys.executable, "-c", _LOOP.format(src=SRC)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    weighted, unrolled = json.loads(out.stdout.strip().splitlines()[-1])
    assert unrolled["coll_by_op"].get("all_reduce", 0) > 0
    assert unrolled["dot_flops"] > 0
    for key in ("dot_flops", "hbm_bytes", "collective_bytes"):
        assert math.isclose(weighted[key], unrolled[key], rel_tol=1e-12), key
    assert weighted["coll_by_op"] == unrolled["coll_by_op"]
    assert weighted["coll_by_axis"] == unrolled["coll_by_axis"]


def test_attention_is_counted_as_the_kernel_runs_it():
    """On ``meta`` tensors attention takes the kernel's route: its count is
    the kernel's formula over the causal pairs (4 d a pair forward, 10 d
    backward), no S x S score tensor is allocated; the plain version counts
    every (query, key) pair in its products."""
    b, s, h, kvh, d = 2, 256, 4, 2, 32
    q, k, v = (torch.empty((b, s, n, d), device="meta", requires_grad=True)
               for n in (h, kvh, kvh))
    acct = A.Account()
    with acct:
        o = attention(q, k, v, impl="chunked", causal=True)
        o.sum().backward()
    pairs = s * (s + 1) // 2
    assert attention_pairs(s, s, True, None) == pairs
    assert acct.flops_by_op["repro_torch.flash_attention"] == 4 * d * pairs * b * h
    assert acct.flops_by_op["repro_torch.flash_attention_bwd"] == 10 * d * pairs * b * h
    assert acct.dot_flops == 14 * d * pairs * b * h
    assert acct.peak < b * h * s * s * 4          # no (S, S) float32 scores
    assert attention_flops((b, h, s, d), (b, kvh, s, d), True, 64) == \
        4 * d * b * h * sum(min(i + 1, 64) for i in range(s))
    plain = A.Account()
    with plain:
        attention_ref(q.detach(), k.detach(), v.detach(), causal=True)
    assert plain.dot_flops == 4 * d * s * s * b * h


@pytest.mark.parametrize("collector", ["enabled", "disabled"])
def test_account_peak_leaves_out_storages_only_a_cycle_holds(collector):
    """A storage that only a reference cycle holds is dead when a larger
    allocation comes, whether or not the cyclic collector would have run:
    the peak is the larger allocation alone, not its sum with the cycle's."""
    import gc

    n = 1 << 20                                   # float32 elements, 4 MiB
    was = gc.isenabled()
    if collector == "disabled":
        gc.disable()
    try:
        acct = A.Account()
        with acct:
            x = torch.ones(n, device="meta")
            box = [x * 2]
            box.append(box)                       # x * 2 now held by a cycle
            del x, box
            torch.ones(3 * n, device="meta")
    finally:
        if was:
            gc.enable()
    assert acct.peak == 3 * n * 4
    assert gc.isenabled() == was


def test_train_step_dot_flops_match_jax_hlo_outside_attention():
    """A reduced ``eventlm-100m`` train step (remat "full"): the port's dot
    FLOPs on ``meta`` equal XLA's multiplicity-weighted dots of the JAX step
    (``hlo.analyze``) but for attention, whose difference is stated by
    formula: JAX's chunked scan runs every (query, key) pair of each KV
    chunk, 4 d a pair forward, again in the recompute, and 8 d in the VJP
    (16 d); the port's kernels run the causal pairs, 4 d forward, again in
    the recompute, and 10 d in the backward kernel (18 d)."""
    cfg = reduced_config(get_config("eventlm-100m"))
    jcfg = jreduced(jget_config("eventlm-100m"))
    b, s = 2, 64
    assert s % cfg.attn_chunk == 0 and cfg.remat_policy == "full"
    jstate = JTS.abstract_state(jcfg)
    jbatch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
              "targets": jax.ShapeDtypeStruct((b, s), jnp.int32),
              "loss_mask": jax.ShapeDtypeStruct((b, s), jnp.float32)}
    from helpers import LOCAL_RULES
    step = JTS.make_train_step(jcfg, LOCAL_RULES, JOptConfig(), 1)
    hlo = jax.jit(step).lower(jstate, jbatch).compile().as_text()
    jax_dots = analyze(hlo)["dot_flops"]

    state = TS.abstract_state(cfg)
    for p in state["params"].parameters():
        p.requires_grad_(True)
    batch = {k: torch.empty((b, s), dtype=t, device="meta")
             for k, t in (("tokens", torch.int32), ("targets", torch.int32),
                          ("loss_mask", torch.float32))}
    acct = A.Account()
    with acct:
        loss = TS.grad_step(cfg, state["params"], batch)
        TS.finish_step(OptConfig(), state, loss, 1)
    attn = acct.flops_by_op["repro_torch.flash_attention"] + \
        acct.flops_by_op["repro_torch.flash_attention_bwd"]
    L, h, d = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    assert attn == L * b * h * d * 18 * (s * (s + 1) // 2)
    jax_attn = L * b * h * d * 16 * s * s
    assert acct.dot_flops - attn == jax_dots - jax_attn


def test_roofline_math():
    """``test_roofline_math`` of the JAX package at the H100 constants."""
    rec = {"arch": "yi-6b", "shape": "train_4k", "compute_dtype": "bfloat16",
           "flops_per_device": 989e12,               # exactly 1 s of compute
           "bytes_per_device": 3.35e12 / 2,          # 0.5 s of HBM
           "collective_bytes_per_device": 50e9 / 4 + 450e9 / 8,
           "collectives_by_axis": {"data": 50e9 / 4, "model": 450e9 / 8},   # 0.375 s
           "params": 6e9, "active_params": 6e9}
    a = RL.analyze_record(rec, chips=256)
    assert a["bottleneck"] == "compute"
    assert abs(a["t_compute"] - 1.0) < 1e-9
    assert abs(a["t_memory"] - 0.5) < 1e-9
    assert abs(a["t_collective"] - 0.375) < 1e-9
    useful = 6 * 6e9 * 256 * 4096 / 256
    assert abs(a["useful_ratio"] - useful / 989e12) < 1e-6
    assert 0 < a["roofline_fraction"] <= 1.0
    f32 = RL.analyze_record({**rec, "compute_dtype": "float32"}, chips=256)
    assert abs(f32["t_compute"] - 989 / 67) < 1e-9 and f32["peak_flops"] == 67e12
    assert RL.mfu(6e9, 4096, "train", 1.0, "bfloat16") == 6 * 6e9 * 4096 / 989e12


# ------------------------------------------------------------ a real cell
def test_dryrun_cell_subprocess():
    """whisper-medium decode_32k on the (32, 8) mesh, as a user runs it."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dryrun.jsonl")
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-medium",
             "--shape", "decode_32k", "--out", out],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": SRC},
            timeout=300, cwd=d)
        assert res.returncode == 0, res.stdout + res.stderr[-3000:]
        rec = json.loads(open(out).read().splitlines()[-1])
    assert rec["ok"] and rec["mesh"] == "32x8" and rec["flops_per_device"] > 0
    assert rec["memory"]["peak_bytes"] < 80e9 and rec["fits"]
    assert rec["params_held"] > 0 and rec["collectives_by_axis"]
    row = RL.analyze_record(rec, chips=256)
    assert row["bottleneck"] in ("compute", "memory", "collective")


# -------------------------------------------------------------- dashboard
def _jax_dashboard(cases: int, months: int, tmpdir: str) -> dict:
    """The JAX example's panels, through its own functions, as the port's
    ``dashboard`` records them."""
    spec = importlib.util.spec_from_file_location(
        "jax_dashboard", os.path.join(ROOT, "examples", "dashboard.py"))
    dash = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dash)
    import repro
    from repro import cases_containing, col
    from repro.core import CASE

    paths, _ = dash.build_monthly_logs(cases, months, tmpdir)
    ds = repro.open(paths)
    region = ds.tables[dash.REGION]
    out = {"files": len(paths)}
    landing = dash.fused_panel("landing", ds, ["dfg", "stats", "performance_dfg", "alpha"])
    out["landing"] = {"dfg": np.asarray(landing["dfg"].counts).tolist(),
                      "case_sizes": np.asarray(landing["stats"]["case_sizes"]).tolist(),
                      "alpha_places": len(landing["alpha"].places)}
    east = region.index("east")
    out["east_dfg"] = np.asarray(dash.widget("east", ds.filter(col(dash.REGION) == east),
                                             "dfg").counts).tolist()
    mc = -(-cases // months)
    one_month = ds.filter(col(CASE).between(2 * mc, 3 * mc - 1))
    out["month_dfg"] = np.asarray(dash.widget("month", one_month, "dfg",
                                              engine="streaming").counts).tolist()
    net = dash.widget("heur", ds.filter(cases_containing(4)), "heuristics")
    out["heuristics_edges"] = int(np.asarray(net.graph).sum())
    sel = one_month.filter(col(dash.REGION) == east)
    r = sel.collect("dfg", engine="streaming")
    out["drill_down_dfg"] = np.asarray(r.result.counts).tolist()
    out["drill_down_skipped"] = [r.report.groups_skipped, r.report.groups_total]
    n_units = ds.window(by="groups", size=1)._num_units()
    size = max(2, n_units // len(paths) * 2)
    w = ds.window(by="groups", size=size, step=max(1, size // 2))
    wm = w.collect_many(["dfg", "activity_counts"])
    out["windows"] = {"bounds": [list(map(int, b)) for b in wm.bounds],
                      "drift": [float(x) for x in w.drift()],
                      "busiest": [int(np.asarray(res["dfg"].counts).max())
                                  for res in wm.results]}
    bp = ds.bottlenecks()
    out["bottleneck"] = {"path": [int(i) for i in bp.path],
                         "bottleneck": float(bp.bottleneck)}
    return out


def test_dashboard_answers_match_jax(capsys):
    """``examples/dashboard_torch.py --device cpu`` at a small size: every
    panel's answer equals the JAX example's (timings aside; the files' sizes
    differ, as the port keeps case ids int64 where JAX narrows them)."""
    spec = importlib.util.spec_from_file_location(
        "dashboard_torch", os.path.join(ROOT, "examples", "dashboard_torch.py"))
    dash = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dash)
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        got = dash.dashboard(3_000, 3, "cpu", d1)
        want = _jax_dashboard(3_000, 3, d2)
    assert got.pop("bytes") > 0
    assert got == want
    assert "bottleneck corridor" in capsys.readouterr().out
