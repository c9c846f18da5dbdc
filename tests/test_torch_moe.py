"""PyTorch port: the MoE family against the JAX package, on the CPU.

The reduced ``qwen3-moe-30b-a3b`` and ``mixtral-8x7b`` (``reduced_config``:
4 experts, top-2, d_model 64, float32 compute), inputs and weights from
numpy seeds or the JAX package's parameters carried over bitwise:

* ``moe_apply_dense`` against ``repro.models.layers.moe_apply_dense``
  within 1e-5 with ample capacity (``capacity_factor=8.0``), with
  ``capacity_factor=0.5`` (the dropped (token, k) set identical), and on
  tied router logits (ties go to the lower expert, as ``jax.lax.top_k``);
* ``moe_apply_ep`` on CPU meshes of 2 and 4 shards against JAX's
  ``moe_apply_ep`` under a ``model`` mesh of as many host devices (a child
  process) and against the port's dense path, within 1e-5 (the partials
  are summed over shards, in another order than the dense combine);
* for both configs: ``params_from_jax`` bitwise; ``forward``, ``prefill``
  and ``decode_step`` within 1e-4 and the engine's greedy tokens
  identical; a checkpoint the JAX package wrote restoring to the same
  logits; expert parallelism through the model and the engine.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JMdl  # noqa: E402
from repro.models.module import Initializer as JInitializer  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.distributed.mesh import mesh_for  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as Mdl  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models.module import Empty  # noqa: E402
from repro_torch.models.moe_ep import moe_apply_ep  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

from helpers import LOCAL_RULES  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MOE_ATOL = 1e-5
MODEL_ATOL = 1e-4


def _cfgs(arch, **overrides):
    cfg_j = jreduced(jget_config(arch)).with_overrides(**overrides)
    cfg = reduced_config(get_config(arch)).with_overrides(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg_j, cfg


def _moe_inputs(cfg, seed, b=2, s=24, tie=False):
    """Router, experts and tokens from a numpy seed; with ``tie`` the
    router's columns 1 and 2 are equal, so every token's logits tie."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": rng.standard_normal((D, E)) * D ** -0.5,
         "gate": rng.standard_normal((E, D, F)) * D ** -0.5,
         "up": rng.standard_normal((E, D, F)) * D ** -0.5,
         "down": rng.standard_normal((E, F, D)) * F ** -0.5}
    if tie:
        p["router"][:, 2] = p["router"][:, 1]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    return p, x


def _jax_keep(p, x, cfg):
    """The (token, k) rows JAX's ``moe_apply_dense`` keeps, by its own steps."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    C = max(8, int(cfg.capacity_factor * xt.shape[0] * K / E))
    logits = jnp.einsum("td,de->te", xt, jnp.asarray(p["router"])).astype(jnp.float32)
    _, idx = jax.lax.top_k(logits, K)
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    slot = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(slot < C), np.asarray(idx)


def _port_moe(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_apply_dense_matches_jax(arch, capacity_factor):
    cfg_j, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    p, x = _moe_inputs(cfg, seed=int(capacity_factor * 10))
    want = JL.moe_apply_dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                              cfg_j, LOCAL_RULES)
    got = L.moe_apply_dense(_port_moe(p), torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL)

    # the dropped (token, k) rows are JAX's
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx = L.route(xt, torch.from_numpy(p["router"]), cfg)
    _, keep = L.dispatch_slots(idx.reshape(-1), cfg.num_experts,
                               L.capacity(cfg, xt.shape[0]))
    want_keep, want_idx = _jax_keep(p, x, cfg_j)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if capacity_factor < 1:
        assert not keep.all(), "capacity 0.5 should drop rows"
    else:
        assert keep.all()


def test_top_k_breaks_ties_by_the_lower_index():
    logits = np.array([[1, 3, 3, 0, 3], [2, 2, 2, 2, 2], [0, 1, 1, 5, 1],
                       [4, 4, 1, 1, 4]], np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = L.top_k_lower_first(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_dense_on_tied_router_logits_matches_jax(arch):
    cfg_j, cfg = _cfgs(arch)
    p, x = _moe_inputs(cfg, seed=3, tie=True)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    logits = xt @ torch.from_numpy(p["router"])
    assert torch.equal(logits[:, 1], logits[:, 2])
    want = JL.moe_apply_dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                              cfg_j, LOCAL_RULES)
    got = L.moe_apply_dense(_port_moe(p), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL)
    _, idx = L.route(xt, torch.from_numpy(p["router"]), cfg)
    np.testing.assert_array_equal(idx.numpy(), _jax_keep(p, x, cfg_j)[1])
    # wherever experts 1 and 2 both make the top k, 1 comes first
    both = ((idx == 1) | (idx == 2)).sum(1) == 2
    assert both.any()
    for row in idx[both].tolist():
        assert row.index(1) < row.index(2)


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """JAX's ``moe_apply_ep`` under ``model`` meshes of 2 and 4 host devices
    (a child process), on each config's inputs from seed 5."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        p, x = _moe_inputs(cfg, seed=5)
        np.savez(tmp / f"{arch}_in.npz", x=x, **p)
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh, set_mesh
from repro.configs import get_config, reduced_config
from repro.models.module import ShardingRules
from repro.models.moe_ep import moe_apply_ep
rules = ShardingRules(embed=None, vocab=None, heads=None, mlp=None, expert=None,
                      batch=None, seq=None)
for arch in {ARCHS!r}:
    cfg = reduced_config(get_config(arch))
    z = np.load({str(tmp)!r} + f"/{{arch}}_in.npz")
    p = {{k: jnp.asarray(z[k]) for k in ("router", "gate", "up", "down")}}
    out = {{}}
    for n in (2, 4):
        with set_mesh(make_mesh((n,), ("model",))):
            out[f"n{{n}}"] = np.asarray(moe_apply_ep(p, jnp.asarray(z["x"]), cfg, rules))
    np.savez({str(tmp)!r} + f"/{{arch}}_out.npz", **out)
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return tmp


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shards", [2, 4])
def test_moe_apply_ep_matches_jax_and_the_dense_path(jax_ep, arch, shards):
    _, cfg = _cfgs(arch, moe_impl="shard_map")
    z = np.load(jax_ep / f"{arch}_in.npz")
    want = np.load(jax_ep / f"{arch}_out.npz")[f"n{shards}"]
    p = {k: torch.from_numpy(z[k]) for k in ("router", "gate", "up", "down")}
    x = torch.from_numpy(z["x"])
    got = moe_apply_ep(p, x, cfg, mesh_for(shards, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=MOE_ATOL)
    dense = L.moe_apply_dense(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=MOE_ATOL)
    # the front door routes by moe_impl; a mesh that does not divide the
    # experts, or none, takes the dense path
    assert torch.equal(L.moe_apply(p, x, cfg, mesh_for(shards, "cpu")), got)
    assert torch.equal(moe_apply_ep(p, x, cfg, mesh_for(3, "cpu")), dense)
    assert torch.equal(moe_apply_ep(p, x, cfg, None), dense)


# ------------------------------------------------------------ the models
@pytest.fixture(scope="module", params=ARCHS)
def jax_model(request):
    cfg = jreduced(jget_config(request.param))
    params = JMdl.init_params(cfg, JInitializer(jax.random.PRNGKey(0), cfg.param_dtype))
    return request.param, cfg, params


def _port(arch, cfg_j, params_j, **overrides):
    cfg = reduced_config(get_config(arch)).with_overrides(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j.with_overrides(**overrides))
    model = Mdl.init_params(cfg, Empty(cfg.param_dtype, "cpu"))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params_j)))
    return cfg, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (b, s)).astype(np.int32)


def test_params_from_jax_is_bitwise(jax_model):
    arch, cfg_j, params_j = jax_model
    cfg, model = _port(arch, cfg_j, params_j)
    state = model.state_dict()
    flat, _ = jax.tree_util.tree_flatten_with_path(params_j)
    assert len(state) == sum(int(np.asarray(v).shape[0]) if "layers" in
                             jax.tree_util.keystr(k) else 1 for k, v in flat)
    for i in range(cfg.num_layers):
        for name in ("router", "gate", "up", "down"):
            np.testing.assert_array_equal(state[f"layers.{i}.moe.{name}"].numpy(),
                                          np.asarray(params_j["layers"]["moe"][name][i]))
    assert not any(".mlp." in k for k in state)
    back = params_to_jax(model)
    for name in ("router", "gate", "up", "down"):
        np.testing.assert_array_equal(back["layers"]["moe"][name],
                                      np.asarray(params_j["layers"]["moe"][name]))


@pytest.mark.parametrize("attn_impl", ["chunked", "ref"])
def test_forward_matches_jax(jax_model, attn_impl):
    arch, cfg_j, params_j = jax_model
    cfg, model = _port(arch, cfg_j, params_j, attn_impl=attn_impl)
    toks = _tokens(cfg, 2, 40)
    want = JMdl.forward(cfg_j.with_overrides(attn_impl=attn_impl), params_j,
                        jnp.asarray(toks), rules=LOCAL_RULES)
    got = Mdl.forward(cfg, model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MODEL_ATOL)


def test_prefill_and_decode_match_jax(jax_model):
    arch, cfg_j, params_j = jax_model
    cfg, model = _port(arch, cfg_j, params_j)
    toks = _tokens(cfg, 3, 20, seed=2)
    want_logits, want_cache = JMdl.prefill(cfg_j, params_j, jnp.asarray(toks[:, :14]),
                                           rules=LOCAL_RULES)
    got_logits, got_cache = Mdl.prefill(cfg, model, torch.from_numpy(toks[:, :14]))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=MODEL_ATOL)
    assert got_cache["pos"] == int(want_cache["pos"]) == 14
    jc = dict(want_cache)
    for name in ("k", "v"):
        jc[name] = jnp.pad(jc[name], ((0, 0), (0, 0), (0, 6), (0, 0), (0, 0)))
    tc = Mdl.init_cache(cfg, 3, 20, "cpu")
    tc["k"][:, :, :14] = got_cache["k"]
    tc["v"][:, :, :14] = got_cache["v"]
    tc["pos"] = 14
    for t in range(14, 20):
        want_step, jc = JMdl.decode_step(cfg_j, params_j, jc, jnp.asarray(toks[:, t:t + 1]),
                                         rules=LOCAL_RULES)
        got_step, tc = Mdl.decode_step(cfg, model, tc, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), atol=MODEL_ATOL)
    assert tc["pos"] == 20


def test_engine_generate_greedy_matches_jax(jax_model):
    arch, cfg_j, params_j = jax_model
    cfg, model = _port(arch, cfg_j, params_j)
    prompts = _tokens(cfg, 4, 12, seed=6)
    want = JEngine(cfg_j, params_j, max_len=64).generate(prompts, steps=8)
    got = Engine(cfg, model, max_len=64, device="cpu").generate(prompts, steps=8)
    assert got.tokens.shape == (4, 8)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits),
                               atol=MODEL_ATOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_expert_parallel_model_matches_the_dense_model(jax_model, shards):
    """``moe_impl="shard_map"`` with a mesh handed to the entry points: the
    same logits within 1e-5 of the dense dispatch and the same greedy
    tokens through the engine."""
    arch, cfg_j, params_j = jax_model
    cfg, model = _port(arch, cfg_j, params_j)
    cfg_ep = cfg.with_overrides(moe_impl="shard_map")
    mesh = mesh_for(shards, "cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 24, seed=7))
    with torch.no_grad():
        np.testing.assert_allclose(Mdl.forward(cfg_ep, model, toks, mesh=mesh).numpy(),
                                   Mdl.forward(cfg, model, toks).numpy(), atol=MOE_ATOL)
    prompts = _tokens(cfg, 3, 10, seed=8)
    ep = Engine(cfg_ep, model, max_len=32, device="cpu", mesh=mesh).generate(prompts, 6)
    dense = Engine(cfg, model, max_len=32, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(ep.tokens, dense.tokens)


def test_checkpoint_written_by_jax_restores_to_the_same_logits(jax_model, tmp_path):
    arch, cfg_j, params_j = jax_model
    JCheckpointManager(str(tmp_path)).save(5, {"params": params_j})
    step, tree = CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 5
    cfg, model = _port(arch, cfg_j, params_j)
    restored = Mdl.init_params(cfg, Empty(cfg.param_dtype, "cpu"))
    restored.load_state_dict(params_from_jax(tree["params"]))
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=4))
    assert torch.equal(Mdl.forward(cfg, restored, toks), Mdl.forward(cfg, model, toks))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_the_moe_family_on_cpu(capsys, arch):
    from repro_torch.launch import serve as tserve

    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                       "--steps", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] 3 requests x 4 tokens in ")
    assert out.tokens.shape == (3, 4)
