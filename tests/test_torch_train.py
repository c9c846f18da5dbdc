"""PyTorch port: EventLM training against the JAX package, on the CPU.

The reduced ``eventlm-100m`` (``reduced_config``: 4 layers, d_model 64, 4
heads over 4 KV heads, head_dim 16, float32) with the JAX package's
parameters carried over bitwise (``params_from_jax`` / ``params_to_jax``).
On the CPU the port differentiates the plain chunked attention under
autograd, as JAX differentiates its ``lax.scan``.  Tolerances, each from
float32 sums taken in another order:

* the attention backward's plain formulas (``flash_attention_bwd_ref``)
  against ``jax.vjp`` of JAX's ``attention_ref`` and torch autograd of
  ``flash_attention_ref``: 1e-5 (GQA, causal, window, ragged ``kv_len``,
  rows with no valid column, D 16 / 64), plus ``gradcheck`` in float64;
* ``loss_fn``: 1e-5; every parameter's gradient within 1e-5 of its
  leaf's largest magnitude, under ``remat_policy`` full, dots and none;
* five train steps against JAX's jitted step: parameters within 2e-5
  (AdamW scales each update to about ``lr`` = 1e-3, so a gradient near 0
  that differs in its last bits moves a parameter by a fraction of that),
  ``m`` / ``v`` within 1e-7, ``lr`` and ``grad_norm`` within 1e-6 / 1e-5
  relative, ``step`` equal;
* checkpoints between the packages, and ``psum_compressed`` over 8 shards
  against JAX's ``shard_map`` at 8 virtual devices: bitwise.

Plus the JAX package's ``tests/test_train_runtime.py`` in port form, the
elastic mesh's shapes, the launcher's CLI with a failure and a resume, and
serving that builds no graph and launches no backward.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.models import model as JMdl  # noqa: E402
from repro.models.module import Initializer as JInitializer  # noqa: E402
from repro.train import trainstep as JTS  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,  # noqa: E402
                                                 flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref, ops)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as Mdl  # noqa: E402
from repro_torch.models.convert import (opt_from_jax, opt_to_jax,  # noqa: E402
                                        params_from_jax, params_to_jax)
from repro_torch.models.module import Empty, Initializer  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train import trainstep as TS  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, load_train_state  # noqa: E402
from repro_torch.train.ft import (FailureInjector, StragglerMonitor,  # noqa: E402
                                  elastic_mesh, run_with_restarts)
from repro_torch.train.optimizer import (OptConfig, adamw_update, global_norm,  # noqa: E402
                                         init_opt_state, jax_leaves, schedule)

from helpers import LOCAL_RULES  # noqa: E402

ARCH = "eventlm-100m"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# torch's default of one thread a core in every process: beside other test
# processes on the same cores its threads wait on each other, and training
# steps took 30 x their time alone
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    cfg = jreduced(jget_config(ARCH))
    return cfg, JMdl.init_params(cfg, JInitializer(jax.random.PRNGKey(0), cfg.param_dtype))


def _port(params_j, **overrides):
    cfg = reduced_config(get_config(ARCH)).with_overrides(**overrides)
    model = Mdl.init_params(cfg, Empty(cfg.param_dtype, "cpu"))
    with torch.no_grad():
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params_j)))
    return cfg, model


def _batch(cfg, b=4, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(3, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    j = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:]),
         "loss_mask": jnp.ones((b, s), jnp.float32)}
    t = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:]),
         "loss_mask": torch.ones((b, s))}
    return j, t


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters()}


def _assert_tree_close(got, want, rel=None, atol=0.0):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        tol = atol if rel is None else rel * float(np.abs(w).max())
        err = float(np.abs(np.asarray(g, np.float64) - w).max())
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


# --------------------------------------------------- attention backward
BWD_SHAPES = [(2, 4, 2, 37, 37, 16, True, None, None),     # GQA, causal
              (1, 6, 2, 70, 70, 64, True, 9, 50),          # window, ragged kv_len
              (2, 4, 1, 5, 40, 16, False, None, 29),       # non-causal, ragged
              (1, 2, 2, 64, 64, 16, True, 4, 10)]          # rows with no valid column


def _qkv_do(seed, b, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d), (b, h, sq, d))]


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,win,kvlen", BWD_SHAPES, ids=str)
def test_bwd_formulas_match_jax_vjp_and_autograd(b, h, kvh, sq, sk, d, causal, win, kvlen):
    q, k, v, do = _qkv_do(sq * 7 + d, b, h, kvh, sq, sk, d)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention_ref(
        q_, k_, v_, None if kvlen is None else jnp.int32(kvlen), causal=causal, window=win),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_lse_ref(tq, tk, tv, kvlen, causal=causal, window=win)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, kvlen, causal=causal, window=win)
    assert flash_attention_bwd_cuda(tq, tk, tv, o, lse, tdo, kvlen, causal=causal,
                                    window=win)[0].equal(got[0])     # CPU: the plain one
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    flash_attention_ref(*leaves, kvlen, causal=causal, window=win).backward(tdo)
    for g, w, a in zip(got, want, leaves):
        assert g.shape == a.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), atol=1e-5)
    if win == 4:                       # rows 13.. see nothing: lse -inf, gradient 0
        assert torch.isinf(lse[..., 13:]).all() and not got[0][..., 13:, :].any()


@pytest.mark.parametrize("causal,win,kvlen", [(True, None, None), (True, 2, 4), (False, None, 3)])
def test_flash_attention_function_gradcheck_float64(causal, win, kvlen):
    """The autograd function's plain forward / backward pair (the CPU route
    of ``FlashAttention``) passes ``gradcheck`` in float64, GQA included
    (small shapes: the numerical Jacobian takes two forwards an element)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 2, 5, 4), (1, 1, 5, 4), (1, 1, 5, 4)))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: ops.FlashAttention.apply(q_, k_, v_, kvlen, causal, win), (q, k, v))


def test_flash_attention_goes_through_the_function_only_for_gradients(monkeypatch):
    calls = []
    real = ops.FlashAttention.apply
    monkeypatch.setattr(ops.FlashAttention, "apply",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    ops.flash_attention(q.detach(), k.detach(), v.detach())
    assert calls == []
    ops.flash_attention(q, k, v).sum().backward()
    assert calls == [1] and q.grad is not None and k.grad.shape == k.shape


# ------------------------------------------------ loss, gradients, steps
@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_loss_and_gradients_match_jax(jax_model, remat):
    cfg_j, params_j = jax_model
    cfg_j = cfg_j.with_overrides(remat_policy=remat)
    cfg, model = _port(params_j, remat_policy=remat)
    assert cfg.attn_impl == cfg_j.attn_impl == "chunked"
    bj, bt = _batch(cfg)
    want_loss, want = jax.value_and_grad(lambda p: JTS.loss_fn(cfg_j, p, bj, LOCAL_RULES))(params_j)
    loss = TS.loss_fn(cfg, model, bt)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    got = params_to_jax(_grads(model))
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    _assert_tree_close(got, want, rel=1e-5)


def test_five_train_steps_match_jax_jit(jax_model):
    cfg_j, params_j = jax_model
    cfg, model = _port(params_j)
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    sj = JTS.init_state(cfg_j, params_j)
    step_j = jax.jit(JTS.make_train_step(cfg_j, LOCAL_RULES, JOptConfig(**oc), 1))
    st = TS.init_state(cfg, model)
    step_t = TS.make_train_step(cfg, OptConfig(**oc), 1)
    for i in range(5):
        bj, bt = _batch(cfg, seed=10 + i)
        sj, mj = step_j(sj, bj)
        st, mt = step_t(st, bt)
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= 1e-5
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
    _assert_tree_close(params_to_jax(st["params"]), sj["params"], atol=2e-5)
    opt = opt_to_jax(st["opt"])
    _assert_tree_close({"m": opt["m"], "v": opt["v"]},
                       {"m": sj["opt"]["m"], "v": sj["opt"]["v"]}, atol=1e-7)
    assert int(opt["step"]) == int(sj["opt"]["step"]) == 5


# ------------------------------------------ test_train_runtime, port form
def _setup(seed=0):
    cfg = reduced_config(get_config(ARCH))
    return cfg, Mdl.init_params(cfg, Initializer(torch.Generator().manual_seed(seed)))


def test_loss_decreases():
    cfg, model = _setup()
    state = TS.init_state(cfg, model)
    step = TS.make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=2, total_steps=40), 1)
    _, b = _batch(cfg)                        # overfit one batch
    losses = []
    for _ in range(30):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::10]


def test_microbatch_equivalence():
    """num_microbatches=4 gives the update of 1 (same global batch)."""
    cfg, _ = _setup()
    _, b = _batch(cfg, b=8)
    oc = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    s1 = TS.init_state(cfg, _setup()[1])
    s4 = TS.init_state(cfg, _setup()[1])
    s1, m1 = TS.make_train_step(cfg, oc, 1)(s1, b)
    s4, m4 = TS.make_train_step(cfg, oc, 4)(s4, b)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, c in zip(s1["params"].parameters(), s4["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), atol=2e-5)


def test_microbatches_match_jax(jax_model):
    """Two microbatches: the summed-then-scaled gradients of JAX's scan."""
    cfg_j, params_j = jax_model
    cfg, model = _port(params_j)
    oc = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    bj, bt = _batch(cfg, b=4, seed=3)
    sj, mj = jax.jit(JTS.make_train_step(cfg_j, LOCAL_RULES, JOptConfig(**oc), 2))(
        JTS.init_state(cfg_j, params_j), bj)
    st, mt = TS.make_train_step(cfg, OptConfig(**oc), 2)(TS.init_state(cfg, model), bt)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= 1e-5
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
    _assert_tree_close(params_to_jax(st["params"]), sj["params"], atol=2e-5)


def test_schedule_shape():
    oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(schedule(oc, torch.tensor(s, dtype=torch.int32))) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0 and abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 < lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6
    assert schedule(oc, torch.tensor(55)).dtype == torch.float32


def test_grad_clip():
    params = {"w": torch.ones(4)}
    _, _, m = adamw_update(OptConfig(clip_norm=1.0), params, {"w": torch.full((4,), 1e6)},
                           init_opt_state(params))
    assert float(m["grad_norm"]) > 1e5        # reported pre-clip


def test_global_norm_sums_in_jax_leaf_order():
    names = ["layers.1.attn.wq", "head", "layers.0.ln1", "embed", "layers.0.attn.wq",
             "layers.1.ln1", "final_norm", "layers.10.attn.wq"]
    assert jax_leaves(names) == [["embed"], ["final_norm"], ["head"],
                                 ["layers.0.attn.wq", "layers.1.attn.wq", "layers.10.attn.wq"],
                                 ["layers.0.ln1", "layers.1.ln1"]]
    rng = np.random.default_rng(0)
    tree = {n: torch.from_numpy(rng.standard_normal(3).astype(np.float32)) for n in names}
    want = np.sqrt(sum(float(np.square(t.numpy().astype(np.float64)).sum()) for t in tree.values()))
    np.testing.assert_allclose(float(global_norm(tree)), want, rtol=1e-6)


def _state(seed=0):
    cfg, model = _setup(seed)
    return cfg, TS.init_state(cfg, model)


def _assert_state_equal(a, b):
    for (n, p), q in zip(a["params"].named_parameters(), b["params"].parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a["opt"]["m"][n], b["opt"]["m"][n])
        assert torch.equal(a["opt"]["v"][n], b["opt"]["v"][n])
    assert int(a["opt"]["step"]) == int(b["opt"]["step"])


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg, state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, state)
    mgr.save(20, state)
    mgr.save(30, state)
    assert mgr.all_steps() == [20, 30]        # keep=2 gc'd step 10
    step, tree = mgr.restore_latest()
    assert step == 30
    restored = load_train_state(cfg, tree, "cpu")
    _assert_state_equal(state, restored)
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))


def test_checkpoint_async(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(1, state)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_training_resume_bitexact(tmp_path):
    """6 steps straight == 3 + checkpoint + restore + 3, bitwise."""
    cfg, s = _state()
    oc = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step = TS.make_train_step(cfg, oc, 1)
    batches = [_batch(cfg, seed=i)[1] for i in range(6)]
    for b in batches:
        s, _ = step(s, b)
    _, s2 = _state()
    for b in batches[:3]:
        s2, _ = step(s2, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, s2)
    s3 = load_train_state(cfg, mgr.restore_latest()[1], "cpu")
    for b in batches[3:]:
        s3, _ = step(s3, b)
    _assert_state_equal(s, s3)


def test_failure_injection_and_restart_loop():
    inj = FailureInjector({3})
    done = []
    for step_i in range(5):
        try:
            inj.check(step_i)
            done.append(step_i)
        except RuntimeError:
            pass
    assert 3 not in done and inj.failed == [3]
    starts, restarts = [], []

    def loop(start):
        starts.append(start)
        for i in range(6 if start == 0 else 4, 10):
            inj2.check(i)
        return 9

    inj2 = FailureInjector({7, 8})
    assert run_with_restarts(loop, on_restart=restarts.append) == 9
    assert starts == [0, -1, -1] and restarts == [1, 2]
    with pytest.raises(RuntimeError):
        run_with_restarts(lambda start: FailureInjector({0}).check(0), max_restarts=2)


def test_straggler_monitor():
    mon = StragglerMonitor(factor=2.0)
    for _ in range(5):
        assert not mon.observe(1.0)
    assert mon.observe(5.0)                   # 5x the EWMA
    assert mon.stragglers == 1


def test_int8_error_feedback_converges():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal(256).astype(np.float32))}
    errors = compression.init_errors(g)
    acc = torch.zeros(256)
    n = 50
    for _ in range(n):
        q, s, errors = compression.compress_tree(g, errors)
        acc = acc + compression.dequantize(q["w"], s["w"])
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(), atol=1e-2)


def test_quantize_roundtrip_bounds():
    x = torch.tensor([-3.0, 0.0, 1.5, 3.0])
    q, s = compression.quantize(x)
    back = compression.dequantize(q, s)
    assert q.dtype == torch.int8
    assert float((back - x).abs().max()) <= float(s) * 0.5 + 1e-7
    # half to even, as jnp.round: 0.5 and 2.5 scale units round down
    q2, _ = compression.quantize(torch.tensor([127.0, 0.5, 2.5, -1.5]))
    assert q2.tolist() == [127, 0, 2, -2]


# ----------------------------------------------------- checkpoint interop
def test_port_checkpoint_restores_in_jax_bitwise(jax_model, tmp_path):
    cfg_j, params_j = jax_model
    cfg, model = _port(params_j)
    st = TS.init_state(cfg, model)
    st, _ = TS.make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=0), 1)(st, _batch(cfg)[1])
    CheckpointManager(str(tmp_path)).save(1, st)
    step, got = JCheckpointManager(str(tmp_path)).restore_latest(JTS.init_state(cfg_j, params_j))
    assert step == 1
    want = {"params": params_to_jax(st["params"]), "opt": opt_to_jax(st["opt"])}
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_checkpoint_restores_in_port_bitwise(jax_model, tmp_path):
    cfg_j, params_j = jax_model
    bj, _ = _batch(cfg_j)
    sj, _ = jax.jit(JTS.make_train_step(cfg_j, LOCAL_RULES, JOptConfig(warmup_steps=0), 1))(
        JTS.init_state(cfg_j, params_j), bj)
    JCheckpointManager(str(tmp_path)).save(1, sj)
    cfg = reduced_config(get_config(ARCH))
    step, tree = CheckpointManager(str(tmp_path)).restore_latest()
    st = load_train_state(cfg, tree, "cpu")
    assert step == 1
    for a, b in zip(jax.tree.leaves({"params": params_to_jax(st["params"]),
                                     "opt": opt_to_jax(st["opt"])}),
                    jax.tree.leaves(jax.tree.map(np.asarray, sj))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = opt_from_jax(opt_to_jax(st["opt"]))
    assert all(torch.equal(back["m"][n], st["opt"]["m"][n]) for n in back["m"])


# ---------------------------------------------------- compression, mesh
def test_psum_compressed_matches_jax_shard_map_bitwise(tmp_path):
    """The port's psum over 8 CPU shards against JAX's ``psum_compressed``
    inside ``shard_map`` at 8 virtual devices (a child process, as
    ``tests/test_distributed.py`` runs it), with carried errors: the means
    and the new errors bitwise."""
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((8, 64)) * np.logspace(-3, 1, 8)[:, None]).astype(np.float32)
    e = (rng.standard_normal((8, 64)) * 1e-3).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, e=e)
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.train import compression
z = np.load({str(tmp_path / "in.npz")!r})
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("pod",))

def f(gl, el):
    mean, err = compression.psum_compressed({{"g": gl}}, {{"g": el}}, "pod")
    return mean["g"], err["g"]

spec = P("pod", None)
m, e = shard_map(f, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))(
    jnp.asarray(z["g"]), jnp.asarray(z["e"]))
np.savez({str(tmp_path / "out.npz")!r}, mean=np.asarray(m), err=np.asarray(e))
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    means, errs = compression.psum_compressed(
        [{"g": torch.from_numpy(g[i:i + 1])} for i in range(8)],
        [{"g": torch.from_numpy(e[i:i + 1])} for i in range(8)])
    np.testing.assert_array_equal(np.concatenate([m["g"].numpy() for m in means]), want["mean"])
    np.testing.assert_array_equal(np.concatenate([x["g"].numpy() for x in errs]), want["err"])
    # each shard's rounding is at most half a scale step: the mean is too
    step = float(np.abs(g + e).max()) / 127
    assert float(np.abs(want["mean"][0] - (g + e).mean(0)).max()) <= step / 2 + 1e-6


def test_elastic_mesh_shrinks():
    """As ``tests/test_distributed.py::test_elastic_mesh_shrinks``."""
    cpus = [torch.device("cpu")] * 8
    m = elastic_mesh(8, model_parallel=2, devices=cpus)
    assert dict(m.shape) == {"data": 4, "model": 2}
    m = elastic_mesh(7, model_parallel=2, devices=cpus)     # lost a device -> 3x2
    assert dict(m.shape) == {"data": 3, "model": 2}
    assert all(len(row) == 2 for row in m.devices)
    with pytest.raises(ValueError):
        elastic_mesh(1, model_parallel=2, devices=cpus)


# ----------------------------------------------------------- CLI, serving
def test_launch_train_cli_runs_on_cpu():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--reduced",
                          "--device", "cpu", "--steps", "12", "--log-every", "4"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS=str(THREADS)))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("[train] step ") and "tok/s" in ln for ln in lines) == 4
    assert lines[-1].startswith("[train] done: first loss")


def test_launch_train_fail_then_resume(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--steps", "12", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5"]
    with pytest.raises(RuntimeError, match="injected node failure at step 7"):
        ttrain.main(argv + ["--fail-at", "7"])
    deadline = time.time() + 60            # the async write of step 5 may still run
    while CheckpointManager(str(tmp_path)).all_steps() != [5] and time.time() < deadline:
        time.sleep(0.05)
    assert CheckpointManager(str(tmp_path)).all_steps() == [5]
    losses = ttrain.main(argv + ["--resume"])
    assert "[train] resumed from step 5" in capsys.readouterr().out
    assert len(losses) == 7 and np.isfinite(losses).all()
    assert CheckpointManager(str(tmp_path)).latest_step() == 12


def test_serving_builds_no_graph_and_launches_no_backward(monkeypatch):
    calls = []
    real = ops.FlashAttention.apply
    monkeypatch.setattr(ops.FlashAttention, "apply", lambda *a: calls.append(1) or real(*a))
    cfg, model = _setup()
    cfg = cfg.with_overrides(attn_impl="pallas")
    prompts = np.random.default_rng(0).integers(3, cfg.vocab_size, (2, 12)).astype(np.int32)
    engine = Engine(cfg, model, max_len=32, device="cpu")
    before = flash_attention_bwd_cuda.launches
    logits, cache = engine.prefill(prompts)
    assert logits.grad_fn is None and not logits.requires_grad
    assert cache["k"].grad_fn is None
    engine.generate(prompts, 4)
    assert calls == [] and flash_attention_bwd_cuda.launches == before
    TS.loss_fn(cfg, model, _batch(cfg)[1]).backward()
    assert len(calls) == 2 * cfg.num_layers      # remat "full": forward and recompute
