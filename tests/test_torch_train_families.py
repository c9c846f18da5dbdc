"""PyTorch port: training of the moe, hybrid, ssm, audio and vlm families
against the JAX package, on the CPU.

The reduced ``qwen3-moe-30b-a3b``, ``mixtral-8x7b``, ``zamba2-7b``,
``xlstm-1.3b``, ``whisper-medium`` and ``internvl2-2b`` (``reduced_config``:
d_model 64, float32 compute), with the JAX package's parameters carried over
by ``models.convert.params_from_jax`` and tokens and frontends from numpy
seeds.  Tolerances, each from float32 sums taken in another order:

* ``loss_fn``: 1e-5; every parameter's gradient within 1e-5 of its leaf's
  largest magnitude against ``jax.value_and_grad`` of the JAX package's
  ``loss_fn``, the port under ``remat_policy`` full, dots and none (zamba2
  also at 15 layers, whose three tail layers run outside the remat groups);
* three train steps against JAX's jitted ``make_train_step``, each taken
  by the port from JAX's state before it: loss 1e-5, ``grad_norm`` 1e-5
  relative, parameters within 2e-5, ``m`` / ``v`` within 1e-7
  (``tests/test_torch_train.py``'s bounds); the port's own three steps run
  on from its state with losses within 1e-4 of JAX's; the same with two
  microbatches for the MoE configs at ``capacity_factor`` 0.5, where routes
  are dropped, and for the two families that take a frontend;
* the MoE layer under autograd: gradients against ``jax.grad`` of
  ``moe_apply_dense`` within 1e-5 at capacity 0.5, a token whose every
  route is dropped gets a gradient of exactly 0, and ``moe_apply_ep`` on
  CPU meshes of 1 / 2 / 4 / 8 shards gives the dense dispatch's gradients
  within 1e-5;
* the SSM chunks at ``ssm_chunk = 64`` with decays that overflow float32
  ``exp`` above a chunk's diagonal (``OVERFLOW``): the port's gradients
  finite and within ``OVERFLOW_RTOL`` of JAX's at ``ssm_chunk = 8`` (small
  enough to stay finite there), the forward logits bitwise those of the
  reference's order (``exp`` then mask), whose gradients are not finite;
* checkpoints of the hybrid, ssm, audio and MoE train states: the port's
  restores in JAX bitwise, and JAX's in the port, both ways;
* ``launch.train --arch`` for the moe, hybrid and ssm families on the CPU,
  and its ``ValueError`` naming the frontend for audio and vlm.
"""
import dataclasses

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
from repro.train import trainstep as JTS  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.distributed.mesh import mesh_for  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models import model as Mdl  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.convert import (opt_to_jax, params_from_jax,  # noqa: E402
                                        params_to_jax)
from repro_torch.models.module import Empty  # noqa: E402
from repro_torch.models.moe_ep import moe_apply_ep  # noqa: E402
from repro_torch.train import trainstep as TS  # noqa: E402
from repro_torch.train.checkpoint import (CheckpointManager, load_train_state,  # noqa: E402
                                          state_to_jax)
from repro_torch.train.optimizer import OptConfig  # noqa: E402

from helpers import LOCAL_RULES  # noqa: E402

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b", "zamba2-7b", "xlstm-1.3b",
         "whisper-medium", "internvl2-2b")
MOE_ARCHS = ARCHS[:2]
GRAD_RTOL = 1e-5
MOE_ATOL = 1e-5
# the overflow case: (arch, the parameter raised, its value or factor).
# zamba2: dt_bias 3 makes each step's log decay ~ -3.05 (A_log 0), so a
# 64-token chunk sums to ~ -195, past float32 exp's 88.7 above the diagonal;
# xLSTM: the forget half of ``wif`` x 5 drives log sigmoid(f) to ~ -2 a
# step.  Both stay finite in JAX's order at chunk 8 (and 16) and overflow at
# 64.  Against JAX at chunk 8: exp of summed log decays up to ~200 carries
# ~200 x 2^-24 ~ 1.2e-5 of relative error, and the two chunk sizes split
# the sums differently (measured: 6.3e-5 zamba2, 1.1e-5 xLSTM)
OVERFLOW = (("zamba2-7b", "mamba.dt_bias", 3.0), ("xlstm-1.3b", "mlstm.wif", 5.0))
OVERFLOW_CHUNK, SMALL_CHUNK = 64, 8
OVERFLOW_RTOL = 1e-4
# AdamW denominators sqrt(v) + eps below this belong to gradients near 0
NOISE_DENOM = 1e-6
# torch's default of one thread a core, beside the suite's other workers,
# made tests/test_torch_train.py's steps 30 x slower
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **overrides):
    cfg_j = jreduced(jget_config(arch)).with_overrides(**overrides)
    cfg = reduced_config(get_config(arch)).with_overrides(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg_j, cfg


@pytest.fixture(scope="module")
def jax_params():
    """Each arch's (and zamba2's at 15 layers) JAX parameters, numpy."""
    cache = {}

    def get(arch, layers=None):
        key = (arch, layers)
        if key not in cache:
            over = {} if layers is None else {"num_layers": layers}
            cfg_j, _ = _cfgs(arch, **over)
            cache[key] = jax.tree.map(np.asarray, JMdl.init_params(
                cfg_j, JInitializer(jax.random.PRNGKey(0), cfg_j.param_dtype)))
        return cache[key]
    return get


@pytest.fixture(scope="module")
def jax_grads(jax_params):
    """``jax.value_and_grad`` of the JAX package's ``loss_fn`` on ``_batch``,
    once per arch (its ``remat_policy`` "full": in JAX the policy chooses
    what is kept, not the values)."""
    cache = {}

    def get(arch, layers=None):
        key = (arch, layers)
        if key not in cache:
            over = {} if layers is None else {"num_layers": layers}
            cfg_j, _ = _cfgs(arch, **over)
            bj, _ = _batch(cfg_j)
            cache[key] = jax.value_and_grad(
                lambda p: JTS.loss_fn(cfg_j, p, bj, LOCAL_RULES))(jax_params(arch, layers))
        return cache[key]
    return get


def _port(cfg, params_j):
    model = Mdl.init_params(cfg, Empty(cfg.param_dtype, "cpu"))
    with torch.no_grad():
        model.load_state_dict(params_from_jax(params_j))
    return model


def _batch(cfg, b=4, s=16, seed=0):
    """(JAX batch, port batch): tokens / targets / loss_mask, and the stub
    frontend ((B, enc_seq | num_patches, d_model) normals x 0.1) where the
    family takes one."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.9).astype(np.float32)
    host = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "loss_mask": mask}
    n = {"audio": cfg.enc_seq, "vlm": cfg.num_patches}.get(cfg.family)
    if n is not None:
        host["frontend"] = (rng.standard_normal((b, n, cfg.d_model)) * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()})


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _assert_tree_close(got, want, rel=None, atol=0.0):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for path, w in flat:
        w = np.asarray(w)
        g = np.asarray(_leaf(got, path), np.float64)
        tol = atol if rel is None else rel * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def _grads(model):
    return params_to_jax({k: p.grad for k, p in model.named_parameters()})


# ------------------------------------------------------- loss, gradients
@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("arch,layers", [(a, None) for a in ARCHS] + [("zamba2-7b", 15)],
                         ids=lambda v: str(v))
def test_loss_and_gradients_match_jax(jax_params, jax_grads, arch, layers, remat):
    over = {"remat_policy": remat}
    if layers is not None:
        over["num_layers"] = layers
    _, cfg = _cfgs(arch, **over)
    model = _port(cfg, jax_params(arch, layers))
    _, bt = _batch(cfg)
    want_loss, want = jax_grads(arch, layers)
    loss = TS.loss_fn(cfg, model, bt)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    got = _grads(model)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    _assert_tree_close(got, want, rel=GRAD_RTOL)
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def test_vlm_loss_drops_the_patch_prefix(jax_params):
    """internvl2's loss covers the token positions only: the logits of its
    patch positions take no gradient."""
    _, cfg = _cfgs("internvl2-2b")
    model = _port(cfg, jax_params("internvl2-2b"))
    _, bt = _batch(cfg)
    seen = []
    real = Mdl.forward

    def forward(*a, **k):
        out = real(*a, **k)
        out.register_hook(seen.append)
        return out

    Mdl.forward = forward
    try:
        TS.loss_fn(cfg, model, bt).backward()
    finally:
        Mdl.forward = real
    (g,) = seen
    assert g.shape[1] == cfg.num_patches + bt["tokens"].shape[1]
    assert not g[:, :cfg.num_patches].any() and g[:, cfg.num_patches:].any()


# ------------------------------------------------------------ train steps
def _assert_params_close(got, sj, oc):
    """The port's parameters after a step against JAX's state ``sj`` after
    it: 2e-5, or ``lr`` where AdamW's denominator is below
    ``NOISE_DENOM`` (see ``_run_steps``)."""
    step = int(sj["opt"]["step"])
    bc2 = 1 - JOptConfig().beta2 ** step
    flat, _ = jax.tree_util.tree_flatten_with_path(sj["params"])
    for path, w in flat:
        denom = np.sqrt(np.asarray(_leaf(sj["opt"]["v"], path)) / bc2) + JOptConfig().eps
        tol = np.where(denom > NOISE_DENOM, 2e-5, oc["lr"])
        err = np.abs(np.asarray(_leaf(got, path), np.float64) - np.asarray(w))
        assert (err <= tol).all(), (jax.tree_util.keystr(path), float(err.max()),
                                    float(denom[err > tol].max()))


def _run_steps(arch, params_j, steps, micro=1, **overrides):
    """``steps`` of JAX's jitted train step, each also taken by the port
    from a copy of JAX's state before it (parameters and AdamW moments
    through ``load_train_state``), and the port's state after it held
    against JAX's.  Started from one shared state, a step's difference is
    its gradient's rounding δ, which AdamW's update ``lr m / (√v + ε)``
    turns into ``lr δ / (√v + ε)``: parameters within 2e-5 where the
    denominator exceeds ``NOISE_DENOM``, and within ``lr`` (one update's
    size) where it does not: a gradient near 0, whose last bits move its
    update by up to a fraction of ``lr``; ``m`` / ``v`` within 1e-7.  Run on from its own
    state, the port's losses track JAX's (1e-4) while those near-zero
    gradients move parameters apart, so the free-running parameters are
    compared only through the losses."""
    cfg_j, cfg = _cfgs(arch, **overrides)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    sj = JTS.init_state(cfg_j, jax.tree.map(jnp.asarray, params_j))
    step_j = jax.jit(JTS.make_train_step(cfg_j, LOCAL_RULES, JOptConfig(**oc), micro))
    step_t = TS.make_train_step(cfg, OptConfig(**oc), micro)
    free = TS.init_state(cfg, _port(cfg, params_j))
    for i in range(steps):
        bj, bt = _batch(cfg, seed=20 + i)
        st = load_train_state(cfg, jax.tree.map(np.asarray, sj), "cpu")
        sj, mj = step_j(sj, bj)
        st, mt = step_t(st, bt)
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= 1e-5
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
        _assert_params_close(params_to_jax(st["params"]), sj, oc)
        opt = opt_to_jax(st["opt"])
        _assert_tree_close({"m": opt["m"], "v": opt["v"]},
                           {"m": sj["opt"]["m"], "v": sj["opt"]["v"]}, atol=1e-7)
        assert int(opt["step"]) == int(sj["opt"]["step"]) == i + 1
        free, mf = step_t(free, bt)
        assert abs(float(mf["loss"]) - float(mj["loss"])) <= 1e-4
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax_jit(jax_params, arch):
    _run_steps(arch, jax_params(arch), 3)


@pytest.mark.parametrize("arch", MOE_ARCHS + ("whisper-medium", "internvl2-2b"))
def test_two_microbatches_match_jax_jit(jax_params, arch):
    """Two microbatches split every batch entry, the frontend included;
    the MoE configs at ``capacity_factor`` 0.5, where each microbatch's 32
    tokens x 2 routes overfill the 4 experts' 8 slots, so routes drop."""
    over = {"capacity_factor": 0.5} if arch in MOE_ARCHS else {}
    cfg = _run_steps(arch, jax_params(arch), 2, micro=2, **over)
    if arch in MOE_ARCHS:
        tokens = 4 * 16 // 2
        assert L.capacity(cfg, tokens) * cfg.num_experts < tokens * cfg.num_experts_per_tok


# ------------------------------------------------------ the MoE layer
def _moe_inputs(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": rng.standard_normal((D, E)) * D ** -0.5,
         "gate": rng.standard_normal((E, D, F)) * D ** -0.5,
         "up": rng.standard_normal((E, D, F)) * D ** -0.5,
         "down": rng.standard_normal((E, F, D)) * F ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    w = rng.standard_normal((b, s, D)).astype(np.float32)     # the output's cotangent
    return p, x, w


def _moe_grads(fn, p, x, w):
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(leaves, xt)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), xt.grad, {k: t.grad for k, t in leaves.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_dense_gradients_match_jax(arch, capacity_factor):
    cfg_j, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    p, x, w = _moe_inputs(cfg, seed=int(capacity_factor * 10) + 1)

    def jloss(pj, xj):
        return (JL.moe_apply_dense(pj, xj, cfg_j, LOCAL_RULES) * jnp.asarray(w)).sum()

    gp_want, gx_want = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _, gx, gp = _moe_grads(lambda pp, xx: L.moe_apply_dense(pp, xx, cfg), p, x, w)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_want), atol=MOE_ATOL)
    for k in p:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(gp_want[k]), atol=MOE_ATOL,
                                   err_msg=k)
    # a token whose every route was dropped takes exactly no gradient
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx = L.route(xt, torch.from_numpy(p["router"]), cfg)
    _, keep = L.dispatch_slots(idx.reshape(-1), cfg.num_experts, L.capacity(cfg, xt.shape[0]))
    dropped = ~keep.reshape(-1, cfg.num_experts_per_tok).any(1)
    if capacity_factor < 1:
        assert dropped.any()
    else:
        assert keep.all()
    assert not gx.reshape(-1, cfg.d_model)[dropped].any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_moe_apply_ep_gradients_match_the_dense_path(arch, shards):
    """Expert parallelism under autograd on CPU meshes (8 experts, so that
    8 shards divide them), against the dense dispatch's gradients, with
    routes dropped (capacity 0.5)."""
    _, cfg = _cfgs(arch, num_experts=8, capacity_factor=0.5)
    cfg_ep = cfg.with_overrides(moe_impl="shard_map")
    p, x, w = _moe_inputs(cfg, seed=shards)
    mesh = mesh_for(shards, "cpu")
    out, gx, gp = _moe_grads(lambda pp, xx: moe_apply_ep(pp, xx, cfg_ep, mesh), p, x, w)
    want, gx_want, gp_want = _moe_grads(lambda pp, xx: L.moe_apply_dense(pp, xx, cfg), p, x, w)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=MOE_ATOL)
    np.testing.assert_allclose(gx.numpy(), gx_want.numpy(), atol=MOE_ATOL)
    for k in p:
        np.testing.assert_allclose(gp[k].numpy(), gp_want[k].numpy(), atol=MOE_ATOL,
                                   err_msg=k)


def test_moe_second_backward_is_bitwise():
    _, cfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=0.5)
    p, x, w = _moe_inputs(cfg, seed=3)
    a = _moe_grads(lambda pp, xx: L.moe_apply_dense(pp, xx, cfg), p, x, w)
    b = _moe_grads(lambda pp, xx: L.moe_apply_dense(pp, xx, cfg), p, x, w)
    assert torch.equal(a[1], b[1]) and all(torch.equal(a[2][k], b[2][k]) for k in p)


# ----------------------------------------- SSM chunks: mask before exp
def _chunk_exp_first(h, xq, bq, cq, adq, dtq, causal):
    """``mamba2._chunk`` in the JAX package's order: exp, then the mask."""
    cum = torch.cumsum(adq, dim=1)
    diff = cum[:, :, None] - cum[:, None, :]
    Lm = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bin,bjn->bij", cq, bq)
    w = cb[..., None] * Lm * dtq[:, None]
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
    y_inter = torch.einsum("bin,bhnp->bihp", cq, h) * torch.exp(cum)[..., None]
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)
    sb = torch.einsum("bjn,bjh,bjhp->bhnp", bq, dtq * decay_to_end, xq)
    h = h * torch.exp(cum[:, -1])[:, :, None, None] + sb
    return h, y_intra + y_inter


def _mlstm_chunk_exp_first(h, m, qq, kk, vv, lf, li, causal):
    """``xlstm._mlstm_chunk`` in the JAX package's order: exp, then the mask."""
    cum = torch.cumsum(lf, dim=1)
    Mi = torch.cummax(li - cum, dim=1).values
    m_row = cum + torch.maximum(Mi, m[:, None])
    diff = cum[:, :, None] - cum[:, None, :] + li[:, None] - m_row[:, :, None]
    w = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
    qk = torch.einsum("bihp,bjhp->bijh", qq, kk)
    y_intra = torch.einsum("bijh,bjhp->bihp", qk * w, vv)
    dec_in = torch.exp(cum + m[:, None] - m_row)
    y_inter = torch.einsum("bihp,bhpr->bihr", qq, h) * dec_in[..., None]
    m_new = cum[:, -1] + torch.maximum(Mi[:, -1], m)
    dec_end = torch.exp(cum[:, -1:] - cum + li - m_new[:, None])
    hb = torch.einsum("bjhp,bjhr->bhpr", kk * dec_end[..., None], vv)
    h = h * torch.exp(cum[:, -1] + m - m_new)[..., None, None] + hb
    return h, m_new, y_intra + y_inter, m_row


def _overflowing(arch, what, value, params_j):
    """``params_j`` with the decay raised in every layer (numpy, a copy)."""
    params_j = jax.tree.map(np.array, params_j)
    if what == "mamba.dt_bias":
        params_j["layers"]["mamba"]["dt_bias"][...] = value
    else:
        wif = params_j["groups"]["mlstm"]["wif"]              # (G, n_m, di, 2H)
        wif[..., wif.shape[-1] // 2:] *= value
    return params_j


@pytest.mark.parametrize("arch,what,value", OVERFLOW, ids=[a for a, *_ in OVERFLOW])
def test_overflowing_chunks_give_finite_gradients(jax_params, monkeypatch, arch, what, value):
    params_j = _overflowing(arch, what, value, jax_params(arch))
    cfg_j, cfg = _cfgs(arch, ssm_chunk=OVERFLOW_CHUNK)
    model = _port(cfg, params_j)
    bj, bt = _batch(cfg, b=2, s=2 * OVERFLOW_CHUNK, seed=4)
    loss = TS.loss_fn(cfg, model, bt)
    loss.backward()
    got = _grads(model)
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())

    # JAX at a chunk small enough that its exp stays finite
    cfg_small = cfg_j.with_overrides(ssm_chunk=SMALL_CHUNK)
    want_loss, want = jax.value_and_grad(
        lambda p: JTS.loss_fn(cfg_small, p, bj, LOCAL_RULES))(params_j)
    assert all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(want))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    _assert_tree_close(got, want, rel=OVERFLOW_RTOL)

    # the forward keeps its bits; exp before the mask overflows and its
    # gradients are not finite (the reference's order)
    with torch.no_grad():
        logits = Mdl.forward(cfg, model, bt["tokens"])
    monkeypatch.setattr(M, "_chunk", _chunk_exp_first)
    monkeypatch.setattr(X, "_mlstm_chunk", _mlstm_chunk_exp_first)
    old = _port(cfg, params_j)
    with torch.no_grad():
        assert torch.equal(Mdl.forward(cfg, old, bt["tokens"]), logits)
    TS.loss_fn(cfg, old, bt).backward()
    assert not all(bool(torch.isfinite(p.grad).all()) for p in old.parameters())


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("arch", ("zamba2-7b", "xlstm-1.3b", "whisper-medium",
                                  "qwen3-moe-30b-a3b"))
def test_checkpoints_round_trip_with_jax_bitwise(jax_params, tmp_path, arch):
    """A JAX train state (its parameters, random moments, step 7) saved by
    the JAX package restores in the port bitwise; the port saves it again
    and the JAX package restores that bitwise."""
    cfg_j, cfg = _cfgs(arch)
    params_j = jax_params(arch)
    rng = np.random.default_rng(11)
    like = JTS.init_state(cfg_j, jax.tree.map(jnp.asarray, params_j))
    sj = {"params": params_j,
          "opt": {"m": jax.tree.map(lambda t: rng.standard_normal(t.shape).astype(np.float32),
                                    params_j),
                  "v": jax.tree.map(lambda t: rng.random(t.shape).astype(np.float32),
                                    params_j),
                  "step": np.int32(7)}}
    JCheckpointManager(str(tmp_path / "jax")).save(7, sj)
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore_latest()
    st = load_train_state(cfg, tree, "cpu")
    assert step == 7 and int(st["opt"]["step"]) == 7
    names = dict(st["params"].named_parameters())
    held = {"zamba2-7b": "shared.attn.wq", "xlstm-1.3b": "groups.1.mlstm.3.wif",
            "whisper-medium": "enc_layers.1.attn.wk", "qwen3-moe-30b-a3b": "layers.2.moe.gate"}
    assert held[arch] in names and held[arch] in st["opt"]["m"]
    if arch == "whisper-medium":
        assert "enc_norm" in names

    def same(got, want):
        flat_g, tree_g = jax.tree_util.tree_flatten(got)
        flat_w, tree_w = jax.tree_util.tree_flatten(want)
        assert tree_g == tree_w
        for a, b in zip(flat_g, flat_w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    same(state_to_jax(st), sj)
    CheckpointManager(str(tmp_path / "port")).save(7, st)
    step, back = JCheckpointManager(str(tmp_path / "port")).restore_latest(like)
    assert step == 7
    same(back, sj)


# ----------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", ("qwen3-moe-30b-a3b", "zamba2-7b", "xlstm-1.3b"))
def test_launch_train_runs_the_family_on_cpu(capsys, arch):
    losses = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                          "--batch", "2", "--seq", "32", "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("[train] step ") for ln in lines) == 3
    assert lines[-1].startswith("[train] done: first loss")
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch,what", [("whisper-medium", "encoder frame embeddings"),
                                       ("internvl2-2b", "patch embeddings")])
def test_launch_train_names_the_missing_frontend(arch, what):
    with pytest.raises(ValueError, match=f"needs a frontend \\({what}\\)"):
        ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1"])


# --------------------------------------- the backward's float32 bound
@pytest.mark.parametrize("h,kvh,d", [(8, 1, 128), (4, 4, 64)])
def test_bwd_magnitudes_carry_dp_error_into_ds(h, kvh, d):
    """``flash_attention_bwd_magnitudes(..., dp_error=True)``: the float32
    plain backward's own error against float64 (causal, GQA at the family
    shapes' group sizes) within 2^-19 A with no relative term, where
    without ``dp_error`` a causal row's first key has dS = 0 in exact
    arithmetic (o = v_0 there), so A_dq is a rounding residue on row 0
    though its gradient carries dP's rounding."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_magnitudes,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_lse_ref)

    gen = torch.Generator().manual_seed(h + d)
    q, do = (torch.randn((2, h, 64, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((2, kvh, 64, d), generator=gen) for _ in range(2))
    o, lse = flash_attention_lse_ref(q, k, v, causal=True)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    exact = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, lse, do)), causal=True)
    old = flash_attention_bwd_magnitudes(q, k, v, o, lse, do, causal=True)
    new = flash_attention_bwd_magnitudes(q, k, v, o, lse, do, causal=True, dp_error=True)
    for x, want, a_old, a_new in zip(got, exact, old, new):
        assert (a_new >= a_old).all()
        assert bool(((x.double() - want).abs() <= 2.0 ** -19 * a_new.double()).all())
    assert bool((old[0][:, :, 0] < 1e-3 * new[0][:, :, 0]).all())
    assert torch.equal(old[2], new[2])


def _tf32(x):
    """``x`` rounded to TF32's 10 fraction bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _planted_bwd(q, k, v, o, lse, do, fault):
    """``flash_attention_bwd_ref``'s causal (dq, dk) with ``fault`` planted
    where the float32 route forms dP and dS: dP or dS off by 2^-11 of
    itself (``dp``, ``ds``), or dP one TF32 product in place of three
    (``dp_one_tf32``); None plants nothing."""
    from repro_torch.kernels.flash_attention import ref as R

    p, kf, vf = R._probs(q, k, v, lse, None, True, None)
    delta = (do * o).sum(-1)
    if fault == "dp_one_tf32":
        dp = torch.einsum("bhqd,bhkd->bhqk", _tf32(do), _tf32(vf))
    else:
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    if fault == "dp":
        dp = dp * (1 + 2.0 ** -11)
    ds = p * (dp - delta[..., None])
    if fault == "ds":
        ds = ds * (1 + 2.0 ** -11)
    scale = q.shape[-1] ** -0.5
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = R._group_sum(torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale, k.shape[1])
    return dq, dk


@pytest.mark.parametrize("fault", [None, "dp", "ds", "dp_one_tf32"])
@pytest.mark.parametrize("h,kvh,d", [(8, 1, 128), (4, 4, 64)])
def test_bwd_float32_bound_rejects_coarser_dp_and_ds(h, kvh, d, fault):
    """The float32 route's bound with ``dp_error``, 1e-5 (1 + |want|) +
    2^-19 A as ``chip_smoke.py`` and ``test_torch_gpu.py`` hold the kernel,
    against the plain float32 backward: a backward whose dP or dS is off by
    2^-11 of itself, or whose dP is one TF32 product, fails it on dQ and
    dK, though A carries dP's and Delta's error into dS; the same code with
    nothing planted passes."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_magnitudes,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_lse_ref)

    gen = torch.Generator().manual_seed(h + d)
    q, do = (torch.randn((2, h, 64, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((2, kvh, 64, d), generator=gen) for _ in range(2))
    o, lse = flash_attention_lse_ref(q, k, v, causal=True)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    mag = flash_attention_bwd_magnitudes(q, k, v, o, lse, do, causal=True, dp_error=True)
    got = _planted_bwd(q, k, v, o, lse, do, fault)
    ratio = max(float(((x - y).abs() / (1e-5 * (1 + y.abs()) + 2.0 ** -19 * a)).max())
                for x, y, a in zip(got, want, mag))
    assert ratio <= 1.0 if fault is None else ratio > 1.0
