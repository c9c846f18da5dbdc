"""PyTorch port: the hybrid, ssm, audio and vlm families against the JAX
package, on the CPU.

The reduced ``zamba2-7b`` (Mamba2 + shared attention), ``xlstm-1.3b``
(mLSTM + sLSTM), ``whisper-medium`` (encoder-decoder, cross attention) and
``internvl2-2b`` (patch prefix) (``reduced_config``: d_model 64, float32
compute), with the JAX package's parameters carried over by
``models.convert.params_from_jax`` and inputs and frontends from numpy
seeds:

* ``params_from_jax`` bitwise, and ``params_to_jax`` back to the JAX tree
  bitwise;
* ``forward`` (both ``attn_impl``), ``prefill`` (logits, and every cache
  entry: bf16 K / V within one bf16 ulp plus 1e-5, float32 states within 1e-4) and 4
  ``decode_step``s within 1e-4 (``MODEL_ATOL``); ``Engine.generate``'s
  greedy tokens identical; zamba2 again with 15 layers, so that layers past
  the last whole group (the published depth of 81 = 13 x 6 + 3 has three)
  run in every entry point;
* each mixer (``mamba2_apply`` / ``mlstm_apply`` / ``slstm_apply`` with
  their states, and one ``*_step`` from them) against its JAX twin within
  1e-5, and the port's chunked forms against its own recurrences at
  ``tests/test_ssm_recurrence.py``'s ``(S, chunk)`` cases and tolerances;
* ``launch.serve`` for zamba2 and xLSTM on the CPU, and its ``ValueError``
  naming the missing frontend for Whisper and InternVL2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import model as JMdl  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.module import Initializer as JInitializer  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models import model as Mdl  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models.module import Empty, Initializer  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

from helpers import LOCAL_RULES  # noqa: E402

ARCHS = ("zamba2-7b", "xlstm-1.3b", "whisper-medium", "internvl2-2b")
MODEL_ATOL = 1e-4
MIXER_ATOL = 1e-5


def _cfgs(arch, **overrides):
    cfg_j = jreduced(jget_config(arch)).with_overrides(**overrides)
    cfg = reduced_config(get_config(arch)).with_overrides(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    return cfg_j, cfg


def _build(arch, **overrides):
    cfg_j, cfg = _cfgs(arch, **overrides)
    params_j = JMdl.init_params(cfg_j, JInitializer(jax.random.PRNGKey(0), cfg_j.param_dtype))
    params_j = jax.tree.map(np.asarray, params_j)
    model = Mdl.init_params(cfg, Empty(cfg.param_dtype, "cpu"))
    model.load_state_dict(params_from_jax(params_j))
    return cfg_j, params_j, cfg, model


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return (request.param, *_build(request.param))


@pytest.fixture(scope="module")
def zamba_tail():
    """zamba2 at 15 layers: two groups of 6 and three tail layers."""
    return ("zamba2-7b", *_build("zamba2-7b", num_layers=15))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (b, s)).astype(np.int32)


def _frontend(cfg, b, seed=9):
    """The stub frontend: (B, enc_seq | num_patches, d_model) normals x 0.1."""
    n = {"audio": cfg.enc_seq, "vlm": cfg.num_patches}.get(cfg.family)
    if n is None:
        return None, None
    fe = (np.random.default_rng(seed).standard_normal((b, n, cfg.d_model)) * 0.1).astype(
        np.float32)
    return jnp.asarray(fe), torch.from_numpy(fe)


def _bf16_rounded_alike(a, b):
    """Two bf16 roundings of float32 values within ``MIXER_ATOL`` of each
    other: at most one bf16 ulp plus that apart."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))) * 2.0 ** 16
    return np.abs(a - b) <= ulp + MIXER_ATOL


def _same_cache(got, want):
    assert set(got) == set(want)
    assert got["pos"] == int(want["pos"])
    for name, t in got.items():
        if name == "pos":
            continue
        w = np.asarray(want[name])
        assert tuple(t.shape) == w.shape, name
        if t.dtype == torch.bfloat16:
            assert _bf16_rounded_alike(t.float().numpy(), w.astype(np.float32)).all(), name
        else:
            assert t.dtype == torch.float32, name
            np.testing.assert_allclose(t.numpy(), w, atol=MODEL_ATOL, rtol=MODEL_ATOL,
                                       err_msg=name)


def _grow(cache, extra, torch_side):
    out = dict(cache)
    for name in ("k", "v"):
        if name in out:
            t = out[name]
            if torch_side:
                g = t.new_zeros((*t.shape[:2], t.shape[2] + extra, *t.shape[3:]))
                g[:, :, :t.shape[2]] = t
                out[name] = g
            else:
                pad = [(0, 0)] * t.ndim
                pad[2] = (0, extra)
                out[name] = jnp.pad(t, pad)
    return out


# ------------------------------------------------------------- parameters
def test_params_from_jax_and_back_are_bitwise(fam):
    arch, cfg_j, params_j, cfg, model = fam
    state = model.state_dict()
    assert len(state) == len(params_from_jax(params_j))
    flat, _ = jax.tree_util.tree_flatten_with_path(params_j)
    back = params_to_jax(model)
    back_flat, _ = jax.tree_util.tree_flatten_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in back_flat] == \
        [jax.tree_util.keystr(k) for k, _ in flat]
    for (path, want), (_, got) in zip(flat, back_flat):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    held = sum(int(np.prod(np.asarray(v).shape)) for _, v in flat)
    assert sum(p.numel() for p in model.parameters()) == held
    if cfg.family == "ssm":
        g = params_j["groups"]
        np.testing.assert_array_equal(state["groups.1.mlstm.4.wq"].numpy(),
                                      g["mlstm"]["wq"][1, 4])
        np.testing.assert_array_equal(state["groups.1.mlstm_ln"].numpy(), g["mlstm_ln"][1])
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(state["shared.attn.wq"].numpy(),
                                      params_j["shared"]["attn"]["wq"])
    if cfg.family == "audio":
        np.testing.assert_array_equal(state["enc_layers.1.attn.wk"].numpy(),
                                      params_j["enc_layers"]["attn"]["wk"][1])


def test_init_cache_layout_matches_jax(fam):
    arch, cfg_j, params_j, cfg, model = fam
    want = JMdl.init_cache(cfg_j, 3, 20, abstract=True)
    got = Mdl.init_cache(cfg, 3, 20, "cpu")
    assert set(got) == set(want) and got["pos"] == 0
    for name, t in got.items():
        if name != "pos":
            assert tuple(t.shape) == want[name].shape, name
            assert str(t.dtype).split(".")[1] == str(want[name].dtype), name
            assert not bool(t.any())


# ------------------------------------------------------------- the models
@pytest.mark.parametrize("attn_impl", ["chunked", "ref"])
def test_forward_matches_jax(fam, attn_impl):
    arch, cfg_j, params_j, cfg, model = fam
    toks = _tokens(cfg, 2, 21)
    jfe, tfe = _frontend(cfg, 2)
    want = JMdl.forward(cfg_j.with_overrides(attn_impl=attn_impl), params_j,
                        jnp.asarray(toks), rules=LOCAL_RULES, frontend=jfe)
    with torch.no_grad():
        got = Mdl.forward(cfg.with_overrides(attn_impl=attn_impl), model,
                          torch.from_numpy(toks), frontend=tfe)
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 21 + extra, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_ATOL)


def _prefill_and_decode(cfg_j, params_j, cfg, model, b=3, s=20, steps=4):
    toks = _tokens(cfg, b, s + steps, seed=2)
    jfe, tfe = _frontend(cfg, b)
    want_logits, want_cache = JMdl.prefill(cfg_j, params_j, jnp.asarray(toks[:, :s]),
                                           rules=LOCAL_RULES, frontend=jfe)
    got_logits, got_cache = Mdl.prefill(cfg, model, torch.from_numpy(toks[:, :s]),
                                        frontend=tfe)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=MODEL_ATOL)
    _same_cache(got_cache, want_cache)
    jc, tc = _grow(want_cache, steps, False), _grow(got_cache, steps, True)
    for t in range(s, s + steps):
        want_step, jc = JMdl.decode_step(cfg_j, params_j, jc, jnp.asarray(toks[:, t:t + 1]),
                                         rules=LOCAL_RULES)
        got_step, tc = Mdl.decode_step(cfg, model, tc, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), atol=MODEL_ATOL)
    _same_cache(tc, jc)


def test_prefill_and_decode_match_jax(fam):
    arch, cfg_j, params_j, cfg, model = fam
    _prefill_and_decode(cfg_j, params_j, cfg, model)


def test_decode_step_leaves_recurrent_states_unwritten(fam):
    """A step from the same cache twice gives the same logits: the states
    come back as new tensors (K / V are written in place, at ``pos``)."""
    arch, cfg_j, params_j, cfg, model = fam
    _, tfe = _frontend(cfg, 2)
    engine = Engine(cfg, model, max_len=16, device="cpu")
    _, cache = engine.prefill(_tokens(cfg, 2, 9), tfe)
    before = {k: t.clone() for k, t in cache.items() if k not in ("pos", "k", "v")}
    tok = torch.from_numpy(_tokens(cfg, 2, 1, seed=3))
    first, _ = engine.decode(cache, tok)
    again, _ = engine.decode(cache, tok)
    assert torch.equal(first, again)
    for k, t in before.items():
        assert torch.equal(cache[k], t), k


def test_engine_generate_greedy_matches_jax(fam):
    arch, cfg_j, params_j, cfg, model = fam
    prompts = _tokens(cfg, 4, 12, seed=6)
    jfe, tfe = _frontend(cfg, 4)
    want = JEngine(cfg_j, params_j, max_len=64).generate(prompts, steps=8, frontend=jfe)
    got = Engine(cfg, model, max_len=64, device="cpu").generate(prompts, steps=8,
                                                               frontend=tfe)
    assert got.tokens.shape == (4, 8)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits),
                               atol=MODEL_ATOL)


def test_hybrid_tail_layers_match_jax(zamba_tail):
    arch, cfg_j, params_j, cfg, model = zamba_tail
    assert cfg.num_layers % cfg.shared_attn_every == 3
    toks = _tokens(cfg, 2, 19, seed=4)
    want = JMdl.forward(cfg_j, params_j, jnp.asarray(toks), rules=LOCAL_RULES)
    with torch.no_grad():
        got = Mdl.forward(cfg, model, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_ATOL)
    _prefill_and_decode(cfg_j, params_j, cfg, model, b=2, s=17)


def test_missing_frontend_and_unknown_family_raise():
    for arch in ("whisper-medium", "internvl2-2b"):
        cfg = reduced_config(get_config(arch))
        model = Mdl.init_params(cfg, Initializer(torch.Generator().manual_seed(0)))
        with pytest.raises(ValueError, match="frontend"):
            Mdl.prefill(cfg, model, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError):
        Mdl.init_params(reduced_config(get_config("zamba2-7b")).with_overrides(
            family="retnet"), Empty(device="cpu"))


# ------------------------------------------------------------- the mixers
def _mixer_cfgs(**kw):
    base = dict(name="t", family="hybrid", num_layers=1, d_model=64, num_heads=4,
                num_kv_heads=4, d_ff=128, vocab_size=100, ssm_state=16, ssm_chunk=8,
                compute_dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _mixer_params(init, cfg_j, seed):
    pj = jax.tree.map(np.asarray, init(JInitializer(jax.random.PRNGKey(seed)), cfg_j))
    return pj, {k: torch.from_numpy(v.copy()) for k, v in pj.items()}


def _u(seed, b, s):
    u = (np.random.default_rng(seed).standard_normal((b, s, 64)) * 0.5).astype(np.float32)
    return jnp.asarray(u), torch.from_numpy(u)


def _close(got, want, atol=MIXER_ATOL):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], atol)
        return
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=atol)


@pytest.mark.parametrize("S", [37, 16])
def test_mamba2_matches_jax(S):
    cfg_j, cfg = _mixer_cfgs()
    pj, pt = _mixer_params(JM.mamba2_init, cfg_j, 0)
    uj, ut = _u(1, 2, S)
    want, wst = JM.mamba2_apply(pj, uj, cfg_j, return_state=True)
    got, gst = M.mamba2_apply(pt, ut, cfg, return_state=True)
    _close(got, want)
    _close(gst, wst)
    vj, vt = _u(2, 2, 1)
    _close(M.mamba2_step(pt, vt, gst, cfg), JM.mamba2_step(pj, vj, wst, cfg_j))


@pytest.mark.parametrize("S", [37, 8])
def test_mlstm_matches_jax(S):
    cfg_j, cfg = _mixer_cfgs(family="ssm", d_ff=0)
    pj, pt = _mixer_params(JX.mlstm_init, cfg_j, 2)
    uj, ut = _u(3, 2, S)
    want, wst = JX.mlstm_apply(pj, uj, cfg_j, return_state=True)
    got, gst = X.mlstm_apply(pt, ut, cfg, return_state=True)
    _close(got, want)
    _close(gst, wst)
    # a second prompt continued from the returned state, then one step
    uj2, ut2 = _u(4, 2, 13)
    want2, wst2 = JX.mlstm_apply(pj, uj2, cfg_j, state=wst, return_state=True)
    got2, gst2 = X.mlstm_apply(pt, ut2, cfg, state=gst, return_state=True)
    _close(got2, want2)
    _close(gst2, wst2)
    vj, vt = _u(5, 2, 1)
    _close(X.mlstm_step(pt, vt, gst2, cfg), JX.mlstm_step(pj, vj, wst2, cfg_j))


@pytest.mark.parametrize("S", [30, 7])
def test_slstm_matches_jax(S):
    cfg_j, cfg = _mixer_cfgs(family="ssm", d_ff=0)
    pj, pt = _mixer_params(JX.slstm_init, cfg_j, 4)
    uj, ut = _u(5, 2, S)
    want, wst = JX.slstm_apply(pj, uj, cfg_j)
    got, gst = X.slstm_apply(pt, ut, cfg)
    _close(got, want)
    _close(gst, wst)
    vj, vt = _u(6, 2, 1)
    _close(X.slstm_step(pt, vt, gst, cfg), JX.slstm_step(pj, vj, wst, cfg_j))


def _port_params(init, cfg, seed):
    return init(Initializer(torch.Generator().manual_seed(seed)), cfg)


@pytest.mark.parametrize("S,chunk", [(37, 8), (16, 16), (65, 16), (5, 8)])
def test_mamba2_chunked_equals_recurrent(S, chunk):
    _, cfg = _mixer_cfgs(ssm_chunk=chunk)
    p = _port_params(M.mamba2_init, cfg, 0)
    u = torch.randn((2, S, 64), generator=torch.Generator().manual_seed(1)) * 0.5
    y_chunk, st_chunk = M.mamba2_apply(p, u, cfg, return_state=True)
    st = M.mamba2_init_state(cfg, 2, "cpu")
    ys = []
    for t in range(S):
        yt, st = M.mamba2_step(p, u[:, t:t + 1], st, cfg)
        ys.append(yt)
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, 1).numpy(), atol=2e-3)
    np.testing.assert_allclose(st_chunk["h"].numpy(), st["h"].numpy(), atol=2e-3)
    np.testing.assert_allclose(st_chunk["conv"].numpy(), st["conv"].numpy(), atol=2e-3)


@pytest.mark.parametrize("S,chunk", [(37, 8), (24, 8), (8, 8)])
def test_mlstm_chunked_equals_recurrent(S, chunk):
    _, cfg = _mixer_cfgs(family="ssm", d_ff=0, ssm_chunk=chunk)
    p = _port_params(X.mlstm_init, cfg, 2)
    u = torch.randn((2, S, 64), generator=torch.Generator().manual_seed(3)) * 0.5
    y_chunk, st_c = X.mlstm_apply(p, u, cfg, return_state=True)
    st = X.mlstm_init_state(cfg, 2, "cpu")
    ys = []
    for t in range(S):
        yt, st = X.mlstm_step(p, u[:, t:t + 1], st, cfg)
        ys.append(yt)
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, 1).numpy(), atol=2e-3)
    np.testing.assert_allclose(st_c["h"].numpy(), st["h"].numpy(), rtol=2e-3, atol=2e-3)


def test_slstm_state_carry():
    _, cfg = _mixer_cfgs(family="ssm", d_ff=0)
    p = _port_params(X.slstm_init, cfg, 4)
    u = torch.randn((2, 30, 64), generator=torch.Generator().manual_seed(5)) * 0.5
    full, _ = X.slstm_apply(p, u, cfg)
    y1, st = X.slstm_apply(p, u[:, :13], cfg)
    y2, _ = X.slstm_apply(p, u[:, 13:], cfg, st)
    np.testing.assert_allclose(full.numpy(), torch.cat([y1, y2], 1).numpy(), atol=1e-5)


# ------------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_launch_serve_runs_on_cpu(capsys, arch):
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                       "--steps", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] 3 requests x 4 tokens in ")
    assert out.tokens.shape == (3, 4)


@pytest.mark.parametrize("arch,what", [("whisper-medium", "encoder frame embeddings"),
                                       ("internvl2-2b", "patch embeddings")])
def test_launch_serve_names_the_missing_frontend(arch, what):
    with pytest.raises(ValueError, match=f"needs a frontend \\({what}\\)"):
        tserve.main(["--arch", arch, "--reduced", "--device", "cpu"])
