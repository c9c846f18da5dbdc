"""PyTorch port: the EventLM serving slice against the JAX package, on the CPU.

The reduced ``eventlm-100m`` (``reduced_config``: 4 layers, d_model 64,
float32 compute) with the JAX package's parameters carried over bitwise by
``models.convert.params_from_jax``:

* ``forward`` logits within 1e-4 for every ``attn_impl``;
* ``prefill`` last logits within 1e-4 and the bf16 K / V cache within one
  bf16 ulp; ``decode_step`` logits within 1e-4;
* ``Engine.generate`` (4 requests x 12-token prompts x 8 steps, ``max_len``
  64) giving the JAX engine's greedy tokens exactly, and again with a
  prompt longer than ``max_len`` and with decode past ``max_len``;
* ``launch.serve.main`` running on the CPU and printing its lines, also
  from a checkpoint the JAX package's ``CheckpointManager`` wrote.

Plus the token pipeline (``frame_to_token_stream``, ``batches``) equal to
the JAX package's on the same synthetic log, and the parameter creation.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.core.eventframe import ACTIVITY as JACTIVITY  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.data import tokenizer as jtokenizer  # noqa: E402
from repro.models import model as JMdl  # noqa: E402
from repro.models.module import Initializer as JInitializer  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.train import trainstep as TS  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.eventframe import ACTIVITY  # noqa: E402
from repro_torch.data import pipeline, synthetic, tokenizer  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as Mdl  # noqa: E402
from repro_torch.models.convert import params_from_jax, unflatten_keystr  # noqa: E402
from repro_torch.models.module import Empty, Initializer  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

from helpers import LOCAL_RULES  # noqa: E402

ARCH = "eventlm-100m"


@pytest.fixture(scope="module")
def jax_model():
    cfg = jreduced(jget_config(ARCH))
    params = JMdl.init_params(cfg, JInitializer(jax.random.PRNGKey(0), cfg.param_dtype))
    return cfg, params


def _port(cfg_j, params_j, **overrides):
    cfg = reduced_config(get_config(ARCH)).with_overrides(**overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j.with_overrides(**overrides))
    model = Mdl.init_params(cfg, Empty(cfg.param_dtype, "cpu"))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params_j)))
    return cfg, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (b, s)).astype(np.int32)


def _bf16_ulps_apart(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))) * 2.0 ** 16
    return np.abs(a - b) <= ulp


def test_params_from_jax_is_bitwise(jax_model):
    cfg_j, params_j = jax_model
    cfg, model = _port(cfg_j, params_j)
    state = model.state_dict()
    flat, _ = jax.tree_util.tree_flatten_with_path(params_j)
    assert len(state) == sum(int(np.asarray(v).shape[0]) if "layers" in
                             jax.tree_util.keystr(k) else 1 for k, v in flat)
    for i in range(cfg.num_layers):
        for grp, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "down")):
            np.testing.assert_array_equal(
                state[f"layers.{i}.{grp}.{name}"].numpy(),
                np.asarray(params_j["layers"][grp][name][i]))
        np.testing.assert_array_equal(state[f"layers.{i}.ln2"].numpy(),
                                      np.asarray(params_j["layers"]["ln2"][i]))
    np.testing.assert_array_equal(state["embed"].numpy(), np.asarray(params_j["embed"]))
    np.testing.assert_array_equal(state["head"].numpy(), np.asarray(params_j["head"]))


@pytest.mark.parametrize("attn_impl", ["chunked", "ref", "pallas"])
def test_forward_matches_jax(jax_model, attn_impl):
    cfg_j, params_j = jax_model
    cfg, model = _port(cfg_j, params_j, attn_impl=attn_impl)
    toks = _tokens(cfg, 2, 40)
    want = JMdl.forward(cfg_j.with_overrides(attn_impl=attn_impl), params_j,
                        jnp.asarray(toks), rules=LOCAL_RULES)
    got = Mdl.forward(cfg, model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def test_forward_bf16_compute_matches_jax(jax_model):
    cfg_j, params_j = jax_model
    cfg, model = _port(cfg_j, params_j, compute_dtype="bfloat16")
    toks = _tokens(cfg, 2, 24, seed=1)
    want = JMdl.forward(cfg_j.with_overrides(compute_dtype="bfloat16"), params_j,
                        jnp.asarray(toks), rules=LOCAL_RULES)
    got = Mdl.forward(cfg, model, torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-2)


def test_prefill_and_decode_match_jax(jax_model):
    cfg_j, params_j = jax_model
    cfg, model = _port(cfg_j, params_j)
    toks = _tokens(cfg, 3, 20, seed=2)
    want_logits, want_cache = JMdl.prefill(cfg_j, params_j, jnp.asarray(toks[:, :14]),
                                           rules=LOCAL_RULES)
    got_logits, got_cache = Mdl.prefill(cfg, model, torch.from_numpy(toks[:, :14]))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-4)
    assert got_cache["pos"] == int(want_cache["pos"]) == 14
    for name in ("k", "v"):
        assert got_cache[name].dtype == torch.bfloat16
        assert _bf16_ulps_apart(got_cache[name].float().numpy(),
                                np.asarray(want_cache[name], np.float32)).all()

    # decode the rest of the tokens against a cache grown to 20
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
        np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), atol=1e-4)
    assert tc["pos"] == 20
    full = Mdl.forward(cfg, model, torch.from_numpy(toks))
    np.testing.assert_allclose(got_step.numpy(), full[:, -1].detach().numpy(), atol=1e-2)


def _prompts(cfg, requests, prompt_len, seed=0):
    frame, tables = synthetic.generate(num_cases=2_000,
                                       num_activities=min(cfg.vocab_size - 8, 32),
                                       seed=seed, device="cpu")
    tok = tokenizer.ActivityTokenizer(tables[ACTIVITY])
    stream = pipeline.frame_to_token_stream(frame, tok)
    return np.stack([stream[i * 37:i * 37 + prompt_len] for i in range(requests)])


def test_engine_generate_greedy_matches_jax(jax_model):
    cfg_j, params_j = jax_model
    cfg, model = _port(cfg_j, params_j)
    prompts = _prompts(cfg, 4, 12)
    want = JEngine(cfg_j, params_j, max_len=64).generate(prompts, steps=8)
    got = Engine(cfg, model, max_len=64, device="cpu").generate(prompts, steps=8)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (4, 8)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits),
                               atol=1e-4)


@pytest.mark.parametrize("prompt_len,max_len,steps", [(12, 8, 4), (12, 14, 6)],
                         ids=["prompt_past_max_len", "decode_past_max_len"])
def test_engine_generate_past_max_len_matches_jax(jax_model, prompt_len, max_len, steps):
    """A prompt longer than ``max_len`` keeps a cache of its own length, and
    decode past the cache writes onto its last slot: the JAX engine's shapes
    (``_grow_cache`` pads only a shorter cache; ``dynamic_update_slice``
    clamps), so its greedy tokens and last logits (within 1e-4)."""
    cfg_j, params_j = jax_model
    cfg, model = _port(cfg_j, params_j)
    prompts = _prompts(cfg, 2, prompt_len, seed=3)
    want = JEngine(cfg_j, params_j, max_len=max_len).generate(prompts, steps=steps)
    eng = Engine(cfg, model, max_len=max_len, device="cpu")
    got = eng.generate(prompts, steps=steps)
    assert got.tokens.shape == (2, steps)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits),
                               atol=1e-4)
    _, cache = eng.prefill(prompts)
    assert cache["k"].shape[2] == max(max_len, prompt_len) and cache["pos"] == prompt_len


def test_engine_from_state_dict_and_sampling(jax_model):
    cfg_j, params_j = jax_model
    cfg, model = _port(cfg_j, params_j)
    state = params_from_jax(jax.tree.map(np.asarray, params_j))
    prompts = _prompts(cfg, 3, 10, seed=1)
    a = Engine(cfg, state, max_len=32, device="cpu").generate(prompts, steps=5)
    b = Engine(cfg, model, max_len=32, device="cpu").generate(prompts, steps=5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    eng = Engine(cfg, model, max_len=32, device="cpu")
    s1 = eng.generate(prompts, 6, greedy=False,
                      generator=torch.Generator().manual_seed(5)).tokens
    s2 = eng.generate(prompts, 6, greedy=False,
                      generator=torch.Generator().manual_seed(5)).tokens
    np.testing.assert_array_equal(s1, s2)
    assert s1.shape == (3, 6) and s1.min() >= 0 and s1.max() < cfg.vocab_size
    assert eng.generate(prompts, 0).tokens.shape == (3, 0)


def test_token_pipeline_matches_jax():
    cols, tables = synthetic.generate_numpy(num_cases=500, num_activities=20, seed=3)
    jframe, jtables = jsynthetic.generate(num_cases=500, num_activities=20, seed=3)
    frame, _ = synthetic.generate(num_cases=500, num_activities=20, seed=3, device="cpu")
    assert tables[ACTIVITY] == jtables[JACTIVITY]
    tok = tokenizer.ActivityTokenizer(tables[ACTIVITY])
    jtok = jtokenizer.ActivityTokenizer(jtables[JACTIVITY])
    stream = pipeline.frame_to_token_stream(frame, tok)
    jstream = jpipeline.frame_to_token_stream(jframe, jtok)
    np.testing.assert_array_equal(stream, np.asarray(jstream))
    for hosts in (2, 3):
        for host in range(hosts):
            np.testing.assert_array_equal(
                pipeline.frame_to_token_stream(frame, tok, host, hosts),
                jpipeline.frame_to_token_stream(jframe, jtok, host, hosts))
    got = list(pipeline.batches(stream, 4, 16))
    want = list(jpipeline.batches(jstream, 4, 16))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in ("tokens", "targets", "loss_mask"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    assert tok.decode(stream[:20]) == jtok.decode(jstream[:20])
    assert tok.decode([tok.vocab_size]) == ["<unk>"]    # JAX raises IndexError
    prefetched = list(pipeline.Prefetcher(pipeline.batches(stream, 4, 16)))
    assert len(prefetched) == len(got)


def test_initializer_draws_truncated_fan_in_normal():
    cfg = get_config(ARCH).with_overrides(num_layers=1)
    model = Mdl.init_params(cfg, Initializer(torch.Generator().manual_seed(0),
                                             cfg.param_dtype))
    # the analytic count leaves out the norms' scales
    assert sum(p.numel() for p in model.parameters() if p.dim() == 2) == cfg.param_count()
    wq = model.layers[0].attn["wq"]
    std = cfg.d_model ** -0.5
    assert float(wq.abs().max()) <= 2 * std
    # a standard normal cut at +-2 has std 0.8796
    assert abs(float(wq.std()) / std - 0.8796) < 0.01
    assert float(model.layers[0].ln1.abs().max()) == 0.0
    assert abs(float(model.embed.std()) - 0.8796) < 0.01
    again = Mdl.init_params(cfg, Initializer(torch.Generator().manual_seed(0),
                                             cfg.param_dtype))
    assert torch.equal(again.layers[0].mlp["up"], model.layers[0].mlp["up"])
    assert all(p.requires_grad for p in model.parameters())    # training differentiates them


def test_unknown_family_raises_value_error():
    cfg = reduced_config(get_config(ARCH)).with_overrides(family="retnet")
    with pytest.raises(ValueError, match="retnet"):
        Mdl.init_params(cfg, Empty(device="cpu"))


def test_checkpoint_written_by_jax_restores_to_the_same_logits(jax_model, tmp_path):
    cfg_j, params_j = jax_model
    mgr_j = JCheckpointManager(str(tmp_path))
    mgr_j.save(3, {"params": params_j})
    mgr_j.save(7, {"params": params_j})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == mgr_j.all_steps() == [3, 7]
    assert mgr.latest_step() == 7
    step, tree = mgr.restore_latest()
    assert step == 7
    cfg, model = _port(cfg_j, params_j)
    restored = Mdl.init_params(cfg, Empty(cfg.param_dtype, "cpu"))
    restored.load_state_dict(params_from_jax(tree["params"]))
    toks = torch.from_numpy(_tokens(cfg, 2, 16, seed=4))
    assert torch.equal(Mdl.forward(cfg, restored, toks), Mdl.forward(cfg, model, toks))
    assert set(mgr.restore(3)) == {"params"}
    assert CheckpointManager(str(tmp_path / "missing")).restore_latest() == (None, None)


def test_unflatten_keystr():
    tree = {"params": {"layers": {"attn": {"wq": 1}}, "embed": 2},
            "opt": {"m": {"embed": 3}, "step": 4}}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert unflatten_keystr({jax.tree_util.keystr(k): v for k, v in flat}) == tree
    for bad in (".attr", "['a'][0]", "['a']x", ""):
        with pytest.raises(ValueError):
            unflatten_keystr({bad: 1})


def test_launch_serve_runs_on_cpu(capsys):
    out = tserve.main(["--reduced", "--device", "cpu", "--requests", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] 4 requests x 8 tokens in ")
    assert lines[0].endswith("tok/s (incl. prefill + compile)")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["  req 0", "  req 1", "  req 2"]
    assert out.tokens.shape == (4, 8)


def test_launch_serve_restores_a_jax_checkpoint(jax_model, tmp_path, capsys):
    """A checkpoint shaped as the JAX trainer writes it (params + AdamW
    state), restored by the port's ``launch/serve.py``."""
    cfg_j, params_j = jax_model
    JCheckpointManager(str(tmp_path)).save(5, TS.init_state(cfg_j, params_j))
    out = tserve.main(["--reduced", "--device", "cpu", "--requests", "4",
                       "--seed", "1", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"[serve] restored step 5 from {tmp_path}"
    # the restored weights are the checkpoint's, not seed 1's: same tokens as
    # the JAX engine over seed 1's prompts
    cfg = reduced_config(get_config(ARCH))
    want = JEngine(cfg_j, params_j, max_len=64).generate(_prompts(cfg, 4, 12, seed=1), 8)
    np.testing.assert_array_equal(out.tokens, np.asarray(want.tokens))
