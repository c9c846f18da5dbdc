"""PyTorch port: flash attention and the model's attention against the JAX
package, on the CPU.

* The kernel's plain version (``flash_attention_ref``) and the
  device-dispatched ``ops.flash_attention`` on CPU tensors against
  ``repro.kernels.flash_attention.flash_attention_pallas`` (interpret mode)
  and its ``attention_ref``: the six shapes and the dtype / block-size
  sweeps of ``tests/test_kernels.py``, atol 2e-5 in float32 and 2e-2 in
  bf16 (the JAX kernel tests' own bounds).
* The model's ``attention`` (``ref``, ``chunked``, ``pallas``) and
  ``attention_decode`` against ``repro.models.attention``, atol 1e-5.

Inputs come from numpy seeds; bf16 inputs are the same float32 draws
rounded to bf16 by both frameworks (round to nearest even, bit-identical).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as jax_kernel_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_cuda,  # noqa: E402
                                                 flash_attention_ref, ops)
from repro_torch.models import attention as tattn  # noqa: E402

SHAPES = [(1, 4, 2, 128, 128, 64, True, None),
          (2, 8, 2, 256, 256, 64, True, 512),
          (1, 4, 4, 200, 200, 32, True, None),
          (1, 4, 1, 1, 384, 64, False, None),
          (1, 2, 2, 96, 96, 128, True, 32),
          (2, 4, 2, 64, 64, 16, False, None)]
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, b, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,win", SHAPES,
                         ids=lambda v: str(v))
def test_flash_attention_plain_matches_pallas_and_ref(dtype, b, h, kvh, sq, sk, d,
                                                      causal, win):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(sq * 31 + d, b, h, kvh, sq, sk, d), dtype)
    kvlen = sk - 17 if sk > 64 else None
    want_pallas = flash_attention_pallas(
        jq, jk, jv, None if kvlen is None else jnp.int32(kvlen), causal=causal,
        window=win, interpret=True)
    want_ref = jax_kernel_ref(jq, jk, jv, None if kvlen is None else jnp.int32(kvlen),
                              causal=causal, window=win)
    for got in (flash_attention_ref(tq, tk, tv, kvlen, causal=causal, window=win),
                ops.flash_attention(tq, tk, tv, kvlen, causal=causal, window=win),
                flash_attention_cuda(tq, tk, tv, kvlen, causal=causal, window=win)):
        assert got.dtype == tq.dtype and tuple(got.shape) == (b, h, sq, d)
        np.testing.assert_allclose(_f32(got), _f32(want_pallas), atol=ATOL[dtype])
        np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=ATOL[dtype])


def _p_in_bf16(q, k, v, kv_len, causal, window):
    """The bf16 kernel's arithmetic in plain PyTorch: float32 scores and
    online-softmax sums, but the weights P rounded to bf16 before P.V (the
    tensor cores' A operand); returns float32, before the output's own
    rounding."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d ** -0.5
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(k.shape[2])[None, :]
    mask = cols < (k.shape[2] if kv_len is None else kv_len)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp(min=-1e30)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf)
    return torch.where(l > 0, o / l.clamp(min=1e-30), 0.0)


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,win", SHAPES, ids=lambda v: str(v))
def test_p_in_bf16_stays_within_its_stated_bound(b, h, kvh, sq, sk, d, causal, win):
    """The bf16 kernel rounds P to bf16 before P.V, where the JAX kernel
    keeps it in float32.  bf16 keeps 8 significant bits, so rounding to
    nearest moves each weight by at most 2^-8 of itself, and an output by
    at most 2^-8 max|v| from float32 P; with the output rounded to bf16 it
    stays within the 2e-2 of the JAX kernel tests (Pallas in interpret
    mode, bf16 inputs)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(sq * 7 + d, b, h, kvh, sq, sk, d), "bfloat16")
    kvlen = sk - 17 if sk > 64 else None
    exact = flash_attention_ref(tq.float(), tk.float(), tv.float(), kvlen,
                                causal=causal, window=win)
    rounded = _p_in_bf16(tq, tk, tv, kvlen, causal, win)
    bound = 2.0 ** -8 * float(tv.float().abs().max())
    assert float((rounded - exact).abs().max()) <= bound
    want = flash_attention_pallas(jq, jk, jv, None if kvlen is None else jnp.int32(kvlen),
                                  causal=causal, window=win, interpret=True)
    np.testing.assert_allclose(_f32(rounded.to(torch.bfloat16)), _f32(want),
                               atol=ATOL["bfloat16"])


def _tf32(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: the kernel's ``tf32_rna`` on the bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_attention(q, k, v, kv_len, causal, window, split):
    """Attention over float32 numpy inputs with every product taken exactly
    (float64 sums): ``split`` takes each product of q.k and of p.v as the
    float32 route's three TF32 products big.big + big.small + small.big
    (big = tf32(x), small = tf32(x - big)); P is float32, as in the kernel.
    Returns the float64 output and the softmax weights P / l."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    kf, vf = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)

    def product(eq, x, y):
        if not split:
            return np.einsum(eq, x.astype(np.float64), y.astype(np.float64))
        xb, yb = _tf32(x), _tf32(y)
        xs, ys = _tf32(x - xb), _tf32(y - yb)
        f64 = np.float64
        return (np.einsum(eq, xs.astype(f64), yb.astype(f64))
                + np.einsum(eq, xb.astype(f64), ys.astype(f64))
                + np.einsum(eq, xb.astype(f64), yb.astype(f64)))

    rows = np.arange(sq)[:, None]
    cols = np.arange(k.shape[2])[None, :]
    mask = cols < (k.shape[2] if kv_len is None else kv_len)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = np.where(mask, product("bhqd,bhkd->bhqk", q, kf) * d ** -0.5, -np.inf)
    m = np.maximum(s.max(-1, keepdims=True), -1e300)
    p = np.where(mask, np.exp(s - m), 0.0).astype(np.float32)
    l = p.astype(np.float64).sum(-1, keepdims=True)
    safe = np.where(l > 0, l, 1.0)
    o = np.where(l > 0, product("bhqk,bhkd->bhqd", p, vf) / safe, 0.0)
    return o, p / safe


@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,win", SHAPES, ids=lambda v: str(v))
def test_f32_split_products_stay_within_their_stated_bound(b, h, kvh, sq, sk, d, causal, win):
    """The float32 kernel takes each product as 3xTF32: both operands split
    into big = tf32(x) and small = tf32(x - big) (nearest, ties away), and
    big.big + big.small + small.big summed.  Dropping small.small and the
    rounding of small leaves each product within 3 x 2^-22 < 2^-20 of
    itself, so an output moves from the float32 result by at most
    2^-20 (sum_j p_j |v_j| + scale sum_j p_j |v_j - o| sum_e |q_e k_je|)
    (p the softmax weights; the second term carries the scores' error
    through the softmax), plus 2^-23 sum_j p_j |v_j| for P's float32
    rounding: at most 6e-6 to 1.9e-5 at these shapes, where the emulated
    outputs move by at most 4e-7.  The emulation also stays within the 2e-5
    of the JAX kernel tests (Pallas in interpret mode)."""
    q, k, v = _qkv(sq * 5 + d, b, h, kvh, sq, sk, d)
    kvlen = sk - 17 if sk > 64 else None
    exact, p = _split_attention(q, k, v, kvlen, causal, win, split=False)
    split, _ = _split_attention(q, k, v, kvlen, causal, win, split=True)
    g = h // kvh
    kf, vf = np.repeat(k, g, axis=1).astype(np.float64), np.repeat(v, g, axis=1).astype(np.float64)
    qk_abs = np.einsum("bhqd,bhkd->bhqk", np.abs(q.astype(np.float64)), np.abs(kf))
    pv = np.einsum("bhqk,bhkd->bhqd", p, np.abs(vf))
    spread = np.abs(vf[:, :, None, :, :] - exact[:, :, :, None, :])      # |v_j - o|
    scores = np.einsum("bhqk,bhqkd->bhqd", p * qk_abs * d ** -0.5, spread)
    bound = 2.0 ** -20 * (pv + scores) + 2.0 ** -23 * pv
    err = np.abs(split - exact)
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-300)).max())
    assert float(bound.max()) < 2e-5
    (jq, jk, jv), _ = _both((q, k, v), "float32")
    want = flash_attention_pallas(jq, jk, jv, None if kvlen is None else jnp.int32(kvlen),
                                  causal=causal, window=win, interpret=True)
    np.testing.assert_allclose(split.astype(np.float32), np.asarray(want), atol=ATOL["float32"])


# (B, H, KVH, Sq, Sk, D, causal, window, kv_len): GQA, a window over ragged
# keys, non-causal ragged keys, rows with no valid column
BWD_SHAPES = [(2, 4, 2, 37, 37, 16, True, None, None),
              (1, 6, 2, 70, 70, 64, True, 9, 50),
              (2, 4, 1, 5, 40, 16, False, None, 29),
              (1, 2, 2, 64, 64, 16, True, 4, 10)]
# the backward kernel's stated bound against the float32 backward:
# |got - want| <= rtol (1 + |want|) + c A, A = flash_attention_bwd_magnitudes
BWD_BOUND = {"bfloat16": (2.0 ** -7, 2 * 2.0 ** -8), "float32": (1e-5, 2.0 ** -19)}


def _to_bf16(x):
    """float64 numpy values rounded to float32, then to bf16 (nearest even)."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.float().numpy().astype(np.float64)


def _emulated_bwd(q, k, v, o, lse, do, kv_len, causal, window, route):
    """(dq, dk, dv) in float64 with the backward kernel's rounding points:
    ``"bfloat16"`` rounds P and dS to bf16 before the gradient products
    (dV = P^T dO, dK = dS^T Q D^-1/2, dQ = dS K D^-1/2) and the gradients
    to bf16 at the end; ``"float32"`` takes each of the seven products as
    3xTF32 (big.big + big.small + small.big, big = tf32(x), small =
    tf32(x - big)) with P and dS in float32.  Other sums are exact."""
    f64 = np.float64
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    kf, vf = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)

    def product(eq, x, y):
        if route == "bfloat16":
            return np.einsum(eq, x.astype(f64), y.astype(f64))
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        xb, yb = _tf32(x), _tf32(y)
        xs, ys = _tf32(x - xb), _tf32(y - yb)
        return (np.einsum(eq, xs.astype(f64), yb.astype(f64))
                + np.einsum(eq, xb.astype(f64), ys.astype(f64))
                + np.einsum(eq, xb.astype(f64), yb.astype(f64)))

    rows = np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    mask = cols < (sk if kv_len is None else kv_len)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = product("bhqd,bhkd->bhqk", q, kf) * d ** -0.5
    p = np.where(mask, np.exp(np.where(mask, s, 0.0) - np.where(np.isinf(lse), 0.0, lse)[..., None]),
                 0.0).astype(np.float32)
    delta = (do.astype(f64) * o.astype(f64)).sum(-1)
    dp = product("bhqd,bhkd->bhqk", do, vf)
    ds = (p * (dp - delta[..., None])).astype(np.float32)
    if route == "bfloat16":
        p, ds = _to_bf16(p), _to_bf16(ds)
    dq = product("bhqk,bhkd->bhqd", ds, kf) * d ** -0.5
    dk = product("bhqk,bhqd->bhkd", ds, q).reshape(b, kvh, g, sk, d).sum(2) * d ** -0.5
    dv = product("bhqk,bhqd->bhkd", p, do).reshape(b, kvh, g, sk, d).sum(2)
    out = (dq, dk, dv)
    return tuple(_to_bf16(x) for x in out) if route == "bfloat16" else out


@pytest.mark.parametrize("route", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,win,kvlen", BWD_SHAPES, ids=str)
def test_bwd_rounding_points_stay_within_their_stated_bound(route, b, h, kvh, sq, sk, d,
                                                           causal, win, kvlen):
    """The backward kernel's arithmetic, emulated: bf16 rounds P and dS to
    bf16 (8 significant bits, each within 2^-8 of itself) before the three
    gradient products, which moves a gradient by at most 2^-8 of its
    magnitude product A (|P|^T |dO| for dv, D^-1/2 |dS|^T |Q| for dk,
    D^-1/2 |dS| |K| for dq), and its outputs are rounded to bf16; float32
    takes every product as 3xTF32 (each within 2^-20 of its magnitude
    product).  Held against the float32 plain backward and ``jax.vjp`` of
    the JAX package's attention on the same inputs (bf16 values for the bf16
    route) within the card's stated bound, rtol (1 + |want|) + c A: 2^-7
    and 2 2^-8 in bf16, 1e-5 and 2^-19 in float32."""
    import jax

    from repro_torch.kernels.flash_attention import (flash_attention_bwd_magnitudes,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_lse_ref)

    rng = np.random.default_rng(sq * 11 + d)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d), (b, h, sq, d)))
    if route == "bfloat16":
        q, k, v, do = (_to_bf16(x).astype(np.float32) for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_lse_ref(tq, tk, tv, kvlen, causal=causal, window=win)
    if route == "bfloat16":                       # the bf16 forward's output
        o = o.to(torch.bfloat16).float()
    plain = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, kvlen, causal=causal, window=win)
    mags = flash_attention_bwd_magnitudes(tq, tk, tv, o, lse, tdo, kvlen, causal=causal,
                                          window=win)
    got = _emulated_bwd(q, k, v, o.numpy(), lse.numpy(), do, kvlen, causal, win, route)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_kernel_ref(
        q_, k_, v_, None if kvlen is None else jnp.int32(kvlen), causal=causal, window=win),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jax_grads = vjp(jnp.asarray(do))
    rtol, c = BWD_BOUND[route]
    for x, want_plain, want_jax, mag in zip(got, plain, jax_grads, mags):
        for want in (want_plain.numpy().astype(np.float64), np.asarray(want_jax, np.float64)):
            bound = rtol * (1 + np.abs(want)) + c * mag.numpy()
            assert (np.abs(x - want) <= bound).all(), float((np.abs(x - want) / bound).max())
    if win == 4:                       # rows 13.. see nothing: gradient 0
        assert not got[0][..., 13:, :].any()


def test_readable_keeps_what_the_kernel_reads_in_place():
    """The wrapper hands the kernel a view as it is when the kernel can read
    it: float32 rows as 16-byte vectors, bf16 through TMA (16-byte base and
    strides, nonzero where a dimension is longer than 1); else a copy."""
    from repro_torch.kernels.flash_attention.flash_attention import _readable

    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.zeros((2, 77, 6, 32), dtype=dtype)
        view = buf.transpose(1, 2)                      # (B, H, S, D) of a (B, S, H, D)
        assert _readable(view) is view
        odd = torch.zeros(1 + buf.numel(), dtype=dtype)[1:].view(2, 77, 6, 32).transpose(1, 2)
        assert _readable(odd) is not odd and _readable(odd).is_contiguous()
        col = torch.zeros((2, 6, 77, 64), dtype=dtype)[..., :32]
        assert _readable(col) is col                    # row stride 64: fine for both
    narrow = torch.zeros((1, 2, 9, 4 * 16), dtype=torch.bfloat16)[..., 4:20]
    assert _readable(narrow) is not narrow              # base 8 bytes past 16-byte alignment
    wide = torch.zeros((1, 2, 9, 68), dtype=torch.bfloat16)[..., :16]
    assert _readable(wide) is not wide                  # row stride 136 bytes
    wide32 = torch.zeros((1, 2, 9, 68), dtype=torch.float32)[..., :16]
    assert _readable(wide32) is wide32                  # 272 bytes: float4 rows fine
    shared = torch.zeros((1, 1, 9, 16), dtype=torch.bfloat16).expand(1, 4, 9, 16)
    assert _readable(shared) is not shared              # stride 0 over 4 heads


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
def test_flash_attention_plain_matches_pallas_block_sweep(bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 1, 2, 2, 256, 256, 64), "float32")
    want = flash_attention_pallas(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(flash_attention_ref(tq, tk, tv).numpy(),
                               np.asarray(want), atol=2e-5)


def test_flash_attention_kv_len_as_tensor():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, 4, 2, 130, 130, 32), "float32")
    want = flash_attention_pallas(jq, jk, jv, jnp.int32(77), interpret=True)
    got = ops.flash_attention(tq, tk, tv, torch.tensor(77, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_rows_with_no_valid_column_are_zero(causal):
    """``kv_len = 0`` leaves every row with no valid column.  The port's
    kernel and plain version return 0 there, as the JAX package's
    ``kernels/flash_attention/ref.py`` does.  The Pallas kernel does not:
    its masked scores are -1e30, so ``exp(NEG_INF - NEG_INF) = 1`` and it
    returns the mean of V over the key tiles it visited, padding included
    (non-causal here: the sum of the 64 keys over one 128-key tile); and
    the model-level ``attention_ref`` averages V uniformly over all keys.
    The serving path never builds such a row (causal, ``kv_len >= 1``)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(11, 1, 2, 1, 64, 64, 16), "float32")
    want = np.asarray(jax_kernel_ref(jq, jk, jv, jnp.int32(0), causal=causal))
    assert not want.any()
    for got in (flash_attention_ref(tq, tk, tv, 0, causal=causal),
                ops.flash_attention(tq, tk, tv, torch.tensor(0), causal=causal)):
        assert not got.numpy().any()
    pallas = np.asarray(flash_attention_pallas(jq, jk, jv, jnp.int32(0),
                                               causal=causal, interpret=True))
    if not causal:
        np.testing.assert_allclose(pallas[0, 0, 0], np.asarray(jv)[0, 0].sum(0) / 128,
                                   atol=1e-5)


def test_flash_attention_window_leaving_a_row_nothing_is_zero():
    (_, _, _), (tq, tk, tv) = _both(_qkv(5, 1, 2, 2, 64, 64, 16), "float32")
    got = flash_attention_ref(tq, tk, tv, 10, causal=True, window=4)
    # rows >= 13 see only columns > row - 4, all at or past kv_len = 10
    assert not got[:, :, 13:].numpy().any()
    assert got[:, :, :10].abs().sum() > 0


@pytest.mark.parametrize("d,dtype,exc", [(100, torch.float32, ValueError),
                                         (512, torch.bfloat16, ValueError),
                                         (64, torch.float16, TypeError)])
def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take(d, dtype, exc):
    q = torch.zeros((1, 2, 8, d), dtype=dtype)
    with pytest.raises(exc):
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("d", [8, 96, 112, 136, 256])
def test_check_takes_every_head_dim_the_kernels_take(d):
    """Multiples of 8 from 8 to 256 pass ``_check`` (the kernels run d on
    the smallest instantiation at least d); on CPU tensors the wrapper then
    takes the plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import _check, head_dim_ok

    assert head_dim_ok(d)
    q = torch.zeros((1, 2, 8, d))
    _check(q, q, q, None)
    assert tuple(flash_attention_cuda(q, q, q).shape) == (1, 2, 8, d)


@pytest.mark.parametrize("d", [4, 100, 260, 512])
def test_check_refuses_head_dims_outside_the_rule(d):
    from repro_torch.kernels.flash_attention.flash_attention import _check, head_dim_ok

    assert not head_dim_ok(d)
    q = torch.zeros((1, 2, 8, d))
    with pytest.raises(ValueError, match="head_dim"):
        _check(q, q, q, None)


def test_check_refuses_a_p_dtype_the_kernels_cannot_round_to():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(NotImplementedError, match="float64"):
        flash_attention_cuda(q, q, q, p_dtype=torch.float64)
    for ok in (None, torch.float32, torch.bfloat16, torch.float16):
        flash_attention_cuda(q, q, q, p_dtype=ok)


@pytest.mark.parametrize("p_dtype,unit", [("bfloat16", 2.0 ** -8), ("float16", 2.0 ** -11)])
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal,win", SHAPES[:3], ids=lambda v: str(v))
def test_p_dtype_plain_version_stays_within_its_bound_of_jax(p_dtype, unit, b, h, kvh, sq,
                                                             sk, d, causal, win):
    """``flash_attention_ref(p_dtype=...)`` rounds exp(s - max) before P.V,
    JAX's chunked attention exp(s - running max): each rounding moves an
    output by at most u max|v| (u = 2^-8 bf16, 2^-11 float16), so the two
    stay within 2 u max|v| (plus float32 noise, 2e-5) of each other; the
    plain backward's dV takes the rounded P."""
    arrs = _qkv(7, b, h, kvh, sq, sk, d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    pdt = getattr(torch, p_dtype)
    got = flash_attention_ref(tq, tk, tv, causal=causal, window=win, p_dtype=pdt)
    want = jattn.attention_chunked(jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
                                   jnp.swapaxes(jv, 1, 2), causal=causal, window=win,
                                   chunk=64, p_dtype=getattr(jnp, p_dtype))
    bound = 2 * unit * float(np.abs(arrs[2]).max()) + 2e-5
    assert float(np.abs(got.numpy() - np.swapaxes(np.asarray(want), 1, 2)).max()) <= bound
    exact = flash_attention_ref(tq, tk, tv, causal=causal, window=win)
    assert float((got - exact).abs().max()) <= bound
    assert not torch.equal(got, exact)
    # the backward rounds P for dV only
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref, flash_attention_lse_ref

    o, lse = flash_attention_lse_ref(tq, tk, tv, causal=causal, window=win, p_dtype=pdt)
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(tq.shape).astype(np.float32))
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, o, lse, do, causal=causal, window=win,
                                         p_dtype=pdt)
    dq0, dk0, dv0 = flash_attention_bwd_ref(tq, tk, tv, o, lse, do, causal=causal, window=win)
    assert torch.equal(dq, dq0) and torch.equal(dk, dk0) and not torch.equal(dv, dv0)


# --------------------------------------------------------- model level
MODEL_SHAPES = [(2, 37, 37, 4, 2, 16, True, None, None),
                (1, 64, 64, 4, 4, 32, True, 8, None),
                (2, 40, 40, 4, 1, 16, True, None, 29),
                (1, 5, 70, 2, 2, 16, False, None, 50)]


def _model_qkv(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,win,kvlen", MODEL_SHAPES,
                         ids=lambda v: str(v))
def test_model_attention_matches_jax(impl, b, sq, sk, h, kvh, d, causal, win, kvlen):
    arrs = _model_qkv(b * 100 + sq, b, sq, sk, h, kvh, d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    kw = dict(causal=causal, window=win, kv_len=kvlen, chunk=16)
    want = jattn.attention(jq, jk, jv, impl=impl, **kw)
    got = tattn.attention(tq, tk, tv, impl=impl, **kw)
    assert tuple(got.shape) == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_model_attention_chunked_p_dtype_matches_jax():
    arrs = _model_qkv(9, 1, 48, 48, 4, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    want = jattn.attention_chunked(jq, jk, jv, chunk=16, p_dtype=jnp.bfloat16)
    got = tattn.attention_chunked(tq, tk, tv, chunk=16, p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("p_dtype", ["bfloat16", "float16"])
def test_model_attention_p_dtype_through_the_plain_path_matches_jax(p_dtype):
    """``attention(impl="chunked", p_dtype=...)`` on CPU tensors is the
    plain chunked scan, JAX's ``attention`` with the same ``p_dtype``."""
    arrs = _model_qkv(11, 2, 40, 40, 4, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, "float32")
    want = jattn.attention(jq, jk, jv, impl="chunked", chunk=16, window=12,
                           p_dtype=getattr(jnp, p_dtype))
    got = tattn.attention(tq, tk, tv, impl="chunked", chunk=16, window=12,
                          p_dtype=getattr(torch, p_dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv_len", [1, 13, 40])
def test_attention_decode_matches_jax(window, kv_len):
    rng = np.random.default_rng(kv_len)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    want = jattn.attention_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.int32(kv_len), window=window)
    got = tattn.attention_decode(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), kv_len, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_model_attention_kernel_route_refuses_offset_causal_rows():
    """The kernel counts causal rows from 0; the model offsets them by
    ``sk - sq``.  Only ``sq == sk`` (every prefill) is sent to it."""
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 9, 2, 16))
    with pytest.raises(ValueError):
        tattn.attention(q, k, k, impl="pallas", causal=True)
