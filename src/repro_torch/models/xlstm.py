"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, strictly recurrent with hidden-to-gate feedback).

mLSTM is a special case of the SSD chunked machinery: the forget gate is a
per-head scalar decay and the input gate weights the ``v k^T`` outer
products.  Numerator and normalizer come out of one chunked pass through a
ones channel appended to ``v`` (state (P, P + 1)), the state kept
stabilized by a running log-scale ``m``.  The JAX package's ``lax.scan``
over chunks is a Python loop over chunks here, and sLSTM's scan over time
a Python loop over tokens (both ``repeat.scan``); every product is plain
``torch``, as the JAX package leaves them to XLA.

The intra-chunk weights mask before they exponentiate,
``exp(where(causal, diff, -inf))``: above a chunk's diagonal ``diff`` grows
with the chunk's summed log forget gates and overflows float32 ``exp``,
which the JAX package computes before its ``where`` drops it (the same
forward, ``exp(-inf)`` being the ``where``'s 0, but ``inf * 0 = NaN``
gradients).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import torch_dtype
from .module import Creator
from .repeat import scan

M_INIT = -30.0     # the stabilizer's start: exp(-30) weighs the empty state


# ------------------------------------------------------------------ mLSTM
def mlstm_init(c: Creator, cfg: ModelConfig):
    D = cfg.d_model
    di = 2 * D                       # up-projection factor 2 (xLSTM paper)
    return {
        "up": c("mlstm.up", (D, 2 * di), ("embed", "heads")),     # [x | z]
        "wq": c("mlstm.wq", (di, di), ("heads", None)),
        "wk": c("mlstm.wk", (di, di), ("heads", None)),
        "wv": c("mlstm.wv", (di, di), ("heads", None)),
        "wif": c("mlstm.wif", (di, 2 * cfg.num_heads), ("heads", None)),
        "norm": c("mlstm.norm", (di,), (None,), scale="zeros"),
        "down": c("mlstm.down", (di, D), ("heads", "embed")),
    }


def _mlstm_qkvg(p, cfg: ModelConfig, u):
    dt_c = torch_dtype(cfg.compute_dtype)
    H = cfg.num_heads
    P = 2 * cfg.d_model // H
    x, z = (u.to(dt_c) @ p["up"].to(dt_c)).chunk(2, dim=-1)
    q = x @ p["wq"].to(dt_c)
    k = (x @ p["wk"].to(dt_c)) * (P ** -0.5)
    v = x @ p["wv"].to(dt_c)
    i_raw, f_raw = (x @ p["wif"].to(dt_c)).float().chunk(2, dim=-1)   # (B, S, H)
    shp = (*q.shape[:2], H, P)
    return (q.reshape(shp).float(), k.reshape(shp).float(), v.reshape(shp).float(),
            i_raw, f_raw, z)


def _mlstm_tail(p, cfg: ModelConfig, y, z):
    dt_c = torch_dtype(cfg.compute_dtype)
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-6)
    y = y * (1.0 + p["norm"].float())
    y = y * F.silu(z.float())
    return y.to(dt_c) @ p["down"].to(dt_c)


def _mlstm_chunk(h, m, qq, kk, vv, lf, li, causal):
    """One chunk: h (B, H, P, P + 1) stored stabilized (h_true = h exp(m)),
    m (B, H); inputs (B, Q, ...).  Returns (h, m, y, m_row)."""
    cum = torch.cumsum(lf, dim=1)                              # (B, Q, H)
    # per-row stabilizer: m_row_i = cum_i + max(m, cummax_{j<=i}(li_j - cum_j))
    Mi = torch.cummax(li - cum, dim=1).values
    m_row = cum + torch.maximum(Mi, m[:, None])                # (B, Q, H)
    # intra-chunk: w_ij = exp(cum_i - cum_j + li_j - m_row_i)
    diff = cum[:, :, None] - cum[:, None, :] + li[:, None] - m_row[:, :, None]
    w = torch.exp(torch.where(causal[None, :, :, None], diff, -torch.inf))
    qk = torch.einsum("bihp,bjhp->bijh", qq, kk)
    y_intra = torch.einsum("bijh,bjhp->bihp", qk * w, vv)
    # inter-chunk (carried state, decayed into this chunk)
    dec_in = torch.exp(cum + m[:, None] - m_row)               # (B, Q, H)
    y_inter = torch.einsum("bihp,bhpr->bihr", qq, h) * dec_in[..., None]
    # state update to the end of the chunk
    m_new = cum[:, -1] + torch.maximum(Mi[:, -1], m)           # (B, H)
    dec_end = torch.exp(cum[:, -1:] - cum + li - m_new[:, None])
    hb = torch.einsum("bjhp,bjhr->bhpr", kk * dec_end[..., None], vv)
    h = h * torch.exp(cum[:, -1] + m - m_new)[..., None, None] + hb
    return h, m_new, y_intra + y_inter, m_row


def mlstm_apply(p, u, cfg: ModelConfig, state=None, return_state: bool = False):
    """Chunked-parallel mLSTM. u: (B, S, D) -> (B, S, D) (+ final state
    ``{"h": (B, H, P, P + 1), "m": (B, H)}``, float32)."""
    b, S, _ = u.shape
    H = cfg.num_heads
    Q = cfg.ssm_chunk or 128
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(p, cfg, u)
    P = q.shape[-1]
    pad = (-S) % Q
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-30.0)
        # +30 -> log_sigmoid ~ 0: padded steps do not decay the carried state
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=30.0)
    nc = (S + pad) // Q
    logf = F.logsigmoid(f_raw)                                 # (B, S', H)
    # ones channel: the state tracks [v | 1] so the normalizer rides along
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)  # (B, S', H, P + 1)
    if state is None:
        h = torch.zeros((b, H, P, P + 1), dtype=torch.float32, device=u.device)
        m = torch.full((b, H), M_INIT, dtype=torch.float32, device=u.device)
    else:
        h, m = state["h"], state["m"]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()

    def chunk(hm, *x):
        h, m, y_c, mrow_c = _mlstm_chunk(*hm, *x, causal)
        return (h, m), (y_c, mrow_c)

    xs = tuple(t.reshape(b, nc, Q, *t.shape[2:]) for t in (q, k, v1, logf, i_raw))
    (h, m), (y, m_row) = scan(nc, chunk, (h, m), xs)
    y = y.reshape(b, nc * Q, *y.shape[3:])[:, :S]
    m_row = m_row.reshape(b, nc * Q, H)[:, :S]
    num, den = y[..., :P], y[..., P:]
    floor = torch.exp(torch.clamp(-m_row, -60.0, 60.0))[..., None]
    out = (num / torch.maximum(den.abs(), floor)).reshape(b, S, H * P)
    y = _mlstm_tail(p, cfg, out, z[:, :S])
    if return_state:
        return y, {"h": h, "m": m}
    return y


def mlstm_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    H = cfg.num_heads
    P = 2 * cfg.d_model // H
    return {"h": torch.zeros((batch, H, P, P + 1), dtype=torch.float32, device=device),
            "m": torch.full((batch, H), M_INIT, dtype=torch.float32, device=device)}


def mlstm_step(p, u, state, cfg: ModelConfig):
    """Single-token mLSTM recurrence (constant-memory decode); ``state`` is
    not written."""
    b = u.shape[0]
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(p, cfg, u)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                        # (B, H, P)
    P = q.shape[-1]
    lf = F.logsigmoid(f_raw[:, 0])                             # (B, H)
    li = i_raw[:, 0]
    m_new = torch.maximum(state["m"] + lf, li)
    fw = torch.exp(state["m"] + lf - m_new)[..., None, None]
    iw = torch.exp(li - m_new)[..., None, None]
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    h = state["h"] * fw + iw * torch.einsum("bhp,bhr->bhpr", k, v1)
    y = torch.einsum("bhp,bhpr->bhr", q, h)
    num, den = y[..., :P], y[..., P:]
    floor = torch.exp(torch.clamp(-m_new, -60.0, 60.0))[..., None]
    out = (num / torch.maximum(den.abs(), floor)).reshape(b, 1, -1)
    return _mlstm_tail(p, cfg, out, z), {"h": h, "m": m_new}


# ------------------------------------------------------------------ sLSTM
def slstm_init(c: Creator, cfg: ModelConfig):
    D = cfg.d_model
    H = cfg.num_heads
    P = D // H
    f = int(D * 4 / 3 / 64) * 64 or 64
    return {
        "w": c("slstm.w", (D, 4 * D), ("embed", "heads")),        # z i f o
        "r": c("slstm.r", (H, P, 4 * P), (None, None, None), scale=0.05),
        "norm": c("slstm.norm", (D,), (None,), scale="zeros"),
        "ff_up": c("slstm.ffu", (D, 2 * f), ("embed", "mlp")),
        "ff_down": c("slstm.ffd", (f, D), ("mlp", "embed")),
    }


def _slstm_cell(p, cfg: ModelConfig, wx_t, state):
    """One sLSTM step. wx_t: (B, 4D) precomputed input projection.  With
    ``slstm_bf16`` the recurrent product takes bf16 operands and sums in
    float32 (JAX's ``preferred_element_type``): a product of two bf16
    values is exact in float32."""
    H, D = cfg.num_heads, cfg.d_model
    P = D // H
    h, cell, n, m = state
    rdt = torch.bfloat16 if cfg.slstm_bf16 else torch.float32
    rx = torch.einsum("bhp,hpq->bhq", h.to(rdt).float(),
                      p["r"].to(rdt).float()).reshape(-1, 4 * D)
    zifo = (wx_t + rx).reshape(-1, H, 4, P)
    zt = torch.tanh(zifo[:, :, 0])
    it = zifo[:, :, 1]
    ft = zifo[:, :, 2]
    ot = torch.sigmoid(zifo[:, :, 3])
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    iw = torch.exp(it - m_new)
    fw = torch.exp(lf + m - m_new)
    cell = fw * cell + iw * zt
    n = fw * n + iw
    h_new = ot * cell / torch.maximum(n.abs(), torch.ones_like(n))
    return h_new, cell, n, m_new


def slstm_apply(p, u, cfg: ModelConfig, state=None):
    """Recurrent sLSTM over time + gated FFN tail. u: (B, S, D).  Returns
    (y, state ``{"h", "c", "n", "m"}``, each (B, H, P) float32)."""
    dt_c = torch_dtype(cfg.compute_dtype)
    b, S, D = u.shape
    wx = (u.to(dt_c) @ p["w"].to(dt_c)).float()
    if state is None:
        state = slstm_init_state(cfg, b, u.device)
    st = (state["h"], state["c"], state["n"], state["m"])

    def step(st, wx_t):
        st = _slstm_cell(p, cfg, wx_t, st)
        return st, st[0]

    st, hs = scan(S, step, st, (wx,))
    y = hs.reshape(b, S, D)
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-6)
    y = y * (1.0 + p["norm"].float())
    g, v = (y.to(dt_c) @ p["ff_up"].to(dt_c)).chunk(2, dim=-1)
    y = (F.gelu(g, approximate="tanh") * v) @ p["ff_down"].to(dt_c)
    return y, {"h": st[0], "c": st[1], "n": st[2], "m": st[3]}


def slstm_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    H = cfg.num_heads
    P = cfg.d_model // H

    def z():
        return torch.zeros((batch, H, P), dtype=torch.float32, device=device)

    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, H, P), M_INIT, dtype=torch.float32, device=device)}


def slstm_step(p, u, state, cfg: ModelConfig):
    return slstm_apply(p, u, cfg, state)
