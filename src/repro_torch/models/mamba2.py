"""Mamba2 (SSD) mixer: the chunked parallel form for prefill, the
recurrent step for decode.

State-space parameters follow the Mamba2 paper: per-head scalar decay
``a = -exp(A_log)``, input-dependent ``dt`` (softplus), shared (G=1) B / C
projections of size ``ssm_state``.  The JAX package's ``lax.scan`` over
chunks is a Python loop over the ``S / ssm_chunk`` chunks here
(``repeat.scan``); each chunk
is the same products as there (plain ``torch`` products, as the JAX
package leaves them to XLA).  Rounding points are the JAX package's: the
projections in the compute dtype, the scan in float32, the conv tail held
and stepped in float32.

The intra-chunk decay masks before it exponentiates:
``exp(where(causal, cum_i - cum_j, -inf))``.  Above the diagonal
``cum_i - cum_j`` is a chunk's summed log decay, which passes ~88.7 (float32
``exp`` overflows) once a 128-token chunk decays by ~0.69 a step; the JAX
package exponentiates first and masks after, which gives the same forward
(``exp(-inf)`` is the ``where``'s 0) but ``inf * 0 = NaN`` gradients there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import torch_dtype
from .module import Creator
from .repeat import scan

CONV_K = 4


def mamba2_init(c: Creator, cfg: ModelConfig):
    D = cfg.d_model
    di = cfg.d_inner
    H = cfg.resolved_ssm_heads
    N = cfg.ssm_state
    return {
        # order: [z (gate) | x | B | C | dt]
        "in_proj": c("mamba.in", (D, 2 * di + 2 * N + H), ("embed", "heads")),
        "conv": c("mamba.conv", (CONV_K, di + 2 * N), (None, "heads"), scale=0.5),
        "A_log": c("mamba.A", (H,), (None,), scale="zeros"),
        "D": c("mamba.D", (H,), (None,), scale="ones"),
        "dt_bias": c("mamba.dtb", (H,), (None,), scale="zeros"),
        "norm": c("mamba.norm", (di,), (None,), scale="zeros"),
        "out_proj": c("mamba.out", (di, D), ("heads", "embed")),
    }


def _split(p, cfg: ModelConfig, u):
    """in_proj + causal depthwise conv; returns z, x, Bm, Cm, dt, raw xBC."""
    dt_c = torch_dtype(cfg.compute_dtype)
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.resolved_ssm_heads
    proj = u.to(dt_c) @ p["in_proj"].to(dt_c)
    z, xBC_raw, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    k = p["conv"].to(dt_c)
    pad = F.pad(xBC_raw, (0, 0, CONV_K - 1, 0))
    S = xBC_raw.shape[1]
    xBC = F.silu(sum(pad[:, i:i + S] * k[i] for i in range(CONV_K)))
    x, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    return z, x, Bm, Cm, dt, xBC_raw


def _gates(p, dt):
    a = -torch.exp(p["A_log"].float())                         # (H,) negative
    return a, F.softplus(dt.float() + p["dt_bias"].float())    # dt: (B, S, H)


def _tail(p, cfg: ModelConfig, y, z):
    """Gated RMSNorm then out-proj (the block's tail), y float32 (B, S, di)."""
    dt_c = torch_dtype(cfg.compute_dtype)
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-6)
    y = y * (1.0 + p["norm"].float())
    return y.to(dt_c) @ p["out_proj"].to(dt_c)


def _chunk(h, xq, bq, cq, adq, dtq, causal):
    """One chunk of the SSD scan: (B, Q, ...) inputs, state h (B, H, N, P)."""
    cum = torch.cumsum(adq, dim=1)                             # (B, Q, H)
    # intra-chunk: L_ij = exp(cum_i - cum_j), i >= j
    diff = cum[:, :, None] - cum[:, None, :]                   # (B, Q, Q, H)
    Lm = torch.exp(torch.where(causal[None, :, :, None], diff, -torch.inf))
    cb = torch.einsum("bin,bjn->bij", cq, bq)                  # (B, Q, Q)
    w = cb[..., None] * Lm * dtq[:, None]                      # (B, Q, Q, H)
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
    # inter-chunk: contribution of the carried state
    y_inter = torch.einsum("bin,bhnp->bihp", cq, h) * torch.exp(cum)[..., None]
    # state update
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)             # (B, Q, H)
    sb = torch.einsum("bjn,bjh,bjhp->bhnp", bq, dtq * decay_to_end, xq)
    h = h * torch.exp(cum[:, -1])[:, :, None, None] + sb
    return h, y_intra + y_inter


def mamba2_apply(p, u, cfg: ModelConfig, return_state: bool = False):
    """Chunked SSD forward. u: (B, S, D) -> (B, S, D) (+ final state
    ``{"h": (B, H, N, P), "conv": (B, CONV_K - 1, di + 2N)}``, float32)."""
    B_, S, _ = u.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.resolved_ssm_heads
    P = di // H
    Q = cfg.ssm_chunk
    pad = (-S) % Q
    z, x, Bm, Cm, dt, xBC_raw = _split(p, cfg, u)
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bm, Cm))
        # -1e9 -> softplus ~ 0: padded steps neither decay nor feed the state
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
    a, dtf = _gates(p, dt)                                     # dtf (B, S', H)
    Sp = S + pad
    nc = Sp // Q
    xh = x.reshape(B_, nc, Q, H, P).float()
    Bh = Bm.reshape(B_, nc, Q, N).float()
    Ch = Cm.reshape(B_, nc, Q, N).float()
    ad = (a * dtf).reshape(B_, nc, Q, H)                       # log decay per step
    dtc = dtf.reshape(B_, nc, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=u.device)
    h, ys = scan(nc, lambda h, *x: _chunk(h, *x, causal), h, (xh, Bh, Ch, ad, dtc))
    y = ys.reshape(B_, Sp, H, P)[:, :S]
    y = y + xh.reshape(B_, Sp, H, P)[:, :S] * p["D"].float()[:, None]
    out = _tail(p, cfg, y.reshape(B_, S, di), z)
    if return_state:
        tail = xBC_raw[:, -(CONV_K - 1):].float()
        need = CONV_K - 1 - tail.shape[1]
        if need > 0:
            tail = F.pad(tail, (0, 0, need, 0))
        return out, {"h": h, "conv": tail}
    return out


def mamba2_init_state(cfg: ModelConfig, batch: int, device="cuda"):
    H, N = cfg.resolved_ssm_heads, cfg.ssm_state
    P = cfg.d_inner // H
    return {
        "h": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, cfg.d_inner + 2 * N),
                            dtype=torch.float32, device=device),
    }


def mamba2_step(p, u, state, cfg: ModelConfig):
    """Single-token recurrence. u: (B, 1, D). Constant memory in context.
    Returns (out, new state); ``state`` is not written."""
    dt_c = torch_dtype(cfg.compute_dtype)
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.resolved_ssm_heads
    P = di // H
    proj = u.to(dt_c) @ p["in_proj"].to(dt_c)
    z, xBC, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    hist = torch.cat([state["conv"], xBC.float()[:, 0:1]], dim=1)
    k = p["conv"].float()
    xBC = F.silu(sum(hist[:, i] * k[i] for i in range(CONV_K)))   # (B, di + 2N)
    x, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    a, dtf = _gates(p, dt[:, 0])                               # dtf (B, H)
    xh = x.reshape(-1, H, P).float()
    decay = torch.exp(a[None] * dtf)                           # (B, H)
    h = state["h"] * decay[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bm.float(), dtf, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + xh * p["D"].float()[:, None]
    return _tail(p, cfg, y.reshape(-1, 1, di), z), {"h": h, "conv": hist[:, 1:]}
