"""Model configuration: one dataclass covers all 10 assigned families."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // num_heads

    # attention pattern
    rope_theta: float = 10_000.0
    global_rope_theta: float = 0.0        # gemma3 global layers (0 -> same)
    window: int | None = None             # sliding window for *all* attn layers
    local_window: int = 0                 # gemma3: window of local layers
    global_every: int = 0                 # gemma3: every k-th layer is global

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                     # expert hidden (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_impl: str = "dense"               # dense (GSPMD) | shard_map (explicit EP)

    # SSM / hybrid (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0                    # 0 -> d_inner // 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    shared_attn_every: int = 0            # zamba2: shared attn block period

    # xLSTM
    slstm_every: int = 0                  # every k-th block is sLSTM

    # encoder-decoder (whisper) / vlm
    enc_layers: int = 0
    enc_seq: int = 0                      # encoder frame count (stub frontend)
    num_patches: int = 0                  # vlm: vision prefix length (stub)

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    tie_embeddings: bool = False

    # runtime knobs (overridable per experiment — hillclimb levers)
    remat_policy: str = "full"            # full | dots | none
    attn_impl: str = "chunked"            # chunked | ref | pallas
    attn_chunk: int = 1024
    seq_parallel: bool = False            # shard activations' seq dim (SP)
    scan_layers: bool = True
    attn_p_dtype: str = "float32"         # probability-matrix dtype in chunked attn
    slstm_bf16: bool = False              # sLSTM recurrent matmul in bf16
    slstm_unroll: int = 1                 # unroll factor of the sLSTM time scan

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:             # mamba2
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def layer_kinds(self) -> tuple[int, ...]:
        """Per-layer kind vector consumed as scan xs.

        dense/moe: 0 = full attn, 1 = local/windowed (gemma3), shared-attn
        period for zamba2 handled in the hybrid block (kind = 1 on slots that
        also run the shared attention block); xlstm: 1 = sLSTM slot.
        """
        L = self.num_layers
        if self.global_every:             # gemma3: every k-th is global (0-idx k-1)
            return tuple(0 if (i % self.global_every == self.global_every - 1) else 1
                         for i in range(L))
        if self.shared_attn_every:        # zamba2
            return tuple(1 if (i % self.shared_attn_every == self.shared_attn_every - 1) else 0
                         for i in range(L))
        if self.slstm_every:              # xlstm
            return tuple(1 if (i % self.slstm_every == self.slstm_every - 1) else 0
                         for i in range(L))
        return tuple(0 for _ in range(L))

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (reported in configs / roofline)."""
        D, V, L = self.d_model, self.vocab_size, self.num_layers
        n = V * D  # embed
        if not self.tie_embeddings:
            n += D * V
        hd = self.resolved_head_dim
        attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        if self.family == "ssm":
            # mLSTM block params (approx): qkv + gates + out
            di = 2 * D
            blk = D * di * 2 + di * D + D * di // 2 + 4 * di
            n += L * blk
            return n
        if self.family == "hybrid":
            di = self.d_inner
            H = self.resolved_ssm_heads
            mamba = D * (2 * di + 2 * self.ssm_state * 2 + H) + di * D + di * 4
            n += L * mamba + attn + 3 * D * self.d_ff  # one shared attn+mlp
            return n
        mlp = 3 * D * self.d_ff
        if self.num_experts:
            eff = self.moe_d_ff or self.d_ff
            mlp = self.num_experts * 3 * D * eff + D * self.num_experts
        n += L * (attn + mlp)
        if self.enc_layers:
            n += self.enc_layers * (attn + 3 * D * self.d_ff)  # encoder
            n += L * attn                                      # cross attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only) for 6ND flops."""
        if not self.num_experts:
            return self.param_count()
        D, L = self.d_model, self.num_layers
        eff = self.moe_d_ff or self.d_ff
        dense_mlp = self.num_experts_per_tok * 3 * D * eff
        full_mlp = self.num_experts * 3 * D * eff
        return self.param_count() - L * full_mlp + L * dense_mlp
