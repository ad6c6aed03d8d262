"""Architecture configuration schema.

Every assigned architecture is expressed as an :class:`ArchConfig`. The config
is the *workload* half of a SECDA-DSE design point; the *plan* half
(sharding / remat / tiling) lives in ``repro_torch.core.design_space``.

Configs are frozen dataclasses so they can be hashed into cost-DB keys.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts layer spec (token-choice top-k, grouped capacity)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Tokens are partitioned into groups of this size; expert capacity is
    # per-group (bounds the dispatch one-hot to group_size**2 * top_k * cf).
    group_size: int = 64

    def capacity(self) -> int:
        cap = int(self.top_k * self.group_size * self.capacity_factor) // self.n_experts
        return max(cap, 1)


@dataclass(frozen=True)
class SSMSpec:
    """Mamba2 / SSD block spec."""

    d_state: int
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # defaults to d_model // n_heads
    qk_norm: bool = False
    swa_window: Optional[int] = None  # sliding-window attention width
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    # hybrid (zamba2): run a single *shared* attention+MLP block every k
    # mamba layers, with per-invocation LoRA deltas on its projections.
    hybrid_attn_every: Optional[int] = None
    hybrid_lora_rank: int = 64
    # encoder-decoder (seamless): n_layers is the decoder depth.
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: "patches" (vlm) / "frames" (audio). input_specs
    # provides precomputed embeddings of this many positions.
    frontend: Optional[str] = None
    frontend_len: int = 0
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    def attention_free(self) -> bool:
        return self.family == "ssm"

    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token context? (SSM / hybrid / bounded SWA)."""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks); used for MODEL_FLOPS."""
        d, dh = self.d_model, self.head_dim()
        p = self.vocab * d  # embedding
        if not self.tie_embeddings:
            p += self.vocab * d  # lm head

        def attn_params() -> int:
            q = d * self.n_heads * dh
            kv = 2 * d * self.n_kv_heads * dh
            o = self.n_heads * dh * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gated SwiGLU

        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            per = (
                d * (2 * di + 2 * s.d_state + nh)  # in_proj -> (z, x, B, C, dt)
                + s.conv_width * (di + 2 * s.d_state)
                + di * d  # out_proj
                + 2 * nh  # A_log, D
            )
            return p + self.n_layers * per
        if self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            per = (
                d * (2 * di + 2 * s.d_state + nh)
                + s.conv_width * (di + 2 * s.d_state)
                + di * d
                + 2 * nh
            )
            p += self.n_layers * per
            p += attn_params() + mlp_params(self.d_ff)  # one shared block
            n_uses = self.n_layers // (self.hybrid_attn_every or self.n_layers)
            r = self.hybrid_lora_rank
            p += n_uses * r * (4 * d + self.n_heads * dh + 2 * self.n_kv_heads * dh + 2 * self.d_ff)
            return p
        per = attn_params()
        if self.moe is not None:
            per += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            per += d * self.moe.n_experts  # router
        else:
            per += mlp_params(self.d_ff)
        per += 2 * d  # norms
        n_blocks = self.n_layers + (self.n_enc_layers if self.enc_dec else 0)
        if self.enc_dec:
            per += attn_params()  # cross attention (decoder side, approx)
        return p + n_blocks * per

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        d = self.d_model
        moe_all = self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        moe_active = self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return full - moe_all + moe_active


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assigned grid."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else cfg.n_kv_heads,
        d_ff=128,
        vocab=256,
        d_head=16,
        frontend_len=8 if cfg.frontend else 0,
    )
    if cfg.moe is not None:
        small["moe"] = replace(cfg.moe, n_experts=4, top_k=2, d_ff_expert=64, group_size=16)
    if cfg.ssm is not None:
        small["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.hybrid_attn_every:
        small["hybrid_attn_every"] = 2
        small["hybrid_lora_rank"] = 4
    if cfg.enc_dec:
        small["n_enc_layers"] = 2
    if cfg.swa_window:
        small["swa_window"] = 16
    small["dtype"] = "float32"
    small.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **small)
