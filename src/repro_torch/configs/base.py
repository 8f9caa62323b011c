"""Model / run configuration shared by every assigned architecture.

A single frozen dataclass describes all families (dense / MoE / hybrid /
SSM / enc-dec / VLM).  Family-specific fields default to "off".  Exact
per-arch values live in ``repro/configs/<arch>.py``; every arch also ships a
``smoke()`` reduction used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free archs)
    n_kv_heads: int
    d_ff: int                        # dense-MLP width (per-expert width for MoE)
    vocab_size: int

    head_dim: int = 0                # 0 → d_model // n_heads
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q/k
    mlp_kind: str = "swiglu"         # swiglu | gelu
    use_rope: bool = True            # jamba/whisper: no rotary embeddings
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # a layer is MoE iff layer % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    # --- SSM (mamba1) -------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: int = 0                 # 0 → ceil(d_model / 16)

    # --- hybrid (jamba) ------------------------------------------------------
    attn_period: int = 0             # 1 attention layer per this many (0 = n/a)
    attn_offset: int = 0             # index of the attn layer within a period

    # --- encoder-decoder (whisper) -------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0                 # encoder positions (whisper-base: 1500)

    # --- modality stubs -------------------------------------------------------
    n_vision_tokens: int = 0         # vlm: precomputed patch embeddings prepended

    # --- numerics / implementation selection ---------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "xla"           # xla | pallas (TPU fused kernel)
    attn_chunk: int = 512            # q-chunk for the XLA path (0 = unchunked)
    ssm_impl: str = "xla"            # xla | pallas
    moe_impl: str = "gather"         # gather | a2a (shard_map expert-parallel)
    remat: bool = True               # checkpoint each layer in train_step
    scan_layers: bool = True         # lax.scan over the layer stack

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads, f"{self.name}: head_dim undefined for attn-free arch"
        return self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def is_moe_layer(self, layer: int) -> bool:
        return (
            self.n_experts > 0 and layer % max(self.moe_every, 1) == self.moe_offset
        )

    def is_attn_layer(self, layer: int) -> bool:
        """hybrid: which layers are attention (the rest are mamba)."""
        if self.family == "ssm":
            return False
        if self.family != "hybrid":
            return True
        return layer % self.attn_period == self.attn_offset

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- analytic parameter / FLOP accounting (roofline §Roofline) -----------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    return q + kv + o


def _mlp_params(cfg: ModelConfig, width: int) -> int:
    mult = 3 if cfg.mlp_kind == "swiglu" else 2
    return mult * cfg.d_model * width


def _mamba_params(cfg: ModelConfig) -> int:
    d_in, n, r = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    return (
        cfg.d_model * 2 * d_in            # in_proj
        + d_in * cfg.ssm_conv             # depthwise conv
        + d_in * (r + 2 * n)              # x_proj
        + r * d_in                        # dt_proj
        + d_in * n + d_in                 # A_log, D
        + d_in * cfg.d_model              # out_proj
    )


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model  # lm head
    layers = cfg.n_layers + cfg.n_enc_layers
    for l in range(cfg.n_layers):
        if cfg.is_attn_layer(l):
            total += _attn_params(cfg)
        else:
            total += _mamba_params(cfg)
        if cfg.is_moe_layer(l):
            e = cfg.top_k if active_only else cfg.n_experts
            total += e * _mlp_params(cfg, cfg.d_ff) + cfg.d_model * cfg.n_experts
        else:
            total += _mlp_params(cfg, cfg.d_ff)
    for _ in range(cfg.n_enc_layers):  # whisper encoder (self-attn + mlp)
        total += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    if cfg.n_enc_layers:  # decoder cross-attention
        total += cfg.n_layers * _attn_params(cfg)
    return total


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
