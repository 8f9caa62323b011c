"""qwen3-32b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936; per-head RMSNorm on
q/k (qk_norm) and decoupled head_dim=128.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5_120,
        n_heads=64,
        n_kv_heads=8,
        d_ff=25_600,
        vocab_size=151_936,
        head_dim=128,
        qk_norm=True,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="qwen3-32b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
    )
