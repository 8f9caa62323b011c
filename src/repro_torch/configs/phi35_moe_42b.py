"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 (per expert) vocab=32064,
MoE 16e top-2 on every layer.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4_096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6_400,
        vocab_size=32_064,
        head_dim=128,
        mlp_kind="swiglu",
        rope_theta=10_000.0,
        n_experts=16,
        top_k=2,
        moe_every=1,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="phi3.5-moe-42b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        n_experts=4,
        top_k=2,
    )
