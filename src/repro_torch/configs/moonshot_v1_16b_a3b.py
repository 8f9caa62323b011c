"""moonshot-v1-16b-a3b [moe] — kimi/moonlight [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (MHA kv=16) d_ff=1408 (per expert) vocab=163840,
MoE 64 experts top-6 on every layer.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2_048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1_408,
        vocab_size=163_840,
        head_dim=128,
        mlp_kind="swiglu",
        rope_theta=50_000.0,
        n_experts=64,
        top_k=6,
        moe_every=1,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="moonshot-v1-16b-a3b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        n_experts=8,
        top_k=2,
    )
