"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Attention appears once per 8-layer period (offset 4, as in the paper's
block); MoE replaces the MLP on every other layer.  Mamba1 state=16.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4_096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab_size=65_536,
        head_dim=128,
        mlp_kind="swiglu",
        n_experts=16,
        top_k=2,
        moe_every=2,
        moe_offset=1,
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        attn_period=8,
        attn_offset=4,
        use_rope=False,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="jamba-v0.1-52b-smoke",
        n_layers=8,          # one full period: 1 attn + 7 mamba, 4 MoE layers
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=4,
        top_k=2,
        ssm_state=4,
    )
