"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12_288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=28_672,
        vocab_size=32_768,
        head_dim=128,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="mistral-large-123b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
    )
