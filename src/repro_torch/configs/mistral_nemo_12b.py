"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5_120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab_size=131_072,
        head_dim=128,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="mistral-nemo-12b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
    )
