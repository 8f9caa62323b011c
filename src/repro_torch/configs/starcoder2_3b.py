"""starcoder2-3b [dense] — GQA + RoPE [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.  StarCoder2 uses a
non-gated GELU MLP (4×d_model).
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3_072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12_288,
        vocab_size=49_152,
        head_dim=128,
        mlp_kind="gelu",
        rope_theta=999_999.0,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="starcoder2-3b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
    )
