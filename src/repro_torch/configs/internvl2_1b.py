"""internvl2-1b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The vision frontend
is a STUB per the assignment: ``input_specs()`` provides precomputed patch
embeddings (``n_vision_tokens`` × d_model) prepended to the text sequence;
the LM backbone below is fully real.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151_655,
        head_dim=64,
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        n_vision_tokens=256,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="internvl2-1b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_vision_tokens=8,
    )
