"""falcon-mamba-7b [ssm] — pure mamba1 stack, attention-free [arXiv:2410.05355].

64L d_model=4096, d_ff=0 (no MLP blocks — each layer is a single mamba1
block), vocab=65024, ssm_state=16, expand=2 (d_inner=8192), conv=4,
dt_rank=256.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4_096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=65_024,
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        dt_rank=256,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="falcon-mamba-7b-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        ssm_state=4,
        dt_rank=8,
    )
