"""whisper-base [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

6L encoder + 6L decoder, d_model=512 8H (MHA) d_ff=2048 vocab=51865.  The
conv/log-mel frontend is a STUB per the assignment: ``input_specs()`` feeds
precomputed frame embeddings (1500 × d_model, Whisper's 30 s at 50 Hz).
Positions are sinusoidal (no table), so arbitrary decode lengths lower
cleanly; Whisper proper caps the decoder at 448 — the assigned decode_32k
cell exercises the *system* (KV plumbing at 32k), noted in DESIGN.md.
"""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2_048,
        vocab_size=51_865,
        head_dim=64,
        mlp_kind="gelu",
        n_enc_layers=6,
        enc_seq=1_500,
        use_rope=False,
    )


def smoke() -> ModelConfig:
    return full().with_(
        name="whisper-base-smoke",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        enc_seq=32,
    )
