"""Architecture registry — every assigned arch is selectable via ``--arch``.

``get_config(name)`` returns the exact published configuration;
``get_config(name, smoke=True)`` returns the reduced same-family variant the
CPU smoke tests instantiate for a real forward/train step.
"""
from __future__ import annotations

from typing import Dict, List

from .base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    ShapeSpec,
)
from . import (
    falcon_mamba_7b,
    internvl2_1b,
    jamba_v01_52b,
    mistral_large_123b,
    mistral_nemo_12b,
    moonshot_v1_16b_a3b,
    phi35_moe_42b,
    qwen3_32b,
    starcoder2_3b,
    whisper_base,
)

_MODULES = {
    "internvl2-1b": internvl2_1b,
    "mistral-large-123b": mistral_large_123b,
    "starcoder2-3b": starcoder2_3b,
    "qwen3-32b": qwen3_32b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "jamba-v0.1-52b": jamba_v01_52b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "whisper-base": whisper_base,
    "falcon-mamba-7b": falcon_mamba_7b,
}

ARCH_NAMES: List[str] = list(_MODULES)

# Sub-quadratic archs run the long_500k cell; pure full-attention archs skip
# it (DESIGN.md §5).
LONG_CONTEXT_ARCHS = {"jamba-v0.1-52b", "falcon-mamba-7b"}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.full()


def shapes_for(name: str) -> List[ShapeSpec]:
    """The assigned shape cells an arch actually runs (skips per DESIGN.md)."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if name in LONG_CONTEXT_ARCHS:
        shapes.append(LONG_500K)
    return shapes


def all_cells() -> List[tuple]:
    return [(a, s) for a in ARCH_NAMES for s in shapes_for(a)]


__all__ = [
    "ALL_SHAPES",
    "ARCH_NAMES",
    "LONG_CONTEXT_ARCHS",
    "ModelConfig",
    "ShapeSpec",
    "all_cells",
    "get_config",
    "shapes_for",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
]
