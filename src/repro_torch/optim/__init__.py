from .adamw import AdamW, AdamWState, global_norm
from .schedule import constant, warmup_cosine

__all__ = ["AdamW", "AdamWState", "constant", "global_norm", "warmup_cosine"]
