"""Public wrappers around the hand-written attention kernels, in the
model's layout.

The model code calls these with ``[B, S, H, hd]`` tensors; the wrappers
hand the kernels ``[B, H, S, hd]`` views (transposes, no copies) and
return the model's layout, with the reference's keyword arguments.  CUDA
tensors go to the kernels and CPU tensors to their plain versions; the
choice is made by the tensors' device alone.
"""
from __future__ import annotations

import torch

from .decode_attention import flash_decode_bhsd
from .flash_attention import flash_attention_bhsd


def flash_attention(
    q: torch.Tensor,            # [B, S, nq, hd]
    k: torch.Tensor,            # [B, S, nkv, hd]
    v: torch.Tensor,            # [B, S, nkv, hd]
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    out = flash_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, block_q=block_q, block_k=block_k,
    )
    return out.transpose(1, 2)


def flash_decode(
    q: torch.Tensor,            # [B, 1, nq, hd]
    k_cache: torch.Tensor,      # [B, S, nkv, hd]
    v_cache: torch.Tensor,      # [B, S, nkv, hd]
    pos,                        # last valid position (host integer)
    block_k: int = 512,
) -> torch.Tensor:
    out = flash_decode_bhsd(
        q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        pos, block_k=block_k,
    )
    return out.transpose(1, 2)


def mamba_scan(*args, **kwargs):
    raise NotImplementedError(
        "mamba_scan is K4, not ported yet: ROADMAP.md §1 queue item 1 "
        "(the training slice, falcon-mamba-7b loss through ssm_impl='pallas')"
    )
