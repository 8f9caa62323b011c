"""Public wrappers around the hand-written kernels, in the model's layout.

The model code calls the attention wrappers with ``[B, S, H, hd]``
tensors; they hand the kernels ``[B, H, S, hd]`` views (transposes, no
copies) and return the model's layout, with the reference's keyword
arguments.  :func:`mamba_scan` picks the scan's blocks as the reference
does and runs it as an autograd function, so that a train step through it
fails loudly instead of losing the gradient below it.  CUDA tensors go to
the kernels and CPU tensors to their plain versions; the choice is made by
the tensors' device alone.
"""
from __future__ import annotations

import torch

from .decode_attention import flash_decode_bhsd
from .flash_attention import flash_attention_bhsd
from .mamba_scan import mamba_scan_blocked


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


class _MambaScan(torch.autograd.Function):
    """K4 with no backward, as in the reference: ``jax.grad`` through its
    Pallas call fails too.  A bare kernel call would return a tensor with
    no ``grad_fn`` and silently cut the gradient of every layer below it;
    this one raises when a backward reaches it."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, block_d, chunk):
        return mamba_scan_blocked(x, dt, a, b_mat, c_mat, block_d=block_d, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y):
        raise NotImplementedError(
            "mamba_scan (K4) has no backward: the reference has no gradient "
            "through its Pallas scan either (jax.grad fails in pallas_call's "
            "JVP rule); train with ssm_impl='xla'"
        )


def mamba_scan(
    x: torch.Tensor,            # [B, S, d_in] f32
    dt: torch.Tensor,
    a: torch.Tensor,            # [d_in, N] f32
    b_mat: torch.Tensor,        # [B, S, N]
    c_mat: torch.Tensor,
    block_d: int = 512,
    chunk: int = 256,
) -> torch.Tensor:
    d_in, s = x.shape[-1], x.shape[1]
    bd = block_d
    while d_in % bd:
        bd //= 2
    ck = chunk
    while s % ck:
        ck //= 2
    return _MambaScan.apply(
        *(t.contiguous() for t in (x, dt, a, b_mat, c_mat)), bd, ck
    )
