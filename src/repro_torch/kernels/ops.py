"""Public wrappers around the hand-written kernels, in the model's layout.

The model code calls the attention wrappers with ``[B, S, H, hd]``
tensors; they hand the kernels ``[B, H, S, hd]`` views (transposes, no
copies) and return the model's layout, with the reference's keyword
arguments.  :func:`mamba_scan` picks the scan's blocks as the reference
does and runs it as an autograd function, so that a train step through it
fails loudly instead of losing the gradient below it.  CUDA tensors go to
the kernels and CPU tensors to their plain versions; the choice is made by
the tensors' device alone.

Each wrapper counts its work by formula in the active
:class:`cost.CostCounter` (``cost.formula_region``: a null context, the
formula not evaluated, when no counter is active), on every device: the
kernel on the card, the plain version on the CPU, and on ``meta``
tensors, where it returns an output of the right shape and runs nothing.  The attention formulas are
what the counter gives for the plain versions (``ref.attention_ref``,
``ref.decode_ref``) on contiguous ``[B, H, S, hd]`` tensors of the same
shapes; the scan's is ``hlo_analysis.ssm_scan_addendum``'s per layer.
"""
from __future__ import annotations

import torch

from . import cost
from .decode_attention import flash_decode_bhsd
from .flash_attention import flash_attention_bhsd
from .mamba_scan import mamba_scan_blocked


def attention_cost(b: int, nq: int, nkv: int, sq: int, sk: int, hd: int,
                   dtype: torch.dtype, causal: bool, decode: bool = False):
    """→ (FLOPs, bytes) that :class:`cost.CostCounter` counts for
    ``ref.attention_ref`` (``decode``: ``ref.decode_ref`` at an integer
    ``pos``) on contiguous tensors of these shapes: the casts to float32
    and back, two batched products, the scale, the mask and its
    ``where``, and the softmax."""
    q_el, kv_el, s_el = b * nq * sq * hd, b * nkv * sk * hd, b * nq * sq * sk
    e = dtype.itemsize
    cast = dtype != torch.float32
    flops = 4 * s_el * hd + s_el + 4 * s_el                   # products, scale, softmax
    nbytes = 2 * (4 * q_el + 4 * kv_el + 4 * s_el) + 8 * s_el + 8 * s_el
    if cast:                                                   # q, k, v up; out down
        flops += 2 * q_el + 2 * kv_el
        nbytes += (e + 4) * (2 * q_el + 2 * kv_el)
    if causal or decode:                                       # mask, scalar, where
        mask = sk if decode else sq * sk
        flops += mask + s_el
        nbytes += 4 + mask + 8 * s_el + 4
        nbytes += 16 * sk + mask if decode else 16 * (sk + sq) + mask   # arange, le
    else:
        nbytes += 8 * sk                                       # the key positions
    return flops, nbytes


def flash_attention(
    q: torch.Tensor,            # [B, S, nq, hd]
    k: torch.Tensor,            # [B, S, nkv, hd]
    v: torch.Tensor,            # [B, S, nkv, hd]
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    b, sq, nq, hd = q.shape
    with cost.formula_region("flash_attention", attention_cost,
                             b, nq, k.shape[2], sq, k.shape[1], hd, q.dtype, causal):
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
    b, _, nq, hd = q.shape
    with cost.formula_region("flash_decode", attention_cost,
                             b, nq, k_cache.shape[2], 1, k_cache.shape[1], hd, q.dtype, False, True):
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
    with cost.formula_region("mamba_scan", scan_cost, x.shape[0], s, d_in, a.shape[-1]):
        return _MambaScan.apply(
            *(t.contiguous() for t in (x, dt, a, b_mat, c_mat)), bd, ck
        )


def scan_cost(b: int, s: int, d_in: int, n: int, backward: bool = False):
    """→ (FLOPs, bytes) of the selective scan over ``b × s`` steps of
    ``d_in`` channels and ``n`` states: 6 FLOPs and 16 bytes a step,
    channel and state forward (``ssm_scan_addendum``'s share of one
    layer), twice that for the backward."""
    el = b * s * d_in * n * (2 if backward else 1)
    return 6 * el, 16 * el
