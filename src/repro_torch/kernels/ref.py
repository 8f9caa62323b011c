"""Plain PyTorch versions of the kernels (the counterparts of
``repro/kernels/ref.py``'s oracles): K2 is held against
:func:`attention_ref`, K3 against :func:`decode_ref`, K4 against
:func:`mamba_scan_ref`.

The attention oracles compute in float32 and cast back to ``q.dtype``, and
mask with ``NEG_INF = -1e30`` as the reference does (not ``-inf``).  The
mamba oracle is a Python loop over time on a ``[B, d_in, N]`` float32
state.  All run on any device.  The kernel wrappers use them for tensors
on the CPU only; on the card's paths nothing calls them.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,            # [B, nq, Sq, hd]
    k: torch.Tensor,            # [B, nkv, Sk, hd]
    v: torch.Tensor,            # [B, nkv, Sk, hd]
    causal: bool = True,
    pos: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    b, nq, sq, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, nkv, g, sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / (hd ** 0.5)
    ki = torch.arange(sk, device=q.device)[None, :]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        s = torch.where(ki <= qi, s, NEG_INF)
    if pos is not None:
        s = torch.where(ki <= pos, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return out.reshape(b, nq, sq, hd).to(q.dtype)


def decode_ref(q, k, v, pos):
    """q [B,nq,1,hd] vs cache [B,nkv,S,hd], valid positions ≤ pos."""
    return attention_ref(q, k, v, causal=False, pos=pos)


def mamba_scan_ref(
    x: torch.Tensor,            # [B, S, d_in] f32
    dt: torch.Tensor,           # [B, S, d_in] f32
    a: torch.Tensor,            # [d_in, N] f32
    b_mat: torch.Tensor,        # [B, S, N] f32
    c_mat: torch.Tensor,        # [B, S, N] f32
) -> torch.Tensor:
    bsz, s, d_in = x.shape
    h = torch.zeros((bsz, d_in, a.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)
        h = da * h + (dt[:, t] * x[:, t])[..., None] * b_mat[:, t, None, :]
        ys.append(torch.einsum("bin,bn->bi", h, c_mat[:, t]))
    return torch.stack(ys, 1)
