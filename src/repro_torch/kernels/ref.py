"""Plain PyTorch versions of the attention kernels (the counterparts of
``repro/kernels/ref.py``'s oracles): K2 is held against
:func:`attention_ref`, K3 against :func:`decode_ref`.

They compute in float32 and cast back to ``q.dtype``, mask with
``NEG_INF = -1e30`` as the reference does (not ``-inf``), and run on any
device.  The kernel wrappers use them for tensors on the CPU only; on the
serving path with a card nothing calls them.  The mamba oracle belongs to
K4's slice.
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
