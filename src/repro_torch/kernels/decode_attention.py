"""K3 — flash decode (one query token against a KV cache), hand-written
for Hopper.

The counterpart of ``repro/kernels/decode_attention.py`` (the Pallas TPU
kernel): :func:`flash_decode_bhsd` takes q ``[B, nq, 1, hd]``, caches k, v
``[B, nkv, S, hd]`` and ``pos``, the last valid position (inclusive), and
returns ``[B, nq, 1, hd]`` in q's dtype.  ``pos`` is a host integer passed
to the kernel as an argument, never a device tensor read back.  Given CUDA
tensors the wrapper checks them, launches ``csrc/decode_attention.cu`` on
the current stream, raises on a CUDA error, and counts the launch in
``stats["launches"]``; given CPU tensors it runs the plain version,
:func:`ref.decode_ref`.  The shape contract is the reference's:
``S % min(block_k, S) == 0``.

No model calls it: the reference's ``decode_attention`` takes the plain
path, and so does the port's.
"""
from __future__ import annotations

from typing import Union

import torch

from ..obs import default_registry
from . import _build, ref
from .flash_attention import DTYPES, check_cuda_inputs, scale_f32, stream

NEG_INF = ref.NEG_INF

#: ``launches``: kernel launches (CUDA tensors only).
stats = default_registry().group("decode_attention", ("launches",))

_P, _I, _F = _build._P, _build._I, _build._F
_build.register(
    "decode_attention",
    {"flash_decode_fwd": (_P, _P, _P, _P) + (_I,) * 17 + (_F, _P)},
)


def flash_decode_bhsd(
    q: torch.Tensor,            # [B, nq, 1, hd]
    k: torch.Tensor,            # [B, nkv, S, hd]
    v: torch.Tensor,            # [B, nkv, S, hd]
    pos: Union[int, torch.Tensor],  # last valid position
    *,
    block_k: int = 512,
) -> torch.Tensor:
    b, nq, one, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    if nkv == 0 or nq % nkv:
        raise ValueError(f"nq={nq} is not a multiple of nkv={nkv}")
    bk = min(block_k, sk)
    if bk <= 0 or sk % bk:
        raise ValueError(f"S={sk} is not a multiple of its block {bk}")
    if q.device.type == "cpu":
        return ref.decode_ref(q, k, v, pos)
    if torch.is_tensor(pos) and pos.device.type != "cpu":
        raise ValueError("pos must be a host integer, not a device tensor")
    pos = int(pos)
    check_cuda_inputs("flash_decode", q, k=k, v=v)
    if one != 1 or tuple(k.shape) != (b, nkv, sk, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} are not a decode step")
    out = torch.empty_like(q)
    err = _build.library("decode_attention").flash_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, nq, nkv, sk, hd, DTYPES[q.dtype], *q.stride()[:2],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:2], pos,
        scale_f32(hd), stream(q.device),
    )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    stats["launches"] += 1
    return out
