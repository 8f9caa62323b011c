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
:func:`ref.decode_ref`; given ``meta`` tensors, an output of the right
shape.  The shape contract is the reference's:
``S % min(block_k, S) == 0``.  The caches are read by 16-byte vector
loads, so their base addresses and strides must be 16-byte aligned.

The kernel is a split-key decode: the live keys ``[0, pos]`` go in
:func:`split_plan`'s chunks, one block per (chunk, kv head, batch) writes
float32 partials to a scratch tensor this wrapper allocates, and a second
kernel merges them (:func:`ref.decode_split_ref` is the same arithmetic in
plain torch).  One wrapper call launches both and counts once.

No model calls it: the reference's ``decode_attention`` takes the plain
path, and so does the port's.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from ..obs import default_registry
from . import _build, ref
from .flash_attention import DTYPES, check_aligned, check_cuda_inputs, scale_f32, stream

NEG_INF = ref.NEG_INF

#: ``launches``: kernel launches (CUDA tensors only).
stats = default_registry().group("decode_attention", ("launches",))

_P, _I, _F = _build._P, _build._I, _build._F
_build.register(
    "decode_attention",
    {"flash_decode_fwd": (_P,) * 5 + (_I,) * 19 + (_F, _P)},
)

#: Keys per chunk are a multiple of this.
CHUNK_GRANULE = 16

def split_plan(live: int, rows: int, sms: int) -> Tuple[int, int]:
    """``(splits, chunk)`` for ``live`` keys over ``rows`` (batch x kv head)
    blocks of keys: chunks of a multiple of :data:`CHUNK_GRANULE` keys, as
    many as give at least two blocks per SM where the keys allow it."""
    if live <= 0:
        return 1, CHUNK_GRANULE
    want = -(-2 * sms // rows)
    chunk = max(CHUNK_GRANULE, live // want // CHUNK_GRANULE * CHUNK_GRANULE)
    return -(-live // chunk), chunk


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
    if q.device.type in ("cpu", "meta"):  # the output takes q's layout, as the kernel's
        out = torch.empty_like(q)
        return out if q.device.type == "meta" else out.copy_(ref.decode_ref(q, k, v, pos))
    if torch.is_tensor(pos) and pos.device.type != "cpu":
        raise ValueError("pos must be a host integer, not a device tensor")
    pos = int(pos)
    check_cuda_inputs("flash_decode", q, k=k, v=v)
    if one != 1 or tuple(k.shape) != (b, nkv, sk, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} are not a decode step")
    check_aligned("flash_decode", k=k, v=v)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, chunk = split_plan(min(pos + 1, sk), b * nkv, sms)
    out = torch.empty_like(q)
    part = torch.empty((b, nq, splits, hd + 2), dtype=torch.float32, device=q.device)
    err = _build.library("decode_attention").flash_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
        b, nq, nkv, sk, hd, DTYPES[q.dtype], *q.stride()[:2],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:2], pos, splits, chunk,
        scale_f32(hd), stream(q.device),
    )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    stats["launches"] += 1
    return out
