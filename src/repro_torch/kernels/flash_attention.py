"""K2 — fused causal GQA flash attention, hand-written for Hopper.

The counterpart of ``repro/kernels/flash_attention.py`` (the Pallas TPU
kernel): :func:`flash_attention_bhsd` takes q ``[B, nq, S, hd]`` and k, v
``[B, nkv, S, hd]`` and returns ``[B, nq, S, hd]`` in q's dtype.  Given CUDA
tensors it checks them, launches ``csrc/flash_attention.cu`` on the current
stream, raises on a CUDA error, and counts the launch in
``stats["launches"]``.  Given CPU tensors it runs the plain version,
:func:`ref.attention_ref`; nothing else selects it, and no failure on the
card falls back to it.  Given ``meta`` tensors it returns an output of
the right shape and runs nothing (``kernels/cost.py`` counts a step there).

The wrapper keeps the reference's shape contract — ``nq % nkv == 0`` and
``S % min(block, S) == 0`` for both block sizes — so the same calls succeed
and fail on both packages, whatever tiling the CUDA kernel uses inside.
The kernel takes float32 or bfloat16 and head dims 64 and 128; inputs may
be strided in batch, head and sequence (the head dim contiguous), so the
model's ``[B, S, H, hd]`` tensors go in as transposed views without a copy,
and the output takes q's layout.  The bfloat16 path loads by TMA, which
needs 16-byte aligned base addresses and strides: the wrapper raises a
``ValueError`` on any other (the model's tensors always are aligned).
"""
from __future__ import annotations


import numpy as np
import torch

from ..obs import default_registry
from . import _build, ref

NEG_INF = ref.NEG_INF
HEAD_DIMS = (64, 128)
#: Keys per tile of the bfloat16 (tensor-core) path, ``kTile`` in its source:
#: it rounds each tile's probabilities against the running row max, as
#: ``ref.attention_ref(..., p_dtype=torch.bfloat16, p_block=KEY_TILE_BF16)``.
KEY_TILE_BF16 = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: ``launches``: kernel launches (CUDA tensors only).
stats = default_registry().group("flash_attention", ("launches",))

_P, _I, _F = _build._P, _build._I, _build._F
_build.register(
    "flash_attention",
    {"flash_attention_fwd": (_P, _P, _P, _P) + (_I,) * 19 + (_F, _I, _P)},
)


def check_cuda_inputs(name: str, q: torch.Tensor, **others) -> None:
    """q and the ``others`` on one CUDA device, of one dtype the kernels
    take, with a contiguous head dim the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {q.device}: only CPU (plain "
                         "version), meta (shapes only) and CUDA (kernel) are supported")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} is not float32 or bfloat16")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} is not one of {HEAD_DIMS}")
    for key, t in others.items():
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
    for key, t in dict(q=q, **others).items():
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {key}'s head dim is not contiguous")


def check_aligned(name: str, **tensors) -> None:
    """Base addresses and batch, head and sequence strides that are whole
    multiples of 16 bytes, as TMA and 16-byte vector loads need."""
    for key, t in tensors.items():
        elt = t.element_size()
        if t.data_ptr() % 16 or any(st * elt % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}: {key}'s base address or strides are not "
                             "16-byte aligned")


def scale_f32(hd: int) -> float:
    """``1 / sqrt(hd)`` as the reference applies it to float32 q."""
    return float(np.float32(1.0 / (hd ** 0.5)))


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention_bhsd(
    q: torch.Tensor,            # [B, nq, S, hd]
    k: torch.Tensor,            # [B, nkv, S, hd]
    v: torch.Tensor,            # [B, nkv, S, hd]
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    b, nq, sq, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    if nkv == 0 or nq % nkv:
        raise ValueError(f"nq={nq} is not a multiple of nkv={nkv}")
    bq, bk = min(block_q, sq), min(block_k, sk)
    if bq <= 0 or bk <= 0 or sq % bq or sk % bk:
        raise ValueError(f"S={sq}/{sk} is not a multiple of its block {bq}/{bk}")
    if q.device.type in ("cpu", "meta"):  # the output takes q's layout, as the kernel's
        out = torch.empty_like(q)
        return out if q.device.type == "meta" else out.copy_(
            ref.attention_ref(q, k, v, causal=causal))
    check_cuda_inputs("flash_attention", q, k=k, v=v)
    if tuple(k.shape) != (b, nkv, sk, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q.dtype == torch.bfloat16:
        check_aligned("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)  # q's layout: a transposed view stays one
    err = _build.library("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, nq, nkv, sq, sk, hd, DTYPES[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        scale_f32(hd), int(causal), stream(q.device),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    stats["launches"] += 1
    return out
