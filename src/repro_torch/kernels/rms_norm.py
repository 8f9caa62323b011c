"""RMSNorm as one hand-written kernel for Hopper.

The reference normalises with a chain of jnp ops that XLA fuses into one
pass; the port's plain version, :func:`ref.rms_norm_ref`, is the same chain
in PyTorch, nine kernels that each read or write a float32 copy of the
activation.  :func:`rms_norm_rows` does the chain's arithmetic over the last
dimension in one pass (``csrc/rms_norm.cu``): each row read once and written
once, the sum of squares and both multiplies in float32, the output rounded
once to x's dtype.  Given CUDA tensors it launches the kernel on the current
stream, raises on a CUDA error, and counts the launch in
``stats["launches"]``.  Given CPU tensors it runs the plain version; given
``meta`` tensors it returns an output of x's shape and runs nothing.

x and the weight are float32 or bfloat16, each its own; the output is
contiguous, of x's shape and dtype.  A non-contiguous x is copied first.
Rows of at most :data:`MAX_ROW_BYTES` of x are held in registers whole.
"""
from __future__ import annotations

import torch

from ..obs import default_registry
from . import _build, ref
from .flash_attention import DTYPES, stream

#: The widest row the kernel holds in registers: 512 threads × 8 packs of 16 bytes.
MAX_ROW_BYTES = 512 * 8 * 16

#: ``launches``: kernel launches (CUDA tensors only).
stats = default_registry().group("rms_norm", ("launches",))

_P, _I, _F = _build._P, _build._I, _build._F
_build.register("rms_norm", {"rms_norm_fwd": (_P, _P, _P) + (_I,) * 5 + (_F, _P)})


def rms_norm_rows(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of ``x [..., width]`` with ``weight [width]``."""
    if x.device.type == "cpu":
        return ref.rms_norm_ref(x, weight, eps)
    if x.device.type == "meta":
        return x.new_empty(x.shape)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rms_norm: x on {x.device}, weight on {weight.device}: only CPU "
                         "(plain version), meta (shapes only) and one CUDA device (kernel)")
    for key, t in (("x", x), ("weight", weight)):
        if t.dtype not in DTYPES:
            raise TypeError(f"rms_norm: {key}'s dtype {t.dtype} is not float32 or bfloat16")
    width = x.shape[-1]
    if tuple(weight.shape) != (width,):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not match x's last "
                         f"dimension {width}")
    if width * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"rms_norm: a row of {width} elements is wider than "
                         f"{MAX_ROW_BYTES} bytes")
    x, weight = x.contiguous(), weight.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    pack = 16 // x.element_size()
    w_align = min(16, pack * weight.element_size())
    vec = width % pack == 0 and x.data_ptr() % 16 == 0 and weight.data_ptr() % w_align == 0
    err = _build.library("rms_norm").rms_norm_fwd(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.numel() // width, width,
        DTYPES[x.dtype], DTYPES[weight.dtype], int(vec), float(eps), stream(x.device),
    )
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    stats["launches"] += 1
    return out
