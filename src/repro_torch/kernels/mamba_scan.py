"""K4 — the mamba1 selective scan, hand-written for Hopper.

The counterpart of ``repro/kernels/mamba_scan.py`` (the Pallas TPU
kernel): :func:`mamba_scan_blocked` takes x, dt ``[B, S, d_in]``, a
``[d_in, N]`` and B, C ``[B, S, N]``, all float32, and returns y ``[B, S,
d_in]`` float32.  Given CUDA tensors it checks them, launches
``csrc/mamba_scan.cu`` on the current stream, raises on a CUDA error, and
counts the launch in ``stats["launches"]``; given CPU tensors it runs the
plain version, :func:`ref.mamba_scan_ref`.  Nothing else selects the
plain version, and no failure on the card falls back to it.

The kernel's arithmetic differs from the plain version's only in its
rounding (exp as ``ex2.approx`` of Δ·(A·log₂e), fused multiply-adds for h
and y, y summed per lane then pairwise across :func:`scan_lanes`' lanes);
:func:`ref.mamba_scan_design_ref` computes that arithmetic on the CPU.

The wrapper keeps the reference's shape contract — ``d_in % min(block_d,
d_in) == 0`` and ``S % min(chunk, S) == 0`` — so the same calls succeed and
fail on both packages; inside, the CUDA kernel stages its own chunks of
time and masks the ragged end.  It has no gradient: the reference's Pallas
call has none (``ops.mamba_scan`` wraps this in an autograd function whose
backward raises).
"""
from __future__ import annotations

import torch

from ..obs import default_registry
from . import _build, ref
from .flash_attention import stream

#: The kernel holds at most this many states per channel (16 lanes of 8).
MAX_STATE = 128


def scan_lanes(n: int) -> tuple:
    """The kernel's ``(G, K)`` for state dim ``n``: G lanes per channel,
    each holding K consecutive states (``csrc/mamba_scan.cu``'s dispatch)."""
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"mamba_scan: state dim N={n}; the kernel takes 1..{MAX_STATE}")
    if n <= 8:
        return 1, 1 << (n - 1).bit_length()
    return 1 << (n - 1).bit_length() - 3, 8


#: ``launches``: kernel launches (CUDA tensors only).
stats = default_registry().group("mamba_scan", ("launches",))

_P, _I = _build._P, _build._I
_build.register("mamba_scan", {"mamba_scan_fwd": (_P,) * 6 + (_I,) * 4 + (_P,)})


def _check_cuda_inputs(x, dt, a, b_mat, c_mat) -> None:
    named = dict(x=x, dt=dt, a=a, b_mat=b_mat, c_mat=c_mat)
    for key, t in named.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"mamba_scan: {key} is on {t.device}, x on {x.device}: "
                             "only all-CPU (plain version) or all on one CUDA "
                             "device (kernel) is supported")
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan: {key} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan: {key} is not contiguous")
    bsz, s, d_in = x.shape
    n = a.shape[-1]
    want = dict(dt=(bsz, s, d_in), a=(d_in, n), b_mat=(bsz, s, n), c_mat=(bsz, s, n))
    for key, shape in want.items():
        if tuple(named[key].shape) != shape:
            raise ValueError(f"mamba_scan: {key} has shape {tuple(named[key].shape)}, "
                             f"expected {shape} for x {tuple(x.shape)}, a [d_in, N]")
    scan_lanes(n)  # raises for a state dim the kernel does not take
    if bsz > 65535:
        raise ValueError(f"mamba_scan: batch {bsz} exceeds the grid's 65 535 rows")


def mamba_scan_blocked(
    x: torch.Tensor,            # [B, S, d_in] f32 (post-conv, silu'd)
    dt: torch.Tensor,           # [B, S, d_in] f32
    a: torch.Tensor,            # [d_in, N] f32 (negative)
    b_mat: torch.Tensor,        # [B, S, N] f32
    c_mat: torch.Tensor,        # [B, S, N] f32
    *,
    block_d: int = 512,
    chunk: int = 256,
) -> torch.Tensor:
    bsz, s, d_in = x.shape
    bd, ck = min(block_d, d_in), min(chunk, s)
    if bd <= 0 or ck <= 0 or d_in % bd or s % ck:
        raise ValueError(f"d_in={d_in} / S={s} are not multiples of their blocks "
                         f"{bd} / {ck}")
    tensors = (x, dt, a, b_mat, c_mat)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.mamba_scan_ref(*tensors)
    _check_cuda_inputs(*tensors)
    y = torch.empty_like(x)
    err = _build.library("mamba_scan").mamba_scan_fwd(
        *(t.data_ptr() for t in tensors), y.data_ptr(),
        bsz, s, d_in, a.shape[-1], stream(x.device),
    )
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    stats["launches"] += 1
    return y
