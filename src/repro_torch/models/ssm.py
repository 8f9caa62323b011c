"""Mamba1 selective-SSM block (falcon-mamba, jamba's mamba layers).

Recurrence (per channel c, state dim n):
    h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t x_t) B_t
    y_t = C_t · h_t + D x_t
with Δ = softplus(x W_dt W_dtproj + b), (B, C) = x W_bc, gated by silu(z)
and preceded by a depthwise causal conv (width ``ssm_conv``).

The plain path loops over time on a ``[B, d_in, N]`` float32 state (the
reference's ``lax.scan``), one fused multiply-add launch per step: the
step's ``exp(Δ A)`` and ``(Δ x) B`` are computed for a chunk of steps at
once, and ``y`` for the chunk in one batched product.  It is
differentiable, and it returns the final state for prefill.
``cfg.ssm_impl == "pallas"`` sends the full-sequence forward without state
through the hand-written scan kernel (K4, ``kernels/ops.py``) instead, as
the reference sends it through its Pallas kernel; that path has no
gradient in either package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .params import P, dtype_of

#: Time steps whose ``exp(Δ A)`` and ``(Δ x) B`` the plain scan computes at
#: once: [B, 128, d_in, N] float32, 134 MB at falcon-mamba-7b's width and
#: batch 2, whatever the sequence length.
SCAN_CHUNK = 128


def mamba_defs(cfg: ModelConfig) -> dict:
    d, d_in = cfg.d_model, cfg.d_inner
    n, r, k = cfg.ssm_state, cfg.resolved_dt_rank, cfg.ssm_conv
    return {
        "w_in_x": P((d, d_in), ("d_model", "d_inner")),
        "w_in_z": P((d, d_in), ("d_model", "d_inner")),
        "conv_w": P((d_in, k), ("d_inner", "conv")),
        "conv_b": P((d_in,), ("d_inner",), "zeros"),
        "w_dt": P((d_in, r), ("d_inner", "dt_rank")),
        "dt_proj": P((r, d_in), ("dt_rank", "d_inner")),
        "dt_bias": P((d_in,), ("d_inner",), "zeros"),
        "w_b": P((d_in, n), ("d_inner", "ssm_state")),
        "w_c": P((d_in, n), ("d_inner", "ssm_state")),
        "a_log": P((d_in, n), ("d_inner", "ssm_state"), "mamba_a"),
        "d_skip": P((d_in,), ("d_inner",), "ones"),
        "w_out": P((d_in, d), ("d_inner", "d_model")),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B,S,d_in], w [d_in,k] → causal depthwise conv, same length: the
    reference's cross-correlation over k−1 left-padded steps, as k shifted
    multiply-adds summed in float32 (no cuDNN, so no TF32 on the card)."""
    k, s = w.shape[-1], x.shape[1]
    xt = F.pad(x, (0, 0, k - 1, 0)).float()                 # left pad
    wf = w.float()
    out = xt[:, 0:s] * wf[:, 0]
    for j in range(1, k):
        out = out + xt[:, j:j + s] * wf[:, j]
    return out.to(x.dtype) + b


def _ssm_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Shared pre-scan projections: returns (xc, dt, B, C) with silu applied."""
    xc = F.silu(x.float()).to(x.dtype)
    dt = F.softplus(
        ((xc @ p["w_dt"]) @ p["dt_proj"]).float() + p["dt_bias"].float()
    )                                                        # [..., d_in] f32
    b_mat = (xc @ p["w_b"]).float()
    c_mat = (xc @ p["w_c"]).float()
    return xc, dt, b_mat, c_mat


def _scan_time(x, dt, a, b_mat, c_mat, h):
    """The plain scan: x, dt [B,S,d_in], a [d_in,N], B, C [B,S,N], h
    [B,d_in,N] (all f32) → (y [B,S,d_in], final h)."""
    ys = []
    for t0 in range(0, x.shape[1], SCAN_CHUNK):
        sl = slice(t0, t0 + SCAN_CHUNK)
        da = torch.exp(dt[:, sl, :, None] * a)                       # [B,T,d_in,N]
        dbx = (dt[:, sl] * x[:, sl])[..., None] * b_mat[:, sl, None, :]
        hs = []
        for da_t, dbx_t in zip(da.unbind(1), dbx.unbind(1)):
            h = torch.addcmul(dbx_t, da_t, h)                        # da ⊙ h + (Δx) B
            hs.append(h)
        ys.append((torch.stack(hs, 1) @ c_mat[:, sl, :, None])[..., 0])
    return torch.cat(ys, 1), h


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence forward: x [B,S,d] → [B,S,d] (+ final (conv, h) state).

    The returned state slots straight into :func:`mamba_decode` so prefill →
    decode hand-off is exact.
    """
    xp_raw = x @ p["w_in_x"]
    z = x @ p["w_in_z"]
    xp = _causal_depthwise_conv(xp_raw, p["conv_w"], p["conv_b"])
    xc, dt, b_mat, c_mat = _ssm_inputs(p, xp, cfg)
    a = -torch.exp(p["a_log"].float())                        # [d_in, N]

    if cfg.ssm_impl == "pallas" and not return_state:
        from ..kernels import ops as kops

        y = kops.mamba_scan(xc.float(), dt, a, b_mat, c_mat)
        h_final = None
    else:
        h0 = xc.new_zeros((xc.shape[0], xc.shape[-1], cfg.ssm_state), dtype=torch.float32)
        y, h_final = _scan_time(xc.float(), dt, a, b_mat, c_mat, h0)

    y = y + p["d_skip"].float() * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["w_out"]
    if not return_state:
        return out
    k = cfg.ssm_conv
    conv_state = xp_raw[:, -(k - 1):, :].to(dtype_of(cfg.compute_dtype))
    return out, {"conv": conv_state, "h": h_final}


def mamba_decode(
    p: dict,
    x: torch.Tensor,                   # [B, 1, d]
    cfg: ModelConfig,
    conv_state: torch.Tensor,          # [B, k-1, d_in] — last k-1 conv inputs
    h: torch.Tensor,                   # [B, d_in, N] f32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token state update — O(1) in sequence length."""
    xp = x @ p["w_in_x"]                                      # [B,1,d_in]
    z = x @ p["w_in_z"]
    window = torch.cat([conv_state, xp], dim=1)              # [B,k,d_in]
    new_conv_state = window[:, 1:]
    xconv = (window.float() * p["conv_w"].float().T).sum(1).to(x.dtype) + p["conv_b"]
    xconv = xconv[:, None, :]                                 # [B,1,d_in]
    xc, dt, b_mat, c_mat = _ssm_inputs(p, xconv, cfg)
    a = -torch.exp(p["a_log"].float())
    dtt, xt = dt[:, 0], xc[:, 0].float()                      # [B,d_in]
    bt, ct = b_mat[:, 0], c_mat[:, 0]                         # [B,N]
    da = torch.exp(dtt[..., None] * a)
    h = da * h + (dtt * xt)[..., None] * bt[:, None, :]
    y = torch.einsum("bin,bn->bi", h, ct) + p["d_skip"].float() * xt
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = (y @ p["w_out"])[:, None, :]
    return out, new_conv_state, h
