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

Under a :class:`kernels.cost.CostCounter` the time loop counts by formula
(``kernels.ops.scan_cost``, ``ssm_scan_addendum``'s per-layer share), its
forward and its backward: on ``meta`` tensors :class:`_MetaScan` stands in
for it without iterating, its graph kept to every input; on the CPU and
the card the loop runs as always, and two identity nodes around it hold
op counting off while autograd runs its backward.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import cost
from ..kernels.ops import scan_cost
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


class _MetaScan(torch.autograd.Function):
    """The time loop on ``meta`` tensors: y and the final h with their
    shapes, counted by formula, forward and backward, without iterating.
    An autograd function, so that a train step keeps the graph below it
    (a stand-in with no ``grad_fn`` would cut every layer underneath)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, h):
        ctx.shapes = [t.shape for t in (x, dt, a, b_mat, c_mat, h)]
        ctx.dims = (x.shape[0], x.shape[1], x.shape[2], a.shape[-1])
        with cost.region("ssm_scan", *scan_cost(*ctx.dims)):
            return torch.empty_like(x), torch.empty_like(h)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        with cost.region("ssm_scan_backward", *scan_cost(*ctx.dims, backward=True)):
            return tuple(grad_y.new_empty(shape) if need else None
                         for shape, need in zip(ctx.shapes, ctx.needs_input_grad))


class _Resume(torch.autograd.Function):
    """Identity on the loop's inputs; its backward, the last of the loop's,
    turns op counting back on."""

    @staticmethod
    def forward(ctx, gate, *inputs):
        ctx.gate = gate
        return tuple(t.view_as(t) for t in inputs)

    @staticmethod
    def backward(ctx, *grads):
        counter, held = ctx.gate
        if held[0]:
            held[0] = False
            counter.release()
        return (None,) + grads


class _Hold(torch.autograd.Function):
    """Identity on the loop's outputs; its backward, the first of the
    loop's, counts the backward by formula and holds op counting off."""

    @staticmethod
    def forward(ctx, gate, dims, *outputs):
        ctx.gate, ctx.dims = gate, dims
        return tuple(t.view_as(t) for t in outputs)

    @staticmethod
    def backward(ctx, *grads):
        counter, held = ctx.gate
        counter.add_region("ssm_scan_backward", *scan_cost(*ctx.dims, backward=True))
        held[0] = True
        counter.hold()
        return (None, None) + grads


def _scan_time(x, dt, a, b_mat, c_mat, h):
    """The plain scan: x, dt [B,S,d_in], a [d_in,N], B, C [B,S,N], h
    [B,d_in,N] (all f32) → (y [B,S,d_in], final h)."""
    if x.device.type == "meta":
        return _MetaScan.apply(x, dt, a, b_mat, c_mat, h)
    dims = (x.shape[0], x.shape[1], x.shape[2], a.shape[-1])
    gate = None
    if (cost.active() and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, dt, a, b_mat, c_mat, h))):
        gate = (cost.current(), [False])
        x, dt, a, b_mat, c_mat, h = _Resume.apply(gate, x, dt, a, b_mat, c_mat, h)
    with cost.formula_region("ssm_scan", scan_cost, *dims):
        y, h = _scan_loop(x, dt, a, b_mat, c_mat, h)
    if gate is not None:
        y, h = _Hold.apply(gate, dims, y, h)
    return y, h


def _scan_loop(x, dt, a, b_mat, c_mat, h):
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
