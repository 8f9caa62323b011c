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

On a rank mesh (``lay``, the model's ``RankLayout``) the block runs
Megatron-style over ``d_inner``, as GSPMD partitions the reference's
block under ``PARAM_RULES``: the residual stream's block is gathered
along the sequence (``mamba/in``), ``w_in_x`` and ``w_in_z`` are
column-parallel (this rank's block of channels), the conv, ``dt_proj``,
``dt_bias``, ``a_log``, ``d_skip`` and the scan (K4 under
``ssm_impl="pallas"``) run on those channels alone, and ``w_out`` is
row-parallel, its partial sums reduce-scattered back (``mamba/out``;
summed where the sequence is whole).  ``w_dt``, ``w_b`` and ``w_c``
contract over ``d_inner``: their partial products are summed over
``model`` in one float32 ``psum`` (``mamba/dtbc``) and rounded to the
compute dtype once after it, where one rank's product rounds once;
``w_out``'s partial sums are float32 too.  Where ``d_inner`` does not
split over ``model`` every rank holds every channel and runs the whole
block, keeping its positions.  A decode tick
whose batch does not split over ``data`` (``RankLayout.stationary``)
keeps the ``d_model`` blocks of ``w_in_x``, ``w_in_z`` and ``w_out`` in
place, as GSPMD partitions the reference's decode cell there: the input
projections' float32 partial products over this rank's block of
``d_model`` are summed over ``data`` (``mamba/in``), and the output's
block of ``d_model``, summed over ``model``, is gathered over ``data``
(``mamba/data``).

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


def _ssm_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig, lay=None):
    """Shared pre-scan projections: returns (xc, dt, B, C) with silu applied.
    ``lay``: ``x`` is this rank's block of the channels (module docstring),
    so the products over ``d_inner`` are partial sums, summed over
    ``model`` in float32."""
    xc = F.silu(x.float()).to(x.dtype)
    if lay is None:
        low, b_mat, c_mat = xc @ p["w_dt"], xc @ p["w_b"], xc @ p["w_c"]
    else:
        from ..distributed.collectives import psum

        w = torch.cat([p["w_dt"], p["w_b"], p["w_c"]], -1).float()
        dtbc = psum(xc.float() @ w, lay.mesh, "model", "mamba/dtbc").to(x.dtype)
        n = cfg.ssm_state
        low, b_mat, c_mat = dtbc.split([w.shape[-1] - 2 * n, n, n], -1)
    dt = F.softplus((low @ p["dt_proj"]).float() + p["dt_bias"].float())   # [..., d_in] f32
    return xc, dt, b_mat.float(), c_mat.float()


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


def _split(p: dict, cfg: ModelConfig, lay) -> bool:
    """Whether this rank holds a block of the channels (``w_in_x``'s
    columns) on a rank mesh."""
    return lay is not None and p["w_in_x"].shape[-1] != cfg.d_inner


def _out_proj(y: torch.Tensor, w_out: torch.Tensor, lay, split: bool) -> torch.Tensor:
    """``y @ w_out``, on a rank mesh (``lay``) scattered to the residual
    stream's block; where this rank holds a block of the channels
    (``split``), its float32 partial products summed over ``model``
    (``mamba/out``) and rounded once, where one rank's product rounds
    once."""
    if split:
        out = lay.scatter_seq(y.float() @ w_out.float(), True, "mamba/out")
        return out.to(y.dtype)
    out = y @ w_out
    return out if lay is None else lay.scatter_seq(out, False, "mamba/out")


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
                lay=None):
    """Full-sequence forward: x [B,S,d] → [B,S,d] (+ final (conv, h) state).

    The returned state slots straight into :func:`mamba_decode` so prefill →
    decode hand-off is exact.  With ``lay`` (a rank mesh's ``RankLayout``;
    module docstring), ``x`` is this rank's block of the residual stream
    and ``p`` its blocks of the weights with ``d_model`` whole; the output
    is this rank's block, and the state this rank's rows and channels: the
    caches' block under ``ACT_RULES_DECODE`` (``d_inner`` over ``model``).
    """
    split = _split(p, cfg, lay)
    if lay is not None:
        x = lay.gather_seq(x, "mamba/in")
    xp_raw = x @ p["w_in_x"]
    z = x @ p["w_in_z"]
    xp = _causal_depthwise_conv(xp_raw, p["conv_w"], p["conv_b"])
    xc, dt, b_mat, c_mat = _ssm_inputs(p, xp, cfg, lay if split else None)
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
    out = _out_proj(y, p["w_out"], lay, split)
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
    lay=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token state update — O(1) in sequence length.  With ``lay``
    (a rank mesh's decode ``RankLayout``), ``x`` is this rank's rows (and
    block of ``d_model`` where the layout is ``stationary``), the states
    its rows and block of channels, and the output's partial sums are
    summed over ``model`` (module docstring)."""
    split = _split(p, cfg, lay)
    if lay is not None and lay.stationary:      # x: this rank's block of d_model
        xz = lay.contract(x, torch.cat([p["w_in_x"], p["w_in_z"]], -1), "mamba/in")
        xp, z = xz.chunk(2, -1)
    else:
        xp = x @ p["w_in_x"]                                  # [B,1,d_in]
        z = x @ p["w_in_z"]
    window = torch.cat([conv_state, xp], dim=1)              # [B,k,d_in]
    new_conv_state = window[:, 1:]
    xconv = (window.float() * p["conv_w"].float().T).sum(1).to(x.dtype) + p["conv_b"]
    xconv = xconv[:, None, :]                                 # [B,1,d_in]
    xc, dt, b_mat, c_mat = _ssm_inputs(p, xconv, cfg, lay if split else None)
    a = -torch.exp(p["a_log"].float())
    dtt, xt = dt[:, 0], xc[:, 0].float()                      # [B,d_in]
    bt, ct = b_mat[:, 0], c_mat[:, 0]                         # [B,N]
    da = torch.exp(dtt[..., None] * a)
    h = da * h + (dtt * xt)[..., None] * bt[:, None, :]
    y = torch.einsum("bin,bn->bi", h, ct) + p["d_skip"].float() * xt
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = _out_proj(y[:, None, :], p["w_out"], lay, split)
    if lay is not None and lay.stationary:
        out = lay.whole_d(out, "mamba/data")
    return out, new_conv_state, h
