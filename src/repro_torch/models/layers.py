"""Shared layer primitives: RMSNorm, RoPE, sinusoidal positions, MLPs.

The reference constrains the MLP's activations here
(``distributed.actctx.constrain``): its hidden activation to ``d_ff``
over ``model`` where the rules map ``d_ff`` (not under the baseline
policy), its output to the residual stream's layout.  Without a rank mesh
both are no-ops and the port drops them.  On a rank mesh the dense model
hands :func:`mlp_block` its ``RankLayout`` (``distributed/actctx.py``),
and the block runs Megatron's MLP on this rank's ``d_ff`` columns: the
sequence gathered, column-parallel gate and up, row-parallel down, and the
partial sums reduce-scattered back to the residual stream's block.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from .params import P


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, lay=None) -> torch.Tensor:
    """RMSNorm over the last dimension; with ``lay`` (a decode layout that
    keeps its ``d_model`` blocks in place, ``RankLayout.d_block``), this
    rank's block of the whole ``x``'s norm, ``weight`` the block.

    Where no gradient is recorded and there is no ``lay`` (every prefill
    and decode tick on one rank), one kernel does it (``ops.rms_norm``);
    a train step's norms and a stationary layout's keep the composed ops."""
    if lay is None and not ops.records(x, weight):
        return ops.rms_norm(x, weight, eps)
    return ref.rms_norm_ref(x, weight, eps, None if lay is None else lay.d_block)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` [...,] → [..., head_dim//2]
    (float32 throughout, as the reference computes them)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; cos/sin: [S, head_dim//2] (or broadcastable)."""
    half = x.shape[-1] // 2
    # cos/sin broadcast over the heads axis: [S, 1, half]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings for integer positions [...,]."""
    half = d_model // 2
    freqs = torch.exp(
        -torch.arange(half, dtype=torch.float32, device=positions.device)
        * (math.log(10_000.0) / max(half - 1, 1))
    )
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, width: Optional[int] = None) -> dict:
    d, f = cfg.d_model, width or cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": P((d, f), ("d_model", "d_ff")),
            "w_up": P((d, f), ("d_model", "d_ff")),
            "w_down": P((f, d), ("d_ff", "d_model")),
        }
    return {
        "w_in": P((d, f), ("d_model", "d_ff")),
        "w_out": P((f, d), ("d_ff", "d_model")),
    }


def mlp_block(p: dict, x: torch.Tensor, cfg: ModelConfig, lay=None) -> torch.Tensor:
    """Gated (swiglu) or plain (tanh-approximate GELU, jax's default) MLP.

    With ``lay`` (a rank mesh's ``RankLayout``), ``x`` is this rank's
    block of the residual stream and ``p`` its blocks of the weights, with
    ``d_model`` whole: the block is gathered along the sequence, the
    product runs on this rank's ``d_ff`` columns, and its share of the
    output is reduce-scattered back (where ``d_ff`` does not split over
    ``model``, every rank holds every column and keeps its positions).  A
    ``stationary`` layout (a decode tick that keeps the ``d_model`` blocks
    in place) hands it ``x``'s block of ``d_model`` and the weights'
    blocks: the in-projections' float32 partial products summed over
    ``data`` (``mlp/in``) and rounded once, the output on the rank's block
    of ``d_model``, summed over ``model``, then gathered over ``data``
    (``mlp/data``)."""
    if lay is not None and lay.stationary:
        return _mlp_stationary(p, x, cfg, lay)
    if lay is not None:
        x = lay.gather_seq(x, "mlp/in")
    if cfg.mlp_kind == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        y = h @ p["w_down"]
    else:
        h = x @ p["w_in"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        y = h @ p["w_out"]
    if lay is not None:
        y = lay.scatter_seq(y, h.shape[-1] != cfg.d_ff, "mlp/out")
    return y


def _mlp_stationary(p: dict, x: torch.Tensor, cfg: ModelConfig, lay) -> torch.Tensor:
    """:func:`mlp_block` under a ``stationary`` layout."""
    names = ("w_gate", "w_up") if cfg.mlp_kind == "swiglu" else ("w_in",)
    h = lay.contract(x, torch.cat([p[n] for n in names], -1), "mlp/in")
    if cfg.mlp_kind == "swiglu":
        g, u = h.chunk(2, -1)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = h @ p["w_down" if cfg.mlp_kind == "swiglu" else "w_out"]
    return lay.whole_d(lay.scatter_seq(y, h.shape[-1] != cfg.d_ff, "mlp/out"), "mlp/data")
