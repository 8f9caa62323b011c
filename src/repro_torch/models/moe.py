"""Capacity-based top-k MoE with sort-based dispatch (GShard-style, static
shapes).

Dispatch: flatten tokens, take top-k experts per token, sort the expert
ids stably, compute each entry's position within its expert (arange −
segment start), drop entries beyond capacity ``C = ceil(T·k/E ·
capacity_factor)``, scatter into an ``[E·C + 1, d]`` buffer (the last row
takes the dropped entries), run per-expert MLPs as batched products, and
combine back with the router weights.  Dropped tokens fall through on the
residual path (standard capacity-factor semantics).

The reference's expert-parallel dispatch (``moe_impl="a2a"``: a
``shard_map`` with all-to-alls along the mesh's ``model`` axis) runs only
under an active mesh; without one it takes this gather path.  The port's
mesh (``launch/mesh.py``) places no tensor across devices and the a2a
dispatch is not ported (ROADMAP.md §1 item 7), so ``"a2a"`` always takes
the gather path here.

Ties and order follow the reference exactly: top-k keeps the lower expert
index among equal probabilities (``lax.top_k``), the dispatch sort is
stable, and each token's k weighted expert outputs are added into a zeroed
buffer in the compute dtype in ascending expert order, rounding after each
add, as the reference's sorted scatter-add does.  The combine is a loop
over the k choices, so it has no atomics and gives the same bits on every
run.

``recording()`` lets a caller see each call's routing (router
probabilities, expert ids, kept entries) without changing what the layer
computes: the tests hold it against the reference's, and the card's smoke
run reports drop rates and routing differences from it.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .params import P

_records: Optional[List[dict]] = None


@contextlib.contextmanager
def recording() -> Iterator[List[dict]]:
    """While active, every ``moe_block`` call appends ``{"probs": [T,E]
    float32, "gate_idx": [T,k], "keep": [T·k] (dispatch order)}``, detached,
    to the list it yields, in call order (a checkpointed pass appends again
    when its backward recomputes the layer)."""
    global _records
    saved, _records = _records, []
    try:
        yield _records
    finally:
        _records = saved


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "router": P((d, e), ("d_model", "experts")),
    }
    if cfg.mlp_kind == "swiglu":
        defs.update(
            w_gate=P((e, d, f), ("experts", "d_model", "d_ff")),
            w_up=P((e, d, f), ("experts", "d_model", "d_ff")),
            w_down=P((e, f, d), ("experts", "d_ff", "d_model")),
        )
    else:
        defs.update(
            w_in=P((e, d, f), ("experts", "d_model", "d_ff")),
            w_out=P((e, f, d), ("experts", "d_ff", "d_model")),
        )
    return defs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """Router over flattened tokens xt [T,d] → (probs [T,E] float32,
    renormalised gate values [T,k], expert ids [T,k]).  Logits are taken
    in the compute dtype and cast to float32 before the softmax; among
    equal probabilities the lower expert index comes first."""
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, : cfg.top_k], idx[:, : cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def dispatch(gate_idx: torch.Tensor, n_experts: int, cap: int):
    """Sort-based dispatch of the [T,k] expert ids → (order [T·k]: the flat
    entries sorted stably by expert, keep [T·k]: within capacity, dest
    [T·k]: buffer row, ``E·cap`` for a dropped entry), all in sorted order."""
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = flat_e.new_zeros(n_experts).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - starts[sorted_e]
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos, torch.full_like(pos, n_experts * cap))
    return order, keep, dest


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] → (y [B,S,d], aux_loss float32 scalar), by the gather
    dispatch whatever ``moe_impl`` says (see the module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    probs, gate_vals, gate_idx = route(p, xt, cfg)

    # Load-balancing auxiliary loss (Switch-style): E · Σ_e f_e · p̄_e.
    me = probs.mean(dim=0)
    top1 = gate_idx[:, 0]
    ce = probs.new_zeros(e).scatter_add_(0, top1, torch.ones_like(top1, dtype=probs.dtype)) / t
    aux = e * torch.sum(me * ce)

    cap = capacity(cfg, t)
    order, keep, dest = dispatch(gate_idx, e, cap)
    if _records is not None:
        _records.append(dict(probs=probs.detach(), gate_idx=gate_idx, keep=keep))
    tok_idx = order // k                                  # source token
    buf = xt.new_zeros((e * cap + 1, d))
    buf[dest] = xt[tok_idx]     # rows distinct but the discarded overflow row
    buf = buf[: e * cap].view(e, cap, d)

    if cfg.mlp_kind == "swiglu":
        g = torch.bmm(buf, p["w_gate"])
        u = torch.bmm(buf, p["w_up"])
        h = F.silu(g.float()).to(buf.dtype) * u
        out_buf = torch.bmm(h, p["w_down"])
    else:
        h = torch.bmm(buf, p["w_in"])
        h = F.gelu(h.float(), approximate="tanh").to(buf.dtype)
        out_buf = torch.bmm(h, p["w_out"])

    out_flat = out_buf.reshape(e * cap, d)
    ys = torch.where(keep[:, None], out_flat[dest.clamp(0, e * cap - 1)], 0.0)
    w = gate_vals.reshape(-1)[order].to(ys.dtype)
    return combine(ys * w[:, None], order, gate_idx).view(b, s, d), aux


def combine(updates: torch.Tensor, order: torch.Tensor, gate_idx: torch.Tensor) -> torch.Tensor:
    """Sum each token's k weighted expert outputs → [T, d] in their dtype.

    ``updates`` [T·k, d] are in dispatch order (sorted by expert).  The
    reference adds them with ``.at[tok_idx].add`` into zeros, which meets
    each token's choices in ascending expert id and rounds after each add;
    this does the same as a loop over the k choices, each add vectorised
    over the tokens, with no atomics."""
    t, k = gate_idx.shape
    per_choice = torch.empty_like(updates)
    per_choice[order] = updates                   # back to (token, choice)
    per_choice = per_choice.view(t, k, -1)
    by_expert = torch.argsort(gate_idx, dim=1)
    rows = torch.arange(t, device=updates.device)
    y = updates.new_zeros((t, updates.shape[1]))
    for j in range(k):
        y = y + per_choice[rows, by_expert[:, j]]
    return y
