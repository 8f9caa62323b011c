"""Capacity-based top-k MoE with sort-based dispatch (GShard-style, static
shapes).

Dispatch: flatten tokens, take top-k experts per token, sort the expert
ids stably, compute each entry's position within its expert (arange −
segment start), drop entries beyond capacity ``C = ceil(T·k/E ·
capacity_factor)``, scatter into an ``[E·C + 1, d]`` buffer (the last row
takes the dropped entries), run per-expert MLPs as batched products, and
combine back with the router weights.  Dropped tokens fall through on the
residual path (standard capacity-factor semantics).

With ``moe_impl="a2a"`` under an ``activation_sharding`` context whose
mesh is a rank mesh (``launch/mesh.py::_make_mesh``) with a ``model`` axis
larger than 1 that divides the experts, the block takes the reference's
expert-parallel dispatch instead (``_moe_block_a2a``, its ``shard_map``
body one for one): each rank routes its own tokens, buckets them by expert
at a per-rank capacity, exchanges the buckets with two all-to-alls along
``model`` and runs its own experts, its collectives issued through
``distributed/collectives.py``.  Everywhere else — no context, a mesh
without ranks, one rank along ``model`` — ``"a2a"`` takes the gather path,
as the reference's does without a mesh.

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
from dataclasses import dataclass
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
    """x [B,S,d] → (y [B,S,d], aux_loss float32 scalar).  Dispatch by
    ``cfg.moe_impl``: "gather", or "a2a" — the expert-parallel dispatch
    under a rank mesh's ``activation_sharding`` context where it applies,
    the gather dispatch elsewhere (see the module docstring)."""
    if cfg.moe_impl == "a2a":
        from ..distributed import actctx

        ctx = actctx.active()
        if ctx is not None and _a2a_applicable(cfg, ctx[0]):
            return _moe_block_a2a(p, x, cfg, ctx[0], ctx[1])
    return _moe_block_gather(p, x, cfg)


def _a2a_applicable(cfg: ModelConfig, mesh) -> bool:
    """The reference's test (a ``model`` axis that divides the experts),
    on a rank mesh with more than one rank along ``model``."""
    n_model = mesh.shape.get("model", 1)
    return (getattr(mesh, "is_rank_mesh", False) and n_model > 1
            and cfg.n_experts % n_model == 0)


def _experts(w: dict, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The per-expert MLPs over ``buf [E, C, d]`` as batched products."""
    if cfg.mlp_kind == "swiglu":
        g = torch.bmm(buf, w["w_gate"])
        u = torch.bmm(buf, w["w_up"])
        h = F.silu(g.float()).to(buf.dtype) * u
        return torch.bmm(h, w["w_down"])
    h = torch.bmm(buf, w["w_in"])
    h = F.gelu(h.float(), approximate="tanh").to(buf.dtype)
    return torch.bmm(h, w["w_out"])


def _moe_block_gather(p: dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
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

    out_flat = _experts(p, buf, cfg).reshape(e * cap, d)
    ys = torch.where(keep[:, None], out_flat[dest.clamp(0, e * cap - 1)], 0.0)
    w = gate_vals.reshape(-1)[order].to(ys.dtype)
    return combine(ys * w[:, None], order, gate_idx).view(b, s, d), aux


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over a rank mesh (the reference's shard_map body)
# ---------------------------------------------------------------------------

#: The reference's specs of the block's parameters under the a2a dispatch
#: (``router_spec``, ``w_in_spec``, ``w_out_spec``), over each leaf's
#: trailing axes (a stacked leaf's leading layer axis is whole).
A2A_PARAM_SPECS = {
    "router": ("data", "model"),
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_in": ("model", "data", None),
    "w_down": ("model", None, "data"),
    "w_out": ("model", None, "data"),
}


@dataclass(frozen=True)
class A2ALayout:
    """Where the tokens of an ``[B, S, d]`` input lie on the ranks: the
    batch over the mesh axes ``dp`` (``()`` when their size does not divide
    B), the sequence over ``model`` when ``seq_sharded``; ``t_loc`` tokens
    a rank, and ``c_e`` the per-rank capacity of each expert."""

    dp: Tuple[str, ...]
    dp_size: int
    seq_sharded: bool
    t_loc: int
    c_e: int


def a2a_layout(cfg: ModelConfig, mesh_shape: dict, rules: dict, b: int, s: int) -> A2ALayout:
    """The reference's ``x_spec`` and ``c_e`` (``repro/models/moe.py``
    :168-185), its integer arithmetic exactly."""
    n_model = mesh_shape["model"]
    dp = rules.get("batch", ("data",))
    if isinstance(dp, list):
        dp = dp[0]
    dp = tuple(a for a in (dp if isinstance(dp, tuple) else (dp,)) if a in mesh_shape)
    dp_size = 1
    for a in dp:
        dp_size *= mesh_shape[a]
    seq_sharded = rules.get("seq") == "model" and s % n_model == 0
    if b % dp_size:
        dp = ()
        dp_size = 1
    t_loc = (b // dp_size) * (s // (n_model if seq_sharded else 1))
    c_e = max(4, -(-int(t_loc * cfg.top_k * cfg.capacity_factor) // cfg.n_experts // 4) * 4)
    return A2ALayout(dp, dp_size, seq_sharded, t_loc, c_e)


def shard_index(name: str, shape, mesh_shape: dict, coords: dict) -> Tuple[slice, ...]:
    """The slices of a rank's block of the block's leaf ``name`` of
    ``shape``, by :data:`A2A_PARAM_SPECS`."""
    from ..distributed.sharding import block_index

    spec = A2A_PARAM_SPECS[name]
    return block_index(shape, (None,) * (len(shape) - len(spec)) + spec, mesh_shape, coords)


def rank_shard(cfg: ModelConfig, mesh):
    """For ``init_params(shard=...)``: each leaf under a ``moe`` key → this
    rank's slices, where the a2a dispatch applies on ``mesh`` (else None:
    every rank holds every parameter)."""
    if cfg.moe_impl != "a2a" or not _a2a_applicable(cfg, mesh):
        return None
    shape, coords = mesh.shape, mesh.coords

    def shard(path, p):
        return shard_index(path[-1], p.shape, shape, coords) if "moe" in path[:-1] else None
    return shard


def _moe_block_a2a(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh, rules
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` around its body: ``x [B,S,d]``, whole
    on every rank, is cut to this rank's block by ``x_spec`` (no
    collective: the port's model is replicated), the body runs on it with
    this rank's parameter shards (``p``, by :data:`A2A_PARAM_SPECS`), and
    the output blocks are gathered back over the sharded axes, so every
    rank returns the whole ``y``.  That reassembly is the port's own (the
    reference leaves ``y`` sharded) and is counted under the path
    ``moe_a2a/reassemble``."""
    from ..distributed.collectives import all_gather

    b, s, d = x.shape
    n_model = mesh.shape["model"]
    if p["router"].shape[-1] * n_model != cfg.n_experts:
        raise ValueError(f"the a2a dispatch takes this rank's shards of the parameters "
                         f"(router {tuple(p['router'].shape)} for {cfg.n_experts} experts "
                         f"over model {n_model})")
    lay = a2a_layout(cfg, mesh.shape, rules, b, s)
    if lay.dp != tuple(a for a in mesh.axis_names if a in lay.dp):
        raise ValueError(f"batch axes {lay.dp} out of the mesh's order {mesh.axis_names}")
    coords = mesh.coords
    bi = 0
    for a in lay.dp:
        bi = bi * mesh.shape[a] + coords[a]
    bl = b // lay.dp_size
    sl, si = (s // n_model, coords["model"]) if lay.seq_sharded else (s, 0)
    y, aux = _a2a_body(p, x[bi * bl:(bi + 1) * bl, si * sl:(si + 1) * sl], cfg, mesh, lay)
    if lay.seq_sharded:
        y = all_gather(y, mesh, "model", 1, "moe_a2a/reassemble")
    if lay.dp:
        y = all_gather(y, mesh, lay.dp, 0, "moe_a2a/reassemble")
    return y, aux


def _a2a_body(p: dict, x_loc: torch.Tensor, cfg: ModelConfig, mesh, lay: A2ALayout
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucketed expert-parallel dispatch on one rank (the reference's
    ``body``, its collectives in its order): gather the router, route the
    local tokens, sum the balance statistics over the global token
    population, bucket the (token, choice) pairs by global expert at
    capacity ``c_e`` (stable sort, overflow row), all-to-all the
    ``[E, c_e, d]`` buffer along ``model`` (each rank owns ``E / n_model``
    contiguous experts), run the local experts on their weights gathered
    over ``data``, all-to-all back, combine in ascending expert id."""
    from ..distributed.collectives import all_gather, all_to_all, psum

    n_model = mesh.shape["model"]
    e, k, c_e = cfg.n_experts, cfg.top_k, lay.c_e
    e_loc = e // n_model
    bl, sl, d = x_loc.shape
    t = bl * sl
    xt = x_loc.reshape(t, d)
    router = all_gather(p["router"], mesh, "data", 0, "moe_a2a/router")
    router = all_gather(router, mesh, "model", 1, "moe_a2a/router")

    probs, gate_vals, gate_idx = route({"router": router}, xt, cfg)

    # Load-balance aux over the *global* token population.
    axes = lay.dp + ("model",) if lay.seq_sharded else lay.dp
    me_sum = probs.sum(dim=0)
    top1 = gate_idx[:, 0]
    ce_sum = probs.new_zeros(e).scatter_add_(0, top1, torch.ones_like(top1, dtype=probs.dtype))
    n_tok = torch.tensor(float(t), dtype=torch.float32, device=xt.device)
    if axes:
        me_sum = psum(me_sum, mesh, axes, "moe_a2a/aux")
        ce_sum = psum(ce_sum, mesh, axes, "moe_a2a/aux")
        n_tok = psum(n_tok, mesh, axes, "moe_a2a/aux")
    aux = e * torch.sum((me_sum / n_tok) * (ce_sum / n_tok))

    # Local bucketing by global expert (stable sort + capacity drop).
    order, keep, dest = dispatch(gate_idx, e, c_e)
    if _records is not None:
        _records.append(dict(probs=probs.detach(), gate_idx=gate_idx, keep=keep))
    tok_idx = order // k
    xbuf = xt.new_zeros((e * c_e + 1, d))
    xbuf[dest] = xt[tok_idx]
    payload = xbuf[: e * c_e].view(n_model, e_loc * c_e, d)
    recv = all_to_all(payload, mesh, "model", "moe_a2a/dispatch")
    # [n_model, e_loc·c_e, d] → [e_loc, n_model·c_e, d]
    toks = recv.view(n_model, e_loc, c_e, d).transpose(0, 1).reshape(e_loc, n_model * c_e, d)

    names = ("w_gate", "w_up", "w_down") if cfg.mlp_kind == "swiglu" else ("w_in", "w_out")
    w = {n: all_gather(p[n], mesh, "data", 2 if n in ("w_down", "w_out") else 1,
                       "moe_a2a/experts") for n in names}
    out = _experts(w, toks, cfg)

    back = out.view(e_loc, n_model, c_e, d).transpose(0, 1).reshape(n_model, e_loc * c_e, d)
    outbuf = all_to_all(back, mesh, "model", "moe_a2a/combine").view(e * c_e, d)
    ys = torch.where(keep[:, None], outbuf[dest.clamp(0, e * c_e - 1)], 0.0)
    wts = gate_vals.reshape(-1)[order].to(ys.dtype)
    return combine(ys * wts[:, None], order, gate_idx).view(bl, sl, d), aux


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
