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

On a rank mesh the MoE model hands :func:`moe_block` its ``RankLayout``
(``distributed/actctx.py``; ``x`` is this rank's block of the residual
stream, ``p`` its blocks of the layer's leaves), and the block is
partitioned as the reference's cell is.  Under the gather dispatch (the
baseline policy, and ``"a2a"`` where the experts do not divide ``model``)
it computes the reference's global dispatch exactly
(:func:`_moe_block_ranks`): the sequence gathered over ``model``
(``moe/in``), the router's expert columns gathered (``moe/router``), every
token of the rank's rows routed alike on every ``model`` rank, the balance
statistics summed over the batch's ranks (``moe/aux``), each entry's place
in its expert at the global capacity from the per-expert counts of the
rows before this rank's (``moe/counts``), the rank's experts run on its
kept entries, and the weighted per-choice outputs reduce-scattered back to
the stream's block (``moe/out``) before the combine.  Under ``"a2a"``
where it applies (the ``opt`` policy) the expert-parallel body runs on the
stream's block itself (:func:`_moe_block_a2a_ranks`), with no slicing and
no reassembly.

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
    float32, "gate_idx": [T,k], "keep": [T·k] (dispatch order), "order":
    [T·k] (the flat (token, choice) entry at each place of the dispatch
    order)}``, detached, to the list it yields, in call order (a
    checkpointed pass appends again when its backward recomputes the
    layer).  On a rank mesh the tokens are the rank's: its rows over the
    whole sequence under the gather dispatch, its block of the stream
    under the a2a dispatch."""
    global _records
    saved, _records = _records, []
    try:
        yield _records
    finally:
        _records = saved


def routing(record: dict) -> dict:
    """A :func:`recording` record's expert ids and kept entries, both
    ``[T, k]`` in (token, choice) order, on the host."""
    kept = torch.zeros_like(record["keep"])
    kept[record["order"]] = record["keep"]
    return dict(gate_idx=record["gate_idx"].cpu(), kept=kept.view(record["gate_idx"].shape).cpu())


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
    return _pick((xt @ p["router"]).float(), cfg)


def _pick(logits: torch.Tensor, cfg: ModelConfig):
    """:func:`route` from the router's float32 logits ``[T, E]``."""
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


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig, lay=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] → (y [B,S,d], aux_loss float32 scalar).  Dispatch by
    ``cfg.moe_impl``: "gather", or "a2a" — the expert-parallel dispatch
    under a rank mesh's ``activation_sharding`` context where it applies,
    the gather dispatch elsewhere (see the module docstring).  ``lay``: the
    MoE model's layer on a rank mesh, ``x`` this rank's block of the
    residual stream and ``p`` its blocks (module docstring)."""
    if lay is not None:
        if a2a_on_ranks(cfg, lay.mesh):
            return _moe_block_a2a_ranks(p, x, cfg, lay)
        return _moe_block_ranks(p, x, cfg, lay)
    if cfg.moe_impl == "a2a":
        from ..distributed import actctx

        ctx = actctx.active()
        if ctx is not None and _a2a_applicable(cfg, ctx[0]):
            return _moe_block_a2a(p, x, cfg, ctx[0], ctx[1])
    return _moe_block_gather(p, x, cfg)


def a2a_on_ranks(cfg: ModelConfig, mesh) -> bool:
    """Whether an MoE layer of ``cfg`` on a rank mesh of ``mesh``'s shape
    takes the a2a dispatch (whose body gathers its own leaves over
    ``data``): ``moe_impl="a2a"`` and more than one rank along ``model``,
    dividing the experts."""
    n_model = mesh.shape.get("model", 1)
    return cfg.moe_impl == "a2a" and n_model > 1 and cfg.n_experts % n_model == 0


def _a2a_applicable(cfg: ModelConfig, mesh) -> bool:
    """The reference's test (a ``model`` axis that divides the experts),
    on a rank mesh with more than one rank along ``model``."""
    return getattr(mesh, "is_rank_mesh", False) and a2a_on_ranks(cfg, mesh)


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
        _records.append(dict(probs=probs.detach(), gate_idx=gate_idx, keep=keep, order=order))
    tok_idx = order // k                                  # source token
    buf = xt.new_zeros((e * cap + 1, d))
    buf[dest] = xt[tok_idx]     # rows distinct but the discarded overflow row
    buf = buf[: e * cap].view(e, cap, d)

    out_flat = _experts(p, buf, cfg).reshape(e * cap, d)
    ys = torch.where(keep[:, None], out_flat[dest.clamp(0, e * cap - 1)], 0.0)
    w = gate_vals.reshape(-1)[order].to(ys.dtype)
    return combine(ys * w[:, None], order, gate_idx).view(b, s, d), aux


def _moe_block_ranks(p: dict, x: torch.Tensor, cfg: ModelConfig, lay
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather dispatch of the whole batch, as GSPMD partitions it, on
    this rank's block ``x`` of the residual stream (module docstring).

    Every ``model`` rank routes its rows over the whole sequence with the
    whole router, so its probabilities, gate values and expert ids are one
    rank's bits.  The reference sorts all ``B·S·k`` entries stably by
    expert, token-major, at the capacity of the global token count: an
    entry's place in its expert is its place among this rank's rows plus
    that expert's entries on the rows before them, the counts of the batch
    ranks of lower coordinate (one all-gather of ``[E]`` integers).  The
    rank runs its ``E / model`` experts (every expert, on its ``d_ff``
    columns, where the experts do not divide ``model``) on the kept
    entries it owns, and weighs each output by its gate value.  The
    per-choice outputs ``[b, S, k, d]``, each token's choices in ascending
    expert id and zero where another rank owns the expert, are
    reduce-scattered over ``model`` along the sequence (summed where the
    sequence is whole): one term of each sum is not zero, so the sum is
    exact where the experts split.  The combine then adds each position's
    k choices in that order, as the reference's scatter-add does.  Nothing
    after that collective is saved for the backward pass, so a
    checkpoint's recomputation stops before it.  The balance term is over
    the global token population (the statistics summed over the batch's
    ranks).

    A decode layout with ``experts_stationary`` keeps the expert stacks'
    ``d_model`` blocks in place: the rows are gathered over ``data``
    (``moe/rows``) and routed alike on every rank of it, the
    in-projections' float32 partial products summed over ``data``
    (``moe/experts``) and rounded once, the out-projection and the combine
    run on the rank's ``d_model`` block, which is gathered over ``data``
    (``moe/data``) before the rank keeps its rows.  A ``stationary``
    layout (a tick whose batch does not split over ``data``) hands the
    block the normed stream's ``d_model`` block, every row on every rank,
    and the router's block: the router's columns gathered over ``model``,
    its float32 partial products summed over ``data`` (``moe/route``) and
    rounded once; the rest as under ``experts_stationary``."""
    from ..distributed.collectives import all_gather, psum

    mesh, e, k = lay.mesh, cfg.n_experts, cfg.top_k
    keep_d = lay.experts_stationary
    xs = lay.gather_seq(x, "moe/in")
    batch, b0, b_loc = lay.batch, lay.b0, lay.b_loc
    if keep_d and "data" in batch:      # the data ranks' rows, routed alike on each
        xs = all_gather(xs, mesh, "data", 0, "moe/rows")
        b0 -= mesh.coords["data"] * b_loc
        b_loc *= mesh.shape["data"]
        batch = tuple(a for a in batch if a != "data")
    b, s, d = xs.shape
    t = b * s
    xt = xs.reshape(t, d)
    e_loc = p["router"].shape[-1]
    router = p["router"] if e_loc == e else all_gather(p["router"], mesh, "model", 1,
                                                       "moe/router")
    if lay.stationary:      # xt: this rank's block of d_model
        probs, gate_vals, gate_idx = _pick(lay.contract(xt, router, "moe/route").float(), cfg)
    else:
        probs, gate_vals, gate_idx = route({"router": router}, xt, cfg)

    top1 = gate_idx[:, 0]
    ones = torch.ones_like(top1, dtype=probs.dtype)
    sums = torch.cat([probs.sum(dim=0), probs.new_zeros(e).scatter_add_(0, top1, ones),
                      probs.new_full((1,), float(t))])
    sums = psum(sums, mesh, batch, "moe/aux")
    aux = e * torch.sum((sums[:e] / sums[-1]) * (sums[e:2 * e] / sums[-1]))

    flat_e = gate_idx.reshape(-1)
    counts = flat_e.new_zeros(e).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    rows = all_gather(counts, mesh, batch, 0, "moe/counts").view(-1, e)
    before = rows[:b0 // b_loc].sum(dim=0)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=xt.device) - starts[sorted_e] + before[sorted_e]
    cap = capacity(cfg, lay.b * lay.s)
    keep = pos < cap
    if _records is not None:
        _records.append(dict(probs=probs.detach(), gate_idx=gate_idx, keep=keep, order=order))
    e0 = lay.mi * e_loc if e_loc != e else 0
    mine = keep & (sorted_e >= e0) & (sorted_e < e0 + e_loc)
    dest = torch.where(mine, (sorted_e - e0) * cap + pos, torch.full_like(pos, e_loc * cap))
    src = lay.d_block(xt) if keep_d and not lay.stationary else xt
    buf = src.new_zeros((e_loc * cap + 1, src.shape[1]))
    buf[dest] = src[order // k]
    buf = buf[: e_loc * cap].view(e_loc, cap, -1)
    out = _experts_stationary(p, buf, cfg, lay) if keep_d else _experts(p, buf, cfg)
    out = out.reshape(e_loc * cap, -1)
    ys = torch.where(mine[:, None], out[dest.clamp(0, e_loc * cap - 1)], 0.0)
    upd = ys * gate_vals.reshape(-1)[order].to(ys.dtype)[:, None]

    # each token's k entries in ascending expert id: their places in the
    # dispatch order, sorted
    place = torch.empty_like(order)
    place[order] = torch.arange(t * k, device=xt.device)
    choices = upd[place.view(t, k).sort(dim=1).values].view(b, s, k, -1)
    f_loc = p["w_down" if cfg.mlp_kind == "swiglu" else "w_out"].shape[-2]
    choices = lay.scatter_seq(choices, e_loc != e or f_loc != cfg.d_ff, "moe/out")
    y = choices.new_zeros(choices.shape[:2] + choices.shape[3:])
    for j in range(k):
        y = y + choices[:, :, j]
    if keep_d:
        y = lay.whole_d(y, "moe/data")[lay.b0 - b0:lay.b0 - b0 + lay.b_loc]
    return y, aux


def _experts_stationary(w: dict, buf: torch.Tensor, cfg: ModelConfig, lay) -> torch.Tensor:
    """:func:`_experts` over ``buf [E, C, d / data]``, this rank's block of
    ``d_model`` of every row, with the expert stacks' ``d_model`` blocks
    in place: the in-projections' float32 partial products summed over
    ``data`` in one all-reduce and rounded once, where one rank's product
    rounds once; the out-projection gives this rank's block of the
    output."""
    from ..distributed.collectives import psum

    names = ("w_gate", "w_up") if cfg.mlp_kind == "swiglu" else ("w_in",)
    part = torch.cat([torch.bmm(buf.float(), w[n].float()) for n in names], dim=-1)
    h = psum(part, lay.mesh, "data", "moe/experts").to(buf.dtype)
    if cfg.mlp_kind == "swiglu":
        g, u = h.chunk(2, dim=-1)
        return torch.bmm(F.silu(g.float()).to(buf.dtype) * u, w["w_down"])
    h = F.gelu(h.float(), approximate="tanh").to(buf.dtype)
    return torch.bmm(h, w["w_out"])


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
    if not _a2a_applicable(cfg, mesh):
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


def _moe_block_a2a_ranks(p: dict, x: torch.Tensor, cfg: ModelConfig, lay
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The a2a dispatch inside the sharded MoE model: the body runs on
    ``x``, this rank's block of the residual stream, which is the block
    ``a2a_layout``'s ``x_spec`` gives it (the batch over the rules' batch
    axes, the sequence over ``model`` where the rules put it there), and
    returns the output's block, with no slicing and no reassembly.  ``p``
    holds the layer's ``moe`` leaves as the parameter rules place them,
    which the layer leaves ungathered: this rank's blocks by
    :data:`A2A_PARAM_SPECS` under ``PARAM_RULES``, or the whole leaves
    under small-DP's rules, of which the rank takes its blocks with no
    collective (as ``shard_map`` takes its operands' blocks).  Where the
    two layouts differ (small-DP's first batch candidate does not divide
    the batch, so ``x_spec`` leaves it whole while the stream takes a
    later candidate), the stream's blocks are gathered whole
    (``moe_a2a/in``), the dispatch cuts and reassembles them as
    :func:`_moe_block_a2a` does, and the rank keeps its block."""
    from ..distributed.actctx import active
    from ..distributed.collectives import all_gather

    mesh, rules = lay.mesh, active()[1]
    al = a2a_layout(cfg, mesh.shape, rules, lay.b, lay.s)
    if p["router"].shape[-1] == cfg.n_experts:
        p = {n: w[shard_index(n, w.shape, mesh.shape, mesh.coords)] for n, w in p.items()}
    if (al.dp, al.seq_sharded) == (lay.batch, lay.seq_sharded):
        return _a2a_body(p, x, cfg, mesh, al)
    x = lay.gather_seq(all_gather(x, mesh, lay.batch, 0, "moe_a2a/in"), "moe_a2a/in")
    y, aux = _moe_block_a2a(p, x, cfg, mesh, rules)
    return lay.rows(y)[:, lay.s0:lay.s0 + lay.s_loc], aux


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
        _records.append(dict(probs=probs.detach(), gate_idx=gate_idx, keep=keep, order=order))
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
