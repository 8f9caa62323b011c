"""Decoder-only stacks: dense, MoE, SSM (mamba) and hybrid (jamba), and
VLM (the VLM prepends patch embeddings in ``model``; its stack is dense).

Parameters keep the reference's stacked layout, so converting the
reference's parameters is a copy: every leaf of ``stack`` is ``[L, ...]``;
the hybrid stack declares one repeating period of ``cfg.attn_period``
slots, ``stack["slot{s}"]``, each leaf ``[n_periods, ...]`` (attention at
slot ``attn_offset``, mamba elsewhere, MoE on the slots ``is_moe_layer``
picks).  Where the reference scans over the stack (``lax.scan``), the port
runs a Python loop over layers (over periods, then the slots of each),
indexing one layer or period of every leaf (a view, no copy); with
``cfg.remat`` a training pass checkpoints each layer, or each period of
the hybrid stack (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).  Decode caches keep the same stacking — attention
``{"k", "v"}`` of ``[L, B, S_max, nkv, hd]``, mamba ``{"conv", "h"}`` of
``[L, B, k-1, d_in]`` and ``[L, B, d_in, N]``, the hybrid's nested under
``"slot{s}"`` with ``L`` its periods — and each layer writes its slice in
place.

On a rank mesh every decoder-only stack runs sharded (``lay``, the
model's ``RankLayout``): the residual stream between layers is this
rank's block (the reference's ``constrain(x, ("batch", "seq", None))`` at
each layer), each layer's weights are gathered along ``d_model`` by one
collective just before the layer runs and dropped after it
(:func:`gather_layer`), and the layer runs attention and MLP on this
rank's heads and ``d_ff`` columns, the MoE block on its experts
(``models/moe.py``: the global gather dispatch, or the a2a body on the
stream's block, whose ``moe`` leaves the layer's gather leaves to it), or
the mamba block on its ``d_inner`` channels (``models/ssm.py``).  A
hybrid period runs each of its slots as that slot's own family runs its
layer: the gather takes one slot's weights with that slot's declaration
(``_one_layer_defs`` of its mixer and ffn), just before the slot, and
drops them after it, so a rank never holds more than one slot's gathered
weights (at jamba-v0.1-52b's width an MoE slot's, 2.8 GB in bf16 on a
(2, 2) mesh, where the whole period's would be 12.8 GB more); which
``moe`` leaves the gather leaves in place follows the slot's ffn
(:func:`moe_kept_leaves`).  The gathers lie inside the checkpointed unit
(a layer, or a hybrid period, as the reference's ``jax.checkpoint`` over
its scan body), so a training pass under ``cfg.remat`` gathers them again
when the backward pass recomputes the unit, and drops them after, as the
reference's ZeRO-3 under ``jax.checkpoint`` does.  The recomputation
stops at the unit's last saved tensor (``torch.utils.checkpoint``'s early
stop, on by default), so it issues the unit's collectives up to its last
MLP's input gather (a mamba layer's up to its ``mamba/dtbc`` sum, an MoE
layer's under the gather dispatch up to its ``moe/counts`` gather, under
the a2a dispatch all of them: its combine saves its indices after the
last all-to-all); a hybrid period's recomputation issues every slot's
collectives but the last slot's output collective (jamba's: slot 7's
``moe/out`` under the gather dispatch, none under the a2a), each counted
as the backward pass's (``collectives.recomputing``).  The recomputed MoE
layer routes as its forward pass did: the same inputs, the same
deterministic router, sort and capacity.  A decode tick on a rank mesh
gathers each layer's (each slot's) weights the same way, and each
attention layer writes the new token's k and v into this rank's block of
the caches where the block holds its position; a mamba layer updates its
rows and channels of the conv window and the state.  Where the decode's
batch does not split over ``data`` a dense, SSM or hybrid stack keeps every
``d_model`` block in place instead (``RankLayout.stationary``): the
residual stream whole on every rank, both norms giving this rank's block
of ``d_model``, every in-projection (attention's q, k and v, the MLP's
gate and up, the MoE router and expert in-projections, mamba's ``w_in``)
a float32 partial product over that block summed over ``data``, every
out-projection landing on the rank's block, which one all-gather over
``data`` makes whole again (``attn/data``, ``mlp/data``, ``moe/data``,
``mamba/data``), as GSPMD partitions the reference's decode cell.  An MoE
tick under the gather dispatch keeps its expert stacks' blocks in place
(``RankLayout.experts_stationary``).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.collectives import recomputing
from ..obs.device import span
from .attention import attn_defs, decode_attention, full_attention
from .layers import mlp_block, mlp_defs, rms_norm
from .moe import a2a_on_ranks, moe_block, moe_defs
from .params import P, Tree, tree_map_defs
from .ssm import mamba_block, mamba_decode, mamba_defs

Cache = Any

#: A prefill layer's parts on the timeline (``obs``), keyed by the layer's
#: index: each norm, the attention mixer without its norm, the ffn without
#: its norm (MLP or MoE).
_NORM, _ATTN, _MLP = (span(f"layer.{part}") for part in ("norm", "attn", "mlp"))


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------

def _slot_kind(cfg: ModelConfig, layer: int) -> Tuple[str, str]:
    """(mixer, ffn) kind for absolute layer index."""
    mixer = "attn" if cfg.is_attn_layer(layer) else "mamba"
    if cfg.d_ff == 0:
        ffn = "none"
    elif cfg.is_moe_layer(layer):
        ffn = "moe"
    else:
        ffn = "mlp"
    return mixer, ffn


def _one_layer_defs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    d = cfg.d_model
    defs: dict = {"ln1": P((d,), ("d_model",), "ones")}
    defs[mixer] = attn_defs(cfg) if mixer == "attn" else mamba_defs(cfg)
    if ffn != "none":
        defs["ln2"] = P((d,), ("d_model",), "ones")
        defs[ffn] = mlp_defs(cfg) if ffn == "mlp" else moe_defs(cfg)
    return defs


def _stack(defs: Tree, n: int, axis: str = "layers") -> Tree:
    return tree_map_defs(
        lambda p: P((n,) + p.shape, (axis,) + p.axes, p.init, p.stddev), defs
    )


def _n_periods(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_period


def stack_defs(cfg: ModelConfig) -> Tree:
    """Layer-stack parameter declaration (see module docstring)."""
    if cfg.family == "hybrid":
        period = {}
        for s in range(cfg.attn_period):
            mixer, ffn = _slot_kind(cfg, s)
            period[f"slot{s}"] = _one_layer_defs(cfg, mixer, ffn)
        return _stack(period, _n_periods(cfg), "period")
    mixer, ffn = _slot_kind(cfg, 0)
    return _stack(_one_layer_defs(cfg, mixer, ffn), cfg.n_layers)


def model_defs(cfg: ModelConfig) -> Tree:
    d, v = cfg.d_model, cfg.vocab_size
    defs: Tree = {
        "embed": P((v, d), ("vocab", "d_model")),
        "stack": stack_defs(cfg),
        "ln_f": P((d,), ("d_model",), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = P((d, v), ("d_model", "vocab"))
    return defs


def _index_tree(tree: Tree, i: int) -> Tree:
    """Layer (or period) ``i`` of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_trees(trees) -> Tree:
    """Stack same-structured trees leaf by leaf on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Layer application (single layer, given its params)
# ---------------------------------------------------------------------------

def _part(sp, index):
    """The entry of the layer's part ``sp`` keyed ``index``; none where
    ``index`` is None."""
    return nullcontext() if index is None else sp(index)


def _apply_layer_full(lp: dict, x: torch.Tensor, cfg: ModelConfig, rope, mixer: str,
                      ffn: str, collect_state: bool, lay=None, index=None):
    """→ (x, aux, state): the MoE balance term (float32, zero without an
    MoE), and the layer's cache contribution — attn: {"k","v"} over the S
    positions seen; mamba: {"conv","h"} final — or None.  ``lay``: the
    layer on a rank mesh (module docstring); ``index``: the layer's, the
    key of its spans (None: no spans)."""
    state = None
    with _part(_NORM, index):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mixer == "attn":
        with _part(_ATTN, index):
            y, (k, v) = full_attention(lp["attn"], h, cfg, rope, causal=True, lay=lay)
        if collect_state:
            state = {"k": k, "v": v}
    elif collect_state:
        y, state = mamba_block(lp["mamba"], h, cfg, return_state=True, lay=lay)
    else:
        y = mamba_block(lp["mamba"], h, cfg, lay=lay)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        with _part(_NORM, index):
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        with _part(_MLP, index):
            if ffn == "moe":
                y, aux = moe_block(lp["moe"], h, cfg, lay)
            else:
                y = mlp_block(lp["mlp"], h, cfg, lay)
        x = x + y
    return x, aux, state


def _apply_layer_decode(lp: dict, x: torch.Tensor, cfg: ModelConfig, rope, mixer: str,
                        ffn: str, cache: Dict[str, torch.Tensor], pos: int,
                        lay=None) -> torch.Tensor:
    keep = lay is not None and lay.stationary        # every d_model block in place
    h = rms_norm(x, lp["ln1"], cfg.norm_eps, lay if keep else None)
    if mixer == "attn":
        y, _, _ = decode_attention(lp["attn"], h, cfg, rope, cache["k"], cache["v"], pos, lay)
    else:
        y, conv_c, h_c = mamba_decode(lp["mamba"], h, cfg, cache["conv"], cache["h"], lay)
        cache["conv"].copy_(conv_c)
        cache["h"].copy_(h_c)
    x = x + y
    if ffn != "none":
        h = rms_norm(x, lp["ln2"], cfg.norm_eps, lay if keep else None)
        if ffn == "moe":
            if keep and a2a_on_ranks(cfg, lay.mesh):    # the a2a body takes whole rows
                h = lay.whole_d(h, "moe_a2a/in")
            y, _ = moe_block(lp["moe"], h, cfg, lay)
        else:
            y = mlp_block(lp["mlp"], h, cfg, lay)
        x = x + y
    return x


# ---------------------------------------------------------------------------
# Stack application
# ---------------------------------------------------------------------------

def _units(cfg: ModelConfig):
    """The stack's repeating units → (count, [(slot key or None, mixer,
    ffn)]): the layers of a uniform stack, or the periods of the hybrid."""
    if cfg.family == "hybrid":
        return _n_periods(cfg), [(f"slot{s}",) + _slot_kind(cfg, s)
                                 for s in range(cfg.attn_period)]
    return cfg.n_layers, [(None,) + _slot_kind(cfg, 0)]


def apply_stack_full(
    cfg: ModelConfig,
    stack: Tree,
    x: torch.Tensor,
    rope,
    collect_state: bool = False,
    lay=None,
):
    """Full-sequence pass → (x, aux_loss, states_stacked | None).  The
    auxiliary loss is the MoE balance term summed over the layers, zero
    for the stacks without MoE.  With ``cfg.remat``, no state to collect
    and grad enabled, each layer (each period of the hybrid stack) is
    checkpointed: its activations are recomputed in the backward pass
    instead of kept.  ``lay``: the stack on a rank mesh, each slot's
    weights gathered just before it runs (module docstring).  A pass that
    collects state (a prefill) marks each layer's parts on the timeline
    (``obs``)."""
    n_units, slots = _units(cfg)

    def unit(up, x, aux, first=None):
        states = {}
        for si, (key, mixer, ffn) in enumerate(slots):
            lp = up if key is None else up[key]
            if lay is not None:
                lp = gather_layer(cfg, lp, _one_layer_defs(cfg, mixer, ffn), lay, ffn)
            x, a, st = _apply_layer_full(lp, x, cfg, rope, mixer, ffn, collect_state, lay,
                                         None if first is None else first + si)
            del lp      # this slot's gathered weights, before the next slot's gather
            aux = aux + a
            states[key] = st
        # A uniform stack's unit is one layer, whose state is the unit's.
        return x, aux, states.get(None, states)

    remat = cfg.remat and not collect_state and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    states = []
    for ui in range(n_units):
        up = _index_tree(stack, ui)
        if remat:
            x, aux, st = checkpoint(unit, up, x, aux, use_reentrant=False,
                                    context_fn=_remat_contexts)
        else:
            x, aux, st = unit(up, x, aux, ui * len(slots) if collect_state else None)
        states.append(st)
    if not collect_state:
        return x, aux, None
    return x, aux, _stack_trees(states)


def gather_layer(cfg: ModelConfig, up: Tree, defs: Tree, lay, ffn: str) -> Tree:
    """One layer's (one slot's) weights, declared by ``defs``, with
    ``d_model`` whole (``RankLayout.gather_params``), but the ``moe``
    leaves that stay as they are (:func:`moe_kept_leaves` of its ``ffn``):
    all of them where the layer takes the a2a dispatch, whose body gathers
    them over ``data`` itself, and the expert stacks where the layout keeps
    their ``d_model`` blocks in place (``experts_stationary``)."""
    kept = moe_kept_leaves(cfg, ffn, lay.mesh, lay.experts_stationary)
    if not kept:
        return lay.gather_params(up, defs, "layer")
    out = lay.gather_params(_without(up, kept), _without(defs, kept), "layer")
    out["moe"] = dict(out.get("moe", {}), **{k: up["moe"][k] for k in kept})
    return out


def moe_kept_leaves(cfg: ModelConfig, ffn: str, mesh, experts_stationary: bool
                    ) -> Tuple[str, ...]:
    """The ``moe`` leaves a layer (or slot) whose ffn is ``ffn`` leaves as
    they are in its gather over ``data`` on a rank mesh of ``mesh``'s shape
    (:func:`gather_layer`): none but for an MoE ffn."""
    if ffn != "moe":
        return ()
    names = tuple(moe_defs(cfg))
    if a2a_on_ranks(cfg, mesh):
        return names
    return tuple(n for n in names if n != "router") if experts_stationary else ()


def _without(tree: Tree, kept: Tuple[str, ...]) -> Tree:
    """``tree`` without the ``moe`` leaves ``kept`` (and without ``moe``
    where none is left)."""
    rest = {k: v for k, v in tree["moe"].items() if k not in kept}
    out = {k: v for k, v in tree.items() if k != "moe"}
    if rest:
        out["moe"] = rest
    return out


def _remat_contexts():
    """A checkpointed unit's contexts: none for its forward, and
    ``collectives.recomputing`` for its recomputation."""
    return nullcontext(), recomputing()


def apply_stack_decode(
    cfg: ModelConfig,
    stack: Tree,
    x: torch.Tensor,
    rope,
    caches: Cache,
    pos: int,
    lay=None,
):
    """One-token pass → (x, caches); each layer writes its slice of the
    stacked caches in place, and the same dict is returned.  An MoE
    layer's auxiliary loss is dropped, as in the reference.  ``lay``: the
    stack on a rank mesh under the decode rules, whose caches are this
    rank's blocks, each slot's weights gathered just before it runs, or
    none where the layout is ``stationary`` (module docstring;
    ``attention.decode_attention``, ``ssm.mamba_decode``)."""
    n_units, slots = _units(cfg)
    for ui in range(n_units):
        up, cu = _index_tree(stack, ui), _index_tree(caches, ui)
        for key, mixer, ffn in slots:
            lp, cc = (up, cu) if key is None else (up[key], cu[key])
            if lay is not None and not lay.stationary:
                lp = gather_layer(cfg, lp, _one_layer_defs(cfg, mixer, ffn), lay, ffn)
            x = _apply_layer_decode(lp, x, cfg, rope, mixer, ffn, cc, pos, lay)
            del lp
    return x, caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _attn_cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Dict[str, P]:
    hd = cfg.resolved_head_dim
    return {
        "k": P((batch, s_max, cfg.n_kv_heads, hd),
               ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
        "v": P((batch, s_max, cfg.n_kv_heads, hd),
               ("batch", "kv_seq", "kv_heads", "head_dim"), "zeros"),
    }


def _mamba_cache_defs(cfg: ModelConfig, batch: int) -> Dict[str, P]:
    return {
        "conv": P((batch, cfg.ssm_conv - 1, cfg.d_inner),
                  ("batch", None, "d_inner"), "zeros"),
        "h": P((batch, cfg.d_inner, cfg.ssm_state),
               ("batch", "d_inner", "ssm_state"), "zeros"),
    }


def _mixer_cache_defs(cfg: ModelConfig, mixer: str, batch: int, s_max: int) -> Dict[str, P]:
    return (_attn_cache_defs(cfg, batch, s_max) if mixer == "attn"
            else _mamba_cache_defs(cfg, batch))


def cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Tree:
    """Declaration of the decode cache tree (P descriptors)."""
    if cfg.family == "hybrid":
        period = {}
        for s in range(cfg.attn_period):
            mixer, _ = _slot_kind(cfg, s)
            period[f"slot{s}"] = _mixer_cache_defs(cfg, mixer, batch, s_max)
        return _stack(period, _n_periods(cfg), "period")
    mixer, _ = _slot_kind(cfg, 0)
    return _stack(_mixer_cache_defs(cfg, mixer, batch, s_max), cfg.n_layers)
