"""Sharded runs of a model of any family over a rank mesh:
what each rank runs for a train step, ``Model.prefill``, decode ticks and
``Model.loss`` under the baseline, ``opt`` and small-DP policies, and the
collectives they issue, by formula.  An MoE layer issues, under the
baseline's gather dispatch, the sequence's gather (``moe/in``), the
router's (``moe/router``), the balance statistics' sum and the expert
counts' gather over the batch's ranks (``moe/aux``, ``moe/counts``) and
the per-choice outputs' reduce-scatter (``moe/out``), a decode tick the
rows' gather and the in-projections' float32 sum over ``data``
(``moe/rows``, ``moe/experts``) and the output block's gather
(``moe/data``); under ``opt`` the a2a body's (``moe_a2a/*``), each with
its transpose in a train step.  A hybrid period issues its slots' ops in
slot order, each slot its own family's and its own gather over ``data``
(``layer``, of that slot's leaves alone); its checkpointed recomputation
re-issues every slot's up to the period's last saved tensor (all but the
last slot's output collective).  A tick whose batch does not split over
``data`` (a dense, VLM, SSM or hybrid model, ``stationary``) gathers no
weights: each slot sums its in-projections' float32 partial products over
``data`` (``attn/in``, ``mamba/in``, ``mlp/in``, ``moe/route`` with
``moe/experts``) and gathers its output's block of ``d_model`` over it
(``attn/data``, ``mamba/data``, ``mlp/data``, ``moe/data``).  A VLM's
stream holds its vision prefix; an encoder-decoder's encoder issues its
own section first (``enc/in``, its layers, ``enc/out``) and each decoder
layer the cross-attention's ops (``xattn/in``, ``xattn/out``).

:func:`run` is a target of ``distributed/ranks.py::run_ranks``: every rank
calls it with the same payload, and for each case of ``payload["cases"]``
(each with ``payload``'s other keys as defaults) builds the rank mesh
(``launch/mesh.py::_make_mesh``) over ``("data", "model")``, or
``("pod", "data", "model")`` for a mesh of three axes, takes the case's
rules (its ``rules`` with ``PARAM_RULES``, or the port's
``launch/dryrun.py::policy_rules`` for its ``policy``), takes its blocks
of the parameters by the parameter rules and runs, under
``activation_sharding(mesh, rules, param_rules)``, the steps the case
names by its entries, in this order: ``"train": {"tokens": [B, S],
"steps": n, "accum": a, "host": ...}``, ``"grad": {"tokens": [B, S]}``
(the loss's gradient and its whole norm, no optimizer), ``"prefill":
{"tokens": [B, S],
"s_max": ... (default the stream's length), "reps": ..., "routing":
...}``, ``"decode": [entry, ...]`` (:func:`_decode`) and ``"loss":
{"tokens": ..., "loss_mask": ... (optional), "cfg": ... (optional),
"reps": ..., "routing": ...}`` (numpy, the whole batch; each of
``"train"``, ``"grad"``, ``"prefill"`` and ``"loss"`` with a VLM's
``vision_embeds`` or an encoder-decoder's ``frames`` beside its tokens,
:func:`_batch`), the later ones on the
parameters the train steps left (``routing``: return the MoE layers'
routing, ``models/moe.py::recording``).  The
decode entries run under ``policy_rules``' rules for a decode cell
(``ACT_RULES_DECODE``), the parameters as the case holds them.
Parameters are either given whole (``params``: numpy, the reference's
layout; each rank keeps its blocks, ``convert.shard_params``) or made
from ``seed`` on the rank's device, each rank drawing the whole tree and
keeping its blocks (``Model.init(shard=sharding.rank_shard(mesh,
param_rules))``).  Each step's collectives are counted
(``hlo_analysis.counting_collectives``; a train entry's of its first
step) and come back as ``(kind, result_bytes, group, path)``, in issue
order.  :func:`assemble_logits` puts the ranks' blocks of the prefill's
logits together, :func:`assemble_blocks` those of a decode tick.

    run_ranks("repro_torch.launch.sharded:run", 8,
              {"device": "cpu", "cases": [case, ...]}, timeout_s=300)
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import List

import torch

from ..configs import get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..distributed import actctx
from ..distributed.collectives import all_gather, staging
from ..distributed.sharding import PARAM_RULES, decode_rules, rank_shard, spec_for
from ..models.attention import rank_kv_heads
from ..models.encdec import dec_layer_defs
from ..models.model import STATIONARY_FAMILIES, Model
from ..models import moe
from ..models.params import dtype_of, flatten, param_axes, unflatten
from ..models.transformer import (
    _attn_cache_defs,
    _one_layer_defs,
    _units,
    _without,
    moe_kept_leaves,
)
from .expert import Op, _host, _ops, _route, _sync
from .hlo_analysis import counting_collectives
from .mesh import Mesh, _make_mesh

AXES = ("pod", "data", "model")


def sharded_collectives(cfg: ModelConfig, mesh_shape: dict, rules: dict, b: int, s: int,
                        param_bytes: int, act_bytes: int, step: str = "prefill",
                        accum: int = 1, param_rules=None, s_max=None) -> List[Op]:
    """The collectives one sharded ``Model.prefill`` (``step="prefill"``),
    ``Model.loss`` (``"loss"``), train step (``"train"``, ``accum``
    microbatches) of a ``[b, s]`` batch of tokens, or decode tick
    (``"decode"``) of a ``[b, 1]`` token, issues on a rank, in order, for
    parameters of ``param_bytes`` an element (by ``param_rules``, default
    ``PARAM_RULES``) and activations of ``act_bytes``.  ``s_max``: the
    caches' length (default the stream's, a VLM's vision prefix included;
    a tick's ``s``).

    Forward: the embedding's gather over ``data`` and its sum into the
    residual stream's block; per layer (per slot of a hybrid period, the
    period's ops times its periods), one gather of the layer's
    ``d_model`` blocks over ``data``, and for attention and the MLP each
    the sequence gathered over ``model`` and the row-parallel sum
    scattered back, for a mamba layer the sequence gathered, the float32
    sum of ``w_dt``, ``w_b`` and ``w_c``'s partial products
    (``mamba/dtbc``) and the row-parallel float32 sum scattered back; then
    the prefill's last position or the loss's whole stream gathered over
    ``model`` and the head's gather over ``data`` (of the embedding, for
    a tied head); the prefill's caches moved to the decode layout
    (``prefill/cache``: an all-to-all over ``model``, an all-gather where
    the positions do not split, none where the q heads do not, nor for an
    SSM's states); the loss's vocab-parallel combination over ``model``
    and its sums over the batch's axes.  A VLM's stream holds its
    ``n_vision_tokens`` before the tokens.  An encoder-decoder runs its
    encoder first on the layout of ``enc_seq`` positions (``enc_in`` and
    ``ln_enc`` gathered over ``data``, ``enc/in``; its layers as the
    dense family's, not causal; its output gathered over ``model``,
    ``enc/out``), then its decoder, whose embedding sums in the
    parameters' dtype and whose layers add the cross-attention's sequence
    gather and row-parallel sum (``xattn/in``, ``xattn/out``) after the
    self-attention's; its prefill moves the cross caches too
    (``prefill/xcache``: the rank's kv heads gathered over ``model``).  A
    decode tick (:func:`_decode_sections`, ``rules`` the decode rules) has
    no sequence to gather, and the launcher's greedy pick ends it.

    A train step runs, for each microbatch, the loss's forward and then
    its backward: each op's transpose (``distributed/collectives.py``) in
    reverse order, where under ``cfg.remat`` each checkpointed unit (a
    layer, or a hybrid period) issues its forward again up to its last
    saved tensor (the checkpoint's recomputation: every slot's gather
    over ``data`` again, but not the unit's last output collective, which
    comes before it, transposed) and each gather's gradient
    reduce-scatter comes after its slot's backward.  Then the sums of the leaves held
    alike along some axes (``actctx.sum_replicated``: ``model``, ``pod``,
    every axis under small-DP; float32 when ``accum > 1``), and the grad
    norm's all-reduce over the mesh (``actctx.whole_sq_sums``)."""
    mesh = Mesh(tuple(mesh_shape), tuple(mesh_shape.values()))
    param_rules = PARAM_RULES if param_rules is None else param_rules
    defs = Model(cfg).defs()
    if step == "decode":
        embed, unit, head = _decode_sections(cfg, defs, mesh, rules, param_rules, b,
                                             s if s_max is None else s_max, param_bytes,
                                             act_bytes)
        return embed + unit * _units(cfg)[0] + head
    if step != "train":
        segments = _loss_sections(cfg, defs, mesh, rules, param_rules, b, s, param_bytes,
                                  act_bytes, step, s_max)
        return [op for ops, n in segments for op in ops * (n or 1)]
    segments = _loss_sections(cfg, defs, mesh, rules, param_rules, b // accum, s, param_bytes,
                              act_bytes, "loss")
    backward = []
    for ops, n in reversed(segments):
        if n is None:
            backward += [_transpose(op) for op in reversed(ops)]
            continue
        # the unit's output collective, after its last saved tensor
        tail = ops[-1:] if ops and ops[-1][3] in ("mlp/out", "mamba/out", "moe/out") else []
        rest = ops[:len(ops) - len(tail)]
        again = [(k, nb, g, f"{path}/bwd") for k, nb, g, path in rest] if cfg.remat else []
        backward += ([_transpose(op) for op in tail] + again
                     + [_transpose(op) for op in reversed(_with_gradient(rest))]) * n
    ops = ([op for seg, n in segments for op in seg * (n or 1)] + backward) * accum
    grad_bytes = 4 if accum > 1 else param_bytes
    leaves = [(p, actctx.replicated_axes(p, mesh, param_rules)) for _, p in flatten(defs)]
    sums: dict = {}
    for p, axes in leaves:
        if axes:
            numel = math.prod(p.shape) // _ways(p, mesh, param_rules)
            sums[axes] = sums.get(axes, 0) + numel * grad_bytes
    ops += [("all-reduce", n, math.prod(mesh_shape[a] for a in axes), "grads")
            for axes, n in sums.items()]
    every = tuple(a for a, n in mesh_shape.items() if n > 1)
    if any(axes != every for _, axes in leaves):
        ops.append(("all-reduce", 4 * len(leaves), math.prod(mesh_shape.values()), "grad_norm"))
    return ops


def _with_gradient(ops: List[Op]) -> List[Op]:
    """The ops among a unit's forward ``ops`` whose results carry a
    gradient: not the expert counts (``moe/counts``), nor an a2a body's
    top-1 counts and token count (the second and third of each run of
    ``moe_a2a/aux`` sums; the first sums the probabilities)."""
    out, aux = [], 0
    for op in ops:
        aux = aux + 1 if op[3] == "moe_a2a/aux" else 0
        if op[3] != "moe/counts" and aux < 2:
            out.append(op)
    return out


def _moe_ops(cfg: ModelConfig, mesh, rules, param_rules, b: int, s: int, seq: bool,
             batch, param_bytes: int, act_bytes: int, keep_d: bool = False,
             stationary: bool = False) -> List[Op]:
    """An MoE layer's ops after its attention's: the a2a body's where it
    applies (``launch/expert.py::a2a_collectives`` without the
    reassembly; where the a2a layout is not the stream's, the stream's
    blocks gathered whole first and the reassembly kept,
    ``moe._moe_block_a2a_ranks``; under ``stationary`` the normed rows'
    ``d_model`` blocks gathered over ``data`` first), else the sharded
    gather dispatch's (``moe._moe_block_ranks``): the sequence gathered
    over ``model``, the router's columns gathered where the experts split,
    the balance statistics' float32 sum and the per-expert counts' gather
    (int64) over the batch's ranks, and the per-choice outputs
    reduce-scattered (summed where the sequence is whole) where the
    experts or ``d_ff`` split.  ``keep_d`` (a decode tick's
    ``experts_stationary``): the rows gathered over ``data`` first (the
    sums and counts then over the other batch axes), the in-projections'
    float32 partial products summed over ``data``, the per-choice outputs
    on the rank's ``d_model`` block, which is gathered over ``data`` last.
    ``stationary`` (a tick whose batch does not split over ``data``): the
    router's block of ``d_model`` gathered over ``model`` alone and its
    float32 partial products summed over ``data`` (``moe/route``)."""
    from .expert import a2a_collectives

    n_model, n_data = mesh.shape.get("model", 1), mesh.shape.get("data", 1)
    b_loc = b // math.prod(mesh.shape[a] for a in batch)
    if moe.a2a_on_ranks(cfg, mesh):
        ops = a2a_collectives(cfg, dict(mesh.shape), rules, b, s, param_bytes, act_bytes)
        al = moe.a2a_layout(cfg, dict(mesh.shape), rules, b, s)
        ins = ([("all-gather", b_loc * s * cfg.d_model * act_bytes, n_data, "moe_a2a/in")]
               if stationary else [])
        if (al.dp, al.seq_sharded) == (tuple(batch), seq):
            return ins + [op for op in ops if op[3] != "moe_a2a/reassemble"]
        if b != b_loc:
            ins.append(("all-gather", b * s // (n_model if seq else 1) * cfg.d_model * act_bytes,
                        b // b_loc, "moe_a2a/in"))
        if seq:
            ins.append(("all-gather", b * s * cfg.d_model * act_bytes, n_model, "moe_a2a/in"))
        return ins + ops
    d, d_out, e, k, f = cfg.d_model, cfg.d_model, cfg.n_experts, cfg.top_k, cfg.d_ff
    experts = _split(param_rules, mesh, "experts", e)
    ffn = not experts and _split(param_rules, mesh, "d_ff", f)
    ops = [("all-gather", b_loc * s * d * act_bytes, n_model, "moe/in")] if seq else []
    if keep_d:
        d_out //= n_data
        if "data" in batch:
            b_loc *= n_data
            ops.append(("all-gather", b_loc * s * d * act_bytes, n_data, "moe/rows"))
            batch = tuple(a for a in batch if a != "data")
    n_batch = math.prod(mesh.shape[a] for a in batch)
    if experts:
        ops.append(("all-gather", (d_out if stationary else d) * e * param_bytes, n_model,
                    "moe/router"))
    if stationary:
        ops.append(("all-reduce", b_loc * s * e * 4, n_data, "moe/route"))
    if n_batch > 1:
        ops += [("all-reduce", (2 * e + 1) * 4, n_batch, "moe/aux"),
                ("all-gather", n_batch * e * 8, n_batch, "moe/counts")]
    if keep_d:
        e_loc, f_loc = e // (n_model if experts else 1), f // (n_model if ffn else 1)
        width = f_loc * (2 if cfg.mlp_kind == "swiglu" else 1)
        ops.append(("all-reduce", e_loc * moe.capacity(cfg, b * s) * width * 4, n_data,
                    "moe/experts"))
    if experts or ffn:
        ops.append(("reduce-scatter", b_loc * s // n_model * k * d_out * act_bytes, n_model,
                    "moe/out") if seq else
                   ("all-reduce", b_loc * s * k * d_out * act_bytes, n_model, "moe/out"))
    if keep_d:
        ops.append(("all-gather", b_loc * s * d * act_bytes, n_data, "moe/data"))
    return ops


def _layer_defs(cfg: ModelConfig, mixer: str, ffn: str, mesh, keep_d: bool = False) -> dict:
    """The leaves a layer's (or slot's) gather over ``data`` takes
    (``transformer.gather_layer``): all but the ``moe`` leaves it leaves
    in place (``transformer.moe_kept_leaves``; ``keep_d``: a decode
    tick's ``experts_stationary``); an encoder-decoder's decoder layer's
    all of them."""
    if cfg.family == "encdec":
        return dec_layer_defs(cfg)
    defs = _one_layer_defs(cfg, mixer, ffn)
    kept = moe_kept_leaves(cfg, ffn, mesh, keep_d)
    return _without(defs, kept) if kept else defs


def _ways(p, mesh, param_rules) -> int:
    """The number of blocks a leaf declared by ``p`` is cut into."""
    n = 1
    for entry in spec_for(p.shape, p.axes, mesh, param_rules):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh.shape[a] if a is not None else 1
    return n


def _transpose(op: Op) -> Op:
    """The backward collective of a forward one (``collectives.py``)."""
    kind, nbytes, group, path = op
    if kind == "all-gather":
        return "reduce-scatter", nbytes // group, group, f"{path}/bwd"
    if kind == "reduce-scatter":
        return "all-gather", nbytes * group, group, f"{path}/bwd"
    return kind, nbytes, group, f"{path}/bwd"


def _gather_params(tree: dict, path: str, mesh, param_rules, param_bytes: int) -> List[Op]:
    """One all-gather of every block split over an axis other than
    ``model``: each such leaf whole along that axis
    (``RankLayout.gather_params``)."""
    n_model = mesh.shape.get("model", 1)
    nbytes, group = 0, 1
    for _, p in flatten(tree):
        leaf = spec_for(p.shape, p.axes, mesh, param_rules)
        other = [e for e in leaf if e not in (None, "model")]
        if other:
            group = math.prod(mesh.shape[a] for a in
                              (other[0] if isinstance(other[0], tuple) else (other[0],)))
            nbytes += math.prod(p.shape) // n_model ** leaf.count("model") * param_bytes
    return [("all-gather", nbytes, group, path)] if group > 1 else []


def _split(param_rules, mesh, axis: str, n: int) -> bool:
    """Whether a dimension of ``n`` with logical ``axis`` splits over
    ``model``."""
    n_model = mesh.shape.get("model", 1)
    return param_rules.get(axis) == "model" and n_model > 1 and n % n_model == 0


def _head_defs(cfg: ModelConfig, defs) -> dict:
    """The leaves the head gathers: ``ln_f`` and ``lm_head``, or the
    embedding for a tied head."""
    return {k: defs[k] for k in ("ln_f", "embed" if cfg.tie_embeddings else "lm_head")}


def _cache_op(cfg: ModelConfig, mesh, param_rules, b_loc: int, s_max: int,
              act_bytes: int) -> List[Op]:
    """The prefill's caches moved to the decode layout
    (``Model._kv_blocks``): one op for every attention layer's k and v, and
    one for an encoder-decoder's ``ek`` and ``ev`` (an all-gather over
    ``model``: every encoder position); none for the mamba states, nor
    where the q heads do not split."""
    n_model = mesh.shape.get("model", 1)
    n_units, slots = _units(cfg)
    n_attn = n_units * sum(mixer == "attn" for _, mixer, _ in slots)
    if not n_attn or not _split(param_rules, mesh, "heads", cfg.n_heads):
        return []
    heads = cfg.n_kv_heads
    if _split(param_rules, mesh, "kv_heads", heads):
        heads //= n_model
    k = _attn_cache_defs(cfg, b_loc, s_max)["k"]
    kv_split = (spec_for(k.shape, k.axes, mesh, decode_rules(mesh)) + (None,) * 2)[1] == "model"
    nbytes = 2 * n_attn * b_loc * heads * cfg.resolved_head_dim * act_bytes
    ops = ([("all-to-all", nbytes * s_max, n_model, "prefill/cache")] if kv_split
           else [("all-gather", nbytes * s_max * n_model, n_model, "prefill/cache")])
    if cfg.family == "encdec":
        ops.append(("all-gather", nbytes * cfg.enc_seq * n_model, n_model, "prefill/xcache"))
    return ops


def _dtbc(cfg: ModelConfig, mesh, param_rules, rows: int) -> List[Op]:
    """The float32 sum over ``model`` of a mamba layer's ``[rows, dt_rank
    + 2N]`` partial products (``ssm._ssm_inputs``), where ``d_inner``
    splits."""
    if not _split(param_rules, mesh, "d_inner", cfg.d_inner):
        return []
    width = cfg.resolved_dt_rank + 2 * cfg.ssm_state
    return [("all-reduce", rows * width * 4, mesh.shape["model"], "mamba/dtbc")]


def _decode_sections(cfg: ModelConfig, defs, mesh, rules, param_rules, b: int, s_max: int,
                     param_bytes: int, act_bytes: int):
    """(the embedding's ops, one unit's — a layer's, or a hybrid period's
    slot by slot —, the head's and the greedy pick's) of a decode tick
    (``attention._decode_attention_sharded``, ``ssm.mamba_decode``, an
    encoder-decoder's cross-attention on the rank's heads); a model of
    ``STATIONARY_FAMILIES`` whose batch does not split over ``data``
    gathers no weights (``actctx.keeps_d_blocks``): the embedding's and
    each slot's output block of ``d_model`` gathered over ``data``, the
    in-projections' and the head's float32 partial sums over it."""
    batch, _ = actctx.residual_axes(b, 1, cfg.d_model, mesh, rules)
    n_model, n_data = mesh.shape.get("model", 1), mesh.shape.get("data", 1)
    b_loc = b // math.prod(mesh.shape[a] for a in batch)
    # a batch that does not split over data keeps the d_model blocks in place
    keep = cfg.family in STATIONARY_FAMILIES and actctx.keeps_d_blocks(
        actctx.RankLayout(mesh, batch, False, b, 1, param_rules), cfg.d_model)
    d = cfg.d_model // (n_data if keep else 1)

    def split(axis: str, n: int) -> bool:
        return _split(param_rules, mesh, axis, n)

    def to_stream(axis: str, n: int, path: str, nbytes: int = act_bytes) -> List[Op]:
        if not split(axis, n):
            return []
        return [("all-reduce", b_loc * d * nbytes, n_model, path)]

    def whole_d(path: str) -> List[Op]:
        return [("all-gather", b_loc * cfg.d_model * act_bytes, n_data, path)] if keep else []

    def contract(width: int, path: str) -> List[Op]:
        return [("all-reduce", b_loc * width * 4, n_data, path)] if keep else []

    def gather_params(tree: dict, path: str) -> List[Op]:
        return [] if keep else _gather_params(tree, path, mesh, param_rules, param_bytes)

    embed = (gather_params({"embed": defs["embed"]}, "embed")
             + to_stream("vocab", cfg.vocab_size, "embed", _embed_bytes(cfg, param_bytes,
                                                                       act_bytes))
             + whole_d("embed/data"))
    keep_d = (not moe.a2a_on_ranks(cfg, mesh)
              and actctx.keeps_expert_blocks(mesh, param_rules, cfg.d_model))
    unit = []
    for _, mixer, ffn in _units(cfg)[1]:
        unit += gather_params(_layer_defs(cfg, mixer, ffn, mesh, keep_d), "layer")
        if mixer == "mamba":
            din = cfg.d_inner // (n_model if split("d_inner", cfg.d_inner) else 1)
            unit += (contract(2 * din, "mamba/in") + _dtbc(cfg, mesh, param_rules, b_loc)
                     + to_stream("d_inner", cfg.d_inner, "mamba/out", 4) + whole_d("mamba/data"))
        else:
            nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
            k = _attn_cache_defs(cfg, b, s_max)["k"]
            kv_split = (spec_for(k.shape, k.axes, mesh, rules) + (None,) * 2)[1] == "model"
            heads, kv_heads = split("heads", nq), split("kv_heads", nkv)
            unit += contract((nq // (n_model if heads else 1)
                              + 2 * nkv // (n_model if kv_heads else 1)) * hd, "attn/in")
            if heads:
                width = nq + (2 * nkv if kv_heads else 0)
                unit.append(("all-gather", b_loc * width * hd * act_bytes, n_model, "attn/qkv"))
            if kv_split:
                unit += [("all-reduce", b_loc * nq * 4, n_model, "attn/max"),
                         ("all-reduce", b_loc * nq * 4, n_model, "attn/sum"),
                         ("reduce-scatter", b_loc * nq // n_model * hd * 4, n_model, "attn/pv")
                         if heads else ("all-reduce", b_loc * nq * hd * 4, n_model, "attn/pv")]
            unit += to_stream("heads", nq, "attn/out") + whole_d("attn/data")
        if cfg.family == "encdec":
            unit += to_stream("heads", cfg.n_heads, "xattn/out")
        if ffn == "mlp":
            f_loc = cfg.d_ff // (n_model if split("d_ff", cfg.d_ff) else 1)
            unit += (contract(f_loc * (2 if cfg.mlp_kind == "swiglu" else 1), "mlp/in")
                     + to_stream("d_ff", cfg.d_ff, "mlp/out") + whole_d("mlp/data"))
        elif ffn == "moe":
            unit += _moe_ops(cfg, mesh, rules, param_rules, b, 1, False, batch, param_bytes,
                             act_bytes, keep_d, keep)
    v_loc = cfg.vocab_size // (n_model if split("vocab", cfg.vocab_size) else 1)
    head = ([("all-reduce", b_loc * v_loc * 4, n_data, "head")] if keep
            else gather_params(_head_defs(cfg, defs), "head"))
    if v_loc != cfg.vocab_size:
        head.append(("all-gather", n_model * b_loc * 2 * 8, n_model, "decode/greedy"))
    return embed, unit, head


def _embed_bytes(cfg: ModelConfig, param_bytes: int, act_bytes: int) -> int:
    """The bytes of an element of the embedding's sum into the stream: the
    parameters' dtype for an encoder-decoder (its positions are added
    before the cast, ``Model._embed``), else the compute dtype."""
    return param_bytes if cfg.family == "encdec" else act_bytes


def _loss_sections(cfg: ModelConfig, defs, mesh, rules, param_rules, b: int, s: int,
                   param_bytes: int, act_bytes: int, step: str, s_max=None):
    """A forward pass (:func:`sharded_collectives`) of ``[b, s]`` tokens as
    segments ``[(ops, repeats)]``: ``repeats`` None for a section that runs
    once (an embedding's, the encoder's output gather, the head's and the
    loss's, or the prefill's, which ends with its caches' move to the
    decode layout), the number of units for one unit's ops (a layer's, or
    a hybrid period's slot by slot)."""
    n_model, d = mesh.shape.get("model", 1), cfg.d_model
    stream_s = s + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    s_max = stream_s if s_max is None else s_max

    def gather_params(tree: dict, path: str) -> List[Op]:
        return _gather_params(tree, path, mesh, param_rules, param_bytes)

    def split(axis: str, n: int) -> bool:
        return _split(param_rules, mesh, axis, n)

    def stack(seq_len: int, slots, layer_defs=None, cross=False):
        """((its batch's ranks, rows a rank, stream bytes a rank), one
        unit's ops, ``to_stream`` and ``gather_seq``) of a stack over ``[b,
        seq_len]``; ``cross``: each layer's cross-attention after its
        self-attention."""
        batch, seq_axis = actctx.residual_axes(b, seq_len, d, mesh, rules)
        seq = seq_axis == "model"
        n_batch = math.prod(mesh.shape[a] for a in batch)
        b_loc = b // n_batch
        s_loc = seq_len // n_model if seq else seq_len
        stream = b_loc * seq_len * d * act_bytes

        def to_stream(axis: str, n: int, path: str, nbytes: int = act_bytes) -> List[Op]:
            if not split(axis, n):
                return []
            if seq:
                return [("reduce-scatter", b_loc * s_loc * d * nbytes, n_model, path)]
            return [("all-reduce", b_loc * seq_len * d * nbytes, n_model, path)]

        def gather_seq(nbytes: int, path: str) -> List[Op]:
            return [("all-gather", nbytes, n_model, path)] if seq else []

        unit = []
        for _, mixer, ffn in slots:
            unit += gather_params(layer_defs or _layer_defs(cfg, mixer, ffn, mesh), "layer")
            if mixer == "mamba":
                unit += (gather_seq(stream, "mamba/in")
                         + _dtbc(cfg, mesh, param_rules, b_loc * seq_len)
                         + to_stream("d_inner", cfg.d_inner, "mamba/out", 4))
            else:
                unit += gather_seq(stream, "attn/in") + to_stream("heads", cfg.n_heads, "attn/out")
            if cross:
                unit += (gather_seq(stream, "xattn/in")
                         + to_stream("heads", cfg.n_heads, "xattn/out"))
            if ffn == "mlp":
                unit += gather_seq(stream, "mlp/in") + to_stream("d_ff", cfg.d_ff, "mlp/out")
            elif ffn == "moe":
                unit += _moe_ops(cfg, mesh, rules, param_rules, b, seq_len, seq, batch,
                                 param_bytes, act_bytes)
        return (n_batch, b_loc, stream), unit, to_stream, gather_seq

    segments = []
    if cfg.family == "encdec":
        (_, _, enc), enc_unit, _, enc_gather = stack(
            cfg.enc_seq, [(None, "attn", "mlp")], _one_layer_defs(cfg, "attn", "mlp"))
        segments += [(gather_params({k: defs[k] for k in ("enc_in", "ln_enc")}, "enc/in"), None),
                     (enc_unit, cfg.n_enc_layers), (enc_gather(enc, "enc/out"), None)]
    (n_batch, b_loc, stream), unit, to_stream, gather_seq = stack(
        stream_s, _units(cfg)[1], cross=cfg.family == "encdec")
    embed = (gather_params({"embed": defs["embed"]}, "embed")
             + to_stream("vocab", cfg.vocab_size, "embed",
                         _embed_bytes(cfg, param_bytes, act_bytes)))
    segments += [(embed, None), (unit, _units(cfg)[0])]
    head_params = gather_params(_head_defs(cfg, defs), "head")
    if step == "prefill":
        last = gather_seq(b_loc * n_model * d * act_bytes, "prefill/last")
        cache = _cache_op(cfg, mesh, param_rules, b_loc, s_max, act_bytes)
        return segments + [(last + head_params + cache, None)]
    head = gather_seq(stream, "loss/x") + head_params
    if split("vocab", cfg.vocab_size):
        head.append(("all-gather", n_model * 2 * b_loc * (s - 1) * 4, n_model, "loss/vocab"))
    if n_batch > 1:
        head.append(("all-reduce", 2 * 4, n_batch, "loss/mean"))
    return segments + [(head, None)]


def _params(case: dict, mesh, model: Model, device, param_rules):
    """This rank's blocks by ``param_rules``: of ``case["params"]`` (numpy,
    whole), or drawn from ``case["seed"]`` on the device."""
    if "params" in case:
        from ..convert import params_from_jax, shard_params

        return params_from_jax(shard_params(case["params"], model.axes(), mesh, mesh.coords,
                                            param_rules), device)
    gen = torch.Generator(device=device).manual_seed(case["seed"])
    return model.init(gen, device, shard=rank_shard(mesh, param_rules))


def _rules(case: dict, mesh):
    """(cfg, parameter rules, activation rules) of a case: its ``rules``
    with ``PARAM_RULES``, or ``dryrun.policy_rules`` of its ``policy``
    (default ``"baseline"``) for a train cell (a ``"prefill"`` cell where
    the case runs a prefill and decode entries only, a ``"decode"`` cell
    where decode entries only) of its first entry's shape; ``cfg``'s
    overrides on top."""
    overrides = case.get("cfg", {})
    smoke = case.get("smoke", False)
    if "rules" in case:
        return get_config(case["arch"], smoke=smoke).with_(**overrides), None, case["rules"]
    from .dryrun import policy_rules

    named = [k for k in _STEPS if k in case]
    kind = ("train" if set(named) - {"prefill", "decode"} else
            "prefill" if "prefill" in named else "decode")
    first = case[named[0]]
    b, s = (first[0] if isinstance(first, list) else first)["tokens"].shape
    cfg, param_rules, rules = policy_rules(case["arch"], ShapeSpec("case", kind, s, b), mesh,
                                           case.get("policy", "baseline"), smoke=smoke)
    return cfg.with_(**overrides), param_rules, rules


def _timed(fn, device):
    """``fn()`` → (its result, CUDA-synchronised wall clock in ms)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _staging_since(before: dict) -> dict:
    """The seconds host-staged collectives spent in each stage
    (``collectives.staging``) since ``before`` (a copy of it)."""
    return {k: staging[k] - before[k] for k in staging}


def _batch(entry: dict, device) -> dict:
    """The batch of an entry (numpy, the whole batch): its ``tokens`` and,
    where given, ``frames``, ``vision_embeds`` and ``loss_mask``, on the
    device."""
    batch = {"tokens": torch.as_tensor(entry["tokens"]).long().to(device)}
    for key in ("frames", "vision_embeds", "loss_mask"):
        if key in entry:
            batch[key] = torch.as_tensor(entry[key]).to(device)
    return batch


def _train(model: Model, params, entry: dict, device, carry: dict):
    """``steps`` train steps (``launch/steps.py::make_train_step``, AdamW
    with ``build_cell``'s schedule, ``accum`` microbatches, parameters and
    state donated as ``build_cell`` donates them) of the whole batch
    ``tokens`` from fresh optimizer state → (result, new params)."""
    from ..optim import AdamW, warmup_cosine
    from .steps import make_train_step

    opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
    state = opt.init(params)
    step = make_train_step(model, opt, accum=entry.get("accum", 1), donate=True)
    batch = _batch(entry, device)
    out = dict(loss=[], grad_norm=[], ms=[])
    _launches(reset=True)
    for _ in range(entry.get("steps", 1)):
        with counting_collectives() as report:
            (params, state, metrics), ms = _timed(lambda: step(params, state, batch), device)
        out.setdefault("ops", _ops(report))
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["ms"].append(ms)
    out.update(_launches())
    trees = dict(params=params, m=state.m, v=state.v)
    out.update({k: _host(trees[k]) for k in entry.get("host", trees)})
    return out, params


def _grad(model: Model, params, entry: dict, device, carry: dict):
    """The loss's gradient of the whole batch ``tokens`` and its whole norm
    (``launch/steps.py::make_grad_step``: the train step's backward and
    sums, no optimizer state) → (``loss``, ``grad_norm``, ``ops``, ``ms``,
    launches; on the card ``max_memory_allocated`` since it began)."""
    from .steps import make_grad_step

    batch = _batch(entry, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _launches(reset=True)
    before = dict(staging)
    with counting_collectives() as report:
        metrics, ms = _timed(lambda: make_grad_step(model)(params, batch), device)
    out = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               ops=_ops(report), ms=ms, staging_s=_staging_since(before), **_launches())
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return out, params


def _cols(lay, v_loc: int, cfg: ModelConfig):
    """The vocabulary columns of this rank's ``v_loc`` logits."""
    v0 = lay.mi * v_loc if v_loc != cfg.vocab_size else 0
    return v0, v0 + v_loc


def _prefill(model: Model, params, entry: dict, device, carry: dict):
    """The prefill; its caches (this rank's blocks in the decode layout)
    stay in ``carry`` for the decode entries."""
    batch = _batch(entry, device)
    lay = model._layout(batch)
    s_max = entry.get("s_max", lay.s)
    call = lambda: model.prefill(params, batch, s_max)  # noqa: E731
    _launches(reset=True)
    before = dict(staging)
    with counting_collectives() as report, _recording(entry) as records:
        (logits, caches), ms = _timed(call, device)
    counts = _launches()
    out = dict(logits=logits.cpu(), rows=(lay.b0, lay.b0 + lay.b_loc),
               cols=_cols(lay, logits.shape[-1], model.cfg), caches=_host(caches),
               ops=_ops(report), staging_s=_staging_since(before), **counts,
               **_routing(records))
    carry.update(caches=caches, pos=lay.s, s_max=s_max)
    del logits, caches
    ms = [ms] + [_timed(call, device)[1] for _ in range(entry.get("reps", 0))]
    return dict(out, ms=ms), params


def cache_slab(cfg: ModelConfig, b: int, s_max: int, seed: int, layer: int, which: str,
               device) -> torch.Tensor:
    """Layer ``layer``'s whole ``which`` cache (``"k"`` or ``"v"``, ``[b,
    s_max, nkv, hd]``; a mamba layer's ``"conv"``, ``[b, k - 1, d_inner]``,
    or ``"h"``, ``[b, d_inner, N]``; an encoder-decoder's ``"ek"`` or
    ``"ev"``, ``[b, enc_seq, nkv, hd]``), float32 standard normal, drawn on
    ``device`` from ``(seed, layer, which)`` alone: every rank, and the
    one-rank model, draw the same slab and keep what they hold of it.
    ``layer`` is the absolute layer index (a hybrid's period times its
    length plus the slot)."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 100_003 + layer) * 2 + _SLAB_STREAM[which])
    decl = next(p for path, p in flatten(Model(cfg).cache_defs(b, s_max)) if path[-1] == which)
    return torch.randn(decl.shape[1:], generator=gen, device=device)


#: Each cache leaf's offset in :func:`cache_slab`'s seed (a mamba layer's
#: conv and h share an attention layer's k and v offsets; the cross
#: caches take their own).
_SLAB_STREAM = {"k": 0, "v": 1, "conv": 0, "h": 1, "ek": 2, "ev": 3}


def cache_dtype(cfg: ModelConfig, decl) -> torch.dtype:
    """A cache leaf's dtype (``Model.init_caches``): float32 for the SSM
    state ``h``, else the compute dtype."""
    return torch.float32 if "ssm_state" in decl.axes else dtype_of(cfg.compute_dtype)


def cache_layers(cfg: ModelConfig, path) -> List[int]:
    """The absolute layer index of each entry along a cache leaf's leading
    axis (``path``: the leaf's path in the cache tree; a hybrid's
    ``("slot{s}", leaf)``)."""
    n_units, slots = _units(cfg)
    if path[0].startswith("slot"):
        return [u * len(slots) + int(path[0][len("slot"):]) for u in range(n_units)]
    return list(range(n_units))


def seeded_caches(model: Model, b: int, s_max: int, seed: int, device, mesh=None,
                  rules=None):
    """Caches of ``b`` rows (and ``s_max`` positions) from :func:`cache_slab`
    in their dtypes (:func:`cache_dtype`): whole, or this rank's blocks on
    ``mesh`` under ``rules`` (``spec_for`` of the cache leaves), one
    layer's slab on the device at a time, a hybrid's slot by slot."""
    from ..distributed.sharding import block_index

    cfg, paths, leaves = model.cfg, [], []
    for path, decl in flatten(model.cache_defs(b, s_max)):
        index = (slice(None),) * len(decl.shape)
        if mesh is not None:
            index = block_index(decl.shape, spec_for(decl.shape, decl.axes, mesh, rules),
                                mesh.shape, mesh.coords)
        shape = [len(range(*sl.indices(n))) for sl, n in zip(index, decl.shape)]
        dtype = cache_dtype(cfg, decl)
        leaf = torch.empty(shape, dtype=dtype, device=device)
        for i, layer in enumerate(cache_layers(cfg, path)):
            slab = cache_slab(cfg, b, s_max, seed, layer, path[-1], device)
            leaf[i] = slab[index[1:]].to(dtype)
            del slab
        paths.append(path)
        leaves.append(leaf)
    return unflatten(paths, leaves)


def _greedy(logits: torch.Tensor, lay, cfg: ModelConfig) -> torch.Tensor:
    """The greedy tokens of this rank's rows from its block ``[b_loc,
    V_loc]`` of the logits: each rank's largest logit and its index, one
    all-gather of them over ``model`` (``decode/greedy``), the first
    largest (the lowest index) of all."""
    idx = logits.argmax(-1)
    if logits.shape[-1] == cfg.vocab_size:
        return idx
    pair = torch.stack([logits.gather(-1, idx[:, None])[:, 0].double(),
                        (idx + _cols(lay, logits.shape[-1], cfg)[0]).double()], -1)
    pairs = all_gather(pair[None], lay.mesh, "model", 0, "decode/greedy")
    best = pairs[..., 0].argmax(0)
    return pairs[best, torch.arange(pair.shape[0], device=pair.device), 1].long()


def _decode(model: Model, params, entries: List[dict], device, carry: dict):
    """Decode ticks under the decode rules, one list item per entry:
    ``{"tokens": [B, n]}`` (numpy) feeds the ``n`` tokens one tick at a
    time (teacher-forced), from position ``pos``, into caches that are the
    prefill's (none of the keys below; ``pos`` the prompt's length, then
    where the last such entry stopped), the whole ``caches`` given (numpy
    ``{"k", "v"}`` ``[L, B, s_max, nkv, hd]``, an SSM's ``{"conv",
    "h"}``, a hybrid's tree of both under ``"slot{s}"``, an
    encoder-decoder's ``ek`` and ``ev`` beside ``k`` and ``v``; each rank
    keeps its blocks) or drawn from ``seed`` at ``s_max``
    (:func:`seeded_caches`); ``pos`` given with either.  ``host_caches``:
    also return host copies of this rank's blocks after the last tick.  →
    per entry: each tick's logits block (host), the greedy tokens of this
    rank's rows (:func:`_greedy`), ``ops``, ``ms`` and ``pos``; ``rows``,
    ``cols``, ``kv`` (this rank's positions; an SSM's block of
    ``d_inner``), ``di`` (its block of ``d_inner``), ``stationary`` (the
    layout keeps every ``d_model`` block in place), ``k3_launches``,
    ``k2_launches`` and ``k4_launches`` (the kernels', over the entry's
    ticks) and, on the card,
    ``max_memory_allocated`` since the entry began."""
    from ..kernels import decode_attention

    mesh, param_rules, rules = carry["mesh"], carry["param_rules"], carry["decode_rules"]
    cfg, out = model.cfg, []
    with actctx.activation_sharding(mesh, rules, param_rules):
        for entry in entries:
            tokens = torch.as_tensor(entry["tokens"]).long().to(device)
            b = tokens.shape[0]
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            if "caches" in entry:
                from ..convert import shard_params

                given = entry["caches"]
                s_max = next((v.shape[2] for p, v in flatten(given) if p[-1] == "k"), 0)
                pos, defs = entry["pos"], model.cache_defs(b, s_max)
                blocks = flatten(shard_params(given, param_axes(defs), mesh, mesh.coords, rules))
                decls = dict(flatten(defs))
                # a copy: a block may be a view of the given arrays, which the
                # ticks would write (a later entry may hold the same arrays)
                caches = unflatten(*zip(*[
                    (p, torch.tensor(v, dtype=cache_dtype(cfg, decls[p]), device=device))
                    for p, v in blocks]))
            elif "seed" in entry:
                s_max, pos = entry["s_max"], entry["pos"]
                caches = seeded_caches(model, b, s_max, entry["seed"], device, mesh, rules)
            else:
                caches, s_max, pos = carry["caches"], carry["s_max"], carry["pos"]
            lay = model.cache_layout(actctx.rank_layout(b, 1, cfg.d_model), s_max, rules)
            kv = ((lay.di0, lay.di0 + lay.di_loc) if cfg.family == "ssm"
                  else (lay.kv0, lay.kv0 + lay.kv_loc))
            res = dict(logits=[], tokens=[], ops=[], ms=[], pos=[],
                       rows=(lay.b0, lay.b0 + lay.b_loc), kv=kv,
                       di=(lay.di0, lay.di0 + lay.di_loc), stationary=lay.stationary)
            decode_attention.stats["launches"] = 0
            _launches(reset=True)
            before = dict(staging)
            for t in range(tokens.shape[1]):
                def tick():
                    logits, _ = model.decode(params, tokens[:, t:t + 1], pos, caches, s_max)
                    return logits, _greedy(logits, lay, cfg)

                with counting_collectives() as report:
                    (logits, picks), ms = _timed(tick, device)
                res["logits"].append(logits.cpu())
                res["tokens"].append(picks.cpu())
                res["ops"].append(_ops(report))
                res["ms"].append(ms)
                res["pos"].append(pos)
                pos += 1
            res["cols"] = _cols(lay, logits.shape[-1], cfg)
            res.update(k3_launches=decode_attention.stats["launches"], **_launches())
            res["staging_s"] = _staging_since(before)
            if entry.get("host_caches"):
                res["caches"] = _host(caches)
            if device.type == "cuda":
                res["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
            if not ("caches" in entry or "seed" in entry):
                carry["pos"] = pos
            del caches
            out.append(res)
    return out, params


def _recording(entry: dict):
    """``moe.recording()`` where the entry asks for its ``routing``, else
    a context that records nothing."""
    return moe.recording() if entry.get("routing") else contextlib.nullcontext()


def _routing(records) -> dict:
    """``{"routing": [per MoE call: this rank's expert ids and kept
    entries (moe.routing)]}`` of a recorded call, else nothing."""
    return {} if records is None else {"routing": [moe.routing(r) for r in records]}


def _launches(reset: bool = False) -> dict:
    """K2's and K4's launches (``k2_launches``, ``k4_launches``) since the
    last reset; ``reset`` sets both counts to 0 first."""
    from ..kernels import flash_attention, mamba_scan

    counts = {"k2_launches": flash_attention.stats, "k4_launches": mamba_scan.stats}
    if reset:
        for stats in counts.values():
            stats["launches"] = 0
    return {k: stats["launches"] for k, stats in counts.items()}


def _loss(model: Model, params, entry: dict, device, carry: dict):
    model = Model(model.cfg.with_(**entry.get("cfg", {})))
    batch = _batch(entry, device)
    call = lambda: model.loss(params, batch)  # noqa: E731
    _launches(reset=True)
    before = dict(staging)
    with counting_collectives() as report, _recording(entry) as records:
        (total, metrics), ms = _timed(call, device)
    counts = _launches()
    return dict(loss=float(total), ce=float(metrics["ce"]), aux=float(metrics["aux"]),
                ops=_ops(report), staging_s=_staging_since(before), **counts,
                **_routing(records),
                ms=[ms] + [_timed(call, device)[1] for _ in range(entry.get("reps", 0))]), params


#: The steps a case may name, in the order they run; a train step's new
#: parameters are those of the steps after it.
_STEPS = {"train": _train, "grad": _grad, "prefill": _prefill, "decode": _decode,
          "loss": _loss}


def _decode_rules(case: dict, mesh):
    """``dryrun.policy_rules``' activation rules for a decode cell of the
    case's arch and policy."""
    from .dryrun import policy_rules

    return policy_rules(case["arch"], ShapeSpec("case", "decode", 1, 1), mesh,
                        case.get("policy", "baseline"), smoke=case.get("smoke", False))[2]


def run(payload: dict) -> List[dict]:
    """The steps each case names → per case: ``coords``, ``kv_heads`` (the
    global kv heads of the prefill's k and v projection on this rank,
    ``attention.rank_kv_heads``; None without attention),
    ``init_s``, ``rules`` and ``param_rules`` (as :func:`_rules` chose
    them), and per step: the train steps' ``loss``, ``grad_norm`` and
    ``ops`` of the first, ``k2_launches`` and ``k4_launches`` over all of
    them, and host copies of this rank's blocks of the new
    ``params``, ``m`` and ``v`` (those the entry's ``host`` names; default
    all three); the grad entry's (:func:`_grad`); the prefill's
    ``logits`` (this rank's block ``[B / batch ranks, V / model ranks]``,
    at ``rows`` and ``cols`` of the whole),
    ``caches`` (host; this rank's blocks in the decode layout), ``ops``,
    ``k2_launches``, ``k4_launches``, and where asked ``routing`` (per MoE
    call, this rank's expert ids and kept entries, ``moe.routing``); the
    decode entries' results (:func:`_decode`); the loss's ``loss``,
    ``ce``, ``aux``, ``ops``, ``routing``,
    ``k2_launches``, ``k4_launches`` (an entry's ``cfg`` overrides, e.g.
    ``attn_impl`` or ``ssm_impl``); the prefill's, the decode
    entries' and the loss's ``staging_s`` (``collectives.staging`` over
    the counted call, or the entry's ticks); each step's ``ms``, the
    CUDA-synchronised wall clock of each train step, or of the counted
    call and of ``reps`` more; on the card, ``params_allocated`` and
    ``max_memory_allocated``; ``route``; ``case_s``, the case's seconds
    from its parameters' initialisation on.  A mesh of three axes is
    ``("pod", "data", "model")``.  Every family runs: dense, MoE, SSM,
    hybrid (its caches a tree of both kinds under ``"slot{s}"``), VLM and
    encoder-decoder (``kv_heads`` those of its decoder's self-attention;
    its caches ``ek`` and ``ev`` beside ``k`` and ``v``)."""
    out = []
    for case in payload["cases"]:
        case = {**{k: v for k, v in payload.items() if k != "cases"}, **case}
        device = torch.device(case.get("device", "cuda"))
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        mesh = _make_mesh(case["mesh"], AXES[-len(case["mesh"]):], device)
        cfg, param_rules, rules = _rules(case, mesh)
        model = Model(cfg)
        t0 = time.perf_counter()
        params = _params(case, mesh, model, device, param_rules)
        _sync(device)
        res = dict(coords=mesh.coords, init_s=time.perf_counter() - t0, rules=rules,
                   param_rules=param_rules, kv_heads=_kv_heads(cfg, params, mesh))
        if device.type == "cuda":
            res["params_allocated"] = torch.cuda.memory_allocated(device)
        carry = dict(mesh=mesh, param_rules=PARAM_RULES if param_rules is None else param_rules)
        if "decode" in case:
            carry["decode_rules"] = _decode_rules(case, mesh)
        with torch.no_grad(), actctx.activation_sharding(mesh, rules, param_rules):
            for name, fn in _STEPS.items():
                if name in case:
                    res[name], params = fn(model, params, case[name], device, carry)
                if name == "decode":
                    carry.pop("caches", None)     # the prefill's
        if device.type == "cuda":
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()    # for the other ranks' next case
        out.append(dict(res, route=_route(), case_s=time.perf_counter() - t0))
    return out


def _kv_heads(cfg: ModelConfig, params, mesh):
    """The global kv heads of the (decoder's) attention's k and v on this
    rank (``attention.rank_kv_heads``), or None without attention.  A
    function, so that no local outlives it to hold the parameters past
    their case."""
    stack = params["decoder" if cfg.family == "encdec" else "stack"]
    attn = next((lp["attn"] for lp in (stack, *stack.values())
                 if isinstance(lp, dict) and "attn" in lp), None)
    return None if attn is None else rank_kv_heads(cfg, attn["w_q"], attn["w_k"],
                                                   mesh.coords["model"])


def assemble_blocks(blocks, b: int, v: int) -> torch.Tensor:
    """The whole ``[b, v]`` float32 logits from every rank's ``(block,
    rows, cols)``."""
    out = torch.empty(b, v)
    for block, (r0, r1), (c0, c1) in blocks:
        out[r0:r1, c0:c1] = block.float()
    return out


def assemble_logits(results: List[dict], b: int, v: int) -> torch.Tensor:
    """The whole ``[b, v]`` float32 last-position logits of one case from
    every rank's :func:`run` result, each block at its ``rows`` and
    ``cols``."""
    return assemble_blocks([(r["prefill"]["logits"], r["prefill"]["rows"],
                             r["prefill"]["cols"]) for r in results], b, v)


def assemble_tick(results: List[dict], entry: int, tick: int, b: int, v: int) -> torch.Tensor:
    """The whole ``[b, v]`` logits of decode entry ``entry``'s tick
    ``tick`` of one case from every rank's :func:`run` result."""
    return assemble_blocks([(r["decode"][entry]["logits"][tick], r["decode"][entry]["rows"],
                             r["decode"][entry]["cols"]) for r in results], b, v)
