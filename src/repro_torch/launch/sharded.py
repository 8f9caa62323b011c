"""Sharded runs of a dense model over a rank mesh: what each rank runs for
a train step, ``Model.prefill`` and ``Model.loss`` under the baseline,
``opt`` and small-DP policies, and the collectives they issue, by formula.

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
"steps": n, "accum": a, "host": ...}``, ``"prefill": {"tokens": [B, S],
"reps": ...}`` and ``"loss": {"tokens": ..., "loss_mask": ...
(optional), "cfg": ... (optional), "reps": ...}`` (numpy, the whole
batch), the later ones on the parameters the train steps left.
Parameters are either given whole (``params``: numpy, the reference's
layout; each rank keeps its blocks, ``convert.shard_params``) or made
from ``seed`` on the rank's device, each rank drawing the whole tree and
keeping its blocks (``Model.init(shard=sharding.rank_shard(mesh,
param_rules))``).  Each step's collectives are counted
(``hlo_analysis.counting_collectives``; a train entry's of its first
step) and come back as ``(kind, result_bytes, group, path)``, in issue
order.  :func:`assemble_logits` puts the ranks' blocks of the prefill's
logits together.

    run_ranks("repro_torch.launch.sharded:run", 8,
              {"device": "cpu", "cases": [case, ...]}, timeout_s=300)
"""
from __future__ import annotations

import math
import time
from typing import List

import torch

from ..configs import get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..distributed import actctx
from ..distributed.sharding import PARAM_RULES, rank_shard, spec_for
from ..models.attention import rank_kv_heads
from ..models.model import Model
from ..models.params import flatten
from ..models.transformer import _one_layer_defs, _slot_kind
from .expert import Op, _host, _ops, _route, _sync
from .hlo_analysis import counting_collectives
from .mesh import Mesh, _make_mesh

AXES = ("pod", "data", "model")


def sharded_collectives(cfg: ModelConfig, mesh_shape: dict, rules: dict, b: int, s: int,
                        param_bytes: int, act_bytes: int, step: str = "prefill",
                        accum: int = 1, param_rules=None) -> List[Op]:
    """The collectives one sharded ``Model.prefill`` (``step="prefill"``),
    ``Model.loss`` (``"loss"``) or train step (``"train"``, ``accum``
    microbatches) of a ``[b, s]`` batch issues on a rank, in order, for
    parameters of ``param_bytes`` an element (by ``param_rules``, default
    ``PARAM_RULES``) and activations of ``act_bytes``.

    Forward: the embedding's gather over ``data`` and its sum into the
    residual stream's block; per layer, one gather of the layer's
    ``d_model`` blocks over ``data``, and for attention and the MLP each
    the sequence gathered over ``model`` and the row-parallel sum
    scattered back; then the prefill's last position or the loss's whole
    stream gathered over ``model`` and the head's gather over ``data``;
    the loss's vocab-parallel combination over ``model`` and its sums over
    the batch's axes.

    A train step runs, for each microbatch, the loss's forward and then
    its backward: each op's transpose (``distributed/collectives.py``) in
    reverse order, where under ``cfg.remat`` each layer issues its forward
    again up to its MLP's input (the checkpoint's recomputation: the
    layer's gather over ``data`` again) after its MLP output's transpose,
    and its gradient's reduce-scatter comes last.  Then the sums of the leaves held
    alike along some axes (``actctx.sum_replicated``: ``model``, ``pod``,
    every axis under small-DP; float32 when ``accum > 1``), and the grad
    norm's all-reduce over the mesh (``actctx.whole_sq_sums``)."""
    mesh = Mesh(tuple(mesh_shape), tuple(mesh_shape.values()))
    param_rules = PARAM_RULES if param_rules is None else param_rules
    defs = Model(cfg).defs()
    if step != "train":
        embed, layer, head = _loss_sections(cfg, defs, mesh, rules, param_rules, b, s,
                                            param_bytes, act_bytes, step)
        return embed + layer * cfg.n_layers + head
    embed, layer, head = _loss_sections(cfg, defs, mesh, rules, param_rules, b // accum, s,
                                        param_bytes, act_bytes, "loss")
    again = [(k, n, g, f"{path}/bwd") for k, n, g, path in layer
             if path != "mlp/out" and cfg.remat]
    rest = [op for op in layer if op[3] != "mlp/out"]
    layer_bwd = ([_transpose(op) for op in layer if op[3] == "mlp/out"] + again
                 + [_transpose(op) for op in reversed(rest)])
    backward = ([_transpose(op) for op in reversed(head)] + layer_bwd * cfg.n_layers
                + [_transpose(op) for op in reversed(embed)])
    ops = (embed + layer * cfg.n_layers + head + backward) * accum
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


def _loss_sections(cfg: ModelConfig, defs, mesh, rules, param_rules, b: int, s: int,
                   param_bytes: int, act_bytes: int, step: str):
    """(the embedding's ops, one layer's, the head's and the loss's) of a
    forward pass (:func:`sharded_collectives`)."""
    batch, seq_axis = actctx.residual_axes(b, s, cfg.d_model, mesh, rules)
    seq = seq_axis == "model"
    n_model = mesh.shape.get("model", 1)
    n_batch = math.prod(mesh.shape[a] for a in batch)
    b_loc, s_loc, d = b // n_batch, s // n_model if seq else s, cfg.d_model
    stream = b_loc * s * d * act_bytes

    def gather_params(tree: dict, path: str) -> List[Op]:
        """One all-gather of every block split over an axis other than
        ``model``: each such leaf whole along that axis."""
        nbytes, group = 0, 1
        for _, p in flatten(tree):
            leaf = spec_for(p.shape, p.axes, mesh, param_rules)
            other = [e for e in leaf if e not in (None, "model")]
            if other:
                group = math.prod(mesh.shape[a] for a in
                                  (other[0] if isinstance(other[0], tuple) else (other[0],)))
                nbytes += math.prod(p.shape) // n_model ** leaf.count("model") * param_bytes
        return [("all-gather", nbytes, group, path)] if group > 1 else []

    def split(axis: str, n: int) -> bool:
        return param_rules.get(axis) == "model" and n_model > 1 and n % n_model == 0

    def to_stream(axis: str, n: int, path: str) -> List[Op]:
        if not split(axis, n):
            return []
        if seq:
            return [("reduce-scatter", b_loc * s_loc * d * act_bytes, n_model, path)]
        return [("all-reduce", stream, n_model, path)]

    def gather_seq(nbytes: int, path: str) -> List[Op]:
        return [("all-gather", nbytes, n_model, path)] if seq else []

    embed = (gather_params({"embed": defs["embed"]}, "embed")
             + to_stream("vocab", cfg.vocab_size, "embed"))
    layer = gather_params(_one_layer_defs(cfg, *_slot_kind(cfg, 0)), "layer")
    for block, axis, n in (("attn", "heads", cfg.n_heads), ("mlp", "d_ff", cfg.d_ff)):
        layer += gather_seq(stream, f"{block}/in") + to_stream(axis, n, f"{block}/out")
    head_params = gather_params({"ln_f": defs["ln_f"], "lm_head": defs["lm_head"]}, "head")
    if step == "prefill":
        last = gather_seq(b_loc * n_model * d * act_bytes, "prefill/last")
        return embed, layer, last + head_params
    head = gather_seq(stream, "loss/x") + head_params
    if split("vocab", cfg.vocab_size):
        head.append(("all-gather", n_model * 2 * b_loc * (s - 1) * 4, n_model, "loss/vocab"))
    if n_batch > 1:
        head.append(("all-reduce", 2 * 4, n_batch, "loss/mean"))
    return embed, layer, head


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
    the case runs only a prefill) of its first entry's shape; ``cfg``'s
    overrides on top."""
    overrides = case.get("cfg", {})
    smoke = case.get("smoke", False)
    if "rules" in case:
        return get_config(case["arch"], smoke=smoke).with_(**overrides), None, case["rules"]
    from .dryrun import policy_rules

    kind = "prefill" if set(_STEPS) & set(case) == {"prefill"} else "train"
    b, s = next(case[k]["tokens"] for k in _STEPS if k in case).shape
    cfg, param_rules, rules = policy_rules(case["arch"], ShapeSpec("case", kind, s, b), mesh,
                                           case.get("policy", "baseline"), smoke=smoke)
    return cfg.with_(**overrides), param_rules, rules


def _timed(fn, device):
    """``fn()`` → (its result, CUDA-synchronised wall clock in ms)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _train(model: Model, params, entry: dict, device):
    """``steps`` train steps (``launch/steps.py::make_train_step``, AdamW
    with ``build_cell``'s schedule, ``accum`` microbatches, parameters and
    state donated as ``build_cell`` donates them) of the whole batch
    ``tokens`` from fresh optimizer state → (result, new params)."""
    from ..kernels import flash_attention
    from ..optim import AdamW, warmup_cosine
    from .steps import make_train_step

    opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
    state = opt.init(params)
    step = make_train_step(model, opt, accum=entry.get("accum", 1), donate=True)
    batch = {"tokens": torch.as_tensor(entry["tokens"]).long().to(device)}
    out = dict(loss=[], grad_norm=[], ms=[])
    flash_attention.stats["launches"] = 0
    for _ in range(entry.get("steps", 1)):
        with counting_collectives() as report:
            (params, state, metrics), ms = _timed(lambda: step(params, state, batch), device)
        out.setdefault("ops", _ops(report))
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["ms"].append(ms)
    out["k2_launches"] = flash_attention.stats["launches"]
    trees = dict(params=params, m=state.m, v=state.v)
    out.update({k: _host(trees[k]) for k in entry.get("host", trees)})
    return out, params


def _prefill(model: Model, params, entry: dict, device):
    from ..kernels import flash_attention

    tokens = torch.as_tensor(entry["tokens"]).long().to(device)
    call = lambda: model.prefill(params, {"tokens": tokens}, tokens.shape[1])  # noqa: E731
    flash_attention.stats["launches"] = 0
    with counting_collectives() as report:
        (logits, caches), ms = _timed(call, device)
    k2 = flash_attention.stats["launches"]
    lay = actctx.rank_layout(*tokens.shape, model.cfg.d_model)
    v_loc = logits.shape[-1]
    v0 = lay.mi * v_loc if v_loc != model.cfg.vocab_size else 0
    out = dict(logits=logits.cpu(), rows=(lay.b0, lay.b0 + lay.b_loc), cols=(v0, v0 + v_loc),
               caches=_host(caches), ops=_ops(report), k2_launches=k2)
    del logits, caches
    ms = [ms] + [_timed(call, device)[1] for _ in range(entry.get("reps", 0))]
    return dict(out, ms=ms), params


def _loss(model: Model, params, entry: dict, device):
    from ..kernels import flash_attention

    model = Model(model.cfg.with_(**entry.get("cfg", {})))
    batch = {"tokens": torch.as_tensor(entry["tokens"]).long().to(device)}
    if "loss_mask" in entry:
        batch["loss_mask"] = torch.as_tensor(entry["loss_mask"]).to(device)
    call = lambda: model.loss(params, batch)  # noqa: E731
    flash_attention.stats["launches"] = 0
    with counting_collectives() as report:
        (total, metrics), ms = _timed(call, device)
    k2 = flash_attention.stats["launches"]
    return dict(loss=float(total), ce=float(metrics["ce"]), aux=float(metrics["aux"]),
                ops=_ops(report), k2_launches=k2,
                ms=[ms] + [_timed(call, device)[1] for _ in range(entry.get("reps", 0))]), params


#: The steps a case may name, in the order they run; a train step's new
#: parameters are those of the steps after it.
_STEPS = {"train": _train, "prefill": _prefill, "loss": _loss}


def run(payload: dict) -> List[dict]:
    """The steps each case names → per case: ``coords``, ``kv_heads`` (the
    global kv heads of this rank's caches, ``attention.rank_kv_heads``),
    ``init_s``, ``rules`` and ``param_rules`` (as :func:`_rules` chose
    them), and per step: the train steps' ``loss``, ``grad_norm`` and
    ``ops`` of the first, ``k2_launches`` over all of them, and host copies of this rank's blocks of the new
    ``params``, ``m`` and ``v`` (those the entry's ``host`` names; default
    all three); the prefill's ``logits`` (this rank's block ``[B / batch
    ranks, V / model ranks]``, at ``rows`` and ``cols`` of the whole),
    ``caches`` (host), ``ops``, ``k2_launches``; the loss's ``loss``,
    ``ce``, ``aux``, ``ops``, ``k2_launches`` (an entry's ``cfg``
    overrides, e.g. ``attn_impl``); each step's ``ms``, the
    CUDA-synchronised wall clock of each train step, or of the counted
    call and of ``reps`` more; on the card, ``params_allocated`` and
    ``max_memory_allocated``; ``route``.  A mesh of three axes is
    ``("pod", "data", "model")``."""
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
        attn = params["stack"]["attn"]
        res = dict(coords=mesh.coords, init_s=time.perf_counter() - t0, rules=rules,
                   param_rules=param_rules,
                   kv_heads=rank_kv_heads(cfg, attn["w_q"], attn["w_k"], mesh.coords["model"]))
        if device.type == "cuda":
            res["params_allocated"] = torch.cuda.memory_allocated(device)
        with torch.no_grad(), actctx.activation_sharding(mesh, rules, param_rules):
            for name, fn in _STEPS.items():
                if name in case:
                    res[name], params = fn(model, params, case[name], device)
        if device.type == "cuda":
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()    # for the other ranks' next case
        out.append(dict(res, route=_route()))
    return out


def assemble_logits(results: List[dict], b: int, v: int) -> torch.Tensor:
    """The whole ``[b, v]`` float32 last-position logits of one case from
    every rank's :func:`run` result, each block at its ``rows`` and
    ``cols``."""
    out = torch.empty(b, v)
    for r in results:
        (r0, r1), (c0, c1) = r["prefill"]["rows"], r["prefill"]["cols"]
        out[r0:r1, c0:c1] = r["prefill"]["logits"].float()
    return out
