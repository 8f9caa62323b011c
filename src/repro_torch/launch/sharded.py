"""Sharded runs of a dense model over a rank mesh: what each rank runs for
``Model.prefill`` and ``Model.loss`` under the baseline policy, and the
collectives they issue, by formula.

:func:`run` is a target of ``distributed/ranks.py::run_ranks``: every rank
calls it with the same payload, and for each case of ``payload["cases"]``
(each with ``payload``'s other keys as defaults) builds the rank mesh
(``launch/mesh.py::_make_mesh``) over ``("data", "model")``, takes its
blocks of the parameters by ``PARAM_RULES`` and runs, under
``activation_sharding(mesh, rules)``, the steps the case names by its
entries: ``"prefill": {"tokens": [B, S], "reps": ...}`` and ``"loss":
{"tokens": ..., "loss_mask": ... (optional), "reps": ...}`` (numpy, the
whole batch), on the same parameters.  Parameters are either given whole (``params``: numpy,
the reference's layout; each rank keeps its blocks,
``convert.shard_params``) or made from ``seed`` on the rank's device, each
rank drawing the whole tree and keeping its blocks
(``Model.init(shard=sharding.rank_shard(mesh))``).  Each step's
collectives are counted (``hlo_analysis.counting_collectives``) and come
back as ``(kind, result_bytes, group, path)``, in issue order.
:func:`assemble_logits` puts the ranks' blocks of the prefill's logits
together.

    run_ranks("repro_torch.launch.sharded:run", 8,
              {"device": "cpu", "cases": [case, ...]}, timeout_s=300)
"""
from __future__ import annotations

import math
import time
from typing import List

import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..distributed import actctx
from ..distributed.sharding import PARAM_RULES, rank_shard, spec_for
from ..models.attention import rank_kv_heads
from ..models.model import Model
from ..models.params import flatten
from ..models.transformer import _one_layer_defs, _slot_kind
from .expert import AXES, Op, _host, _ops, _route, _sync
from .hlo_analysis import counting_collectives
from .mesh import Mesh, _make_mesh


def sharded_collectives(cfg: ModelConfig, mesh_shape: dict, rules: dict, b: int, s: int,
                        param_bytes: int, act_bytes: int, step: str = "prefill") -> List[Op]:
    """The collectives one sharded ``Model.prefill`` (``step="prefill"``)
    or ``Model.loss`` (``"loss"``) of a ``[b, s]`` batch issues on a rank,
    in order, for parameters of ``param_bytes`` an element and
    activations of ``act_bytes``: the embedding's gather over ``data`` and
    its sum into the residual stream's block; per layer, one gather of the
    layer's ``d_model`` blocks over ``data``, and for attention and the MLP
    each the sequence gathered over ``model`` and the row-parallel sum
    scattered back; then the prefill's last position or the loss's whole
    stream gathered over ``model`` and the head's gather over ``data``;
    the loss's vocab-parallel combination over ``model`` and its sums
    over the batch's axes."""
    mesh = Mesh(tuple(mesh_shape), tuple(mesh_shape.values()))
    batch, seq_axis = actctx.residual_axes(b, s, cfg.d_model, mesh, rules)
    seq = seq_axis == "model"
    n_model = mesh_shape.get("model", 1)
    n_batch = math.prod(mesh_shape[a] for a in batch)
    b_loc, s_loc, d = b // n_batch, s // n_model if seq else s, cfg.d_model
    ops: List[Op] = []

    def add(kind, nbytes, group, path):
        if group > 1:
            ops.append((kind, nbytes, group, path))

    def gather_params(defs: dict, path: str):
        """One all-gather of every block split over an axis other than
        ``model``: each such leaf whole along that axis."""
        nbytes, group = 0, 1
        for _, p in flatten(defs):
            leaf = spec_for(p.shape, p.axes, mesh, PARAM_RULES)
            other = [e for e in leaf if e not in (None, "model")]
            if other:
                group = math.prod(mesh_shape[a] for a in
                                  (other[0] if isinstance(other[0], tuple) else (other[0],)))
                nbytes += math.prod(p.shape) // n_model ** leaf.count("model") * param_bytes
        add("all-gather", nbytes, group, path)

    def to_stream(partial: bool, path: str):
        if partial:
            if seq:
                add("reduce-scatter", b_loc * s_loc * d * act_bytes, n_model, path)
            else:
                add("all-reduce", b_loc * s * d * act_bytes, n_model, path)

    def split(n: int) -> bool:
        return n_model > 1 and n % n_model == 0

    defs = Model(cfg).defs()
    gather_params({"embed": defs["embed"]}, "embed")
    to_stream(split(cfg.vocab_size), "embed")
    layer = _one_layer_defs(cfg, *_slot_kind(cfg, 0))
    stream = b_loc * s * d * act_bytes
    for _ in range(cfg.n_layers):
        gather_params(layer, "layer")
        for block, n in (("attn", cfg.n_heads), ("mlp", cfg.d_ff)):
            if seq:
                add("all-gather", stream, n_model, f"{block}/in")
            to_stream(split(n), f"{block}/out")
    if step == "prefill":
        if seq:
            add("all-gather", b_loc * n_model * d * act_bytes, n_model, "prefill/last")
        gather_params({"ln_f": defs["ln_f"], "lm_head": defs["lm_head"]}, "head")
        return ops
    if seq:
        add("all-gather", stream, n_model, "loss/x")
    gather_params({"ln_f": defs["ln_f"], "lm_head": defs["lm_head"]}, "head")
    if split(cfg.vocab_size):
        add("all-gather", n_model * 2 * b_loc * (s - 1) * 4, n_model, "loss/vocab")
    add("all-reduce", 2 * 4, n_batch, "loss/mean")
    return ops


def _params(case: dict, mesh, model: Model, device):
    """This rank's blocks: of ``case["params"]`` (numpy, whole), or drawn
    from ``case["seed"]`` on the device."""
    if "params" in case:
        from ..convert import params_from_jax, shard_params

        return params_from_jax(shard_params(case["params"], model.axes(), mesh, mesh.coords),
                               device)
    gen = torch.Generator(device=device).manual_seed(case["seed"])
    return model.init(gen, device, shard=rank_shard(mesh))


def _timed(fn, device):
    """``fn()`` → (its result, CUDA-synchronised wall clock in ms)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _prefill(model: Model, params, entry: dict, device) -> dict:
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
    return dict(out, ms=[ms] + [_timed(call, device)[1] for _ in range(entry.get("reps", 0))])


def _loss(model: Model, params, entry: dict, device) -> dict:
    batch = {"tokens": torch.as_tensor(entry["tokens"]).long().to(device)}
    if "loss_mask" in entry:
        batch["loss_mask"] = torch.as_tensor(entry["loss_mask"]).to(device)
    call = lambda: model.loss(params, batch)  # noqa: E731
    with counting_collectives() as report:
        (total, metrics), ms = _timed(call, device)
    return dict(loss=float(total), ce=float(metrics["ce"]), aux=float(metrics["aux"]),
                ops=_ops(report),
                ms=[ms] + [_timed(call, device)[1] for _ in range(entry.get("reps", 0))])


_STEPS = {"prefill": _prefill, "loss": _loss}


def run(payload: dict) -> List[dict]:
    """The steps each case names → per case: ``coords``, ``kv_heads`` (the
    global kv heads of this rank's caches, ``attention.rank_kv_heads``),
    ``init_s``, and per step: the prefill's ``logits`` (this rank's block
    ``[B / batch ranks, V / model ranks]``, at ``rows`` and ``cols`` of
    the whole), ``caches`` (host), ``ops``, ``k2_launches``; the loss's
    ``loss``, ``ce``, ``aux``, ``ops``; each step's ``ms``, the
    CUDA-synchronised wall clock of the counted call and of ``reps`` more;
    on the card, ``params_allocated`` and ``max_memory_allocated``;
    ``route``."""
    out = []
    for case in payload["cases"]:
        case = {**{k: v for k, v in payload.items() if k != "cases"}, **case}
        device = torch.device(case.get("device", "cuda"))
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        mesh = _make_mesh(case["mesh"], AXES, device)
        cfg = get_config(case["arch"], smoke=case.get("smoke", False)).with_(**case.get("cfg", {}))
        model = Model(cfg)
        t0 = time.perf_counter()
        params = _params(case, mesh, model, device)
        _sync(device)
        attn = params["stack"]["attn"]
        res = dict(coords=mesh.coords, init_s=time.perf_counter() - t0,
                   kv_heads=rank_kv_heads(cfg, attn["w_q"], attn["w_k"], mesh.coords["model"]))
        if device.type == "cuda":
            res["params_allocated"] = torch.cuda.memory_allocated(device)
        with torch.no_grad(), actctx.activation_sharding(mesh, case["rules"]):
            for name, fn in _STEPS.items():
                if name in case:
                    res[name] = fn(model, params, case[name], device)
        if device.type == "cuda":
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        del params
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
