"""Expert-parallel runs over a rank mesh: what each rank runs for the a2a
MoE block and for a model served through it, and the collectives the
block issues, by formula.

Each of :func:`block`, :func:`prefill` and :func:`serve` is a target of
``distributed/ranks.py::run_ranks``: every rank calls it with the same
payload (a dict), builds the rank mesh (``launch/mesh.py::_make_mesh``)
over ``("data", "model")``, and returns what it computed, on the host.
Parameters are either given whole (numpy, the reference's layout: each
rank keeps its shards, ``convert.shard_moe_params``) or made from a seed
on the rank's device, each rank keeping only its own blocks of the expert
stack (``Model.init(shard=moe.rank_shard(...))``).  Collectives are
counted (``hlo_analysis.counting_collectives``) around the block or the
model, and each record's ops come back as ``(kind, result_bytes, group,
path)``.

    run_ranks("repro_torch.launch.expert:block", 8,
              {"device": "cpu", "cases": [case, ...]}, timeout_s=300)
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..distributed import actctx
from ..models import moe
from ..models.model import Model
from ..models.params import dtype_of, init_params
from .hlo_analysis import Collective, CollectiveReport, _wire_bytes, counting_collectives
from .mesh import _make_mesh

AXES = ("data", "model")

Op = Tuple[str, int, int, str]


def a2a_collectives(cfg: ModelConfig, mesh_shape: dict, rules: dict, b: int, s: int,
                    param_bytes: int, act_bytes: int) -> List[Op]:
    """The collectives one ``moe_block`` call under the a2a dispatch issues
    on a rank, in order, for an input ``[b, s, d]`` whose elements take
    ``act_bytes`` and parameters of ``param_bytes`` an element: the body's
    (router gathers, the balance sums, the dispatch all-to-all, the weight
    gathers, the combine all-to-all), then the reassembly's."""
    lay = moe.a2a_layout(cfg, mesh_shape, rules, b, s)
    n_data, n_model = mesh_shape.get("data", 1), mesh_shape["model"]
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    ops: List[Op] = []

    def add(kind, nbytes, group, path):
        if group > 1:
            ops.append((kind, nbytes, group, path))

    add("all-gather", d * (e // n_model) * param_bytes, n_data, "moe_a2a/router")
    add("all-gather", d * e * param_bytes, n_model, "moe_a2a/router")
    axes = lay.dp + ("model",) if lay.seq_sharded else lay.dp
    g = int(np.prod([mesh_shape[a] for a in axes])) if axes else 1
    for nbytes in (4 * e, 4 * e, 4):
        add("all-reduce", nbytes, g, "moe_a2a/aux")
    add("all-to-all", e * lay.c_e * d * act_bytes, n_model, "moe_a2a/dispatch")
    n_w = 3 if cfg.mlp_kind == "swiglu" else 2
    for _ in range(n_w):
        add("all-gather", (e // n_model) * d * f * param_bytes, n_data, "moe_a2a/experts")
    add("all-to-all", e * lay.c_e * d * act_bytes, n_model, "moe_a2a/combine")
    if lay.seq_sharded:
        add("all-gather", (b // lay.dp_size) * s * d * act_bytes, n_model, "moe_a2a/reassemble")
    if lay.dp:
        add("all-gather", b * s * d * act_bytes, lay.dp_size, "moe_a2a/reassemble")
    return ops


def report_of(ops: List[Op]) -> CollectiveReport:
    """The ``CollectiveReport`` of ``(kind, result_bytes, group, path)``
    ops (each once), as ``counting_collectives`` builds it."""
    return CollectiveReport([Collective(k, n, g, 1, _wire_bytes(k, n, g), path)
                             for k, n, g, path in ops])


def _ops(report) -> List[Op]:
    return [(c.kind, c.result_bytes, c.group, c.path) for c in report.ops]


def _route() -> dict:
    """The backend this rank's collectives ran on, and how many of them
    went in place or through host memory (``distributed/collectives.py``)."""
    import torch.distributed as dist

    from ..distributed.collectives import stats

    return dict(backend=dist.get_backend(), **{k: int(v) for k, v in stats.items()})


def _setup(case: dict):
    """(mesh, cfg, device) of a case: ``mesh`` (its shape), ``arch``,
    ``smoke``, ``cfg`` (overrides), ``device``."""
    device = torch.device(case.get("device", "cuda"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = _make_mesh(case["mesh"], AXES, device)
    cfg = get_config(case["arch"], smoke=case.get("smoke", False)).with_(
        moe_impl="a2a", **case.get("cfg", {}))
    return mesh, cfg, device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drops(records) -> List[float]:
    return [float((~r["keep"]).sum()) / r["keep"].numel() for r in records]


def block(payload: dict) -> List[dict]:
    """One MoE block per case of ``payload["cases"]`` (each with
    ``payload``'s keys as defaults): ``rules``, and either ``params`` (the
    whole block, numpy) and ``x`` (numpy ``[B, S, d]``), or ``seed``,
    ``dtype`` and ``x_shape`` ``(B, S)`` (parameters from
    ``torch.Generator(seed)`` on the device, this rank's blocks only; ``x``
    normal from ``seed + 1``).  With ``gather`` the rank with coordinates all 0 also runs the
    one-rank gather dispatch on the whole block (from the same seed).
    ``reps`` times the block that many more times (CUDA-synchronised wall
    clock, milliseconds).  → per case: ``coords``, ``y`` (whole, host),
    ``aux``, ``ops``, ``drops`` (this rank's dropped share), ``c_e``."""
    out = []
    for case in payload["cases"]:
        case = {**{k: v for k, v in payload.items() if k != "cases"}, **case}
        mesh, cfg, device = _setup(case)
        coords = mesh.coords
        defs = moe.moe_defs(cfg)
        if "params" in case:
            from ..convert import params_from_jax, shard_moe_params

            whole = case["params"]
            p = params_from_jax(shard_moe_params(whole, mesh, coords), device)
            x = torch.as_tensor(case["x"]).to(device)
        else:
            dtype = dtype_of(case["dtype"])
            gen = torch.Generator(device=device).manual_seed(case["seed"])
            p = init_params(defs, gen, dtype, device, lambda path, leaf: moe.shard_index(
                path[-1], leaf.shape, mesh.shape, coords))
            x = torch.randn(tuple(case["x_shape"]) + (cfg.d_model,), device=device,
                            generator=torch.Generator(device=device).manual_seed(case["seed"] + 1)
                            ).to(dtype)
        lay = moe.a2a_layout(cfg, mesh.shape, case["rules"], x.shape[0], x.shape[1])
        with torch.no_grad(), actctx.activation_sharding(mesh, case["rules"], replicated=True):
            with counting_collectives() as report, moe.recording() as rec:
                y, aux = moe.moe_block(p, x, cfg)
            _sync(device)
            times = []
            for _ in range(case.get("reps", 0)):
                t0 = time.perf_counter()
                moe.moe_block(p, x, cfg)
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
        res = dict(coords=coords, y=y.cpu(), aux=float(aux), ops=_ops(report),
                   drops=_drops(rec)[0], c_e=lay.c_e, ms=times)
        if case.get("gather") and not any(coords.values()):
            del p
            if "params" in case:
                pw = params_from_jax(whole, device)
            else:
                gen = torch.Generator(device=device).manual_seed(case["seed"])
                pw = init_params(defs, gen, dtype, device)
            with torch.no_grad(), moe.recording() as rec_g:
                yg, auxg = moe.moe_block(pw, x, cfg.with_(moe_impl="gather"))
            res.update(y_gather=yg.cpu(), aux_gather=float(auxg), drops_gather=_drops(rec_g)[0])
            del pw
        out.append(dict(res, route=_route()))
    return out


def _model(case: dict, mesh, cfg, device):
    model = Model(cfg)
    gen = torch.Generator(device=device).manual_seed(case["seed"])
    return model, model.init(gen, device, shard=moe.rank_shard(cfg, mesh))


def _tokens(case: dict, cfg, device) -> torch.Tensor:
    if "tokens" in case:
        return torch.as_tensor(case["tokens"]).long().to(device)
    rng = np.random.default_rng(case["seed"] + 2)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, case["tokens_shape"])).to(device)


def prefill(payload: dict) -> dict:
    """``Model.prefill`` of ``tokens`` (numpy ``[B, S]``, or
    ``tokens_shape`` drawn from ``seed + 2``) under the rank mesh, the
    parameters from ``seed`` (this rank's expert blocks only), ``s_max``
    positions of cache.  With ``gather`` the rank at coordinates 0 also
    runs the whole model from the same seed without a mesh.  → ``logits``
    ``[B, V]`` and the attention caches on the host, ``ops`` of the whole
    prefill, ``drops`` per MoE layer on this rank, ``k2_launches``."""
    from ..kernels import flash_attention

    mesh, cfg, device = _setup(payload)
    model, params = _model(payload, mesh, cfg, device)
    tokens = _tokens(payload, cfg, device)
    s_max = payload.get("s_max", tokens.shape[1])
    with torch.no_grad(), actctx.activation_sharding(mesh, payload["rules"], replicated=True):
        flash_attention.stats["launches"] = 0
        with counting_collectives() as report, moe.recording() as rec:
            logits, caches = model.prefill(params, {"tokens": tokens}, s_max)
        _sync(device)
        k2 = flash_attention.stats["launches"]
    out = dict(coords=mesh.coords, logits=logits.cpu(), caches=_host(caches),
               ops=_ops(report), drops=_drops(rec), k2_launches=k2, route=_route())
    if payload.get("gather") and not any(mesh.coords.values()):
        del params
        whole = Model(cfg.with_(moe_impl="gather"))
        pw = whole.init(torch.Generator(device=device).manual_seed(payload["seed"]), device)
        with torch.no_grad():
            lg, cg = whole.prefill(pw, {"tokens": tokens}, s_max)
        out.update(logits_gather=lg.cpu(), caches_gather=_host(cg))
    return out


def _host(tree):
    """Host copies of a tree's tensors (copies on the host too, so later
    in-place writes do not reach them)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.to("cpu", copy=True)


def serve(payload: dict) -> dict:
    """A ``ServeEngine`` on each rank over the rank mesh: ``requests``
    prompts of ``prompt_len`` tokens (``launch/serve.py::make_requests``,
    ``seed``), admitted in order into ``slots`` slots of ``s_max``
    positions and decoded to ``max_new`` tokens, every rank in the same
    order (the engine directly: no router, whose choices could differ
    between ranks).  → the tokens, prefill and tick times (CUDA-synchronised
    wall clock), K2's launches, ``ops`` of the first prefill and of one
    decode tick, the prefill's drop rate per MoE layer, device memory."""
    from ..kernels import flash_attention
    from ..serving import ServeEngine
    from .serve import make_requests

    mesh, cfg, device = _setup(payload)
    t0 = time.perf_counter()
    model, params = _model(payload, mesh, cfg, device)
    _sync(device)
    init_s = time.perf_counter() - t0
    memory = {}
    if device.type == "cuda":
        memory = dict(params_allocated=torch.cuda.memory_allocated(device),
                      init_peak=torch.cuda.max_memory_allocated(device),
                      card_free_after_init=torch.cuda.mem_get_info(device)[0])
    engine = ServeEngine(model, params, payload["slots"], payload["s_max"], device=device)
    reqs = make_requests(cfg, payload["requests"], payload["prompt_len"], payload["max_new"],
                         payload["seed"])
    prefill_ms, tick_ms, ops, tick_ops, drops = [], [], None, None, None
    flash_attention.stats["launches"] = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with actctx.activation_sharding(mesh, payload["rules"], replicated=True):
        pending = list(reqs)
        while pending or engine.active:
            while pending and engine.has_capacity():
                t = time.perf_counter()
                with counting_collectives() as report, moe.recording() as rec:
                    engine.admit(pending.pop(0))
                _sync(device)
                prefill_ms.append((time.perf_counter() - t) * 1e3)
                if ops is None:
                    ops, drops = _ops(report), _drops(rec)
            t = time.perf_counter()
            with counting_collectives() as report:
                engine.tick()
            _sync(device)
            tick_ms.append((time.perf_counter() - t) * 1e3)
            tick_ops = tick_ops or _ops(report)
    out = dict(coords=mesh.coords, tokens={r.rid: list(r.tokens_out) for r in reqs},
               first_tokens=[r.tokens_out[0] for r in reqs], init_s=init_s,
               prefill_ms=prefill_ms, tick_ms=tick_ms,
               k2_launches=flash_attention.stats["launches"], ops=ops, tick_ops=tick_ops,
               drops=drops, done=all(r.done for r in reqs), route=_route())
    if device.type == "cuda":
        out.update(max_memory_allocated=torch.cuda.max_memory_allocated(device),
                   memory_allocated=torch.cuda.memory_allocated(device), **memory)
    return out


def probe(payload: dict) -> float:
    """One all-reduce of a one-element tensor on ``device`` over the world
    (a backend's first collective) → the sum."""
    import torch.distributed as dist

    x = torch.ones(1, device=payload.get("device", "cuda"))
    dist.all_reduce(x)
    return float(x)
