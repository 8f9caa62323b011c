"""Dry run of every (arch × shape × mesh) cell: memory per device, the
step's global FLOPs and bytes, its collectives and the roofline terms,
without a device.

The port of the reference's ``launch/dryrun.py``.  Per cell it writes a
JSON record under ``artifacts/dryrun_torch/`` holding:

* ``memory``      — the bytes each device holds of the step's arguments
  and outputs, and those its donated arguments alias, from the cell's
  shardings (``distributed/sharding.py::spec_for`` shards a dimension only
  where the mesh axis divides it, so each division is exact); ``peak_gib``,
  the live-bytes peak of one rank's program (:func:`rank_program`: its
  parameter, moment and cache blocks, the whole batch, and what the step
  makes), and ``temp_gib``, that peak less its arguments.
* ``accounting``  — the step's global FLOPs, bytes and transcendentals as
  ``kernels/cost.py`` counts them on ``meta`` tensors (the kernels and the
  mamba time scan by their formulas), the ops it has no FLOP rule for,
  and ``model_flops_estimate``.
* ``collectives`` — the reference's keys (``count``,
  ``by_kind_wire_bytes``, ``wire_bytes_ici``, ``wire_bytes_dcn``) of the
  collectives one rank's program issues, with ``collectives_note`` saying
  what the count covers.  :func:`rank_program` runs the cell's step as one
  rank of the production mesh runs it (``launch/sharded.py``'s path: the
  rank's blocks of every parameter, ``activation_sharding`` under
  :func:`policy_rules`) on ``meta`` tensors over a recording mesh
  (``launch/mesh.py::recording_mesh``), so each collective returns an
  empty tensor of its result's shape and is counted, every trip of every
  loop by running it; a train cell at ``--accum`` microbatches (8, the
  reference's compiled cell).  The count must equal
  ``launch/sharded.py::sharded_collectives`` op for op (without the
  launcher's greedy pick, ``decode/greedy``, which the cell does not
  issue), else the record is not ``ok``.
* ``roofline``    — ``roofline_terms(...).to_dict()`` at the H100's record
  over the mesh's chip count, its collective term from that count.

The accounting cell is the reference's: ``scan_layers=False,
attn_chunk=0``, one microbatch, AdamW moments in float32, and decode at the
host integer ``pos = seq_len - 1`` (the plain decode attends the whole
cache under a mask, so the count does not depend on ``pos``).  The
accounting runs once per (arch, shape), not once per mesh.  Not carried:
``_scope_trips``, the reference's workaround for XLA visiting a loop body
once; the counter counts every trip of a loop that runs, and the time
scan by formula.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both        # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --policy opt --accum 8
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCH_NAMES, get_config, shapes_for
from ..configs.base import ShapeSpec
from ..distributed import actctx
from ..distributed.sharding import (
    ACT_RULES_DECODE,
    ACT_RULES_SMALL_DP,
    ACT_RULES_TRAIN,
    ACT_RULES_TRAIN_OPT,
    PARAM_RULES,
    PARAM_RULES_SMALL_DP,
    NamedSharding,
    block_index,
    param_shardings,
    spec_for,
)
from ..kernels.cost import CostCounter
from ..models.model import Model
from ..models.params import dtype_of, tree_map_defs
from ..optim.adamw import AdamW, AdamWState
from ..optim.schedule import constant, warmup_cosine
from .hlo_analysis import (
    H100_SXM,
    counting_collectives,
    model_flops_estimate,
    roofline_terms,
    ssm_scan_addendum,
)
from .inputs import decode_inputs, train_inputs
from .mesh import make_production_mesh, mesh_device_count, recording_mesh
from .steps import (make_decode_step, make_eval_step, make_grad_step, make_prefill_step,
                    make_train_step)

SMALL_MODEL_PARAMS = 2e8     # below this, the opt policy runs pure DP
TRAIN_ACCUM = 8              # the reference's compiled train cell's microbatches
ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
GIB = 2 ** 30


def policy_rules(arch: str, shape: ShapeSpec, mesh, policy: str, smoke: bool = False):
    """→ (cfg transform, param rules, activation rules) for a policy.
    ``smoke``: decide by (and transform) the arch's smoke configuration."""
    cfg = get_config(arch, smoke=smoke)
    act = dict(ACT_RULES_DECODE if shape.kind == "decode" else ACT_RULES_TRAIN)
    param_rules = None  # PARAM_RULES default
    if policy == "opt":
        # Measured lesson (§Perf): head-sharded attention + Megatron blocks
        # win for train_4k but *regress* 32k prefill (the gathered-h and
        # per-head full-length scores outweigh the savings) — so the opt
        # activation rules apply to training only; prefill keeps the
        # baseline seq-sharding and still gets the a2a MoE dispatch.
        if cfg.param_count() < SMALL_MODEL_PARAMS and shape.kind == "train":
            act = dict(ACT_RULES_SMALL_DP)
            param_rules = PARAM_RULES_SMALL_DP
        elif shape.kind == "train":
            act = dict(ACT_RULES_TRAIN_OPT)
        if cfg.n_experts:
            cfg = cfg.with_(moe_impl="a2a")
    if "pod" in mesh.shape and "batch" in act and not isinstance(act["batch"], list):
        act["batch"] = ("pod", "data")
    elif "batch" in act and not isinstance(act["batch"], list):
        act["batch"] = ("data",)
    return cfg, param_rules, act


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _device_bytes(arrays, shardings, mesh) -> int:
    """Bytes one device holds of ``arrays`` under ``shardings`` (the same
    tree, a ``NamedSharding`` per tensor)."""
    total = 0
    for t, sh in zip(_leaves(arrays), _leaves(shardings), strict=True):
        ways = 1
        for entry in sh.spec:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    ways *= mesh.shape[axis]
        total += t.numel() * t.element_size() // ways
    return total


def _cache_abstract(model: Model, batch: int, s_max: int, rules, mesh):
    """Prefill's output caches on ``meta`` and their shardings."""
    cdefs = model.cache_defs(batch, s_max)
    caches = decode_inputs(model.cfg, ShapeSpec("cache", "decode", s_max, batch), None)[0][2]
    sh = tree_map_defs(lambda p: NamedSharding(mesh, spec_for(p.shape, p.axes, mesh, rules)),
                       cdefs)
    return caches, sh


def build_cell(arch: str, shape: ShapeSpec, mesh, policy: str = "baseline") -> dict:
    """The cell's step on ``meta`` stand-ins, with the reference's shardings:
    → {args, in_shardings, outs, out_shardings, donate}."""
    cfg, param_rules, _act = policy_rules(arch, shape, mesh, policy)
    model = Model(cfg)
    params = model.abstract()
    param_sh = param_shardings(model.defs(), mesh, rules=param_rules)
    rep = NamedSharding(mesh, ())
    rules = dict(ACT_RULES_DECODE)
    rules["batch"] = ("pod", "data") if "pod" in mesh.shape else ("data",)
    logits = torch.empty((shape.global_batch, cfg.vocab_size), dtype=torch.float32,
                         device="meta")
    logits_sh = NamedSharding(mesh, spec_for(tuple(logits.shape), ("batch", "vocab"), mesh,
                                             rules))
    if shape.kind == "train":
        batch, batch_sh = train_inputs(cfg, shape, mesh)
        opt_state = AdamW().init(params)
        opt_sh = AdamWState(m=param_sh, v=param_sh, count=rep)
        metrics = [opt_state.count.new_empty((), dtype=logits.dtype)] * 2
        return dict(args=(params, opt_state, batch),
                    in_shardings=(param_sh, opt_sh, batch_sh),
                    outs=(params, opt_state, metrics), out_shardings=(param_sh, opt_sh, [rep] * 2),
                    donate=(0, 1))
    if shape.kind == "prefill":
        batch, batch_sh = train_inputs(cfg, shape, mesh)
        caches, cache_sh = _cache_abstract(model, shape.global_batch, shape.seq_len, rules, mesh)
        return dict(args=(params, batch), in_shardings=(param_sh, batch_sh),
                    outs=(logits, caches), out_shardings=(logits_sh, cache_sh), donate=())
    (token, pos, caches), (token_sh, pos_sh, cache_sh) = decode_inputs(cfg, shape, mesh)
    return dict(args=(params, token, pos, caches),
                in_shardings=(param_sh, token_sh, pos_sh, cache_sh),
                outs=(logits, caches), out_shardings=(logits_sh, cache_sh), donate=(3,))


def memory_per_device(cell: dict, mesh) -> dict:
    """Bytes per device of the cell's arguments, outputs, and the outputs
    its donated arguments alias (params and moments in training, the
    caches in decode)."""
    return {
        "argument": _device_bytes(cell["args"], cell["in_shardings"], mesh),
        "output": _device_bytes(cell["outs"], cell["out_shardings"], mesh),
        "alias": sum(_device_bytes(cell["args"][i], cell["in_shardings"][i], mesh)
                     for i in cell["donate"]),
    }


def accounting(arch: str, shape: ShapeSpec) -> dict:
    """The unsharded step of the cell counted on ``meta`` tensors (the
    counterpart of the reference's ``accounting_lowering``): → the
    counter's result, with ``model_flops`` and the cell's config."""
    cfg = get_config(arch).with_(scan_layers=False, attn_chunk=0)
    model = Model(cfg)
    params = model.abstract()
    if shape.kind == "train":
        opt = AdamW(lr=constant(3e-4))
        batch, _ = train_inputs(cfg, shape, None)
        step, args = make_train_step(model, opt, accum=1), (params, opt.init(params), batch)
    elif shape.kind == "prefill":
        batch, _ = train_inputs(cfg, shape, None)
        step, args = make_prefill_step(model, shape.seq_len), (params, batch)
    else:
        (token, _pos, caches), _ = decode_inputs(cfg, shape, None)
        step, args = make_decode_step(model), (params, token, shape.seq_len - 1, caches)
    t0 = time.time()
    with CostCounter(*args) as counter:
        step(*args)
    out = counter.result()
    out["model_flops"] = model_flops_estimate(cfg, shape)
    out["accounting_s"] = round(time.time() - t0, 1)
    out["cfg"] = cfg
    return out


def rank_blocks(defs, mesh, rules, dtype) -> dict:
    """This rank's blocks of the leaves ``defs`` declares, by ``rules``
    (``spec_for``, ``sharding.block_index`` at the mesh's coordinates), as
    empty ``meta`` tensors of ``dtype(decl)``: nothing is drawn, so a tree
    of any size costs nothing."""
    def block(decl):
        index = block_index(decl.shape, spec_for(decl.shape, decl.axes, mesh, rules),
                            mesh.shape, mesh.coords)
        shape = [len(range(*sl.indices(n))) for sl, n in zip(index, decl.shape)]
        return torch.empty(shape, dtype=dtype(decl), device="meta")

    return tree_map_defs(block, defs)


def _cell_kind(kind: str) -> str:
    """The kind of cell whose rules a step of ``kind`` runs under (a loss
    or grad entry runs under a train cell's)."""
    return kind if kind in ("prefill", "decode") else "train"


def cell_step(arch: str, shape: ShapeSpec, mesh, policy: str):
    """(cfg, b, s, s_max) of a production cell's :func:`rank_program`: the
    policy's config, the batch, the tokens' length (a VLM's cell holds its
    vision prefix in ``seq_len``) and the caches' length (none for a train
    cell)."""
    cfg = policy_rules(arch, shape, mesh, policy)[0]
    vis = cfg.n_vision_tokens if cfg.family == "vlm" and shape.kind != "decode" else 0
    return (cfg, shape.global_batch, shape.seq_len - vis,
            None if shape.kind == "train" else shape.seq_len)


def rank_rules(cfg, kind: str, b: int, s: int, mesh, policy_or_rules):
    """(cfg, parameter rules, activation rules) of a step of ``kind``
    (:func:`rank_program`'s ``policy_or_rules``)."""
    if not isinstance(policy_or_rules, str):
        return (cfg, *policy_or_rules)
    shape = ShapeSpec("rank", _cell_kind(kind), s, b)
    policy_cfg, param_rules, rules = policy_rules(cfg.name, shape, mesh, policy_or_rules)
    return cfg.with_(moe_impl=policy_cfg.moe_impl), param_rules, rules


def rank_step(cfg, kind: str, b: int, s: int, mesh, param_rules, rules,
              accum: int = TRAIN_ACCUM, s_max=None):
    """(the step, its arguments on ``meta``, the bytes of its parameter,
    moment and cache blocks) that :func:`rank_program` runs on ``mesh``
    (a recording mesh: its coordinates place the blocks)."""
    model = Model(cfg)
    p_rules = PARAM_RULES if param_rules is None else param_rules
    params = rank_blocks(model.defs(), mesh, p_rules, lambda _: dtype_of(cfg.param_dtype))
    n_vis = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    if kind == "decode":
        from .sharded import cache_dtype

        s_max = s if s_max is None else s_max
        caches = rank_blocks(model.cache_defs(b, s_max), mesh, rules,
                             lambda d: cache_dtype(cfg, d))
        token = torch.empty((b, 1), dtype=torch.int32, device="meta")
        return (make_decode_step(model, s_max), (params, token, s_max - 1, caches),
                _nbytes([params, caches]))
    batch = train_inputs(cfg, ShapeSpec("rank", kind, s + n_vis, b), None)[0]
    if kind == "train":
        f32 = lambda _: torch.float32  # noqa: E731
        state = AdamWState(m=rank_blocks(model.defs(), mesh, p_rules, f32),
                           v=rank_blocks(model.defs(), mesh, p_rules, f32),
                           count=torch.zeros((), dtype=torch.int32, device="meta"))
        step = make_train_step(model, AdamW(lr=warmup_cosine(3e-4, 2000, 100_000)),
                               accum=accum, donate=True)
        return step, (params, state, batch), _nbytes([params, state])
    steps = {"prefill": lambda: make_prefill_step(model, s_max or s + n_vis),
             "loss": lambda: make_eval_step(model), "grad": lambda: make_grad_step(model)}
    if kind not in steps:
        raise ValueError(f"no rank program for a {kind!r} step")
    return steps[kind](), (params, batch), _nbytes([params])


def _nbytes(trees) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(trees))


def rank_program(cfg, kind: str, b: int, s: int, mesh_shape: dict, policy_or_rules,
                 accum: int = TRAIN_ACCUM, s_max=None, rank: int = 0) -> dict:
    """One rank's step of a cell, run on ``meta`` tensors over a recording
    mesh of ``mesh_shape`` (axis → size; ``launch/mesh.py::recording_mesh``,
    this rank ``rank``), counted.

    ``kind``: ``"train"`` (``make_train_step`` with ``build_cell``'s AdamW
    schedule, ``accum`` microbatches, donated), ``"prefill"``
    (``make_prefill_step`` into caches of ``s_max``, default the stream's
    length), ``"decode"`` (one tick at ``pos = s_max - 1`` on caches of
    ``s_max``, default ``s``), ``"loss"`` (``make_eval_step``) or ``"grad"``
    (``make_grad_step``), of a ``[b, s]`` batch of tokens (a VLM's vision
    embeddings and an encoder-decoder's frames beside them).
    ``policy_or_rules``: a policy name (``policy_rules`` of ``cfg.name``,
    whose config transform is applied to ``cfg``: ``cfg`` may be cut in
    depth) or ``(param_rules, rules)`` (``param_rules`` None for
    ``PARAM_RULES``).  The parameters (and the moments) are this rank's
    blocks by the parameter rules and a decode tick's caches its blocks in
    the decode layout (:func:`rank_blocks`); the batch is the whole batch,
    as every rank is given it (:func:`rank_step`).

    → ``{"report": the CollectiveReport, "cost": the CostCounter's result,
    "block_bytes": the bytes of the parameter, moment and cache blocks,
    "cfg", "param_rules", "rules"}``."""
    mesh = recording_mesh(tuple(mesh_shape.values()), tuple(mesh_shape), rank)
    cfg, param_rules, rules = rank_rules(cfg, kind, b, s, mesh, policy_or_rules)
    step, args, block_bytes = rank_step(cfg, kind, b, s, mesh, param_rules, rules, accum, s_max)
    with actctx.activation_sharding(mesh, rules, param_rules), \
            counting_collectives() as report, CostCounter(*args) as counter:
        step(*args)
    return dict(report=report, cost=counter.result(), block_bytes=block_bytes, cfg=cfg,
                param_rules=param_rules, rules=rules)


def formula_ops(cfg, kind: str, b: int, s: int, mesh_shape: dict, param_rules, rules,
                accum: int = TRAIN_ACCUM, s_max=None) -> list:
    """``launch/sharded.py::sharded_collectives`` for the step
    :func:`rank_program` runs, without the launcher's greedy pick
    (``decode/greedy``), which no cell issues; a grad step's is a train
    step's of one microbatch (the optimizer issues no collective)."""
    from .sharded import sharded_collectives

    step = "train" if kind == "grad" else kind
    ops = sharded_collectives(cfg, mesh_shape, rules, b, s, dtype_of(cfg.param_dtype).itemsize,
                              dtype_of(cfg.compute_dtype).itemsize, step=step,
                              accum=1 if kind == "grad" else accum, param_rules=param_rules,
                              s_max=s_max)
    return [op for op in ops if op[3] != "decode/greedy"]


def first_difference(got: list, want: list):
    """The first (index, counted op, formula op) where two op lists differ
    (None for an op past the end of its list), or None where they agree."""
    for i in range(max(len(got), len(want))):
        a = got[i] if i < len(got) else None
        w = want[i] if i < len(want) else None
        if a != w:
            return i, a, w
    return None


def record_path(out_dir: Path, arch: str, shape: ShapeSpec, multi_pod: bool,
                policy: str = "baseline") -> Path:
    suffix = "" if policy == "baseline" else f"__{policy}"
    return out_dir / f"{arch}__{shape.name}__{'pod512' if multi_pod else 'pod256'}{suffix}.json"


def run_cell(
    arch: str,
    shape: ShapeSpec,
    multi_pod: bool,
    out_dir: Path,
    force: bool = False,
    policy: str = "baseline",
    acct: dict | None = None,
    accum: int = TRAIN_ACCUM,
) -> dict:
    """One cell's record, written to ``out_dir``; ``acct`` is the (arch,
    shape)'s :func:`accounting`, made here when not given; ``accum``: the
    train cell's microbatches in the rank program."""
    mesh_tag = "pod512" if multi_pod else "pod256"
    out = record_path(out_dir, arch, shape, multi_pod, policy)
    if out.exists() and not force:
        return json.loads(out.read_text())

    t0 = time.time()
    record: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_tag, "policy": policy,
                    "ok": False}
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh_device_count(mesh)
        cell = build_cell(arch, shape, mesh, policy)
        mem_bytes = memory_per_device(cell, mesh)
        cfg, b, s, s_max = cell_step(arch, shape, mesh, policy)
        t1 = time.time()
        prog = rank_program(cfg, shape.kind, b, s, mesh.shape, policy, accum=accum, s_max=s_max)
        rank_s = time.time() - t1
        batch_at = (1, 2) if shape.kind == "decode" else (len(cell["args"]) - 1,)
        batch_bytes = sum(_device_bytes(cell["args"][i], cell["in_shardings"][i], mesh)
                          for i in batch_at)
        if prog["block_bytes"] != mem_bytes["argument"] - batch_bytes:
            raise AssertionError(f"the rank program's blocks hold {prog['block_bytes']} B; the "
                                 f"cell's arguments less its batch {mem_bytes['argument']} - "
                                 f"{batch_bytes} B")
        mem = {f"{k}_gib": v / GIB for k, v in mem_bytes.items()}
        mem["peak_gib"] = prog["cost"]["live_peak_bytes"] / GIB
        mem["temp_gib"] = (prog["cost"]["live_peak_bytes"]
                           - prog["cost"]["argument_bytes"]) / GIB
        record["memory"] = mem
        acct = acct if acct is not None else accounting(arch, shape)
        add_flops, add_bytes = ssm_scan_addendum(acct["cfg"], shape)
        record["accounting"] = {
            "flops_global": float(acct["flops"]),
            "bytes_global": float(acct["bytes"]),
            "model_flops": acct["model_flops"],
            "transcendentals": float(acct["transcendentals"]),
            "uncounted": acct["uncounted"],
            "regions": acct["regions"],
            "ssm_addendum_flops": add_flops,
            "ssm_addendum_bytes": add_bytes,
            "accounting_s": acct["accounting_s"],
        }
        coll = prog["report"]
        record["collectives"] = {
            "count": coll.count(),
            "by_kind_wire_bytes": coll.by_kind(),
            "wire_bytes_ici": coll.total_wire_bytes(dcn=False),
            "wire_bytes_dcn": coll.total_wire_bytes(dcn=True),
        }
        record["collectives_note"] = COLLECTIVES_NOTE
        record["rank_program"] = {"accum": accum if shape.kind == "train" else 1,
                                  "flops_one_rank": float(prog["cost"]["flops"]),
                                  "seconds": round(rank_s, 1)}
        record["chip"] = H100_SXM.name
        record["roofline"] = roofline_terms(acct["flops"], acct["bytes"], coll, chips,
                                            acct["model_flops"], chip=H100_SXM).to_dict()
        got = [(c.kind, c.result_bytes, c.group, c.path) for c in coll.ops]
        want = formula_ops(prog["cfg"], shape.kind, b, s, mesh.shape, prog["param_rules"],
                           prog["rules"], accum, s_max)
        diff = first_difference(got, want)
        if diff is not None:
            raise AssertionError(f"op {diff[0]} of {len(got)} counted ({diff[1]}) differs from "
                                 f"sharded_collectives' ({diff[2]}, of {len(want)})")
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["seconds"] = round(time.time() - t0, 1)

    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2, default=str))
    return record


#: What a record's ``collectives`` count covers, and what it does not.
COLLECTIVES_NOTE = (
    "the collectives one rank of the mesh issues in the port's program for this cell "
    "(launch/sharded.py's path, run on meta tensors over a recording mesh), every trip "
    "counted by running it (a train cell at its --accum microbatches), equal op for op to "
    "launch/sharded.py::sharded_collectives; count is the number of ops issued, not of "
    "distinct ops in a compiled program. Not covered: collectives XLA's partitioner would "
    "add or drop for the reference's compiled cell (the CPU tests put the port's sharded "
    "cells at 0.24-1.51x the compiled cells' wire bytes); and H100_SXM.link_bytes_s "
    "(NVLink, 450 GB/s) is applied to every group inside a pod of 256, as the reference "
    "applies ICI, although a 16-rank model group spans two 8-GPU hosts. wire_bytes_dcn "
    "counts the groups that span pod.")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--policy", default="baseline", choices=["baseline", "opt"])
    ap.add_argument("--accum", type=int, default=TRAIN_ACCUM,
                    help="a train cell's microbatches in the rank program")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes_for(arch):
            if args.shape != "all" and shape.name != args.shape:
                continue
            acct = None
            for multi in meshes:
                tag = f"{arch} × {shape.name} × {'2x16x16' if multi else '16x16'}"
                if acct is None and (args.force or not record_path(
                        out_dir, arch, shape, multi, args.policy).exists()):
                    try:
                        acct = accounting(arch, shape)
                    except Exception:  # noqa: BLE001 — run_cell counts again and records it
                        pass
                rec = run_cell(arch, shape, multi, out_dir, force=args.force,
                               policy=args.policy, acct=acct, accum=args.accum)
                if rec["ok"]:
                    n_ok += 1
                    mem = rec["memory"]["peak_gib"]
                    dom = rec.get("roofline", {}).get("dominant", "-")
                    print(f"[OK]   {tag:64s} peak={mem:8.2f} GiB/dev "
                          f"flops={rec['accounting']['flops_global']:.3e} "
                          f"collectives={rec['collectives']['count']} "
                          f"s={rec['seconds']:6.1f} dominant={dom}", flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag:64s} {rec['error']}", flush=True)
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
