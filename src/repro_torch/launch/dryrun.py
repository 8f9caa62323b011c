"""Dry run of every (arch × shape × mesh) cell: memory per device, the
step's global FLOPs and bytes, and the roofline terms, without a device.

The port of the reference's ``launch/dryrun.py``.  Per cell it writes a
JSON record under ``artifacts/dryrun_torch/`` holding:

* ``memory``      — the bytes each device holds of the step's arguments
  and outputs, and those its donated arguments alias, from the cell's
  shardings (``distributed/sharding.py::spec_for`` shards a dimension only
  where the mesh axis divides it, so each division is exact).  The port
  has no partitioned program, so there is no per-device temporary figure:
  ``temp_gib_one_device`` is the live-bytes peak of the unsharded step
  beyond its arguments, on one device, and no ``peak_gib`` is written.
* ``accounting``  — the step's global FLOPs, bytes and transcendentals as
  ``kernels/cost.py`` counts them on ``meta`` tensors (the kernels and the
  mamba time scan by their formulas), the ops it has no FLOP rule for,
  and ``model_flops_estimate``.
* ``roofline``    — ``roofline_terms(...).to_dict()`` at the H100's record
  over the mesh's chip count.
* ``collectives`` — null, with ``collectives_note`` saying why: a
  production cell's collectives come from the sharded model (parameters
  and activations placed by ``distributed/sharding.py``'s rules).  The
  port runs a dense model's prefill, loss and train step sharded over the
  ranks of a rank mesh (``launch/sharded.py``, counted by
  ``hlo_analysis.counting_collectives``), but the dry run has no ranks and
  counts none yet; the other step kinds and families are not sharded.  A
  partial count would pass for the whole, so none is written, and
  ``dominant`` is compute or memory.

The cell is the reference's accounting cell: ``scan_layers=False,
attn_chunk=0``, one microbatch, AdamW moments in float32, and decode at the
host integer ``pos = seq_len - 1`` (the plain decode attends the whole
cache under a mask, so the count does not depend on ``pos``).  The
accounting runs once per (arch, shape), not once per mesh.  Not carried:
``_scope_trips`` and ``--accum``, the reference's workarounds for XLA
visiting a loop body once and for its compiled cells; the counter counts
every trip of a loop that runs, and the time scan by formula.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both        # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
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
from ..distributed.sharding import (
    ACT_RULES_DECODE,
    ACT_RULES_SMALL_DP,
    ACT_RULES_TRAIN,
    ACT_RULES_TRAIN_OPT,
    PARAM_RULES_SMALL_DP,
    NamedSharding,
    param_shardings,
    spec_for,
)
from ..kernels.cost import CostCounter
from ..models.model import Model
from ..models.params import tree_map_defs
from ..optim.adamw import AdamW, AdamWState
from ..optim.schedule import constant
from .hlo_analysis import (
    H100_SXM,
    CollectiveReport,
    model_flops_estimate,
    roofline_terms,
    ssm_scan_addendum,
)
from .inputs import decode_inputs, train_inputs
from .mesh import make_production_mesh, mesh_device_count
from .steps import make_decode_step, make_prefill_step, make_train_step

SMALL_MODEL_PARAMS = 2e8     # below this, the opt policy runs pure DP
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
) -> dict:
    """One cell's record, written to ``out_dir``; ``acct`` is the (arch,
    shape)'s :func:`accounting`, made here when not given."""
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
        mem = {f"{k}_gib": v / GIB
               for k, v in memory_per_device(build_cell(arch, shape, mesh, policy), mesh).items()}
        acct = acct if acct is not None else accounting(arch, shape)
        mem["temp_gib_one_device"] = (acct["live_peak_bytes"] - acct["argument_bytes"]) / GIB
        mem["live_peak_gib_one_device"] = acct["live_peak_bytes"] / GIB
        mem["note"] = ("no partitioned program: temp_gib_one_device is the unsharded step's "
                       "live-bytes peak beyond its arguments on one device; no peak_gib per device")
        record["memory"] = mem
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
        record["collectives"] = None
        record["collectives_note"] = (
            "not counted: this cell's collectives come from the sharded model "
            "(distributed/sharding.py's rules across ranks); a dense model's prefill, loss "
            "and train step run sharded on a rank mesh (launch/sharded.py), but the dry run "
            "has no ranks and does not count their collectives yet")
        record["chip"] = H100_SXM.name
        record["roofline"] = roofline_terms(acct["flops"], acct["bytes"], CollectiveReport(),
                                            chips, acct["model_flops"], chip=H100_SXM).to_dict()
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["seconds"] = round(time.time() - t0, 1)

    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2, default=str))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--policy", default="baseline", choices=["baseline", "opt"])
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
                               policy=args.policy, acct=acct)
                if rec["ok"]:
                    n_ok += 1
                    mem = rec["memory"]["argument_gib"]
                    dom = rec.get("roofline", {}).get("dominant", "-")
                    print(f"[OK]   {tag:64s} args={mem:8.2f} GiB/dev "
                          f"flops={rec['accounting']['flops_global']:.3e} "
                          f"s={rec['seconds']:6.1f} dominant={dom}", flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag:64s} {rec['error']}", flush=True)
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
