#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each; any failure exits non-zero before the
result lines are printed:

1. device   — CUDA present and capability (9, 0); build every kernel
              library from ``src/repro_torch/kernels/csrc`` with nvcc, one
              nvcc per source, all started together.
2. kernels  — the planning-scan kernel (K1) in all three gather forms against
              its plain PyTorch version on CPU copies of the same seeded
              non-dyadic inputs, bit for bit, over a sweep of shapes and
              the failure path's (n 1..48, L 1 and 6, W 64..4 096); its
              time at the fleet path's shape beside the plain version's
              and the card's bound; the latency of one dependent float64
              add and the time of an empty launch (probes in
              ``csrc/ts_plan.cu``).
3. main     — BASS wavefront placement of 40 000 tasks on a 4 096-host fleet
              through ``ClusterController``, on the ``cuda`` backend (ledger
              mirror on the card) and on ``numpy``; the schedules must be
              byte-identical and every wave must have launched the kernel.
4. failure  — a k=8 fat-tree, 1 000 tasks, a core switch killed mid-stream; the
              reroute engine's column scans run on the card; schedules and
              reroute logs identical to the ``numpy`` backend's.  The
              ``(n, L, W)`` of every column launch of the ``cuda`` leg, as
              a histogram; K1's column form timed at the commonest shape
              and at the widest W, each beside its bound (bytes, or the
              chain of W dependent adds at the probed latency).
5. attention — flash attention (K2) and flash decode (K3) against their
              plain PyTorch versions on the card, on the reference's test
              shapes, the edges of their tiling and splitting, and the
              model's shapes, in float32 (atol 2e-5) and bfloat16
              (atol 2e-2), K2's bfloat16 path also against the plain
              version of its own rounding of P (``DESIGN_TOL``); their
              times at the model's shapes beside the plain versions', the
              bound and one PyTorch library call, by CUDA events and, per
              kernel, by ``torch.profiler``.
6. serve    — mistral-nemo-12b at full width and depth (bf16, seeded random
              parameters): two ``ServeEngine`` replicas behind a
              ``BassRouter`` serve 8 requests of 512 prompt tokens and 16
              new tokens, driven by ``launch/serve.py``'s ``drive``; K2
              launches once per layer and prefill.  Then the kernel path
              against the plain attention path: (a) full depth, bf16,
              last-position prefill logits; (b) full width, 4 layers, f32,
              16 greedy tokens identical.  One more prefill of the served
              shape is counted (``kernels/cost.py``, untimed) for phase 11.
7. train    — (a) the selective scan (K4) against its plain PyTorch version
              on the card, on the reference's test shapes and the model's,
              in float32 (atol 2e-4); its time at the model's shape beside
              the plain version's and the bound, and the special-function
              units' measured ex2 rate (probe in ``csrc/mamba_scan.cu``).
              falcon-mamba-7b at full
              width, 8 of its 64 layers (bf16, seeded random parameters,
              2 × 1 024 seeded tokens): (b) ``make_eval_step`` through K4
              (one launch per layer) and through the plain time loop, the
              two losses within 1e-3 in bf16 and, on float32 parameters,
              within 1e-5; K4 against the time loop on the first layer's
              own scan inputs; one more eval through K4 counted for
              phase 11; (c) three ``make_train_step`` steps
              (plain scan, remat, AdamW with warmup-cosine), losses and
              grad norms finite and positive and the parameters moved, with
              step time, tokens/s and peak device memory, then a fourth
              step and a second eval under ``torch.profiler`` (device time
              and idle share); (d) at 2 layers,
              a train step through K4 raises, as in the reference.
8. scheduler — the rest of the scheduler, each leg on ``cuda`` and then on
              ``numpy`` in one process, schedules and ledgers
              byte-identical: (a) ``bench_hierarchy.py``'s fleet leg (64
              pods × 256 hosts, 128 jobs × 256 tasks every 0.05 s) through
              the pod-affine ``HierarchicalController``, one ledger mirror
              per pod, with the flat ``ClusterController`` on ``cuda`` over
              the same arrivals beside it (a leg past 60 s cuts the job
              count, printed); (b) ``bench_recovery.py``'s acceptance storm
              (k 8, 128 tasks, a controller kill) journaled, and its twin
              from snapshot bytes plus the journal replay; a state restore
              across a retire with the mirror live; the affine hierarchy's
              snapshot twin; (c) ``bench_faults.py``'s storm at k 8 with
              500 tasks (host kills, stragglers, retries, LATE
              speculation) on both reroute engines, and at its acceptance
              config (k 8, 128 tasks, 6 crashes, 16 stragglers) on the
              batched engine, where LATE backups launch on both backends.
              K1's launches on each path go on the kernel line.
9. models   — the MoE, hybrid and encoder-decoder families on the serving
              path, each served like phase 6 (2 replicas × 4 slots behind
              ``BassRouter``, 8 requests, 16 new tokens), K2 launched once
              per attention layer and prefill, then freed: (a)
              moonshot-v1-16b-a3b at full width and depth (bf16, 512-token
              prompts), served twice with identical tokens, the prefill's
              drop rate; its bf16 full-depth logits on the kernel and
              plain paths against float32 and the share of expert choices
              they differ in; at 4 layers in float32 the two paths' greedy
              tokens, every expert choice, and logits within 1e-4; one MoE
              layer in float32 on the card against its CPU copy (routing
              identical, 1e-4); (b) jamba-v0.1-52b at full width, 16 of 32
              layers: the serve, a slot write into a fresh engine (only
              that slot of every cache leaf changes), an eval step through
              K4 (one launch per mamba layer) against the time loop
              (phase 7's bounds, float32 on one period of 8 layers), and
              float32 greedy tokens on one period, kernel = plain; (c)
              whisper-base with zero frames and 128-token prompts (K2 at
              head dim 64), float32 greedy tokens kernel = plain.
10. trainer — (a) internvl2-1b at full width and depth through
              ``launch/train.py``'s ``main`` (6 steps of 8 × 1 024
              positions with 256 vision embeddings, a checkpoint every 3
              steps): losses and grad norms finite and positive, the
              parameters moved, the epoch's shard placement launched K1
              once per ``wave_scan`` and its fetches equal the ``numpy``
              backend's, the final checkpoint restores bit for bit onto
              the card; step time, tokens/s, peak memory, one profiled
              step's idle share, the seconds ``save`` held the loop and
              each write took; one more step counted for phase 11, with
              ``torch.cuda.max_memory_allocated`` over it.  (b) ``--preset 100m``: 4 straight steps
              against 2 then ``--resume`` for 2 more, each leg its own
              process; the two step-4 checkpoints the same bytes.  (c)
              ``plan_epoch`` and ``prefetch_epoch`` of 8 192 shards of
              512 MB on the 4 096 hosts of phase 3, ``cuda`` then
              ``numpy``, byte-identical (a leg past 60 s halves the shard
              count, printed).  (d) ``tree_compress_with_feedback`` over
              (a)'s gradient tree on the card against a CPU copy, bit for
              bit, and ``cross_pod_allreduce`` plain and compressed over a
              one-rank NCCL group against the host's sum.
11. cost    — (a) ``python -m repro_torch.launch.dryrun`` for
              internvl2-1b × train_4k, falcon-mamba-7b × prefill_32k and
              moonshot-v1-16b-a3b × prefill_32k (``--mesh single``), one
              process each, all started together: every record ``ok``,
              its ``collectives`` (one rank's program on ``meta``, the
              train cell at 8 microbatches) the count and wire bytes of
              ``sharded_collectives`` for the cell, each cell's count, ICI
              and DCN wire bytes, ``dominant`` and ``peak_gib`` printed.
              (b) Each step counted in phases 6, 7 and 10 counted again on
              ``meta`` with the same config and shapes: FLOPs and bytes
              equal to the card's count exactly, and each kernel's region
              counted once per layer.  (c) Beside each step's measured
              time: the counted FLOPs and bytes, achieved TFLOP/s,
              ``mfu`` (``model_flops_estimate`` over time × the H100
              record's bf16 peak), the counted FLOPs' share of that peak,
              the roofline bound over the time, and for the trainer step
              the counted one-device live peak beside
              ``torch.cuda.max_memory_allocated``; and the host time of a
              kernel wrapper's region with no counter active.

12. expert  — the expert-parallel MoE dispatch (``moe_impl="a2a"``) on 4
              ranks, one process each, all on the one card, as a (1, 4)
              rank mesh (sequence over ``model``), their collectives on
              gloo staged through host memory after one probe of NCCL
              (recorded): (a) moonshot's MoE block at full width (64
              experts, 16 a rank), B 1, S 512, float32 and bf16 at
              capacity factor 8.0 against the one-rank gather (float32
              within 1e-4, bf16 stated), bf16 at 1.25 with each rank's
              drop rate; (b) moonshot-v1-16b-a3b at full width through a
              ``ServeEngine`` on every rank (2 requests of 512 tokens, 4
              new), at the largest depth whose reckoned bytes fit 70 GB
              (all 48 layers), capped at 12 for the script's time, the
              greedy tokens equal on every rank and
              K2 once per layer and prefill on each; at 2 layers in
              float32 every rank's prefill logits within 1e-4 of the
              one-rank gather's; (c) phi3.5-moe-42b-a6.6b at full width
              (16 experts, 4 a rank) served the same way at the largest
              depth that fits, capped at 6 for the script's time; (d) every rank's counted collectives equal
              to ``launch/expert.py::a2a_collectives`` op for op.
13. sharded — mistral-nemo-12b at full width sharded over 4 ranks of the
              one card (``launch/sharded.py``), each holding its blocks of
              every parameter by ``PARAM_RULES`` under the baseline
              policy's rules (batch over ``data``, sequence over
              ``model``), as (1, 4) and (2, 2) rank meshes, gloo staged
              through host memory as in phase 12, once the card's memory
              is back: (a) 2 layers in float32, the prefill logits of 2 of
              phase 6's prompts and their loss against the one-rank
              model's within 1e-4; (b) 10 of 40 layers in bf16 with K2 on
              each rank's heads (10 launches a prefill), the 4 ranks'
              last-position logits no farther from the float32 prefill
              than 1.5 × the one-rank bf16 logits are, and the same first
              tokens; (c) on (2, 2) the bf16 loss of 2 × 1 024 tokens
              within max(1e-3, 2 × the one-rank bf16 loss's distance) of
              the float32 loss; (d) every rank's collectives equal to
              ``launch/sharded.py::sharded_collectives``; per rank the
              time of each step's first (counted) call and of one repeat,
              wire bytes by kind, memory.
14. sharded train — mistral-nemo-12b's train step at full width sharded
              over 4 ranks of the one card (``launch/sharded.py``'s
              ``"train"`` entry; gloo staged through host memory), the
              rules from ``launch/dryrun.py::policy_rules``: (2, 2) under
              the baseline and (1, 4) under ``opt`` (12.2 G parameters:
              ``ACT_RULES_TRAIN_OPT``); steps of 4 × 1 024 (in bf16 2
              microbatches of 2 × 1 024), parameters and moments donated;
              then on the same card the one-rank steps from the same seed:
              (a) 2 layers in float32, one step: its loss and grad norm within 1e-4, every
              leaf of the m within 1e-3 of its largest |m|; (b) 2
              layers in bf16, one step (depth and steps by the script's
              time): its loss within 1e-2 and
              grad norm within 2 %, then an eval of 2 × 512 through K2 on
              each rank's heads of the updated shards (2 launches a rank)
              within 1e-2 of the one-rank
              model's; K2 launched no time in the train steps (they take
              the chunked attention, as the reference's train cell does);
              every rank's collectives equal to ``sharded_collectives(
              step="train")`` (and ``"loss"`` for the eval); per rank the
              step times, wire bytes by kind, memory.  Small-DP takes no
              full-width dense config (all have at least 2e8 parameters):
              it is held on the CPU only, as the output says.
15. sharded ssm — falcon-mamba-7b at full width sharded over 4 ranks of
              the one card (gloo, host-staged), each layer's mamba block
              on the rank's block of ``d_inner`` and the tied head on the
              embedding's vocab-parallel block, the rules from
              ``policy_rules`` (``ACT_RULES_DECODE`` for the ticks): (a) 2
              layers in float32 on (1, 4) and (2, 2): the prefill of 2 ×
              512, the loss of 2 × 1 024 and 2 ticks fed from the
              prefill's states within 1e-4 of one rank, and on (2, 2) a
              train step (accum 2, baseline) by phase 14's (a) gates; (b)
              16 of 64 layers in bf16 on (1, 4): the prefill no farther from
              float32 than 1.5 × one rank's bf16 (first tokens equal), the
              eval of 2 × 1 024 through K4 (16 launches a rank at d_in
              2 048; its distance from one rank's time loop reported), the
              same eval in float32 within 1e-4 of one rank's float32 time
              loop, 4 ticks, a tick at decode_32k's B 128 and one at
              long_500k's B 1, ``pos`` 524 287, each by the same 1.5 ×
              rule; (c) two bf16 train steps on (1, 4) under ``opt`` at 4
              layers by phase 14's (b) gates; (d) every rank's collectives equal to
              ``sharded_collectives``; (e) K4 against its plain version at
              d_in 2 048 and 4 096 (B 2, S 1 024), timed; (f) per rank the
              step, tick and eval times, wire bytes by kind, memory.
16. sharded moe — moonshot-v1-16b-a3b at full width sharded over 4 ranks
              of the one card (gloo, host-staged), the experts over
              ``model``, the rules from ``policy_rules``, the one-rank
              references first: (a) 2 layers in float32 under the
              baseline (the sharded gather dispatch) on (1, 4) and (2, 2):
              the prefill of 2 × 512, the loss of 2 × 1 024 and 2 ticks
              fed from the prefill's caches within 5e-5 of one rank, with
              each rank's routing against one rank's reported, and on
              (2, 2) one train step (accum 2) whose loss and grad norm are
              within 1e-5 of one rank's; (b) 6 of 48 layers in bf16 on
              (1, 4) under the baseline: the prefill's first tokens equal
              or a near tie (its logits' distance from float32 reported
              beside one rank's), the loss of 2 × 1 024 no farther from
              float32 than 1.5 × one rank's bf16 loss and within 1e-2 of
              it, 4 ticks reported; (c) 2 layers on (1, 4) under ``opt``
              (the a2a dispatch on each rank's block of the stream, at a
              capacity no bucket overflows): a float32 prefill within 5e-5
              of one rank's, a bf16 prefill's first tokens by (b)'s rule,
              a bf16 train step whose loss is within 1e-3 and grad norm
              within 0.5 % of one rank's; (d) every rank's collectives equal to
              ``sharded_collectives``, K2 once a layer on each rank in
              every prefill and eval; per rank the step and tick times,
              wire bytes by kind, memory.
17. sharded hybrid — jamba-v0.1-52b at full width sharded over 4 ranks
              of the one card (gloo, host-staged), each slot of a period
              as its own family on ranks and one slot's weights gathered
              at a time, the one-rank references first: (a) one period
              (8 layers) in float32 on (1, 4): the prefill's logits
              within 1e-4, the loss of 2 × 1 024 and 4 ticks from the
              prefill's caches within 5e-5 of one rank, routing 100 % one
              rank's; (b) the period in bf16 on (1, 4): the prefill's
              first tokens equal or a near tie, the eval through K2 and K4
              no farther from float32 than 1.5 × one rank's and within
              1e-2 of it, 4 ticks reported; (c) the bf16 period on (2, 2):
              the prefill and 2 ticks by (b)'s rules, at most 14 GB a
              rank; (d) two
              long_500k ticks (B 1, ``pos`` 524 286 and 524 287) on seeded
              caches, every slot stationary: each no farther from float32
              than 1.5 × one rank's, no ``layer`` gather; (e) one period
              under ``opt`` at capacity factor 8: a float32 prefill within
              1e-4 of one rank's, routing 100 % equal, a bf16 prefill
              reported; (f) ``Model.loss`` under ``torch.autograd.grad``
              on one bf16 period, ``remat`` on: the loss within 1e-2 and
              the grad norm within 0.5 % of one rank's; (g) every rank's
              collectives equal to ``sharded_collectives``, K2 once a
              period in every prefill and eval, K4 7 times a period in
              every eval.
18. sharded encoder-decoder and VLM — internvl2-1b and whisper-base at
              full width sharded over 4 ranks of the one card (gloo,
              host-staged), the one-rank references first, vision
              embeddings and frames from the seed: (a) internvl2-1b in
              float32, 24 layers, on (1, 4): the prefill of 2 × (256 +
              512) within 1e-4, the loss of 2 × (256 + 768) and 2 ticks
              from the prefill's caches within 5e-5 of one rank; (b) on
              (2, 2): float32 at 4 layers (the prefill, the loss), bf16 at
              24 (the prefill, the eval through K2, 2 ticks, one
              decode_32k tick), each no farther from float32 than 1.5 ×
              one rank's, the first tokens equal or a near tie; (c) one
              float32 train step under ``opt`` on (1, 4) at 4 layers; (d)
              whisper-base whole in float32 on (1, 4) and (2, 2): the
              prefill of 2 × (1 500 frames, 128 tokens), the loss of 2 ×
              384, 2 ticks; (e) whisper-base in bf16 on (1, 4): the
              prefill, the eval, 2 ticks, one decode_32k tick; (f) its
              float32 train step under the baseline on (2, 2) and under
              ``opt`` (small-DP) on (1, 4), by phase 14 (a)'s gates; (g)
              every rank's collectives equal to ``sharded_collectives``,
              K2 once a decoder layer in every prefill and eval and never
              in a tick or a train step.
              In phases 13–18 each counted entry (prefill, loss, train,
              grad, tick) is also run as one rank's program on ``meta``
              in this process (``launch/dryrun.py::rank_program``, the
              case's config, depth, mesh, rules and shapes): its ops equal
              the formula, and so every rank's on the card, op for op
              (the launcher's ``decode/greedy`` left out).
19. examples — the port's five example scripts in this process: the three
              scheduler scripts (``examples/quickstart_torch.py``,
              ``bass_cluster_demo_torch.py``, ``failover_demo_torch.py``)
              on ``cuda`` and then on ``numpy``, the same standard output,
              K1 launched on ``cuda``; ``serve_batch_torch.py`` routes and
              finishes all 10 requests; ``train_e2e_torch.py`` at its
              defaults (300 steps), its checkpoints under ``build/``, its
              last loss below its first.

The last three lines are the kernel table as JSON, the card's name and
power limit as ``nvidia-smi`` prints them, and ``{"ok": true, ...}``.  A
full report goes to ``build/chip_smoke.json``.

    python3 chip_smoke.py --kernel-times

builds the kernels and prints only K1's times (fleet shape, the failure
leg's commonest and widest launch shapes) and K4's, as one JSON line (and
``build/kernel_times.json``): copied into two trees, it compares their
kernels in one call.

    python3 chip_smoke.py --sharded-train
    python3 chip_smoke.py --sharded
    python3 chip_smoke.py --sharded-ssm
    python3 chip_smoke.py --sharded-moe
    python3 chip_smoke.py --sharded-hybrid
    python3 chip_smoke.py --sharded-encdec-vlm
    python3 chip_smoke.py --examples

build the kernels and run phase 14, 13, 15, 16, 17, 18 or 19 alone (its
line only, and for 13–18 the ``meta`` rank programs' line).
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.launch.hlo_analysis import H100_SXM, chip_named  # noqa: E402

# H100 SXM peaks from the port's chip record (NVIDIA data sheet): HBM3
# bandwidth, vector float64 and float32 and dense bf16 tensor-core rates;
# phase 1 checks that the card is the one the record names.  And the
# special-function units' exponentials, 16 per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) on 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_S = H100_SXM.hbm_bytes_s
F64_FLOP_S = H100_SXM.peak_f64_flop_s
F32_FLOP_S = H100_SXM.peak_f32_flop_s
BF16_FLOP_S = H100_SXM.peak_bf16_flop_s
SFU_EXP_S = 16 * 132 * 1.98e9
SEED = 0
REPORT = {}


def log(phase: str, **fields) -> None:
    REPORT.setdefault("phases", {})[phase] = fields
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# -- counted steps ---------------------------------------------------------------

#: The steps phases 6, 7 and 10 count once on the card, untimed, under
#: ``kernels/cost.py``'s counter: the card's count, the step's function and
#: ``meta`` stand-ins of its arguments (phase 11 counts it again there), its
#: config and shape (for ``model_flops_estimate``) and the phase's measured
#: time of the same step.
COUNTED = {}


def _meta(tree):
    """The same tree with every tensor an empty one on ``meta``."""
    import torch

    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return tree


def _count_step(name, fn, args, cfg, shape, seconds, **extra):
    """Count ``fn(*args)`` once on the card, its arguments live, and keep
    what phase 11 needs; → the card's count."""
    import torch

    from repro_torch.kernels import cost

    torch.cuda.synchronize()
    with cost.CostCounter(*args) as c:
        fn(*args)
    torch.cuda.synchronize()
    COUNTED[name] = dict(fn=fn, meta_args=_meta(args), cfg=cfg, shape=shape,
                         seconds=seconds, card=c.result(), card_by_op=c.by_op, **extra)
    return c.result()


# -- phase 1 -------------------------------------------------------------------


def phase_device():
    import torch

    # Importing each kernel's module registers its source with _build.
    from repro_torch.kernels import _build, decode_attention, flash_attention  # noqa: F401
    from repro_torch.kernels import mamba_scan, ts_plan_device  # noqa: F401

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke needs an H100")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    if cap != (9, 0):
        raise SystemExit(f"{name} has capability {cap}, not (9, 0)")
    try:  # no share of a peak is computed against another card's record
        chip_named(name)
    except KeyError as exc:
        raise SystemExit(f"{name}: {exc}") from None
    t0 = time.perf_counter()
    _build.build()
    info = _build.build_info
    log("device", name=name, capability=list(cap), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=time.perf_counter() - t0,
        nvcc_s={k: v["build_s"] for k, v in info.items()},
        libraries={k: os.path.relpath(v["path"], HERE) for k, v in info.items()})
    REPORT["ptxas"] = {k: v["log"] for k, v in info.items()}
    return name, smi


# -- phase 2 -------------------------------------------------------------------


def _bitwise(a, b):
    """Same shape and dtype, and every element the same bits (NaN matches
    NaN whatever its payload).  Returns (equal, max |a - b| over finite)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    if a.dtype == torch.float64:
        same = (a.view(torch.int64) == b.view(torch.int64)) | (a.isnan() & b.isnan())
        fin = torch.isfinite(a) & torch.isfinite(b)
        err = float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0
    else:
        same = a == b
        err = float((a - b).abs().max()) if a.numel() else 0.0
    return bool(same.all()), err


def _mirror(rng, R, Wm):
    M = rng.random((R, Wm))
    u = rng.random((R, Wm))
    M[u < 0.3] = 0.0  # free cells: full residue
    M[u > 0.9] = 1.0  # fully booked cells: no bandwidth
    return M


def _sizes(rng, booked, caps, secs):
    """Sizes around each row's deliverable total, so that most rows fit at
    some slot, some never fit, and a few are empty."""
    total = ((1.0 - booked.max(axis=1)) * caps[:, None] * secs).sum(axis=1)
    sizes = total * rng.uniform(0.0, 1.3, size=len(caps))
    sizes[rng.random(len(caps)) < 0.1] = 0.0
    return sizes


def _window_case(rng, n, L, W, dur=0.1):
    R, Wm = max(4 * L, 64), W + 257
    M = _mirror(rng, R, Wm)
    pad = rng.integers(0, R, size=(n, L))
    off = rng.integers(0, Wm - W + 1, size=n)
    sz = off + rng.integers(0, 10_000, size=n)
    t0 = sz * dur - rng.uniform(0.0, dur, size=n)
    first = rng.uniform(1e-3, dur, size=n)
    caps = rng.uniform(1.0, 37.0, size=n)
    secs = np.full((n, W), dur)
    secs[:, 0] = first
    booked = M[pad[:, :, None], off[:, None, None] + np.arange(W)]
    sizes = _sizes(rng, booked, caps, secs)
    return M, pad, off, caps, first, sizes, sz, t0, dur


def _columns_case(rng, n, L, W):
    R, Wm = max(4 * L, 64), W + 257
    M = _mirror(rng, R, Wm)
    pad = rng.integers(0, R, size=(n, L))
    cols = rng.integers(0, Wm, size=(n, W))
    secs = rng.uniform(0.0, 0.13, size=(n, W))
    caps = rng.uniform(1.0, 37.0, size=n)
    sizes = _sizes(rng, M[pad[:, :, None], cols[:, None, :]], caps, secs)
    return M, pad, cols, caps, secs, sizes


def _dense_case(rng, n, L, W):
    booked = rng.random((n, L, W))
    caps = rng.uniform(1.0, 37.0, size=n)
    secs = rng.uniform(0.0, 1.3, size=(n, W))
    sizes = _sizes(rng, booked, caps, secs)
    overlay = (rng.random((n, L, W)) < 0.2).astype(np.float64)
    return booked, caps, secs, sizes, overlay


# The failure path's column scans: a reroute round's live candidates (a few
# to a few dozen rows), up to a fat tree's path length, and W = 64
# escalating ×4 (core/reroute.py); W 4 096 runs past one shared tile.
FAILURE_SHAPES = [(n, L, W) for n in (1, 3, 17, 48) for L in (1, 6)
                  for W in (64, 256, 1024, 4096)]


def _shapes():
    for W in (1, 16, 64, 200, 1024, 4096, 65536):
        ns = (1, 9, 33, 1024) if W <= 200 else ((1, 9, 33) if W == 1024 else (1, 9))
        for n in ns:
            for L in (1, 4, 9):
                yield n, L, W
    yield from FAILURE_SHAPES


def _time_ms(fn, reps=50, flush=None):
    """Median device time of one call, by CUDA events.  Each call is queued
    behind a sleeping kernel so that the host has enqueued all of it before
    the device reaches it, and the events bracket device time only; with
    ``flush``, the L2 is overwritten first, as a caller between waves finds
    it."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(10_000_000)  # ~5 ms of device time
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def phase_kernels():
    import torch

    from repro_torch.kernels import ts_plan, ts_plan_device as dev

    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    up = lambda x, dt, d: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=d)  # noqa: E731
    f64, i64 = torch.float64, torch.int64
    checked, max_err, fails = 0, 0.0, []

    def compare(label, got, ref):
        nonlocal checked, max_err
        for k, (g, r) in enumerate(zip(got, ref)):
            ok, err = _bitwise(g, r)
            max_err = max(max_err, err)
            checked += 1
            if not ok:
                fails.append(f"{label} output {k} (max |err| {err})")

    for n, L, W in _shapes():
        M, pad, off, caps, first, sizes, sz, t0, dur = _window_case(rng, n, L, W)
        args = [(M, f64), (pad, i64), (off, i64), (caps, f64), (first, f64),
                (sizes, f64), (sz, i64), (t0, f64)]
        got = dev.scan_window(*(up(x, t, cuda) for x, t in args), dur, W)
        ref = ts_plan.wave_scan_torch(*(up(x, t, "cpu") for x, t in args), dur, W)
        compare(f"window n={n} L={L} W={W}", got, ref)

        M, pad, cols, caps, secs, sizes = _columns_case(rng, n, L, W)
        args = [(M, f64), (pad, i64), (cols, i64), (caps, f64), (secs, f64), (sizes, f64)]
        got = dev.scan_columns(*(up(x, t, cuda) for x, t in args))
        ref = ts_plan.col_scan_torch(*(up(x, t, "cpu") for x, t in args))
        compare(f"columns n={n} L={L} W={W}", got, ref)

        booked, caps, secs, sizes, overlay = _dense_case(rng, n, L, W)
        for cap in (None, 3.7):
            for ov in (None, overlay):
                got = dev.plan_scan(booked, caps, secs, sizes, cap, ov, device=cuda)
                cpu = [up(x, f64, "cpu") for x in (booked, caps, secs, sizes)]
                ref = ts_plan.plan_scan_torch(
                    *cpu, cap, None if ov is None else up(ov, f64, "cpu")
                )
                compare(f"dense n={n} L={L} W={W} cap={cap} overlay={ov is not None}",
                        [torch.from_numpy(np.asarray(g)) for g in got], ref)
    if fails:
        raise AssertionError(f"{len(fails)} of {checked} kernel outputs differ "
                             f"from the plain version: {fails[:5]}")
    probes = _k1_probes(cuda)
    timing = _k1_window_timing(cuda, probes)
    log("kernels", checked=checked, bitwise=True, max_abs_err=max_err, **probes, **timing)
    return dict(checked=checked, max_abs_err=max_err, **probes, **timing)


def _k1_probes(cuda):
    """The latency of one dependent float64 add (the in-order sum's chain)
    by a ``clock64`` / ``%globaltimer`` loop, and the time of an empty
    launch by the same events as the kernel's: the probes of
    ``csrc/ts_plan.cu``.  Empty where the library has none."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    lib = _build.library("ts_plan")
    if not hasattr(lib, "ts_plan_probe_dadd"):
        return {}
    dadd, empty = lib.ts_plan_probe_dadd, lib.ts_plan_probe_empty
    dadd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    empty.argtypes = [ctypes.c_void_p]
    dadd.restype = empty.restype = ctypes.c_int

    def ok(err):
        if err != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")

    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = torch.ones(2, dtype=torch.float64, device=cuda)
    out = torch.zeros(1, dtype=torch.float64, device=cuda)
    t = torch.zeros(2, dtype=torch.int64, device=cuda)
    iters = 1 << 20
    for _ in range(3):
        ok(dadd(x.data_ptr(), out.data_ptr(), t.data_ptr(), iters, stream))
    torch.cuda.synchronize()
    cycles, ns = t.tolist()
    if float(out) != 1.0 + iters:
        raise AssertionError(f"dadd probe summed to {float(out)}, not {1 + iters}")
    return dict(dadd_latency_cycles=cycles / iters, dadd_latency_ns=ns / iters,
                empty_launch_ms=_time_ms(lambda: ok(empty(stream))))


def _k1_bound(n, L, W, form, probes):
    """The least time of one scan launch: the bytes it must move at the
    memory rate, its float64 operations at their peak rate, and the
    dependent chain of W adds at one add's latency, the largest."""
    gathered = n * L * W + n * L
    per_row = {"window": 6, "columns": 2}[form]  # caps, sizes (+ off, first, sz, t0; end)
    per_slot = {"window": 0, "columns": 2}[form]  # cols, secs
    nbytes = 8 * (gathered + n * per_row + n * per_slot * W + 3 * n * W + n
                  + (n if form == "window" else 0))
    flops = n * W * (L + 4) + 8 * n
    bound_s = {"bytes": nbytes / HBM_BYTES_S, "operations": flops / F64_FLOP_S}
    if "dadd_latency_ns" in probes:
        bound_s["chain"] = W * probes["dadd_latency_ns"] * 1e-9
    by = max(bound_s, key=bound_s.get)
    return dict(bound_ms=bound_s[by] * 1e3, bound_by=by,
                bound_ms_each={k: v * 1e3 for k, v in bound_s.items()},
                bytes=nbytes, flops=flops)


def _k1_window_timing(cuda, probes):
    """K1's window form at the fleet path's shape: one wave gathers n≈1 000
    candidates × L=4 links × w=64 slots from a 4 112 × 8 192 mirror."""
    import torch

    from repro_torch.kernels import ts_plan, ts_plan_device as dev

    rng = np.random.default_rng(SEED + 1)
    up = lambda x, dt, d: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=d)  # noqa: E731
    f64, i64 = torch.float64, torch.int64
    n, L, W, R, Wm, dur = 1024, 4, 64, 4112, 8192, 0.1
    M = up(rng.random((R, Wm)), f64, cuda)
    pad = up(rng.integers(0, R, size=(n, L)), i64, cuda)
    off = up(rng.integers(0, Wm - W, size=n), i64, cuda)
    sz = off + 1000
    caps = up(rng.uniform(1e9, 25e9, size=n), f64, cuda)
    first = up(rng.uniform(1e-3, dur, size=n), f64, cuda)
    sizes = up(rng.uniform(256e6, 640e6, size=n), f64, cuda)
    t0 = sz.to(f64) * dur
    args = (M, pad, off, caps, first, sizes, sz, t0, dur, W)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)  # > 50 MB L2
    ms = _time_ms(lambda: dev.scan_window(*args), flush=flush)
    ms_warm = _time_ms(lambda: dev.scan_window(*args))
    plain_ms = _time_ms(lambda: ts_plan.wave_scan_torch(*args), flush=flush)
    cpu_args = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    ts_plan.wave_scan_torch(*cpu_args)
    c0 = time.perf_counter()
    for _ in range(5):
        ts_plan.wave_scan_torch(*cpu_args)
    plain_cpu_ms = (time.perf_counter() - c0) / 5 * 1e3
    # bound_ms / bound_by: bytes against operations at their peak rates;
    # with_chain: the dependent chain of W adds beside them.
    bound = _k1_bound(n, L, W, "window", {})
    chain = _k1_bound(n, L, W, "window", probes)
    return dict(shape=[n, L, W], mirror=[R, Wm], ms=ms, ms_l2_warm=ms_warm,
                plain_ms=plain_ms, plain_cpu_ms=plain_cpu_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                bytes=bound["bytes"], flops=bound["flops"],
                with_chain=dict(bound_ms=chain["bound_ms"], bound_by=chain["bound_by"],
                                bound_ms_each=chain["bound_ms_each"]))


# -- phase 3 -------------------------------------------------------------------


def _reset_counts():
    """Every kernel's launch count (and the scan's call counts) to 0."""
    from repro_torch.kernels import (decode_attention, flash_attention, mamba_scan, ts_plan,
                                     ts_plan_device)

    ts_plan_device.stats.reset()
    ts_plan.calls.reset()
    flash_attention.stats.reset()
    decode_attention.stats.reset()
    mamba_scan.stats.reset()


def _counts():
    from repro_torch.kernels import ts_plan, ts_plan_device

    return dict(ts_plan_device.stats), dict(ts_plan.calls)


def _fleet_leg(backend: str, pods=16, hosts=256, n_tasks=40_000, batch=1024):
    import torch

    from repro_torch.core import ClusterController
    from repro_torch.kernels import ts_plan
    from repro_torch.tools.dump_schedules import fleet_instance

    inst = fleet_instance(pods, hosts, n_tasks)
    ts_plan.set_backend(backend)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ctrl = ClusterController.from_instance(inst)
    lat_ms = []
    t0 = time.perf_counter()
    for i in range(0, n_tasks, batch):
        c0 = time.perf_counter()
        ctrl.submit(inst.tasks[i:i + batch], at=0.0)
        ctrl.run_until(0.0)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - c0) * 1e3)
    dt = time.perf_counter() - t0
    stats, calls = _counts()
    assert len(ctrl.schedule().assignments) == n_tasks
    return ctrl, dict(
        backend=backend, tasks=n_tasks, hosts=pods * hosts, seconds=dt,
        tasks_s=n_tasks / dt, batch_p50_ms=float(np.percentile(lat_ms, 50)),
        batch_p99_ms=float(np.percentile(lat_ms, 99)), stats=stats, calls=calls,
        max_memory_allocated=(
            torch.cuda.max_memory_allocated() if backend == "cuda" else None
        ),
        ledger_shape=list(ctrl.state.ledger.reserved.shape),
    )


def phase_main_path():
    """The fleet run on ``cuda``, then on ``numpy`` (the repeats of each, run
    before for the spread of host noise, were cut for the script's time).
    The cuda leg's schedule must equal the numpy leg's."""
    from repro_torch.convert import canon

    legs, ref = [], None
    for backend in ("cuda", "numpy"):
        ctrl, leg = _fleet_leg(backend)
        leg["schedule"] = canon(ctrl.schedule().assignments)
        leg["ledger"] = ctrl.state.ledger.reserved.copy()
        if backend == "numpy" and ref is None:
            ref = leg
        legs.append(leg)
        del ctrl
        gc.collect()  # free the leg's mirror before the next leg's peak
    identical = all(leg["schedule"] == ref["schedule"] for leg in legs)
    ledger_identical = all(np.array_equal(leg["ledger"], ref["ledger"]) for leg in legs)
    for leg in legs:
        del leg["schedule"], leg["ledger"]
    # The first leg is the main path's run: its counts were set to 0 just
    # before it and read just after.
    cuda = legs[0]
    launches, waves = cuda["stats"]["launches"], cuda["calls"]["wave_scan"]
    log("main", legs=legs, identical=identical, ledger_identical=ledger_identical)
    if not (identical and ledger_identical):
        raise AssertionError("a cuda schedule differs from the numpy backend's")
    if not (launches > 0 and cuda["stats"]["launches_window"] == waves
            and all(leg["calls"]["wave_scan"] == waves for leg in legs)):
        raise AssertionError(f"{launches} launches for {waves} waves")
    return cuda


# -- phase 4 -------------------------------------------------------------------


# 1 000 tasks (3 000 before, for the script's time, PERF.md §4): each leg
# still reroutes half of them round the dead core switch.
FAILURE_TASKS = 1000


def _failure_leg(backend: str, k=8, n_tasks=FAILURE_TASKS, shapes=None):
    """Sources in the lower pods, workers in the upper ones, so every shard
    crosses the core; half the tasks are placed, core0_0 dies under their
    transfers, then the other half arrive on the degraded fabric.  With
    ``shapes`` (a dict), the leg counts there the ``(n, L, W)`` of every
    column-form launch, with its mirror's shape."""
    from repro_torch.core import ClusterController, Task, storage_hosts
    from repro_torch.kernels import ts_plan, ts_plan_device
    from repro_torch.net import fat_tree_fabric

    fab = fat_tree_fabric(k, link_mbps=100.0)
    hosts = storage_hosts(fab)
    sources, workers = hosts[: len(hosts) // 2], hosts[len(hosts) // 2:]
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, len(sources), size=(n_tasks, 3))
    tasks = [
        Task(tid=i, size=float(256 + (i % 7) * 64), compute=0.05,
             replicas=tuple(sources[j] for j in idx[i]))
        for i in range(n_tasks)
    ]
    idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
    scan_columns = ts_plan_device.scan_columns
    if shapes is not None:
        def recording(M, pad, cols, *rest):
            key = (pad.shape[0], pad.shape[1], cols.shape[1])
            count, mirrors = shapes.get(key, (0, set()))
            shapes[key] = (count + 1, mirrors | {tuple(M.shape)})
            return scan_columns(M, pad, cols, *rest)

        ts_plan_device.scan_columns = recording
    ts_plan.set_backend(backend)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        ctrl = ClusterController(fab, workers, "bass", idle=idle, slot_duration=0.1)
        half = n_tasks // 2
        ctrl.submit(tasks[:half], at=0.0)
        ctrl.run_until(0.0)
        ctrl.fail_switch("core0_0", at=0.5)
        ctrl.submit(tasks[half:], at=1.0)
        ctrl.run()
    finally:
        ts_plan_device.scan_columns = scan_columns
    dt = time.perf_counter() - t0
    stats, calls = _counts()
    return ctrl, dict(backend=backend, tasks=n_tasks, seconds=dt,
                      rerouted=len(ctrl.reroute_log), stats=stats, calls=calls)


def phase_failure(probes):
    from repro_torch.convert import canon

    def log_canon(c):
        return [(r.flow, r.old_path, r.new_path, float(r.delivered).hex(),
                 float(r.remaining).hex(), float(r.new_end).hex())
                for r in c.reroute_log]

    shapes = {}
    ctrl, cuda = _failure_leg("cuda", shapes=shapes)
    ref_ctrl, numpy_leg = _failure_leg("numpy")
    same = canon(ctrl.schedule().assignments) == canon(ref_ctrl.schedule().assignments)
    same_log = log_canon(ctrl) == log_canon(ref_ctrl)
    del ctrl, ref_ctrl
    gc.collect()
    timing = _k1_failure_timing(shapes, probes)
    log("failure", cuda=cuda, numpy=numpy_leg, identical=same, reroute_identical=same_log,
        k1=timing)
    if not (same and same_log and cuda["rerouted"] > 0):
        raise AssertionError("failure path differs from the numpy backend's")
    if not (cuda["stats"]["launches_columns"] > 0
            and sum(c for c, _ in shapes.values()) == cuda["stats"]["launches_columns"]):
        raise AssertionError("the reroute engine launched no column scan, or "
                             "launches went unrecorded")
    return dict(cuda, k1=timing)


def _histogram(shapes):
    """``(n, L, W)`` → launches, the commonest first, and the launches by W."""
    rows = sorted(shapes.items(), key=lambda kv: (-kv[1][0], kv[0]))
    by_w = {}
    for (n, L, W), (count, _) in shapes.items():
        by_w[W] = by_w.get(W, 0) + count
    return ([dict(n=n, L=L, W=W, launches=c) for (n, L, W), (c, _) in rows],
            dict(sorted(by_w.items())))


def _k1_failure_timing(shapes, probes):
    """K1's column form at the failure leg's commonest launch shape and at
    its widest W (the commonest shape there), on seeded inputs of that
    shape gathered from a mirror of the leg's own size: columns increasing
    along each row, as the reroute engine's compressed columns are."""
    import torch

    from repro_torch.kernels import ts_plan, ts_plan_device as dev

    cuda = torch.device("cuda", 0)
    hist, by_w = _histogram(shapes)
    widest = max(by_w)
    picks = {"commonest": hist[0],
             "widest": next(h for h in hist if h["W"] == widest)}
    rng = np.random.default_rng(SEED + 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)  # > 50 MB L2
    up = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=cuda)  # noqa: E731
    f64, i64 = torch.float64, torch.int64
    out = dict(launches=sum(h["launches"] for h in hist), distinct_shapes=len(hist),
               launches_by_W=by_w, histogram=hist[:12])
    for key, h in picks.items():
        n, L, W = h["n"], h["L"], h["W"]
        R, Wm = max(shapes[(n, L, W)][1])
        M = rng.random((R, Wm))
        M[rng.random((R, Wm)) < 0.3] = 0.0
        span = min(2 * W, Wm)
        start = rng.integers(0, Wm - span + 1, size=n)
        cols = start[:, None] + np.sort(
            np.stack([rng.choice(span, W, replace=False) for _ in range(n)]), axis=1)
        args = (up(M, f64), up(rng.integers(0, R, size=(n, L)), i64), up(cols, i64),
                up(rng.uniform(1.0, 37.0, size=n), f64),
                up(rng.uniform(0.0, 0.1, size=(n, W)), f64),
                up(rng.uniform(0.0, 37.0 * 0.05 * W, size=n), f64))
        got = dev.scan_columns(*args)
        want = ts_plan.col_scan_torch(*(a.cpu() for a in args))
        if not all(_bitwise(g, w)[0] for g, w in zip(got, want)):
            raise AssertionError(f"K1's column form differs at {(n, L, W)}")
        out[key] = dict(shape=[n, L, W], launches=h["launches"], mirror=[R, Wm],
                        ms=_time_ms(lambda: dev.scan_columns(*args), flush=flush),
                        ms_l2_warm=_time_ms(lambda: dev.scan_columns(*args)),
                        plain_ms=_time_ms(lambda: ts_plan.col_scan_torch(*args), flush=flush),
                        **_k1_bound(n, L, W, "columns", probes))
    return out


# -- phase 5 -------------------------------------------------------------------

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (B, S, nq, nkv, hd): tests/test_kernels.py's FLASH_CASES and DECODE_CASES
# (with their pos); the designs' edges — K2 with one partial key tile
# (S 40), a ragged last tile (S 96), S not a multiple of 256 (384) and
# g = 7, K3 with pos on a chunk boundary (640 live keys: 10 chunks of 64 on
# 132 SMs), at S - 1, at 0 and over a 4 096-position cache; then the
# model's shapes — the prefills phase 9 serves (moonshot-v1-16b-a3b's 512
# tokens over 16 heads of 128, whisper-base's 128 over 8 heads of 64; jamba
# shares mistral's), each rank's heads of mistral's prefill in phase 13
# (8 of 32 and 2 of 8 kv heads on a (1, 4) mesh, for one prompt and the
# two a rank takes there; 16 and 4 on (2, 2)), then mistral-nemo-12b's
# prefill of a 512-token prompt
# (last: phase 5 times it) and its decode over 4 slots of a 1 024-position
# cache.
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 256, 6, 2, 64),
                (1, 512, 4, 4, 128), (1, 128, 14, 2, 64),
                (1, 40, 4, 2, 64), (1, 40, 4, 2, 128), (2, 96, 4, 2, 64),
                (1, 96, 8, 2, 128), (1, 384, 8, 2, 128), (1, 128, 14, 2, 128),
                (1, 512, 16, 16, 128), (1, 128, 8, 8, 64),
                (1, 512, 8, 2, 128), (2, 512, 8, 2, 128), (1, 512, 16, 4, 128),
                (1, 512, 32, 8, 128)]
DECODE_SHAPES = [(2, 512, 4, 2, 64, 137), (1, 1024, 8, 8, 128, 1023),
                 (2, 256, 6, 2, 64, 0), (1, 512, 16, 16, 64, 300),
                 (4, 1024, 32, 8, 128, 639), (4, 1024, 32, 8, 128, 1023),
                 (4, 1024, 32, 8, 128, 0), (4, 4096, 32, 8, 128, 4095),
                 (4, 1024, 32, 8, 128, 600)]
# K2's bfloat16 path is also held against the plain version of its own
# arithmetic, ``ref.attention_ref(..., p_dtype=bfloat16, p_block=64)`` (P
# rounded to bf16 against the running max of each 64-key tile, from
# float64): |got - want| <= rtol |want| + atol, rtol one bf16 ulp at the
# bottom of a binade.  The kernel's float32 scores and ex2 can put a P
# within a few float32 ulps of a rounding boundary on its other side; atol
# covers such a flip where many keys share the row.
DESIGN_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -10)
ATTN_DESIGNS = {
    "flash_attention": "bf16: wgmma for Q.K^T and P.V (P rounded to bf16 in registers), "
                       "k/v by TMA into a 2-stage mbarrier ring fed by a producer warp, "
                       "64-row q tiles x 64-key tiles, softmax with pairwise reductions "
                       "and ex2; f32: CUDA cores (first design)",
    "flash_decode": "split-key: (chunk, kv head, batch) blocks serve all g heads, "
                    "32-key tiles by 16-byte cp.async in a 2-stage ring, f32 partials, "
                    "then a merge kernel",
}


def _profiled_per_call(kernel, library, reps=20):
    """Device time per call by ``torch.profiler`` (L2 warm, ``reps`` calls
    back to back): for the kernel's wrapper and for the library call, the
    summed time of every kernel and copy the call runs, and each by name.
    Beside the CUDA-event times, which hold each call with its launches."""
    out = {}
    for key, fn in (("profiled", kernel), ("library_profiled", library)):
        fn()
        _, prof = _profiled(lambda: [fn() for _ in range(reps)])
        out[key] = dict(ms_per_call=prof["device_s"] * 1e3 / reps, reps=reps,
                        ops_per_call=prof["device_ops"] / reps,
                        kernels=[dict(name=t["name"], ms_per_call=t["ms"] / reps,
                                      count=t["count"]) for t in prof["top"]])
    return out


def _attn_inputs(rng, b, s, sq, nq, nkv, hd, dtype, dev):
    """q [B, sq, nq, hd], k, v [B, s, nkv, hd]: the model's layout."""
    import torch

    mk = lambda shp: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shp).astype(np.float32)).to(dev, getattr(torch, dtype))
    return mk((b, sq, nq, hd)), mk((b, s, nkv, hd)), mk((b, s, nkv, hd))


def _bhsd(*ts):
    return [t.transpose(1, 2) for t in ts]


def phase_attention():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import KEY_TILE_BF16

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    err = {"flash_attention": 0.0, "flash_decode": 0.0}
    design = dict(max_abs_err=0.0, atol_needed=0.0, **DESIGN_TOL)
    by_shape = {}  # K2's errors per (dtype, shape): against the plain version, the oracle
    fails, checked = [], 0
    for dtype in ("float32", "bfloat16"):
        for b, s, nq, nkv, hd in FLASH_SHAPES:
            q, k, v = _attn_inputs(rng, b, s, s, nq, nkv, hd, dtype, cuda)
            got = ops.flash_attention(q, k, v, causal=True)
            want = ref.attention_ref(*_bhsd(q, k, v), causal=True).transpose(1, 2)
            e = float((got.float() - want.float()).abs().max())
            err["flash_attention"] = max(err["flash_attention"], e)
            checked += 1
            case = by_shape[f"{dtype} {(b, s, nq, nkv, hd)}"] = dict(max_abs_err=e)
            if not e <= ATTN_TOL[dtype]:
                fails.append(f"flash_attention {dtype} {(b, s, nq, nkv, hd)}: {e}")
            if dtype == "bfloat16":
                want = ref.attention_ref(*_bhsd(q, k, v), causal=True, p_dtype=torch.bfloat16,
                                         p_block=KEY_TILE_BF16).transpose(1, 2).float()
                diff = (got.float() - want).abs()
                need = float((diff - DESIGN_TOL["rtol"] * want.abs()).max())
                design["max_abs_err"] = max(design["max_abs_err"], float(diff.max()))
                design["atol_needed"] = max(design["atol_needed"], need)
                case.update(design_max_abs_err=float(diff.max()), design_atol_needed=need)
                if not need <= DESIGN_TOL["atol"]:
                    fails.append(f"flash_attention bf16 design {(b, s, nq, nkv, hd)}: "
                                 f"max |d| {float(diff.max())}, atol needed {need}")
        for b, s, nq, nkv, hd, pos in DECODE_SHAPES:
            q, k, v = _attn_inputs(rng, b, s, 1, nq, nkv, hd, dtype, cuda)
            got = ops.flash_decode(q, k, v, pos)
            want = ref.decode_ref(*_bhsd(q, k, v), pos).transpose(1, 2)
            e = float((got.float() - want.float()).abs().max())
            err["flash_decode"] = max(err["flash_decode"], e)
            checked += 1
            if not e <= ATTN_TOL[dtype]:
                fails.append(f"flash_decode {dtype} {(b, s, nq, nkv, hd, pos)}: {e}")
    torch.cuda.synchronize()
    if fails:
        raise AssertionError(f"{len(fails)} of {checked} attention cases differ "
                             f"from the plain version: {fails[:5]}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)  # > 50 MB L2
    timing = {}
    # K2 at the model's prefill shape, bf16.
    b, s, nq, nkv, hd = FLASH_SHAPES[-1]
    q, k, v = _attn_inputs(rng, b, s, s, nq, nkv, hd, "bfloat16", cuda)
    qb, kb, vb = (t.contiguous() for t in _bhsd(q, k, v))
    elt = 2
    nbytes = elt * (2 * b * s * nq * hd + 2 * b * s * nkv * hd)
    flops = 4 * b * nq * hd * s * (s + 1) // 2  # causal: keys <= query
    bound = {"bytes": nbytes / HBM_BYTES_S, "operations": flops / BF16_FLOP_S}
    by = max(bound, key=bound.get)
    timing["flash_attention"] = dict(
        shape=dict(B=b, S=s, nq=nq, nkv=nkv, hd=hd, dtype="bfloat16"),
        ms=_time_ms(lambda: ops.flash_attention(q, k, v, causal=True), flush=flush),
        ms_l2_warm=_time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        plain_ms=_time_ms(lambda: ref.attention_ref(*_bhsd(q, k, v), causal=True), flush=flush),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True, enable_gqa=True), flush=flush),
        library="torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), [B, H, S, hd] inputs",
        bound_ms=bound[by] * 1e3, bound_by=by, bytes=nbytes, flops=flops,
        max_abs_err=err["flash_attention"], design_check=design, by_shape=by_shape,
        **_profiled_per_call(lambda: ops.flash_attention(q, k, v, causal=True),
                             lambda: F.scaled_dot_product_attention(
                                 qb, kb, vb, is_causal=True, enable_gqa=True)))
    # K3 at the model's decode shape, bf16.
    b, s, nq, nkv, hd, pos = DECODE_SHAPES[-1]
    q, k, v = _attn_inputs(rng, b, s, 1, nq, nkv, hd, "bfloat16", cuda)
    qb, kb, vb = (t.contiguous() for t in _bhsd(q, k, v))
    mask = (torch.arange(s, device=cuda) <= pos).view(1, 1, 1, s)
    nbytes = elt * (2 * b * nq * hd + 2 * b * nkv * (pos + 1) * hd)
    flops = 4 * b * nq * (pos + 1) * hd
    bound = {"bytes": nbytes / HBM_BYTES_S, "operations": flops / BF16_FLOP_S}
    by = max(bound, key=bound.get)
    timing["flash_decode"] = dict(
        shape=dict(B=b, S=s, nq=nq, nkv=nkv, hd=hd, pos=pos, dtype="bfloat16"),
        ms=_time_ms(lambda: ops.flash_decode(q, k, v, pos), flush=flush),
        ms_l2_warm=_time_ms(lambda: ops.flash_decode(q, k, v, pos)),
        plain_ms=_time_ms(lambda: ref.decode_ref(*_bhsd(q, k, v), pos), flush=flush),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, enable_gqa=True), flush=flush),
        library="torch.nn.functional.scaled_dot_product_attention(attn_mask=keys <= pos, "
                "enable_gqa=True), [B, H, S, hd] inputs",
        bound_ms=bound[by] * 1e3, bound_by=by, bytes=nbytes, flops=flops,
        max_abs_err=err["flash_decode"],
        **_profiled_per_call(lambda: ops.flash_decode(q, k, v, pos),
                             lambda: F.scaled_dot_product_attention(
                                 qb, kb, vb, attn_mask=mask, enable_gqa=True)))
    log("attention", checked=checked, tolerance=ATTN_TOL, **timing)
    return timing


# -- phase 6 -------------------------------------------------------------------

SERVE = dict(arch="mistral-nemo-12b", replicas=2, slots=4, s_max=1024,
             requests=8, prompt_len=512, max_new=16)
# (a): last-position logits of one 512-token prefill at full depth in bf16,
# on the kernel path and on the plain path, each held against the same
# prefill computed in float32 throughout (the bf16 weights upcast layer by
# layer).  The plain path rounds the scores and the probabilities to bf16,
# as the reference's XLA path does; the kernel keeps the scores in float32
# and rounds only the probabilities that enter P.V.  A
# fault in the kernel shows as an error of the logits' own size; so the
# kernel path must be no farther from the float32 logits than the plain
# path is.


def _prefill_logits(model, params, prompt, s_max, dev):
    import torch

    with torch.no_grad():
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(prompt[None, :], device=dev).long()}, s_max)
    del caches
    return logits[0].float()


def _head_params(cfg, params):
    """The parameters the head reads: ``ln_f`` and ``lm_head``, or the
    embedding for a tied head."""
    return {k: params[k] for k in ("ln_f", "embed" if cfg.tie_embeddings else "lm_head")}


def _f32_forward(cfg, params, tokens, dev):
    """The stack over ``tokens`` ``[B, S]`` in float32 throughout, on the
    plain attention path (the SSM's time loop), with each layer's bf16
    weights upcast as the layer runs (a float32 copy of all the weights
    would not fit beside the bf16 ones) → (the float32 model, its head's
    parameters, the last layer's output).  Any decoder-only stack: dense,
    MoE, SSM, or a hybrid's periods slot by slot."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model

    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32", attn_impl="xla",
                      ssm_impl="xla")
    model = Model(cfg32)
    n_units, slots = tf._units(cfg)
    with torch.no_grad():
        x = params["embed"][torch.as_tensor(tokens, device=dev).long()].float()
        rope = model._rope(torch.arange(x.shape[1], device=dev))
        for ui in range(n_units):
            up = tf._index_tree(params["stack"], ui)
            for key, mixer, ffn in slots:
                lp = _up(up if key is None else up[key])
                x, _, _ = tf._apply_layer_full(lp, x, cfg32, rope, mixer, ffn, False)
                del lp
        return model, _up(_head_params(cfg, params)), x


def _up(tree):
    """A tree's tensors in float32."""
    return {k: _up(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def _prefill_logits_f32(cfg, params, prompt, dev):
    """The prefill's last-position logits in float32 throughout
    (:func:`_f32_forward`) of one prompt, or ``[B, V]`` of a batch."""
    import torch

    model, head, x = _f32_forward(cfg, params, prompt[None, :] if prompt.ndim == 1 else prompt,
                                  dev)
    with torch.no_grad():
        logits = model._head(head, x[:, -1:])[:, 0]
    return logits[0] if prompt.ndim == 1 else logits


def _loss_f32(cfg, params, tokens, dev):
    """The mean next-token cross-entropy of ``tokens`` in float32
    throughout (:func:`_f32_forward`)."""
    import torch

    model, head, x = _f32_forward(cfg, params, tokens, dev)
    with torch.no_grad():
        pred = model._head(head, x)[:, :-1]
        tgt = torch.as_tensor(tokens[:, 1:], device=dev).long()
        nll = torch.logsumexp(pred, -1) - torch.gather(pred, -1, tgt[..., None])[..., 0]
        return float(nll.mean())


def _greedy(model, params, prompt, n, dev, s_max=1024):
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(model, params, 1, s_max, device=dev)
    req = Request(rid=0, prompt=prompt, max_new=n)
    assert eng.admit(req)
    while eng.active:
        eng.tick()
    return list(req.tokens_out)


def phase_serve():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention, ts_plan, ts_plan_device
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.serve import drive, make_requests
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import count_params
    from repro_torch.models.model import Model
    from repro_torch.serving import BassRouter, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    ts_plan.set_backend("cuda")
    cfg = get_config(SERVE["arch"]).with_(attn_impl="pallas", remat=False)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=cuda).manual_seed(SEED), cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(model.defs())
    names = [f"pod0/host{i}" for i in range(SERVE["replicas"])]
    engines = {n: ServeEngine(model, params, SERVE["slots"], SERVE["s_max"], name=n,
                              device=cuda) for n in names}
    router = BassRouter(names)
    reqs = make_requests(cfg, SERVE["requests"], SERVE["prompt_len"], SERVE["max_new"], SEED)
    assert [r.prefix_hash for r in reqs] == [r.rid % 2 for r in reqs]

    # The serving path's run: counts to 0 just before it, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = drive(engines, router, reqs, log=None)
    torch.cuda.synchronize()
    k1, calls = dict(ts_plan_device.stats), dict(ts_plan.calls)
    k2, k3 = flash_attention.stats["launches"], decode_attention.stats["launches"]
    peak = torch.cuda.max_memory_allocated()

    prefills = len(out["prefill_s"])
    tokens = sum(len(r.tokens_out) for r in reqs)
    planner_calls = calls["wave_scan"] + calls["col_scan"] + calls["plan_scan"]
    run = dict(
        config=SERVE, params=n_params, init_s=init_s, seconds=out["seconds"],
        tokens=tokens, tokens_s=tokens / out["seconds"], prefills=prefills,
        prefill_p50_ms=float(np.percentile(out["prefill_s"], 50)) * 1e3,
        decode_ticks=len(out["tick_s"]),
        decode_tick_p50_ms=float(np.percentile(out["tick_s"], 50)) * 1e3,
        max_memory_allocated=peak, k2_launches=k2, k3_launches=k3,
        k1_launches=k1["launches"], planner_calls=calls,
        router=dict(router.stats))
    if not (all(r.done and len(r.tokens_out) == SERVE["max_new"] for r in reqs)
            and prefills == SERVE["requests"]):
        raise AssertionError(f"serve run incomplete: {run}")
    if k2 != cfg.n_layers * prefills:
        raise AssertionError(f"K2 launched {k2} times for {prefills} prefills of "
                             f"{cfg.n_layers} layers")
    if k1["launches"] != planner_calls:
        raise AssertionError(f"K1 launched {k1['launches']} times for "
                             f"{planner_calls} planning scans")

    # One more prefill of the served shape, counted (phase 11 holds the
    # count against meta and sets it beside the prefill p50).
    prompt = reqs[0].prompt
    _count_step("serve_prefill", make_prefill_step(model, SERVE["s_max"]),
                (params, {"tokens": torch.as_tensor(prompt[None, :], device=cuda).long()}),
                cfg, ShapeSpec("serve_prefill", "prefill", SERVE["prompt_len"], 1),
                run["prefill_p50_ms"] * 1e-3, kernel_regions={"flash_attention": cfg.n_layers})

    # (a) full depth, bf16: kernel path and plain path against float32.
    lp = _prefill_logits(model, params, prompt, SERVE["s_max"], cuda)
    lx = _prefill_logits(Model(cfg.with_(attn_impl="xla")), params, prompt,
                         SERVE["s_max"], cuda)
    l32 = _prefill_logits_f32(cfg, params, prompt, cuda)
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    check_a = dict(kernel_vs_f32=err(lp, l32), plain_vs_f32=err(lx, l32),
                   kernel_vs_plain=err(lp, lx), max_abs_logit=float(l32.abs().max()),
                   finite=bool(torch.isfinite(lp).all()),
                   argmax_equal=int(lp.argmax()) == int(lx.argmax()) == int(l32.argmax()))
    del params, engines, router
    gc.collect()
    torch.cuda.empty_cache()
    if not (check_a["finite"] and check_a["kernel_vs_f32"] <= check_a["plain_vs_f32"]):
        raise AssertionError(f"(a) the kernel path is farther from float32 than the "
                             f"plain path: {check_a}")

    # (b) full width, 4 layers, f32: 16 greedy tokens identical.
    cfg4 = cfg.with_(n_layers=4, param_dtype="float32", compute_dtype="float32")
    params4 = Model(cfg4).init(torch.Generator(device=cuda).manual_seed(SEED), cuda)
    k2_before = flash_attention.stats["launches"]
    tok_p = _greedy(Model(cfg4), params4, prompt, SERVE["max_new"], cuda)
    tok_x = _greedy(Model(cfg4.with_(attn_impl="xla")), params4, prompt, SERVE["max_new"], cuda)
    check_b = dict(tokens_pallas=tok_p, tokens_xla=tok_x, identical=tok_p == tok_x,
                   k2_launches=flash_attention.stats["launches"] - k2_before)
    del params4
    gc.collect()
    torch.cuda.empty_cache()
    log("serve", run=run, check_a=check_a, check_b=check_b)
    if not (check_b["identical"] and len(tok_p) == SERVE["max_new"]
            and check_b["k2_launches"] == cfg4.n_layers):
        raise AssertionError(f"(b) greedy tokens differ: {check_b}")
    return run


# -- phase 7 -------------------------------------------------------------------

SCAN_TOL = 2e-4  # tests/test_kernels.py's atol for the scan, float32
# (B, S, d_in, N): tests/test_kernels.py's MAMBA_CASES, then the model's
# shape — falcon-mamba-7b's scan over a batch of 2 × 1 024 tokens.
MAMBA_SHAPES = [(2, 256, 128, 8), (1, 512, 256, 16), (2, 128, 512, 4),
                (2, 1024, 8192, 16)]
TRAIN = dict(arch="falcon-mamba-7b", n_layers=8, batch=2, seq=1024, steps=3,
             peak_lr=1e-3, warmup=1)
# (b): the K4 path and the time-loop path compute the same float32 scan
# and differ only in its rounding.  In float32 throughout that is all the
# losses see: 1e-5 is ten float32 ulps of a loss of about 12.  In bf16 the
# scan's rounding (about 1e-7 of y) flips bf16 roundings of the gated
# output, and through 16 layers the flips moved the loss by 3.4e-4 in the
# first run of this check on an H100, against a bound of 1e-4 that a CPU
# proxy had suggested; so the bf16 bound is 1e-3 (1e-4 of the loss), and
# the float32 leg and the layer-0 scan on the path's own inputs are the
# close checks of the kernel.
EVAL_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _scan_inputs(rng, b, s, d_in, n, dev):
    """x normal, dt = softplus(normal), a = -exp(0.5 normal), B and C
    normal: the reference's test inputs, made with numpy."""
    import torch

    mk = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)  # noqa: E731
    return (mk(rng.standard_normal((b, s, d_in))),
            mk(np.log1p(np.exp(rng.standard_normal((b, s, d_in))))),
            mk(-np.exp(0.5 * rng.standard_normal((d_in, n)))),
            mk(rng.standard_normal((b, s, n))), mk(rng.standard_normal((b, s, n))))


def _phase_scan(cuda):
    """(a): K4 against its plain version; its time at the model's shape."""
    import torch

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    err, fails = 0.0, []
    for case in MAMBA_SHAPES:
        inputs = _scan_inputs(rng, *case, cuda)
        e = float((ops.mamba_scan(*inputs) - ref.mamba_scan_ref(*inputs)).abs().max())
        err = max(err, e)
        if not e <= SCAN_TOL:
            fails.append(f"{case}: {e}")
    torch.cuda.synchronize()
    if fails:
        raise AssertionError(f"K4 differs from its plain version: {fails}")
    return dict(checked=len(MAMBA_SHAPES), tolerance=SCAN_TOL, max_abs_err=err,
                **_k4_timing(cuda, rng))


def _k4_timing(cuda, rng):
    """K4 at the model's shape beside its plain version and its bound."""
    import torch

    from repro_torch.kernels import ops, ref

    b, s, d_in, n = MAMBA_SHAPES[-1]
    inputs = _scan_inputs(rng, b, s, d_in, n, cuda)
    probe = _ex2_probe(cuda)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)  # > 50 MB L2
    return dict(
        shape=dict(B=b, S=s, d_in=d_in, N=n, dtype="float32"),
        ms=_time_ms(lambda: ops.mamba_scan(*inputs), flush=flush),
        ms_l2_warm=_time_ms(lambda: ops.mamba_scan(*inputs)),
        plain_ms=_time_ms(lambda: ref.mamba_scan_ref(*inputs), flush=flush),
        library_ms=None, **_k4_bound(b, s, d_in, n), **probe)


def _k4_bound(b, s, d_in, n):
    """K4's bound at ``[b, s, d_in]`` × ``[d_in, n]``: its inputs read and
    y written once at the HBM rate, or its float32 operations and its
    exponentials at the special-function units' rate, the larger."""
    nbytes = 4 * (3 * b * s * d_in + d_in * n + 2 * b * s * n)
    n_exp = b * s * d_in * n
    flops = b * s * d_in * (1 + 6 * n)  # Δx; per state Δ·A, ⊙h, ·B, +, ·C, Σ
    bound = {"bytes": nbytes / HBM_BYTES_S,
             "operations": max(flops / F32_FLOP_S, n_exp / SFU_EXP_S)}
    by = max(bound, key=bound.get)
    return dict(bound_ms=bound[by] * 1e3, bound_by=by, bytes=nbytes, flops=flops, exps=n_exp,
                flops_ms=flops / F32_FLOP_S * 1e3, exps_ms=n_exp / SFU_EXP_S * 1e3)


def _ex2_probe(cuda):
    """The special-function units' ex2 rate, by ``csrc/mamba_scan.cu``'s
    probe (independent chains on every SM), beside the peak the bound
    assumes.  Empty where the library has none."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    lib = _build.library("mamba_scan")
    if not hasattr(lib, "mamba_scan_probe_ex2"):
        return {}
    fn = lib.mamba_scan_probe_ex2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, device=cuda)
    blocks, iters = 4 * torch.cuda.get_device_properties(cuda).multi_processor_count, 2000
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def run():
        if fn(out.data_ptr(), blocks, iters, stream) != 0:
            raise RuntimeError("ex2 probe launch failed")

    ms = _time_ms(run, reps=10)
    rate = blocks * 256 * iters * 16 / (ms * 1e-3)
    return dict(ex2_per_s=rate, ex2_per_s_peak=SFU_EXP_S, ex2_probe_ms=ms)


def phase_train():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import decode_attention, flash_attention, mamba_scan
    from repro_torch.launch.steps import make_eval_step, make_train_step
    from repro_torch.models import count_params
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten
    from repro_torch.optim import AdamW, warmup_cosine

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    scan = _phase_scan(cuda)

    cfg = get_config(TRAIN["arch"]).with_(n_layers=TRAIN["n_layers"], ssm_impl="pallas",
                                          remat=True)
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(SEED), cuda)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, size=(TRAIN["batch"], TRAIN["seq"]))
    batch = {"tokens": torch.as_tensor(toks, device=cuda)}
    n_tokens = toks.size

    # (b) The eval path's run: counts to 0 just before it, read just after.
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out_k = make_eval_step(Model(cfg))(params, batch)
    loss_k = float(out_k["loss"])
    eval_k_s = time.perf_counter() - t0
    launches = {"mamba_scan": mamba_scan.stats["launches"],
                "flash_attention": flash_attention.stats["launches"],
                "flash_decode": decode_attention.stats["launches"]}
    t0 = time.perf_counter()
    loss_x = float(make_eval_step(Model(cfg.with_(ssm_impl="xla")))(params, batch)["loss"])
    eval_x_s = time.perf_counter() - t0
    check_b = dict(bfloat16=dict(loss_kernel=loss_k, loss_plain=loss_x,
                                 abs_diff=abs(loss_k - loss_x)),
                   tolerance=EVAL_TOL, seconds_kernel=eval_k_s, seconds_plain=eval_x_s,
                   launches=launches, layer0_scan=_layer0_scan(cfg, params, batch))
    _, check_b["profile_kernel"] = _profiled(lambda: make_eval_step(Model(cfg))(params, batch))
    _count_step("eval_k4", make_eval_step(Model(cfg)), (params, batch), cfg,
                ShapeSpec("eval_k4", "prefill", TRAIN["seq"], TRAIN["batch"]),
                check_b["profile_kernel"]["wall_s"], kernel_regions={"mamba_scan": cfg.n_layers})
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    params32 = Model(cfg32).init(torch.Generator(device=cuda).manual_seed(SEED), cuda)
    l32 = {impl: float(make_eval_step(Model(cfg32.with_(ssm_impl=impl)))(params32, batch)["loss"])
           for impl in ("pallas", "xla")}
    del params32
    check_b["float32"] = dict(loss_kernel=l32["pallas"], loss_plain=l32["xla"],
                              abs_diff=abs(l32["pallas"] - l32["xla"]))
    if not all(np.isfinite(check_b[dt]["loss_kernel"])
               and check_b[dt]["abs_diff"] <= EVAL_TOL[dt] for dt in EVAL_TOL):
        raise AssertionError(f"(b) the eval losses differ: {check_b}")
    if not check_b["layer0_scan"]["max_abs_err"] <= SCAN_TOL:
        raise AssertionError(f"(b) K4 differs on the path's inputs: {check_b}")
    if launches["mamba_scan"] != cfg.n_layers:
        raise AssertionError(f"(b) K4 launched {launches['mamba_scan']} times for "
                             f"{cfg.n_layers} layers")

    # (c) Three train steps on the plain scan, with remat.
    opt = AdamW(lr=warmup_cosine(TRAIN["peak_lr"], TRAIN["warmup"], TRAIN["steps"]))
    step = make_train_step(Model(cfg.with_(ssm_impl="xla")), opt)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, losses, norms, step_s = params, [], [], []
    for _ in range(TRAIN["steps"]):
        t0 = time.perf_counter()
        p, state, metrics = step(p, state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    (p, state, _), profile = _profiled(lambda: step(p, state, batch))
    moved = {"/".join(path): float((new != old).float().mean())
             for (path, new), (_, old) in zip(flatten(p), flatten(params))}
    sizes = {"/".join(path): t.numel() for path, t in flatten(params)}
    moved_all = sum(moved[k] * sizes[k] for k in moved) / sum(sizes.values())
    run = dict(config=TRAIN, cut="n_layers 64 -> 8 (one H100 holds the bf16 "
               "parameters, gradients and float32 moments of 16 layers, not of 64; "
               "8 for the script's time)",
               params=count_params(Model(cfg).defs()), init_s=init_s, losses=losses,
               grad_norms=norms, step_s=step_s, step_p50_s=float(np.median(step_s)),
               tokens_s=n_tokens / float(np.median(step_s)), max_memory_allocated=peak,
               moved_fraction=moved_all, moved_fraction_by_leaf=moved,
               profile_step4=profile)
    # Some leaves move by less than half a bf16 ulp in three steps: those
    # initialised to ones or to A's logs, and w_dt and dt_proj, whose
    # gradients at this random initialisation are far below AdamW's eps
    # (about 1e-14 at the smoke width).  The projections and the embedding,
    # most of the parameters, must move.
    del p, state, params
    gc.collect()
    torch.cuda.empty_cache()
    if not (all(np.isfinite(v) and v > 0 for v in losses + norms) and moved_all >= 0.9):
        raise AssertionError(f"(c) train run failed: {run}")

    # (d) A train step through K4 raises, as in the reference.
    cfg2 = cfg.with_(n_layers=2)
    params2 = Model(cfg2).init(torch.Generator(device=cuda).manual_seed(SEED), cuda)
    opt2 = AdamW()
    try:
        make_train_step(Model(cfg2), opt2)(params2, opt2.init(params2), batch)
        check_d = dict(raised=None)
    except NotImplementedError as exc:
        check_d = dict(raised="NotImplementedError", message=str(exc))
    del params2
    gc.collect()
    torch.cuda.empty_cache()
    log("train", scan=scan, check_b=check_b, run=run, check_d=check_d)
    if check_d["raised"] is None:
        raise AssertionError("(d) a train step through K4 did not raise")
    return dict(scan=scan, launches=launches["mamba_scan"], run=run)


def _profiled(fn):
    """``fn()`` under ``torch.profiler``, tracing the device only → (its
    result, the wall time, the summed device time and count of the CUDA
    kernels and copies it ran, the idle share 1 − device/wall, the six
    largest by device time, and the seconds the trace took to read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) * 1e-6
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return out, dict(wall_s=wall, device_s=busy, idle_share=1.0 - busy / wall,
                     device_ops=sum(e.count for e in dev),
                     top=[dict(name=e.key[:90], count=e.count,
                               ms=e.self_device_time_total * 1e-3) for e in top],
                     read_s=time.perf_counter() - t0)


def _layer0_scan(cfg, params, batch):
    """K4 against the plain time loop on the scan inputs that the eval
    path gives the first layer."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm

    with torch.no_grad():
        lp = {k: v[0] for k, v in params["stack"]["mamba"].items()}
        x = rms_norm(params["embed"][batch["tokens"]], params["stack"]["ln1"][0], cfg.norm_eps)
        xp = ssm._causal_depthwise_conv(x @ lp["w_in_x"], lp["conv_w"], lp["conv_b"])
        xc, dt, b_mat, c_mat = ssm._ssm_inputs(lp, xp, cfg)
        a = -torch.exp(lp["a_log"].float())
        y = ops.mamba_scan(xc.float(), dt, a, b_mat, c_mat)
        h0 = a.new_zeros((xc.shape[0],) + tuple(a.shape))
        want, _ = ssm._scan_time(xc.float(), dt, a, b_mat, c_mat, h0)
    return dict(max_abs_err=float((y - want).abs().max()), max_abs_y=float(want.abs().max()),
                rms_y=float(want.square().mean().sqrt()),
                rms_skip=float(xc.float().square().mean().sqrt()))


# -- phase 8 -------------------------------------------------------------------

# bench_hierarchy.py's full-mode FLEET_LEG: 64 pods × 256 hosts, 128 jobs of
# 256 tasks arriving every 0.05 s, 0.1 s slots, seed 0.
HIER_FLEET = dict(n_pods=64, hosts_per_pod=256, jobs=128, tasks_per_job=256,
                  dt=0.05, slot=0.1, seed=0)
LEG_LIMIT_S = 60.0  # a longer hierarchy leg cuts its job count
# bench_recovery.py's and bench_faults.py's acceptance configurations (k 8:
# 128 hosts), on bench_faults.py's storm (``dump_schedules.fault_storm_setup``):
# FaultPlan seed 7 over [0.5, 3.0), crashed hosts back after 2 s, stragglers
# 4–8× slower, retries (4 attempts, 0.5 s backoff).
RECOVERY = dict(k=8, tasks=128, crashes=6, stragglers=16, crash_at=1.2, outage=1.0,
                batches=8, estimator="window")
# The storm at 500 tasks (3 000 before, for the script's time, PERF.md §4):
# the same faults (6 hosts down and back, every killed task retried).
STORM = dict(k=8, tasks=500, crashes=6, stragglers=16)
# bench_faults.py's acceptance config, (8, 128, 6, 16): its LATE gate fires
# (spec_launch > 0), which the 500-task storm's never did.
STORM_ACCEPTANCE = dict(k=8, tasks=128, crashes=6, stragglers=16)
BACKENDS = ("cuda", "numpy")  # each leg on the card, then the reference
_CANON_EXCLUDE = ("wavefront.", "recovery.")


def _hier_jobs(hosts, n_jobs, tasks_per_job, dt, seed=0):
    """bench_hierarchy.py's open-loop arrival stream: job ``j`` arrives at
    ``j*dt`` with its 3 replicas in one rotating pod, 64–256 MB shards."""
    import random

    from repro_torch.core import Task

    rng = random.Random(seed)
    by_pod = {}
    for h in hosts:
        by_pod.setdefault(h.split("/", 1)[0], []).append(h)
    pods = sorted(by_pod)
    jobs, tid = [], 0
    for j in range(n_jobs):
        pool = by_pod[pods[j % len(pods)]]
        jobs.append(([Task(tid + i, size=float(rng.uniform(64e6, 256e6)), compute=0.05,
                           replicas=tuple(rng.sample(pool, min(3, len(pool)))))
                      for i in range(tasks_per_job)], j * dt))
        tid += tasks_per_job
    return jobs


def _fault_plan(workers, n_crashes, n_stragglers):
    from repro_torch.core.faults import FaultPlan
    from repro_torch.tools import dump_schedules as d

    return FaultPlan.generate(d.SEED, workers, d.T0, d.T1, n_crashes=n_crashes, mttr=d.MTTR,
                              n_stragglers=n_stragglers, slow_factor=d.SLOW)


def _fault_controller(fab, workers, speculation=False):
    from repro_torch.core.controller import BassPolicy, ClusterController, RetryPolicy

    return ClusterController(fab, workers, BassPolicy(multipath=True), slot_duration=0.1,
                             retry=RetryPolicy(max_attempts=4, backoff_s=0.5),
                             speculation=speculation)


def _ctrl_canon(c):
    """The recovery suite's equivalence image of a flat controller:
    schedule (floats as hex), reroute log, behavioural counters, ledger
    bytes, origin and retired columns."""
    from repro_torch.convert import canon

    counters = {k: v for k, v in sorted(c.obs.snapshot(trace_tail=0)["counters"].items())
                if not k.startswith(_CANON_EXCLUDE)}
    led = c.state.ledger
    reroutes = [(r.flow, r.old_path, r.new_path, float(r.delivered).hex(),
                 float(r.remaining).hex(), float(r.new_end).hex()) for r in c.reroute_log]
    return (canon(c.schedule().assignments), reroutes, counters,
            led.reserved.tobytes(), led.base_slot, led.retired_slots)


def _hier_canon(h):
    from repro_torch.convert import canon

    return (canon(h.schedule().assignments),
            tuple((n, sh.reserved.tobytes(), sh.base_slot, sh.retired_slots)
                  for n, sh in sorted(h.ledger.shards.items())))


def _hier_leg(backend, mode, n_jobs=None):
    """One hierarchy-fleet leg: ``mode`` ``affine`` (the pod-affine
    ``HierarchicalController``) or ``flat`` (``ClusterController``).  With
    ``n_jobs`` None the leg stops submitting once it has run LEG_LIMIT_S
    and reports the jobs it ran (the cut); otherwise it runs ``n_jobs``."""
    import torch

    from repro_torch.core import ClusterController, storage_hosts, tpu_dcn_fabric
    from repro_torch.core.hierarchy import HierarchicalController
    from repro_torch.kernels import ts_plan

    cfg = HIER_FLEET
    fab = tpu_dcn_fabric(n_pods=cfg["n_pods"], hosts_per_pod=cfg["hosts_per_pod"])
    hosts = storage_hosts(fab)
    jobs = _hier_jobs(hosts, cfg["jobs"], cfg["tasks_per_job"], cfg["dt"], cfg["seed"])
    ts_plan.set_backend(backend)
    torch.cuda.reset_peak_memory_stats()
    # The path's run: counts to 0 just before it, read just after.
    _reset_counts()
    if mode == "affine":
        ctl = HierarchicalController(fab, hosts, affinity=True, slot_duration=cfg["slot"])
    else:
        ctl = ClusterController(fab, hosts, "bass", slot_duration=cfg["slot"])
    lat_ms, ran = [], 0
    t0 = time.perf_counter()
    for tasks, at in jobs[:n_jobs]:
        c0 = time.perf_counter()
        ctl.submit(tasks, at=at)
        ctl.run_until(at)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - c0) * 1e3)
        ran += 1
        if n_jobs is None and time.perf_counter() - t0 > LEG_LIMIT_S:
            break
    dt = time.perf_counter() - t0
    stats, calls = _counts()
    n_tasks = ran * cfg["tasks_per_job"]
    if sum(len(r.assignments) for r in ctl.jobs.values()) != n_tasks:
        raise AssertionError(f"{mode} {backend}: not every task was placed")
    leg = dict(backend=backend, mode=mode, hosts=len(hosts), jobs=ran, tasks=n_tasks,
               seconds=dt, tasks_s=n_tasks / dt,
               job_p50_ms=float(np.percentile(lat_ms, 50)),
               job_p99_ms=float(np.percentile(lat_ms, 99)),
               k1_launches=stats.get("launches", 0), mirror_syncs=stats.get("mirror_syncs", 0),
               waves=calls["wave_scan"], calls=calls,
               max_memory_allocated=(torch.cuda.max_memory_allocated()
                                     if backend == "cuda" else None))
    if mode == "affine":
        leg["mirrors"] = sum(pc.shard._mirror is not None for pc in ctl.pods.values())
        leg["pods"] = len(ctl.pods)
        leg["hier"] = dict(ctl._stats)
    return ctl, leg


def _phase8_hierarchy():
    """(a) The hierarchy fleet on each backend, then the flat controller on
    the first over the same arrivals; the affine legs byte-identical."""
    first, rest = BACKENDS[0], BACKENDS[1:]
    ctl, lead = _hier_leg(first, "affine")
    n_jobs = lead["jobs"]
    want = _hier_canon(ctl)
    del ctl
    gc.collect()
    legs, identical = [lead], True
    for backend in rest:
        ctl, leg = _hier_leg(backend, "affine", n_jobs)
        identical = identical and _hier_canon(ctl) == want
        legs.append(leg)
        del ctl
        gc.collect()
    ctl, flat = _hier_leg(first, "flat", n_jobs)
    del ctl
    gc.collect()
    cut = None if n_jobs == HIER_FLEET["jobs"] else dict(
        jobs=n_jobs, of=HIER_FLEET["jobs"], reason=f"the {first} leg passed {LEG_LIMIT_S} s")
    return dict(legs=legs, flat=flat, identical=identical, cut=cut)


def _recovery_twin(backend):
    """(b1) The journaled storm with a mid-storm controller kill: the
    never-crashed controller and its twin rebuilt from snapshot bytes plus
    the journal replay."""
    from repro_torch.core.controller import ClusterController
    from repro_torch.core.journal import ControllerSnapshot, Journal
    from repro_torch.kernels import ts_plan
    from repro_torch.tools.dump_schedules import T1, fault_storm_setup

    cfg = RECOVERY
    ts_plan.set_backend(backend)
    fab, workers, tasks = fault_storm_setup(cfg["k"], cfg["tasks"])
    base = _fault_controller(fab, workers)
    base.attach_journal()
    base.attach_telemetry(estimator=cfg["estimator"])
    _fault_plan(workers, cfg["crashes"], cfg["stragglers"]).apply(base)
    base.fail_controller(at=cfg["crash_at"])
    base.recover_controller(at=cfg["crash_at"] + cfg["outage"])
    per = max(1, len(tasks) // cfg["batches"])
    batches = [tasks[i:i + per] for i in range(0, len(tasks), per)]
    snap = None
    for i, batch in enumerate(batches):
        at = i * (T1 / len(batches))
        base.submit(batch, at=at)
        base.run_until(at)
        if i == len(batches) // 2:
            snap = base.snapshot().to_bytes()  # mid-storm checkpoint
    base.run()
    twin = ClusterController.recover_from(fab, ControllerSnapshot.from_bytes(snap),
                                          Journal.from_bytes(base.journal.to_bytes()))
    out = dict(base=_ctrl_canon(base), twin=_ctrl_canon(twin))
    out["stats"] = dict(faults=dict(base.fault_stats), ha=dict(base.ha_stats),
                        makespan=max(r.makespan for r in base.jobs.values() if r.placed))
    return out


def _restore_across_retire(backend):
    """(b2) A wave, a snapshot, a retire past the wave's transfers with the
    mirror live, a wave, the restore, and the next wave."""
    from repro_torch.convert import canon
    from repro_torch.core.controller import BassPolicy, ClusterState
    from repro_torch.kernels import ts_plan
    from repro_torch.tools.dump_schedules import fault_storm_setup

    ts_plan.set_backend(backend)
    fab, workers, tasks = fault_storm_setup(RECOVERY["k"], RECOVERY["tasks"])
    state = ClusterState(fab, workers, slot_duration=0.1, horizon_slots=64)
    pol = BassPolicy(multipath=True)
    third = len(tasks) // 3
    first = pol.place_batch(tasks[:third], state)
    snap = state.snapshot()
    led = state.ledger
    cut = led.slot_of(max(a.transfer.end for a in first if a.transfer is not None)) + 8
    state.advance(cut * led.slot_duration)
    led.retire_to(cut)
    retired = led.retired_slots
    second = pol.place_batch(tasks[third:2 * third], state)
    state.restore(snap)
    last = pol.place_batch(tasks[2 * third:], state)
    if retired <= 0 or (led.base_slot, led.retired_slots) != (0, 0):
        raise AssertionError("the restore did not cross a retire")
    return (canon(first), canon(second), canon(last), led.reserved.tobytes())


def _hier_recovery_twin(backend):
    """(b3) The pod-affine hierarchical controller's sharded journal,
    snapshot and ``recover_from`` twin on the k 8 fat-tree."""
    import random

    from repro_torch.core import Task, storage_hosts
    from repro_torch.core.hierarchy import HierarchicalController
    from repro_torch.core.journal import ControllerSnapshot, ShardedJournal
    from repro_torch.kernels import ts_plan
    from repro_torch.net import fat_tree_fabric

    ts_plan.set_backend(backend)
    fab = fat_tree_fabric(RECOVERY["k"])
    hosts = storage_hosts(fab)
    rng = random.Random(61)
    jobs = [([Task(j * 100 + i, size=rng.uniform(40, 400), compute=rng.uniform(1, 20),
                   replicas=tuple(rng.sample(hosts, 3))) for i in range(rng.randint(4, 40))],
             j * 2.0) for j in range(16)]
    h1 = HierarchicalController(fab, hosts, affinity=True, rebalance_interval=3.0)
    jrn = h1.attach_journal()
    for tasks, at in jobs[:8]:
        h1.submit(tasks, at=at)
    h1.run_until(9.0)
    snap = h1.snapshot().to_bytes()
    for tasks, at in jobs[8:]:
        h1.submit(tasks, at=at)
    h1.run()
    h2 = HierarchicalController.recover_from(fab, ControllerSnapshot.from_bytes(snap),
                                             ShardedJournal.from_bytes(jrn.to_bytes()))
    return dict(base=_hier_canon(h1), twin=_hier_canon(h2), stats=dict(h1._stats))


def _phase8_recovery():
    """(b) Each check on every backend; the counts of each backend's run of
    all three."""
    runs = {}
    for backend in BACKENDS:
        _reset_counts()
        t0 = time.perf_counter()
        runs[backend] = dict(twin=_recovery_twin(backend),
                             restore=_restore_across_retire(backend),
                             hier=_hier_recovery_twin(backend))
        stats, calls = _counts()
        runs[backend]["seconds"] = time.perf_counter() - t0
        runs[backend]["k1_launches"] = stats.get("launches", 0)
        runs[backend]["mirror_syncs"] = stats.get("mirror_syncs", 0)
        runs[backend]["calls"] = calls
    ref = runs[BACKENDS[-1]]
    checks = dict(
        twin_equals_uncrashed=all(r["twin"]["base"] == r["twin"]["twin"]
                                  for r in runs.values()),
        twin_across_backends=all(r["twin"]["base"] == ref["twin"]["base"]
                                 for r in runs.values()),
        restore_across_backends=all(r["restore"] == ref["restore"] for r in runs.values()),
        hier_twin_equals=all(r["hier"]["base"] == r["hier"]["twin"] for r in runs.values()),
        hier_across_backends=all(r["hier"]["base"] == ref["hier"]["base"]
                                 for r in runs.values()),
    )
    out = {b: dict(seconds=r["seconds"], k1_launches=r["k1_launches"],
                   mirror_syncs=r["mirror_syncs"], calls=r["calls"],
                   storm=r["twin"]["stats"], hier=r["hier"]["stats"])
           for b, r in runs.items()}
    return dict(runs=out, checks=checks)


def _storm_leg(backend, engine, cfg=STORM):
    """(c) bench_faults.py's storm: host kills, stragglers, retries and
    LATE speculation, under one reroute engine."""
    import torch

    from repro_torch.kernels import ts_plan
    from repro_torch.tools.dump_schedules import fault_storm_setup

    ts_plan.set_backend(backend)
    fab, workers, tasks = fault_storm_setup(cfg["k"], cfg["tasks"])
    _reset_counts()
    t0 = time.perf_counter()
    ctrl = _fault_controller(fab, workers, speculation=True)
    ctrl.reroute_engine = engine
    ctrl.submit(tasks, at=0.0)
    ctrl.run_until(0.0)
    _fault_plan(workers, cfg["crashes"], cfg["stragglers"]).apply(ctrl)
    ctrl.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats, calls = _counts()
    placed = sorted(a.tid for a in ctrl.jobs[0].assignments)
    if placed != list(range(cfg["tasks"])):
        raise AssertionError(f"the storm lost {cfg['tasks'] - len(placed)} tasks")
    return ctrl, dict(backend=backend, engine=engine, seconds=dt,
                      k1_launches=stats.get("launches", 0),
                      mirror_syncs=stats.get("mirror_syncs", 0), calls=calls,
                      faults=dict(ctrl.fault_stats), rerouted=len(ctrl.reroute_log),
                      makespan=ctrl.jobs[0].makespan)


def _phase8_storm():
    """Both engines on the first backend, the batched one on the others:
    every leg's schedule, reroute log, fault counters and ledger equal the
    last leg's, and legs of one engine equal in every counter too (the
    engines count their own work differently)."""
    legs, canons = [], []
    for backend in BACKENDS:
        for engine in (("batched", "sequential") if backend == BACKENDS[0] else ("batched",)):
            ctrl, leg = _storm_leg(backend, engine)
            canons.append((engine, _ctrl_canon(ctrl),
                           sorted((k, float(v).hex()) for k, v in ctrl.fault_stats.items())))
            legs.append(leg)
            del ctrl
            gc.collect()
    last_engine, last, last_faults = canons[-1]
    invariant = lambda c: c[:2] + c[3:]  # noqa: E731  (all but the counters)
    identical = all(invariant(c) == invariant(last) and f == last_faults
                    and (e != last_engine or c == last) for e, c, f in canons)
    return dict(legs=legs, identical=identical, acceptance=_storm_acceptance())


def _storm_acceptance():
    """bench_faults.py's acceptance storm (``STORM_ACCEPTANCE``), the
    batched engine on each backend: schedules, reroute logs, counters and
    fault counters byte-identical, and LATE backups launched on both."""
    legs, canons = [], []
    for backend in BACKENDS:
        ctrl, leg = _storm_leg(backend, "batched", STORM_ACCEPTANCE)
        canons.append((_ctrl_canon(ctrl),
                       sorted((k, float(v).hex()) for k, v in ctrl.fault_stats.items())))
        legs.append(leg)
        del ctrl
        gc.collect()
    spec = [leg["faults"]["spec_launch"] for leg in legs]
    return dict(config=STORM_ACCEPTANCE, legs=legs, spec_launch=spec,
                identical=all(c == canons[-1] for c in canons),
                seconds=sum(leg["seconds"] for leg in legs))


def phase_scheduler():
    """Phase 8: the rest of the scheduler, each leg on ``cuda`` and then on
    ``numpy`` in one process, byte-identical."""
    t0 = time.perf_counter()
    hier = _phase8_hierarchy()
    rec = _phase8_recovery()
    storm = _phase8_storm()
    first = BACKENDS[0]
    acceptance = storm["acceptance"]
    launches = dict(
        hierarchy=hier["legs"][0]["k1_launches"],
        recovery=rec["runs"][first]["k1_launches"],
        fault_storm=sum(leg["k1_launches"] for leg in storm["legs"]
                        if leg["backend"] == first),
        fault_storm_acceptance=acceptance["legs"][0]["k1_launches"],
    )
    log("scheduler", hierarchy=hier, recovery=rec, storm=storm, k1_launches=launches,
        seconds=time.perf_counter() - t0)
    bad = [k for k, ok in [("hierarchy", hier["identical"]), ("storm", storm["identical"]),
                           ("storm_acceptance", acceptance["identical"])]
           + list(rec["checks"].items()) if not ok]
    if bad:
        raise AssertionError(f"phase 8: not byte-identical across backends: {bad}")
    if not all(n > 0 for n in acceptance["spec_launch"]):
        raise AssertionError(f"phase 8: the acceptance storm launched no LATE backup: "
                             f"{acceptance['spec_launch']}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"phase 8: K1 was not launched on every path: {launches}")
    return dict(launches=launches, hierarchy=hier, storm=storm)


# -- phase 9 -------------------------------------------------------------------

# The MoE, hybrid and encoder-decoder families, each served the way phase 6
# serves mistral-nemo-12b (2 replicas × 4 slots behind ``BassRouter``, 8
# requests, 16 new tokens each).  moonshot-v1-16b-a3b at full width and
# depth (56.1 GB of bf16 parameters); jamba-v0.1-52b at full width, cut to
# 16 of its 32 layers (two periods: 52.1 GB; all 32 take 103.1 GB), its
# float32 checks on one period (8 layers, 50 GB); whisper-base whole, with
# zero audio frames (the engine's stub) and prompts of 128 tokens (K2 takes
# S a multiple of its 128-row block; whisper's decoder holds 448).
MODELS = {
    "moe": dict(arch="moonshot-v1-16b-a3b", n_layers=48, f32_layers=4, replicas=2, slots=4,
                s_max=1024, requests=8, prompt_len=512, max_new=16),
    "hybrid": dict(arch="jamba-v0.1-52b", n_layers=16, f32_layers=8, replicas=2, slots=4,
                   s_max=1024, requests=8, prompt_len=512, max_new=16, eval_batch=2,
                   eval_seq=1024),
    "encdec": dict(arch="whisper-base", replicas=2, slots=4, s_max=448,
                   requests=8, prompt_len=128, max_new=16),
}
# One MoE layer in float32 on the card against its CPU copy, and the
# kernel path's float32 logits against the plain path's (4 layers): sums
# of 2 048 and 1 408 float32 terms in another order, so a few float32
# ulps of values under 1 in size.  The bf16 full-depth logits are reported
# against float32, not gated: routing is discontinuous, and a bf16
# difference between K2 and the plain path's rounding can flip an expert
# choice and move a logit by its own size.
MOE_TOL = 1e-4


def _drop_rate(calls, n_tokens, n_layers):
    """Dropped share of the (token, choice) entries of the MoE calls
    recorded by ``moe.recording()`` over ``n_tokens`` tokens (the
    prefills): over all of them, and by layer (the calls come ``n_layers``
    to a prefill, in layer order)."""
    keeps = [c["keep"] for c in calls if c["gate_idx"].shape[0] == n_tokens]
    drops = [float((~k).sum()) / k.numel() for k in keeps]
    by_layer = [float(np.mean(drops[li::n_layers])) for li in range(n_layers)]
    return float(np.mean(drops)), by_layer


def _routing_diff(a, b):
    """(share of expert ids that differ, share of (token, layer) pairs whose
    chosen set differs) between two recordings of the same calls."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} MoE calls against {len(b)}")
    ids = pairs = ids_n = pairs_n = 0
    for x, y in zip(a, b):
        gx, gy = x["gate_idx"].cpu(), y["gate_idx"].cpu()
        ids += int((gx != gy).sum())
        pairs += int((gx.sort(-1)[0] != gy.sort(-1)[0]).any(-1).sum())
        ids_n, pairs_n = ids_n + gx.numel(), pairs_n + gx.shape[0]
    return ids / ids_n, pairs / pairs_n


def _n_attn(cfg):
    return sum(cfg.is_attn_layer(layer) for layer in range(cfg.n_layers))


def _model_serve(model, params, spec, dev):
    """One serve run of ``spec``: engines behind a ``BassRouter`` driven by
    ``launch/serve.py``'s ``drive``, every kernel's count set to 0 just
    before and read just after → (run, {rid: tokens}, requests).  Raises
    unless every request completed and K2 launched once per attention
    layer and prefill."""
    import torch

    from repro_torch.kernels import decode_attention, flash_attention, mamba_scan
    from repro_torch.launch.serve import drive, make_requests
    from repro_torch.serving import BassRouter, ServeEngine

    cfg = model.cfg
    names = [f"pod0/host{i}" for i in range(spec["replicas"])]
    engines = {n: ServeEngine(model, params, spec["slots"], spec["s_max"], name=n, device=dev)
               for n in names}
    router = BassRouter(names)
    reqs = make_requests(cfg, spec["requests"], spec["prompt_len"], spec["max_new"], SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = drive(engines, router, reqs, log=None)
    torch.cuda.synchronize()
    k1, calls = _counts()
    k2, k3 = flash_attention.stats["launches"], decode_attention.stats["launches"]
    k4 = mamba_scan.stats["launches"]
    prefills = len(out["prefill_s"])
    tokens = sum(len(r.tokens_out) for r in reqs)
    run = dict(
        seconds=out["seconds"], tokens=tokens, tokens_s=tokens / out["seconds"],
        prefills=prefills, prefill_p50_ms=float(np.percentile(out["prefill_s"], 50)) * 1e3,
        decode_ticks=len(out["tick_s"]),
        decode_tick_p50_ms=float(np.percentile(out["tick_s"], 50)) * 1e3,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        k2_launches=k2, k3_launches=k3, k4_launches=k4, k1_launches=k1["launches"],
        planner_calls=calls, attn_layers=_n_attn(cfg), head_dim=cfg.resolved_head_dim)
    if not (all(r.done and len(r.tokens_out) == spec["max_new"] for r in reqs)
            and prefills == spec["requests"]):
        raise AssertionError(f"{cfg.name}: serve run incomplete: {run}")
    if k2 != _n_attn(cfg) * prefills or k4 != 0:
        raise AssertionError(f"{cfg.name}: K2 launched {k2} times (K4 {k4}) for {prefills} "
                             f"prefills of {_n_attn(cfg)} attention layers")
    return run, {r.rid: list(r.tokens_out) for r in reqs}, reqs


def _profile_paths(model, params, spec, dev):
    """One prefill of a ``prompt_len`` prompt and one decode step over
    ``slots`` slots at position ``prompt_len``, the serve run's shapes,
    each warm under ``torch.profiler`` (``_profiled``): wall and device
    time, idle share, the largest device kernels."""
    import torch

    from repro_torch.launch.serve import make_requests
    from repro_torch.models import encdec

    cfg = model.cfg
    prompt = make_requests(cfg, 1, spec["prompt_len"], 1, SEED + 3)[0].prompt
    batch = {"tokens": torch.as_tensor(prompt[None, :], device=dev).long()}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                                      device=dev)
    caches = model.init_caches(spec["slots"], spec["s_max"], dev)
    token = torch.ones((spec["slots"], 1), dtype=torch.long, device=dev)
    with torch.no_grad():
        prefill = lambda: model.prefill(params, batch, spec["s_max"])  # noqa: E731
        decode = lambda: model.decode(params, token, spec["prompt_len"], caches)  # noqa: E731
        prefill(), decode()
        out = dict(prefill=_profiled(prefill)[1], decode=_profiled(decode)[1])
        if cfg.family == "encdec":
            out["encode"] = _profiled(lambda: encdec.encode(params, batch["frames"], cfg))[1]
    del caches
    return out


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _phase9_moe(dev, spec):
    """(a) moonshot-v1-16b-a3b at full width and depth, bf16."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import count_params, moe
    from repro_torch.models.model import Model

    cfg = get_config(spec["arch"]).with_(
        n_layers=spec["n_layers"], attn_impl="pallas", remat=False)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    run, tokens, reqs = _model_serve(model, params, spec, dev)
    with moe.recording() as rec:  # the determinism gate's second run
        _, tokens_again, _ = _model_serve(model, params, spec, dev)
    run["drop_rate_prefill"], run["drop_rate_prefill_by_layer"] = _drop_rate(
        rec, spec["prompt_len"], cfg.n_layers)
    run["profile"] = _profile_paths(model, params, spec, dev)
    run["capacity_prefill"] = moe.capacity(cfg, spec["prompt_len"])
    run["capacity_decode"] = moe.capacity(cfg, spec["slots"])
    twice = dict(identical=tokens == tokens_again)

    # bf16 at full depth: the kernel path and the plain path against float32.
    prompt = reqs[0].prompt
    with moe.recording() as rk:
        lk = _prefill_logits(model, params, prompt, spec["s_max"], dev)
    with moe.recording() as rx:
        lx = _prefill_logits(Model(cfg.with_(attn_impl="xla")), params, prompt,
                             spec["s_max"], dev)
    l32 = _prefill_logits_f32(cfg, params, prompt, dev)
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    ids, pairs = _routing_diff(rk, rx)
    bf16 = dict(kernel_vs_f32=err(lk, l32), plain_vs_f32=err(lx, l32),
                kernel_vs_plain=err(lk, lx), max_abs_logit=float(l32.abs().max()),
                expert_ids_differing=ids, token_layers_differing=pairs,
                finite=bool(torch.isfinite(lk).all()))
    del params
    _free()

    # float32, full width, spec["f32_layers"] layers: kernel path = plain path.
    cfg32 = cfg.with_(n_layers=spec["f32_layers"], param_dtype="float32",
                      compute_dtype="float32")
    params32 = Model(cfg32).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    with moe.recording() as rk:
        tok_k = _greedy(Model(cfg32), params32, prompt, spec["max_new"], dev, spec["s_max"])
    with moe.recording() as rx:
        tok_x = _greedy(Model(cfg32.with_(attn_impl="xla")), params32, prompt,
                        spec["max_new"], dev, spec["s_max"])
    ids32, _ = _routing_diff(rk, rx)
    lk32 = _prefill_logits(Model(cfg32), params32, prompt, spec["s_max"], dev)
    lx32 = _prefill_logits(Model(cfg32.with_(attn_impl="xla")), params32, prompt,
                           spec["s_max"], dev)
    f32 = dict(layers=cfg32.n_layers, tokens_kernel=tok_k, tokens_plain=tok_x,
               identical=tok_k == tok_x, routing_calls=len(rk),
               expert_ids_differing=ids32, logits_kernel_vs_plain=err(lk32, lx32),
               tolerance=MOE_TOL)

    # One MoE layer in float32 on the card against its CPU copies.
    lp = {k: v[0] for k, v in params32["stack"]["moe"].items()}
    x = torch.randn((1, spec["prompt_len"], cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    with torch.no_grad(), moe.recording() as rd:
        y, aux = moe.moe_block(lp, x, cfg32)
    with torch.no_grad(), moe.recording() as rc:
        yc, auxc = moe.moe_block({k: v.cpu() for k, v in lp.items()}, x.cpu(), cfg32)
    same = all(torch.equal(a[k].cpu(), b[k]) for a, b in zip(rd, rc)
               for k in ("gate_idx", "keep"))
    layer = dict(routing_identical=same, max_abs_err=err(y.cpu(), yc),
                 aux_err=abs(float(aux) - float(auxc)), max_abs_y=float(yc.abs().max()),
                 tolerance=MOE_TOL)
    del params32, lp
    _free()
    out = dict(config=spec, params=count_params(model.defs()), run=run, twice=twice,
               bf16_full_depth=bf16, f32=f32, layer=layer)
    if not (twice["identical"] and bf16["finite"]):
        raise AssertionError(f"(a) the serve's tokens differ between two runs: {out}")
    if not (f32["identical"] and ids32 == 0 and f32["logits_kernel_vs_plain"] <= MOE_TOL):
        raise AssertionError(f"(a) float32 kernel and plain paths differ: {f32}")
    if not (same and layer["max_abs_err"] <= MOE_TOL and layer["aux_err"] <= MOE_TOL):
        raise AssertionError(f"(a) the MoE layer on the card differs from its CPU copy: {layer}")
    return out


def _slot_write(model, params, spec, dev):
    """Three requests into a fresh one-replica engine, the third into slot
    2: that slot of every cache leaf must change, and no other slot."""
    import torch

    from repro_torch.launch.serve import make_requests
    from repro_torch.models.params import flatten
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model, params, spec["slots"], spec["s_max"], device=dev)
    reqs = make_requests(model.cfg, 3, spec["prompt_len"], spec["max_new"], SEED + 2)
    admitted = [eng.admit(r) for r in reqs[:2]]
    before = {path: t.clone() for path, t in flatten(eng._caches)}
    admitted.append(eng.admit(reqs[2]))
    others = [i for i in range(spec["slots"]) if i != 2]
    leaves = list(flatten(eng._caches))
    out = dict(admitted=all(admitted) and eng.active.get(2) is reqs[2],
               others_untouched=all(torch.equal(t[:, others], before[p][:, others])
                                    for p, t in leaves),
               slot_written=all(not torch.equal(t[:, 2], before[p][:, 2]) for p, t in leaves),
               leaves=len(leaves), kinds=sorted({p[-1] for p, _ in leaves}))
    del eng, before
    return out


def _phase9_hybrid(dev, spec):
    """(b) jamba-v0.1-52b at full width, 16 of 32 layers, bf16."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, mamba_scan
    from repro_torch.launch.steps import make_eval_step
    from repro_torch.models import count_params
    from repro_torch.models.model import Model

    cfg = get_config(spec["arch"]).with_(
        n_layers=spec["n_layers"], attn_impl="pallas", ssm_impl="pallas", remat=False)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    run, _, reqs = _model_serve(model, params, spec, dev)
    run["profile"] = _profile_paths(model, params, spec, dev)
    slots = _slot_write(model, params, spec, dev)

    # The eval path's run through K4: counts to 0 just before, read just after.
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                size=(spec["eval_batch"], spec["eval_seq"]))
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    loss_k = float(make_eval_step(model)(params, batch)["loss"])
    eval_k_s = time.perf_counter() - t0
    launches = dict(mamba_scan=mamba_scan.stats["launches"],
                    flash_attention=flash_attention.stats["launches"])
    t0 = time.perf_counter()
    loss_x = float(make_eval_step(Model(cfg.with_(ssm_impl="xla")))(params, batch)["loss"])
    eval_x_s = time.perf_counter() - t0
    n_mamba = cfg.n_layers - _n_attn(cfg)
    ev = dict(bfloat16=dict(loss_kernel=loss_k, loss_plain=loss_x,
                            abs_diff=abs(loss_k - loss_x)),
              seconds_kernel=eval_k_s, seconds_plain=eval_x_s, launches=launches,
              mamba_layers=n_mamba, tolerance=EVAL_TOL)
    del params
    _free()

    # float32 on one period: eval through K4 against the time loop, and the
    # greedy tokens of the kernel and plain attention paths.
    cfg32 = cfg.with_(n_layers=spec["f32_layers"], param_dtype="float32",
                      compute_dtype="float32")
    params32 = Model(cfg32).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    before = mamba_scan.stats["launches"]
    l32 = {impl: float(make_eval_step(Model(cfg32.with_(ssm_impl=impl)))(params32, batch)["loss"])
           for impl in ("pallas", "xla")}
    ev["float32"] = dict(layers=cfg32.n_layers, loss_kernel=l32["pallas"], loss_plain=l32["xla"],
                         abs_diff=abs(l32["pallas"] - l32["xla"]),
                         k4_launches=mamba_scan.stats["launches"] - before)
    prompt = reqs[0].prompt
    tok_k = _greedy(Model(cfg32), params32, prompt, spec["max_new"], dev, spec["s_max"])
    tok_x = _greedy(Model(cfg32.with_(attn_impl="xla")), params32, prompt, spec["max_new"],
                    dev, spec["s_max"])
    f32 = dict(layers=cfg32.n_layers, tokens_kernel=tok_k, tokens_plain=tok_x,
               identical=tok_k == tok_x)
    del params32
    _free()
    out = dict(config=spec, params=count_params(model.defs()),
               cut="n_layers 32 -> 16 (two periods: one H100 holds 52.1 GB of their bf16 "
                   "parameters, not the 103.1 GB of 32); float32 checks on one period",
               run=run, slot_write=slots, eval=ev, f32=f32)
    if not (slots["admitted"] and slots["others_untouched"] and slots["slot_written"]):
        raise AssertionError(f"(b) the hybrid caches were not written into their slot: {slots}")
    if not (launches["mamba_scan"] == n_mamba and ev["float32"]["k4_launches"]
            == cfg32.n_layers - _n_attn(cfg32)):
        raise AssertionError(f"(b) K4 launched {launches} times for {n_mamba} mamba layers")
    if not all(np.isfinite(ev[dt]["loss_kernel"]) and ev[dt]["abs_diff"] <= EVAL_TOL[dt]
               for dt in EVAL_TOL):
        raise AssertionError(f"(b) the eval losses differ: {ev}")
    if not f32["identical"]:
        raise AssertionError(f"(b) float32 greedy tokens differ: {f32}")
    return out


def _phase9_encdec(dev, spec):
    """(c) whisper-base whole, bf16, zero audio frames."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import count_params
    from repro_torch.models.model import Model

    cfg = get_config(spec["arch"]).with_(attn_impl="pallas", remat=False)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    run, _, reqs = _model_serve(model, params, spec, dev)
    run["profile"] = _profile_paths(model, params, spec, dev)
    del params
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    params32 = Model(cfg32).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    prompt = reqs[0].prompt
    tok_k = _greedy(Model(cfg32), params32, prompt, spec["max_new"], dev, spec["s_max"])
    tok_x = _greedy(Model(cfg32.with_(attn_impl="xla")), params32, prompt, spec["max_new"],
                    dev, spec["s_max"])
    f32 = dict(tokens_kernel=tok_k, tokens_plain=tok_x, identical=tok_k == tok_x)
    del params32
    _free()
    if not f32["identical"]:
        raise AssertionError(f"(c) float32 greedy tokens differ: {f32}")
    return dict(config=spec, params=count_params(model.defs()), run=run, f32=f32)


def phase_models():
    """Phase 9: the MoE, hybrid and encoder-decoder families on the serving
    path, one after another, each freed before the next starts."""
    import torch

    from repro_torch.kernels import ts_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    ts_plan.set_backend("cuda")
    cuda = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = {}
    for fam, fn in (("moe", _phase9_moe), ("hybrid", _phase9_hybrid),
                    ("encdec", _phase9_encdec)):
        t = time.perf_counter()
        out[fam] = fn(cuda, MODELS[fam])
        out[fam]["seconds"] = time.perf_counter() - t
    log("models", seconds=time.perf_counter() - t0, **out)
    return out


# -- phase 10 ------------------------------------------------------------------

# (a) internvl2-1b (arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B) whole:
# 493 709 440 parameters, the largest of the ten configurations whose bf16
# parameters, float32 moments and step fit one H100 (starcoder2-3b, 3.18 B,
# would need about 83 GB at the 26 bytes a parameter phase 7 read).  Trained
# through ``launch/train.py``'s ``main``: 6 steps of 8 × 1 024 positions
# (256 of them vision embeddings), seeded random parameters, a checkpoint
# every 3 steps (about 4.9 GB each: bf16 parameters, float32 m and v).
TRAINER = dict(arch="internvl2-1b", steps=6, batch=8, seq=1024, ckpt_every=3)
# (b) the 126 M preset at full size: 4 straight steps, and 2 then --resume
# for 2 more, each leg its own process; the two step-4 checkpoints equal
# (8 and 4 before, cut for the script's time).
RESTART = dict(preset="100m", steps=4, cut=2, batch=8, seq=256)
# (c) plan_epoch then prefetch_epoch on phase 3's 4 096 hosts with
# examples/bass_cluster_demo.py's 512 MB shards, three replicas, seed 7, an
# idle backlog (8 192 shards: 16 384 before, cut for the script's time); a
# cuda leg past EPOCH_LIMIT_S halves the shard count.
EPOCH = dict(pods=16, hosts=256, shards=8_192, size_bytes=512e6, replication=3, seed=7)
EPOCH_LIMIT_S = 60.0


def _same_bits(a, b):
    """Same shape, dtype and bits (floats compared as integers)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(as_int), b.view(as_int)
    return bool(torch.equal(a, b))


def _state_leaves(params, opt_state):
    """Every tensor of (params, AdamW state) in a fixed order."""
    from repro_torch.models.params import flatten

    return ([t for _, t in flatten(params)] + [t for _, t in flatten(opt_state.m)]
            + [t for _, t in flatten(opt_state.v)] + [opt_state.count])


def _grads(model, params, batch):
    """The gradient tree of ``model.loss`` at ``params`` on ``batch``."""
    import torch

    from repro_torch.models.params import flatten, unflatten

    paths, leaves = zip(*flatten(params))
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, _ = model.loss(unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return unflatten(paths, [g.detach() for g in grads])


def _phase10_trainer(dev):
    """(a) internvl2-1b through ``launch/train.py``: every count set to 0
    just before ``main`` and read just after → (report, gradient tree)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import canon_fetches
    from repro_torch.kernels import ts_plan
    from repro_torch.launch import train
    from repro_torch.models import count_params
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten

    spec = TRAINER
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="ckpt_trainer_", dir=os.path.join(HERE, "build"))
    argv = ["--arch", spec["arch"], "--steps", str(spec["steps"]), "--batch",
            str(spec["batch"]), "--seq", str(spec["seq"]), "--ckpt-every",
            str(spec["ckpt_every"]), "--ckpt-dir", ckdir, "--log-every", "1",
            "--seed", str(SEED)]
    try:
        ts_plan.set_backend("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = train.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        k1, calls = _counts()
        cfg = res["cfg"]
        params, opt_state = res["params"], res["opt_state"]

        ts_plan.set_backend("numpy")
        _, numpy_fetches, _ = train.epoch_placement()
        ts_plan.set_backend("cuda")

        t0 = time.perf_counter()
        step, (rp, ro) = Checkpointer(ckdir).restore((params, opt_state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got, want = _state_leaves(rp, ro), _state_leaves(params, opt_state)
        restored = dict(step=step, leaves=len(want), seconds=restore_s,
                        on_card=all(t.device.type == "cuda" for t in got),
                        bitwise=all(_same_bits(g, w) for g, w in zip(got, want, strict=True)))
        del rp, ro, got, want
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckdir, f"step_{step:09d}", n))
                         for n in ("shard_host0.npz", "manifest.json"))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    init = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    moved = {"/".join(path): float((new != old).float().mean())
             for (path, new), (_, old) in zip(flatten(params), flatten(init))}
    sizes = {"/".join(path): t.numel() for path, t in flatten(init)}
    moved_all = sum(moved[k] * sizes[k] for k in moved) / sum(sizes.values())
    del init
    profiled_out, profile = _profiled(lambda: res["train_step"](params, opt_state, res["batch"]))
    del profiled_out  # its new parameters and moments, so the next step's peak is its own
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _count_step("trainer_step", res["train_step"], (params, opt_state, res["batch"]), cfg,
                ShapeSpec("trainer", "train", spec["seq"], spec["batch"]),
                float(np.median(res["step_s"])), kernel_regions={}, allocated_before=allocated)
    COUNTED["trainer_step"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    grads = _grads(Model(cfg), params, res["batch"])

    losses = [v for _, v in res["losses"]]
    norms = [v for _, v in res["grad_norms"]]
    p50 = float(np.median(res["step_s"]))
    out = dict(
        config=spec, argv=argv, params=count_params(Model(cfg).defs()), seconds=main_s,
        losses=losses, grad_norms=norms, step_s=res["step_s"], step_p50_s=p50,
        tokens_s=spec["batch"] * spec["seq"] / p50, tokens_s_trainer=res["tokens_s"],
        max_memory_allocated=peak, moved_fraction=moved_all, moved_fraction_by_leaf=moved,
        profile_step=profile, save_s=res["save_s"], write_s=res["write_s"],
        checkpoint_bytes=ckpt_bytes, restore=restored,
        k1_launches=k1.get("launches", 0), k1_launches_window=k1.get("launches_window", 0),
        wave_scan_calls=calls["wave_scan"], placement_device_stats=res["device_stats"],
        fetches=len(res["assignments"]),
        local=sum(1 for a in res["assignments"] if a.source is None),
        fetches_identical=canon_fetches(res["assignments"]) == canon_fetches(numpy_fetches),
        steps_logged=len(losses))
    out["ok"] = dict(
        finite=len(losses) == spec["steps"]
        and all(np.isfinite(v) and v > 0 for v in losses + norms),
        moved=moved_all >= 0.9,
        k1=calls["wave_scan"] >= 1 and out["k1_launches"] == calls["wave_scan"]
        == out["k1_launches_window"],
        fetches=out["fetches_identical"],
        restore=restored["step"] == spec["steps"] and restored["on_card"]
        and restored["bitwise"])
    return out, grads


def _npz_members(path):
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _phase10_restart():
    """(b) ``python -m repro_torch.launch.train --preset 100m``: RESTART's
    straight steps in one process, beside its cut and then ``--resume`` for
    the rest in two others; every leaf of the two last checkpoints must be
    the same bytes."""
    import shutil
    import tempfile

    spec = RESTART
    root = tempfile.mkdtemp(prefix="ckpt_restart_", dir=os.path.join(HERE, "build"))
    dirs = dict(straight=os.path.join(root, "straight"), resumed=os.path.join(root, "resumed"))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--preset", spec["preset"],
            "--batch", str(spec["batch"]), "--seq", str(spec["seq"]), "--log-every", "1",
            "--ckpt-every", "1000", "--seed", str(SEED)]

    def start(steps, ckdir, *extra):
        return subprocess.Popen(base + ["--steps", str(steps), "--ckpt-dir", ckdir, *extra],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=HERE)

    def finish(proc, name):
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"(b) the {name} leg exited {proc.returncode}: {out[-3000:]}")
        return out

    try:
        t0 = time.perf_counter()
        straight = start(spec["steps"], dirs["straight"])  # beside the other two
        logs = dict(first=finish(start(spec["cut"], dirs["resumed"]), "first"))
        logs["resume"] = finish(start(spec["steps"], dirs["resumed"], "--resume"), "resume")
        logs["straight"] = finish(straight, "straight")
        seconds = time.perf_counter() - t0
        last = f"step_{spec['steps']:09d}"
        a = _npz_members(os.path.join(dirs["straight"], last, "shard_host0.npz"))
        b = _npz_members(os.path.join(dirs["resumed"], last, "shard_host0.npz"))
        manifests = [open(os.path.join(d, last, "manifest.json")).read() for d in dirs.values()]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    differ = sorted(n for n in a if a[n] != b.get(n))
    out = dict(config=spec, seconds=seconds, leaves=len(a), leaves_differing=differ,
               manifests_equal=manifests[0] == manifests[1], same_keys=set(a) == set(b),
               resumed=f"resumed from step {spec['cut']}" in logs["resume"],
               log_tails={k: v.strip().splitlines()[-3:] for k, v in logs.items()})
    out["ok"] = dict(identical=not differ and out["same_keys"] and out["manifests_equal"],
                     resumed=out["resumed"])
    return out


def _epoch_instance(n_shards):
    """(hosts, shards) of the fleet-scale epoch: ``uniform_shards`` draws
    each shard's replicas from the 4 096 hosts (seconds on the host)."""
    from repro_torch.data import uniform_shards

    spec = EPOCH
    hosts = [f"pod{p}/host{h}" for p in range(spec["pods"]) for h in range(spec["hosts"])]
    return hosts, uniform_shards(n_shards, hosts, spec["size_bytes"],
                                 replication=spec["replication"], seed=spec["seed"])


def _epoch_leg(backend, hosts, shards):
    """plan_epoch, then prefetch_epoch, on ``backend`` → per call: seconds,
    K1 launches, ``wave_scan`` calls and the schedules' bit-exact images."""
    import torch

    from repro_torch.convert import canon, canon_fetches
    from repro_torch.core.topology import tpu_dcn_fabric
    from repro_torch.data import plan_epoch, prefetch_epoch
    from repro_torch.kernels import ts_plan

    ts_plan.set_backend(backend)
    fabric = tpu_dcn_fabric(EPOCH["pods"], EPOCH["hosts"])
    out, images = {}, {}
    for name, fn in (("plan_epoch", plan_epoch), ("prefetch_epoch", prefetch_epoch)):
        _reset_counts()
        t0 = time.perf_counter()
        fetches, sched = fn(fabric, hosts, {h: 0.0 for h in hosts}, shards)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k1, calls = _counts()
        out[name] = dict(seconds=dt, k1_launches=k1.get("launches", 0),
                         wave_scan_calls=calls["wave_scan"], makespan=sched.makespan,
                         local=sum(1 for f in fetches if f.source is None))
        images[name] = (canon_fetches(fetches), canon(sched.assignments))
    return out, images


def _phase10_epoch():
    """(c) the fleet-scale epoch placement on ``cuda``, then ``numpy``."""
    n, cuts = EPOCH["shards"], []
    while True:
        hosts, shards = _epoch_instance(n)
        cuda, cuda_images = _epoch_leg("cuda", hosts, shards)
        slowest = max(leg["seconds"] for leg in cuda.values())
        if slowest <= EPOCH_LIMIT_S or n <= 1024:
            break
        cuts.append(f"shards {n} -> {n // 2} (a cuda leg took {slowest:.1f} s)")
        print(f"[trainer] (c) {cuts[-1]}", flush=True)
        n //= 2
    numpy_legs, numpy_images = _epoch_leg("numpy", hosts, shards)
    from repro_torch.kernels import ts_plan

    ts_plan.set_backend("cuda")
    identical = {k: cuda_images[k] == numpy_images[k] for k in cuda_images}
    out = dict(config=dict(EPOCH, shards=n), cuts=cuts, cuda=cuda, numpy=numpy_legs,
               identical=identical,
               k1_launches=sum(leg["k1_launches"] for leg in cuda.values()))
    out["ok"] = dict(identical=all(identical.values()),
                     k1=all(leg["k1_launches"] >= 1
                            and leg["k1_launches"] == leg["wave_scan_calls"]
                            for leg in cuda.values()))
    return out


def _phase10_compress(grads, dev):
    """(d) error-feedback int8 compression of (a)'s gradient tree on the
    card against a CPU copy; then ``cross_pod_allreduce``, plain and
    compressed, over a one-rank NCCL group on the card against the sum
    computed on the host."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import cross_pod_allreduce
    from repro_torch.distributed.grad_compress import (compress, decompress,
                                                       tree_compress_with_feedback)
    from repro_torch.models.params import flatten, unflatten

    paths = [p for p, _ in flatten(grads)]
    to_cpu = lambda tree: unflatten(paths, [t.cpu() for _, t in flatten(tree)])  # noqa: E731
    # A carried residual of the gradients' own size, so the sum x + residual
    # is exercised too.
    carried = unflatten(paths, [g.float() * 0.5 for _, g in flatten(grads)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = tree_compress_with_feedback(grads, carried)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = tree_compress_with_feedback(to_cpu(grads), to_cpu(carried))
    host_s = time.perf_counter() - t0
    same = [all(_same_bits(a, b) for (_, a), (_, b) in zip(flatten(c), flatten(h)))
            for c, h in zip(card, host)]
    rounds = [dict(payloads=same[0], scales=same[1], residuals=same[2], card_s=card_s,
                   cpu_s=host_s, max_abs_residual=max(float(t.abs().max())
                                                      for _, t in flatten(card[2])))]
    n_elems = sum(g.numel() for _, g in flatten(grads))
    del card, host, carried

    x = max((g for _, g in flatten(grads)), key=lambda g: g.numel()).float()
    init_file = tempfile.mktemp(prefix="nccl_init_", dir=os.path.join(HERE, "build"))
    dist.init_process_group("nccl", init_method=f"file://{init_file}", world_size=1, rank=0)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = cross_pod_allreduce(x, compressed=False)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        packed = cross_pod_allreduce(x, compressed=True)
        torch.cuda.synchronize()
        packed_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        if os.path.exists(init_file):
            os.remove(init_file)
    xc = x.cpu()
    want_packed = decompress(*compress(xc), tuple(xc.shape))
    allreduce = dict(group="nccl, one rank on the card", numel=x.numel(),
                     plain_equal=_same_bits(plain, xc), plain_s=plain_s,
                     compressed_equal=_same_bits(packed, want_packed), compressed_s=packed_s,
                     compressed_max_err=float((packed.cpu() - xc).abs().max()),
                     max_abs_x=float(xc.abs().max()))
    out = dict(gradient_elements=n_elems, rounds=rounds, allreduce=allreduce)
    out["ok"] = dict(
        compress=all(r["payloads"] and r["scales"] and r["residuals"] for r in rounds),
        allreduce=allreduce["plain_equal"] and allreduce["compressed_equal"])
    return out


def phase_trainer():
    """Phase 10: the trainer entry point on the card, a resume against a
    straight run, the fleet-scale epoch placement, and the gradient
    compression and cross-pod all-reduce."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    t0 = time.perf_counter()
    parts = {}
    t = time.perf_counter()
    parts["trainer"], grads = _phase10_trainer(cuda)
    parts["trainer"]["phase_s"] = time.perf_counter() - t
    _free()
    for name, fn in (("restart", _phase10_restart), ("epoch", _phase10_epoch),
                     ("compress", lambda: _phase10_compress(grads, cuda))):
        t = time.perf_counter()
        parts[name] = fn()
        parts[name]["phase_s"] = time.perf_counter() - t
    del grads
    _free()
    seconds = time.perf_counter() - t0
    log("trainer", seconds=seconds, **parts)
    bad = [f"{name}.{k}" for name, part in parts.items() for k, ok in part["ok"].items()
           if not ok]
    if bad:
        raise AssertionError(f"phase 10: failed gates {bad}")
    return parts


# -- phase 11 ------------------------------------------------------------------

# (a) the dry run's CLI, one process per cell, all started together after
# phase 1: the trainer's cell, the mamba time scan at full size (by formula)
# and the MoE dispatch at 32k.
DRYRUN_CELLS = [("internvl2-1b", "train_4k"), ("falcon-mamba-7b", "prefill_32k"),
                ("moonshot-v1-16b-a3b", "prefill_32k")]


DRYRUN_DIR = os.path.join(HERE, "build", "dryrun_torch")
#: The dry runs' processes, started once (:func:`_start_dryruns`).
DRYRUN_PROCS = {}


def _start_dryruns():
    """Start (a)'s dry runs, one process each, unless started: they run on
    the host's cores on ``meta`` tensors (internvl2-1b's train cell at 8
    microbatches about 45 s), so ``main`` starts them beside phase 2 and
    phase 11 reads them."""
    if not DRYRUN_PROCS:
        env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
        DRYRUN_PROCS.update({f"{a}__{s}": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
             "--mesh", "single", "--out", DRYRUN_DIR, "--force"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for a, s in DRYRUN_CELLS})
    return DRYRUN_PROCS


def _dryrun_formula(arch, shape_name):
    """The count and wire bytes ``launch/sharded.py::sharded_collectives``
    gives a dry-run cell on the (16, 16) mesh under the baseline (the
    greedy pick left out, as ``dryrun.formula_ops`` leaves it)."""
    from repro_torch.configs import shapes_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.expert import report_of
    from repro_torch.launch.mesh import make_production_mesh, recording_mesh

    shape = next(s for s in shapes_for(arch) if s.name == shape_name)
    mesh = make_production_mesh()
    cfg, b, s, s_max = dryrun.cell_step(arch, shape, mesh, "baseline")
    rec = recording_mesh(mesh.axis_sizes, mesh.axis_names)
    cfg, param_rules, rules = dryrun.rank_rules(cfg, shape.kind, b, s, rec, "baseline")
    ops = dryrun.formula_ops(cfg, shape.kind, b, s, mesh.shape, param_rules, rules,
                             dryrun.TRAIN_ACCUM, s_max)
    report = report_of(ops)
    return dict(count=report.count(), wire_bytes_ici=report.total_wire_bytes(dcn=False),
                wire_bytes_dcn=report.total_wire_bytes(dcn=True))


def _region_noop_ns(n=200_000):
    """Host nanoseconds a region costs per call with no counter active:
    ``cost.region`` given its numbers, and K2's wrapper's
    ``cost.formula_region`` (its formula left unevaluated)."""
    import torch

    from repro_torch.kernels import cost, ops

    assert not cost.active()
    t0 = time.perf_counter()
    for _ in range(n):
        with cost.region("flash_attention", 1, 2):
            pass
    bare = (time.perf_counter() - t0) / n * 1e9
    t0 = time.perf_counter()
    for _ in range(n):
        with cost.formula_region("flash_attention", ops.attention_cost,
                                 1, 32, 8, 512, 512, 128, torch.bfloat16, True):
            pass
    wrapper = (time.perf_counter() - t0) / n * 1e9
    return dict(region_ns=bare, formula_region_ns=wrapper)


def phase_cost():
    """Phase 11: the dry run's records for three cells, and each counted
    step of phases 6, 7 and 10 counted again on ``meta`` (the same FLOPs
    and bytes, exactly), beside its measured time against the card's
    peaks."""
    from repro_torch.kernels import cost
    from repro_torch.launch.hlo_analysis import model_flops_estimate

    t0 = time.perf_counter()
    procs = _start_dryruns()

    steps, bad = {}, []
    for name, rec in COUNTED.items():
        with cost.CostCounter(*rec["meta_args"]) as c:
            rec["fn"](*rec["meta_args"])
        meta, card, secs = c.result(), rec["card"], rec["seconds"]
        flops, nbytes = card["flops"], card["bytes"]
        mf = model_flops_estimate(rec["cfg"], rec["shape"])
        bound = {"operations": flops / BF16_FLOP_S, "bytes": nbytes / HBM_BYTES_S}
        regions = {k: v["calls"] for k, v in card["regions"].items()}
        steps[name] = dict(
            shape=dict(kind=rec["shape"].kind, seq=rec["shape"].seq_len,
                       batch=rec["shape"].global_batch, layers=rec["cfg"].n_layers),
            flops=flops, bytes=nbytes, transcendentals=card["transcendentals"],
            meta_flops=meta["flops"], meta_bytes=meta["bytes"],
            seconds=secs, achieved_tflop_s=flops / secs / 1e12, model_flops=mf,
            mfu=mf / (secs * BF16_FLOP_S), flop_share_of_peak=flops / (secs * BF16_FLOP_S),
            roofline_bound_s=max(bound.values()), bound_by=max(bound, key=bound.get),
            bound_over_time=max(bound.values()) / secs, regions=regions,
            uncounted=card["uncounted"], ops=card["ops"],
            live_peak_bytes_meta=meta["live_peak_bytes"],
            live_peak_bytes_card=card["live_peak_bytes"],
            argument_bytes=card["argument_bytes"],
            **{k: rec[k] for k in ("allocated_before", "max_memory_allocated") if k in rec})
        if "max_memory_allocated" in rec:  # the step's own peak: its arguments and what it made
            steps[name]["measured_step_peak_bytes"] = (
                rec["max_memory_allocated"] - rec["allocated_before"] + card["argument_bytes"])
        if (flops, nbytes) != (meta["flops"], meta["bytes"]):
            by_op = rec["card_by_op"]
            steps[name]["differs_by_op"] = {
                k: (by_op.get(k), c.by_op.get(k)) for k in sorted(set(by_op) | set(c.by_op))
                if by_op.get(k) != c.by_op.get(k)}
            bad.append(f"{name}: card {flops} FLOPs, {nbytes} B; meta {meta['flops']}, "
                       f"{meta['bytes']}")
        if regions != rec["kernel_regions"] or meta["regions"] != card["regions"]:
            bad.append(f"{name}: kernel regions {regions}, expected {rec['kernel_regions']}")
    noop = _region_noop_ns()

    records, summary = {}, {}
    for cell, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        path = os.path.join(DRYRUN_DIR, f"{cell}__pod256.json")
        rec = json.load(open(path)) if os.path.exists(path) else {"ok": False}
        records[cell] = dict(ok=rec["ok"] and proc.returncode == 0,
                             returncode=proc.returncode, tail=stdout.strip()[-200:],
                             **{k: rec.get(k) for k in ("accounting", "roofline", "memory",
                                                        "collectives", "rank_program",
                                                        "error")})
        if not records[cell]["ok"]:
            bad.append(f"dryrun {cell}: {rec.get('error')} {stderr[-500:]}")
            continue
        want = _dryrun_formula(*cell.split("__"))
        coll = rec["collectives"]
        summary[cell] = dict(count=coll["count"], wire_bytes_ici=coll["wire_bytes_ici"],
                             wire_bytes_dcn=coll["wire_bytes_dcn"],
                             dominant=rec["roofline"]["dominant"],
                             peak_gib=rec["memory"]["peak_gib"], formula=want)
        if {k: coll[k] for k in want} != want:
            bad.append(f"dryrun {cell}: collectives {coll} against the formula's {want}")
    log("cost_collectives", cells=summary)
    log("cost", seconds=time.perf_counter() - t0, steps=steps, dryrun=records,
        region_noop=noop, chip=H100_SXM.name, peak_bf16_flop_s=BF16_FLOP_S,
        hbm_bytes_s=HBM_BYTES_S)
    if bad:
        raise AssertionError(f"phase 11: {bad}")
    return steps


# -- phase 12 ------------------------------------------------------------------

# The expert-parallel MoE dispatch (``moe_impl="a2a"``) on 4 ranks, one
# process each (``distributed/ranks.py``), all on ``cuda:0``, as a (1, 4)
# rank mesh with the sequence over ``model``: 16 of moonshot-v1-16b-a3b's 64
# experts a rank, 4 of phi3.5-moe-42b-a6.6b's 16.  NCCL is probed once (one
# all-reduce over the 4 ranks); everything else runs on gloo, which stages
# each CUDA payload through host memory (``distributed/collectives.py``).
# Depth: the largest whose parameters (each rank a whole copy of the
# non-expert ones and its quarter of the experts), caches and a context
# per rank fit under EXPERT_BUDGET bytes and the card's free memory.
EXPERT_WORLD, EXPERT_MESH = 4, (1, 4)
EXPERT_RULES = {"batch": ("data",), "seq": "model"}
EXPERT_BUDGET = 70 * 2**30        # of the card's 80 GiB
EXPERT_RANK_OVERHEAD = 0.8e9     # a rank's CUDA context and activations
EXPERT_SERVE = dict(slots=1, s_max=640, requests=2, prompt_len=512, max_new=4)
EXPERT_LIMIT = 600               # seconds for one multi-rank run
# Served depth caps for the script's time (phi3.5-moe: 21 of 32 layers fit
# by the reckoning, moonshot all 48; 6 and 12 for the script's time,
# PERF.md §4; moonshot 12 → 6 for phase 18's).
EXPERT_MAX_LAYERS = {"phi3.5-moe-42b-a6.6b": 6, "moonshot-v1-16b-a3b": 6}
# a2a against the one-rank gather, float32: the same products over other
# buffer shapes, and the balance sums over the ranks in another order.
EXPERT_TOL = 1e-4


def _card_released(free_before, limit_s=60.0):
    """Wait until the card's free memory is within 1 GiB of
    ``free_before`` (the ranks of the last run have exited, and their
    memory can take a moment to come back) → seconds waited."""
    import torch

    t0 = time.perf_counter()
    while torch.cuda.mem_get_info()[0] < free_before - 2**30:
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"the card's memory was not released in {limit_s} s: "
                                 f"{torch.cuda.mem_get_info()[0]} B free, {free_before} before; "
                                 f"this process {torch.cuda.memory_allocated()} B allocated, "
                                 f"{torch.cuda.memory_reserved()} B reserved")
        time.sleep(0.1)
    return time.perf_counter() - t0


def _expert_payload(**kw):
    return dict(device="cuda:0", mesh=EXPERT_MESH, rules=EXPERT_RULES, seed=SEED, **kw)


def _rank_mesh_bytes(cfg, serve):
    """Bytes on the card for ``cfg`` on the rank mesh: each rank a whole
    copy of the parameters outside the expert stack, its share of the
    expert stack, the engine's cache and one more (a prefill's), the
    largest float32 slice the initialisation draws at a time, and its
    overhead."""
    import math

    from repro_torch.models.model import Model
    from repro_torch.models.params import _SLICE_ELEMS, dtype_of, flatten

    size = dtype_of(cfg.param_dtype).itemsize
    experts = other = slice_bytes = 0
    for path, p in flatten(Model(cfg).defs()):
        n = math.prod(p.shape) * size
        cols = math.prod(p.shape[1:])
        slice_bytes = max(slice_bytes, 4 * cols * max(1, _SLICE_ELEMS // max(cols, 1)))
        if "moe" in path[:-1] and path[-1] != "router":
            experts += n
        else:
            other += n
    cache = (_n_attn(cfg) * 2 * serve["s_max"] * cfg.n_kv_heads * cfg.resolved_head_dim
             * dtype_of(cfg.compute_dtype).itemsize)
    per_rank = other + cache * (serve["slots"] + 1) + slice_bytes + EXPERT_RANK_OVERHEAD
    return experts + EXPERT_WORLD * per_rank


def _expert_depth(arch, budget):
    """(layers, bytes): the largest depth of ``arch`` whose reckoning fits,
    up to its cap in EXPERT_MAX_LAYERS."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    for n in range(EXPERT_MAX_LAYERS.get(arch, cfg.n_layers), 0, -1):
        need = _rank_mesh_bytes(cfg.with_(n_layers=n), EXPERT_SERVE)
        if need <= budget:
            return n, need
    raise AssertionError(f"{arch}: not one layer fits in {budget} B")


def _expert_probe_nccl():
    """One all-reduce over 4 NCCL ranks on one card → what NCCL said."""
    from repro_torch.distributed.ranks import RankFailure, run_ranks

    t0 = time.perf_counter()
    try:
        out = run_ranks("repro_torch.launch.expert:probe", EXPERT_WORLD, {"device": "cuda:0"},
                        backend="nccl", timeout_s=120)
        said = dict(accepted=True, sums=out)
    except RankFailure as exc:
        lines = [ln for ln in str(exc).splitlines()
                 if "NCCL" in ln or "Duplicate" in ln or "Error" in ln]
        said = dict(accepted=False, said=lines[:6] or [str(exc)[-600:]])
    said["seconds"] = time.perf_counter() - t0
    return said


def _same_ranks(results, key):
    return all(r[key] == results[0][key] for r in results)


def _check_ops(name, results, want):
    """Every rank's counted ops equal to the formula → (count, wire bytes by kind)."""
    from repro_torch.launch.expert import report_of

    for r in results:
        for key, ops in want.items():
            if r[key] != ops:
                raise AssertionError(f"{name} rank {r['coords']}: {key} {r[key]} against "
                                     f"the formula {ops}")
    return {key: dict(count=report_of(ops).count(), wire_bytes=report_of(ops).by_kind())
            for key, ops in want.items()}


#: Phases 13–18: each entry's ``meta`` rank program (``launch/dryrun.py::
#: rank_program``), by its case's arguments: its op count, the first op
#: where it parts from the formula (None: none), its host seconds.
META_PROGRAMS = {}


def _formula(cfg, mesh, rules, b, s, param_bytes, act_bytes, step="prefill", accum=1,
             param_rules=None, s_max=None, kind=None):
    """``sharded_collectives`` of an entry the ranks ran (the caller holds
    every rank's ops against it), after holding the ``meta`` rank program
    of the same case against it op for op, without the launcher's greedy
    pick (``decode/greedy``): the ranks' ops then equal the rank
    program's.  ``kind``: the rank program's step where it is not ``step``
    (a grad entry's ``"grad"``)."""
    from repro_torch.launch.dryrun import first_difference, rank_program
    from repro_torch.launch.sharded import sharded_collectives

    want = sharded_collectives(cfg, mesh, rules, b, s, param_bytes, act_bytes, step, accum,
                               param_rules, s_max)
    kind = kind or step
    key = repr((cfg, sorted(mesh.items()), rules, b, s, kind, accum, param_rules, s_max))
    if key not in META_PROGRAMS:
        t0 = time.perf_counter()
        prog = rank_program(cfg, kind, b, s, dict(mesh), (param_rules, rules), accum=accum,
                            s_max=s_max)
        got = [(c.kind, c.result_bytes, c.group, c.path) for c in prog["report"].ops]
        META_PROGRAMS[key] = dict(
            arch=cfg.name, layers=cfg.n_layers, kind=kind, batch=[b, s], mesh=dict(mesh),
            ops=len(got), seconds=time.perf_counter() - t0,
            differs_at=first_difference(got, [op for op in want if op[3] != "decode/greedy"]))
    if META_PROGRAMS[key]["differs_at"] is not None:
        raise AssertionError(f"the meta rank program of {cfg.name} {kind} {b} × {s} on {mesh} "
                             f"parts from the ranks' formula: {META_PROGRAMS[key]}")
    return want


def _meta_summary():
    """Phases 13–18's ``meta`` rank programs: how many, their ops and host
    seconds."""
    progs = list(META_PROGRAMS.values())
    return dict(programs=len(progs), ops=sum(p["ops"] for p in progs),
                seconds=sum(p["seconds"] for p in progs), each=progs)


def _expert_block():
    """(a) moonshot's MoE block at full width, B 1, S 512, on the 4 ranks:
    float32 and bf16 at capacity factor 8.0 against the one-rank gather
    (rank 0), bf16 at 1.25 with each rank's drop rate."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.expert import a2a_collectives

    arch, shape = "moonshot-v1-16b-a3b", (1, 512)
    cases = [dict(dtype="float32", cfg=dict(capacity_factor=8.0), gather=True),
             dict(dtype="bfloat16", cfg=dict(capacity_factor=8.0), gather=True),
             dict(dtype="bfloat16", cfg=dict(capacity_factor=1.25))]
    t0 = time.perf_counter()
    res = run_ranks("repro_torch.launch.expert:block", EXPERT_WORLD,
                    _expert_payload(arch=arch, x_shape=shape, reps=5, cases=cases),
                    timeout_s=EXPERT_LIMIT)
    seconds = time.perf_counter() - t0
    out = {}
    for i, case in enumerate(cases):
        ranks = [r[i] for r in res]
        r0 = ranks[0]
        cfg = get_config(arch).with_(**case["cfg"])
        size = 4 if case["dtype"] == "float32" else 2
        label = f"{case['dtype']}_cf{case['cfg']['capacity_factor']}"
        counts = _check_ops(label, ranks, {"ops": a2a_collectives(
            cfg, dict(zip(("data", "model"), EXPERT_MESH)), EXPERT_RULES, *shape, size, size)})
        entry = dict(c_e=r0["c_e"], drops=[r["drops"] for r in ranks],
                     finite=all(bool(torch.isfinite(r["y"]).all()) for r in ranks),
                     ranks_identical=all(torch.equal(r["y"], r0["y"]) for r in ranks),
                     aux=[r["aux"] for r in ranks], ms=[float(np.median(r["ms"])) for r in ranks],
                     route=r0["route"], collectives=counts)
        if case.get("gather"):
            y, yg = r0["y"].float(), r0["y_gather"].float()
            entry.update(max_abs_err=float((y - yg).abs().max()), max_abs_y=float(yg.abs().max()),
                         aux_err=abs(r0["aux"] - r0["aux_gather"]),
                         drops_gather=r0["drops_gather"])
        out[label] = entry
    f32, bf16 = out["float32_cf8.0"], out["bfloat16_cf8.0"]
    f32["tolerance"] = EXPERT_TOL
    out["seconds"] = seconds
    if not all(e["finite"] and e["ranks_identical"] for k, e in out.items() if k != "seconds"):
        raise AssertionError(f"(a) a rank's output is not finite or differs: {out}")
    if not (f32["max_abs_err"] <= EXPERT_TOL and f32["aux_err"] <= EXPERT_TOL
            and max(f32["drops"]) == 0 and f32["drops_gather"] == 0):
        raise AssertionError(f"(a) float32 a2a against the one-rank gather: {f32}")
    if max(bf16["drops"]) != 0 or bf16["drops_gather"] != 0:
        raise AssertionError(f"(a) bf16 at capacity factor 8.0 dropped: {bf16}")
    return out


def _expert_serve(arch, n_layers, budget_bytes):
    """(b), (c): ``arch`` at full width and ``n_layers`` through the serving
    engine on the 4 ranks (bf16; the config's capacity factor)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.expert import a2a_collectives

    cfg = get_config(arch).with_(n_layers=n_layers, attn_impl="pallas", remat=False)
    over = dict(n_layers=n_layers, attn_impl="pallas", remat=False)
    t0 = time.perf_counter()
    res = run_ranks("repro_torch.launch.expert:serve", EXPERT_WORLD,
                    _expert_payload(arch=arch, cfg=over, **EXPERT_SERVE), timeout_s=EXPERT_LIMIT,
                    env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    seconds = time.perf_counter() - t0
    r0 = res[0]
    n_moe = sum(cfg.is_moe_layer(layer) for layer in range(n_layers))
    mesh = dict(zip(("data", "model"), EXPERT_MESH))
    per_layer = lambda b, s: a2a_collectives(cfg, mesh, EXPERT_RULES, b, s, 2, 2)  # noqa: E731
    counts = _check_ops(arch, res, {"ops": per_layer(1, EXPERT_SERVE["prompt_len"]) * n_moe,
                                    "tick_ops": per_layer(EXPERT_SERVE["slots"], 1) * n_moe})
    prefills = EXPERT_SERVE["requests"]
    out = dict(arch=arch, layers=n_layers, of_layers=get_config(arch).n_layers,
               reckoned_bytes=budget_bytes, seconds=seconds, init_s=[r["init_s"] for r in res],
               first_tokens=r0["first_tokens"], tokens=r0["tokens"],
               ranks_identical=_same_ranks(res, "tokens"), done=all(r["done"] for r in res),
               k2_launches=[r["k2_launches"] for r in res], attn_layers=_n_attn(cfg),
               prefill_ms=[r["prefill_ms"] for r in res],
               tick_ms_p50=[float(np.median(r["tick_ms"])) for r in res],
               drop_rate_prefill=[float(np.mean(r["drops"])) for r in res],
               drop_rate_prefill_by_layer_rank0=r0["drops"],
               max_memory_allocated=[r["max_memory_allocated"] for r in res],
               params_allocated=[r["params_allocated"] for r in res],
               init_peak=[r["init_peak"] for r in res],
               card_free_after_init=[r["card_free_after_init"] for r in res],
               route=r0["route"], collectives=counts)
    if not (out["done"] and out["ranks_identical"]):
        raise AssertionError(f"{arch}: serve incomplete or ranks differ: {out}")
    if any(k != _n_attn(cfg) * prefills for k in out["k2_launches"]):
        raise AssertionError(f"{arch}: K2 launched {out['k2_launches']} times for {prefills} "
                             f"prefills of {_n_attn(cfg)} attention layers")
    return out


def _expert_f32_logits(n_layers=2):
    """(b) moonshot at full width, ``n_layers`` layers, float32, at a
    capacity no rank can overflow (``ceil(E / k)``: ``c_e`` ≥ the local
    tokens, and the gather's capacity ≥ all tokens): every rank's prefill
    logits against the one-rank gather's (rank 0, the same seed)."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks

    arch = "moonshot-v1-16b-a3b"
    cfg = get_config(arch)
    over = dict(n_layers=n_layers, param_dtype="float32", compute_dtype="float32",
                attn_impl="pallas", capacity_factor=float(math.ceil(cfg.n_experts / cfg.top_k)))
    t0 = time.perf_counter()
    res = run_ranks("repro_torch.launch.expert:prefill", EXPERT_WORLD,
                    _expert_payload(arch=arch, cfg=over, tokens_shape=(1, 512), gather=True),
                    timeout_s=EXPERT_LIMIT)
    lg = res[0]["logits_gather"]
    out = dict(layers=n_layers, capacity_factor=over["capacity_factor"],
               seconds=time.perf_counter() - t0,
               max_abs_err=max(float((r["logits"] - lg).abs().max()) for r in res),
               max_abs_logit=float(lg.abs().max()), drops=[max(r["drops"]) for r in res],
               k2_launches=[r["k2_launches"] for r in res], tolerance=EXPERT_TOL)
    if not (out["max_abs_err"] <= EXPERT_TOL and max(out["drops"]) == 0):
        raise AssertionError(f"(b) float32 a2a prefill against the one-rank gather: {out}")
    return out


def phase_expert():
    """Phase 12: the expert-parallel MoE dispatch on 4 ranks of one card."""
    import torch

    _free()
    free, total = torch.cuda.mem_get_info()
    budget = min(EXPERT_BUDGET, free - 2 * 2**30)
    t0 = time.perf_counter()
    out = dict(mesh=EXPERT_MESH, rules=EXPERT_RULES, free_bytes=free, total_bytes=total,
               budget_bytes=budget, nccl=_expert_probe_nccl(), released_s=[])
    out["released_s"].append(_card_released(free))
    out["block"] = _expert_block()
    out["released_s"].append(_card_released(free))
    out["f32"] = _expert_f32_logits()
    for key, arch in (("moe", "moonshot-v1-16b-a3b"), ("phi", "phi3.5-moe-42b-a6.6b")):
        out["released_s"].append(_card_released(free))
        layers, need = _expert_depth(arch, budget)
        out[key] = _expert_serve(arch, layers, need)
    out["phase_s"] = time.perf_counter() - t0
    log("expert", **out)
    return out


# -- phase 13 ------------------------------------------------------------------

# mistral-nemo-12b at full width on 4 ranks of the one card, each holding
# its blocks of every parameter by PARAM_RULES, under the baseline policy's
# activation rules (``launch/dryrun.py::policy_rules`` for a prefill or a
# train cell on a ("data", "model") mesh); gloo, host-staged, as phase 12.
SHARDED_MESHES = ((1, 4), (2, 2))
SHARDED_RULES = {"batch": ("data",), "seq": "model", "vocab": "model"}
SHARDED_PROMPTS = 2               # of phase 6's 512-token prompts
SHARDED_LOSS_SHAPE = (2, 1024)
SHARDED_LIMIT = 600               # seconds for the multi-rank run
# (a) f32 at 2 layers against the one-rank model: the same products cut
# over heads and columns, their partial sums added in another order.
SHARDED_TOL = 1e-4
# (b) bf16 at full depth: the reduce-scatter sums bf16 partial sums in
# another order than one rank's product, so the gate is relative to the
# one-rank bf16 logits' own distance from float32.
SHARDED_BF16_FACTOR = 1.5
# Timed repeats of each step after the counted call; none on (2, 2) in bf16,
# whose prefill and loss each take 15–16 s a rank in gloo, for the script's
# time.
SHARDED_REPS = 1
# (b), (c) at 10 of 40 layers, for the script's time (PERF.md §4): the
# one-rank references at the same depth.
SHARDED_BF16_LAYERS = 10
# (e), (f): decode ticks under ACT_RULES_DECODE (the caches' positions over
# ``model``) after the prefill, into caches of DECODE_S_MAX positions,
# teacher-forced with the one-rank model's greedy tokens; then one tick on
# a cache of decode_32k's length drawn from a seed
# (``launch/sharded.py::seeded_caches``), its 128 rows cut to 4 by the
# memory reckoning in PERF.md, at a position in the last rank's block with
# every earlier block full.  Decode on (2, 2) runs at 2 layers only: its
# weight gathers over ``data`` at 40 layers move about 6.1 GB a tick
# through host memory.  (e) holds SHARDED_TOL against the one-rank model,
# (f) SHARDED_BF16_FACTOR against the float32 reference.
DECODE_S_MAX = 1024
DECODE_TICKS = dict(f32=1, bf16=4)     # for the script's time (PERF.md §4; f32 2 → 1)
LONG = dict(b=4, s_max=32768, pos=32000, seed=SEED + 23)


def _sharded_references(cfg, prompts, loss_tokens, long_token, dev):
    """The one-rank model on the card, the parameters from SEED: (a) f32 at
    2 layers, the prefill logits and the loss of the prompts; (b) bf16 at
    full depth, the prefill logits on K2 and in float32 throughout; (c)
    the loss of ``loss_tokens`` in bf16 on K2 and in float32; (e), (f)
    after each prefill (at DECODE_S_MAX) DECODE_TICKS greedy ticks — the
    tokens fed and each tick's logits — and the long tick on LONG's
    seeded caches; for (f) both in float32 throughout too."""
    import torch

    from repro_torch.launch.sharded import seeded_caches
    from repro_torch.models.model import Model

    out = {}
    cfg2 = cfg.with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    for key, c in (("f32", cfg2), ("bf16", cfg)):
        model = Model(c)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        tok = torch.as_tensor(prompts, device=dev).long()
        with torch.no_grad():
            logits, caches = model.prefill(params, {"tokens": tok}, DECODE_S_MAX)
            fed, ticks, last = [], [], logits
            for t in range(DECODE_TICKS[key]):
                fed.append(last.argmax(-1)[:, None])
                last, caches = model.decode(params, fed[-1], prompts.shape[1] + t, caches)
                ticks.append(last.float().cpu())
            del caches
            loss_tok = prompts if key == "f32" else loss_tokens
            loss, _ = model.loss(params, {"tokens": torch.as_tensor(loss_tok, device=dev).long()})
            long_caches = seeded_caches(model, LONG["b"], LONG["s_max"], LONG["seed"], dev)
            long = model.decode(params, torch.as_tensor(long_token, device=dev).long(),
                                LONG["pos"], long_caches)[0]
            del long_caches
        fed = torch.cat(fed, 1).cpu().numpy()
        out[key] = dict(logits=logits.float().cpu(), loss=float(loss), fed=fed,
                        ticks=torch.stack(ticks), long=long.float().cpu())
        if key == "bf16":
            out[key]["logits_f32"] = _prefill_logits_f32(cfg, params, prompts, dev).cpu()
            out[key]["loss_f32"] = _loss_f32(cfg, params, loss_tokens, dev)
            out[key]["ticks_f32"] = _ticks_f32(cfg, params, prompts, fed, dev).cpu()
            out[key]["long_f32"] = _seeded_tick_f32(cfg, params, long_token, LONG, dev).cpu()
        del params
        _free()
    return out


def _dense_loss_bound(one_rank_dist):
    """Phase 13's bound on a sharded bf16 loss's distance from float32:
    twice one rank's distance, or 1e-3 where that is smaller (a mean over
    thousands of positions of bf16 sums in another order)."""
    return max(1e-3, 2 * one_rank_dist)


def _ticks_f32(cfg, params, prompts, fed, dev):
    """Teacher-forced ticks in float32 throughout: the logits at the fed
    tokens' positions of one causal pass over the prompts and the fed
    tokens (:func:`_f32_forward`) → ``[ticks, B, V]``."""
    import torch

    model, head, x = _f32_forward(cfg, params, np.concatenate([prompts, fed], 1), dev)
    with torch.no_grad():
        return model._head(head, x[:, prompts.shape[1]:]).transpose(0, 1)


def _seeded_tick_f32(cfg, params, token, spec, dev):
    """One tick in float32 throughout on the caches ``spec`` draws
    (:func:`_seeded_ticks_f32`) → ``[B, V]``."""
    return _seeded_ticks_f32(cfg, params, token, spec, dev)[0]


def _seeded_ticks_f32(cfg, params, tokens, spec, dev):
    """Chained ticks of ``tokens`` ``[B, n]`` from ``spec["pos"]`` in
    float32 throughout on the caches ``spec`` (``b``, ``s_max``, ``pos``,
    ``seed``) draws, layer by layer (a hybrid's periods slot by slot): each
    layer's bf16 weights upcast, its cache slabs drawn from the seed
    (``launch/sharded.py::cache_slab``, by absolute layer), rounded to the
    dtype the ranks hold them in and upcast, the n ticks run through the
    layer in turn, and the slabs dropped after it; the whole float32 cache
    is never held → ``[n, B, V]``."""
    import torch

    from repro_torch.launch.sharded import cache_dtype, cache_slab
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model

    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32", attn_impl="xla")
    model = Model(cfg32)
    n_units, slots = tf._units(cfg)
    tokens = np.asarray(tokens)
    with torch.no_grad():
        x = params["embed"][torch.as_tensor(tokens, device=dev).long()].float()
        ropes = [model._rope(torch.tensor([spec["pos"] + t], device=dev))
                 for t in range(tokens.shape[1])]
        for ui in range(n_units):
            up = tf._index_tree(params["stack"], ui)
            for si, (key, mixer, ffn) in enumerate(slots):
                lp = _up(up if key is None else up[key])
                decls = tf._mixer_cache_defs(cfg, mixer, spec["b"], spec["s_max"])
                cache = {w: cache_slab(cfg, spec["b"], spec["s_max"], spec["seed"],
                                       ui * len(slots) + si, w, dev)
                         .to(cache_dtype(cfg, decl)).float() for w, decl in decls.items()}
                x = torch.cat([tf._apply_layer_decode(lp, x[:, t:t + 1], cfg32, ropes[t], mixer,
                                                      ffn, cache, spec["pos"] + t)
                               for t in range(tokens.shape[1])], 1)
                del cache, lp
        return model._head(_up(_head_params(cfg, params)), x).transpose(0, 1)


def _sharded_decode(ranks, case, ccfg, mesh, ref, label, fails):
    """(e)/(f)/(g) of one case's decode entries → its report."""
    import torch

    from repro_torch.distributed.sharding import decode_rules
    from repro_torch.launch.expert import report_of
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharded import assemble_tick

    err = lambda a, c: float((a - c).abs().max())  # noqa: E731
    key = "bf16" if ccfg.compute_dtype == "bfloat16" else "f32"
    rules = decode_rules(Mesh(tuple(mesh), tuple(mesh.values())))
    size = 2 if key == "bf16" else 4
    v, out = ccfg.vocab_size, {}
    for j, (name, entry) in enumerate(zip(("ticks", "long"), case["decode"])):
        b = entry["tokens"].shape[0]
        s_max = entry.get("s_max", DECODE_S_MAX)
        want = _formula(ccfg, mesh, rules, b, 1, size, size, "decode", s_max=s_max)
        if any(ops != want for r in ranks for ops in r["decode"][j]["ops"]):
            fails.append(f"(g) {label} decode {name}: a rank's ops differ from the formula")
        refs = ref[key][name] if name == "long" else ref[key]["ticks"]
        refs = refs[None] if name == "long" else refs
        n = len(ranks[0]["decode"][j]["ms"])
        got = [assemble_tick(ranks, j, t, b, v) for t in range(n)]
        rep = dict(
            pos=ranks[0]["decode"][j]["pos"], s_max=s_max, batch=b,
            ms=[r["decode"][j]["ms"] for r in ranks],
            kv=[r["decode"][j]["kv"] for r in ranks],
            collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
            max_memory_allocated=[r["decode"][j]["max_memory_allocated"] for r in ranks],
            k3_launches=[r["decode"][j]["k3_launches"] for r in ranks],
            staging_s=[r["decode"][j]["staging_s"] for r in ranks],
            finite=all(bool(torch.isfinite(g).all()) for g in got))
        picks = [torch.empty(b, dtype=torch.long) for _ in range(n)]
        for r in ranks:
            r0, r1 = r["decode"][j]["rows"]
            for t in range(n):
                picks[t][r0:r1] = r["decode"][j]["tokens"][t]
        if key == "f32":
            rep.update(errs=[err(g, w) for g, w in zip(got, refs)], tolerance=SHARDED_TOL)
            if not max(rep["errs"]) <= SHARDED_TOL:
                fails.append(f"(e) {label} decode {name}: {rep['errs']} against one rank")
        else:
            f32 = ref[key]["long_f32"][None] if name == "long" else ref[key]["ticks_f32"]
            rep.update(ranks_vs_f32=[err(g, w) for g, w in zip(got, f32)],
                       one_rank_vs_f32=[err(o, w) for o, w in zip(refs, f32)],
                       ranks_vs_one_rank=[err(g, o) for g, o in zip(got, refs)],
                       bound_factor=SHARDED_BF16_FACTOR)
            if any(a > SHARDED_BF16_FACTOR * o for a, o in zip(rep["ranks_vs_f32"],
                                                               rep["one_rank_vs_f32"])):
                fails.append(f"(f) {label} decode {name}: {rep['ranks_vs_f32']} from float32 "
                             f"against one rank's {rep['one_rank_vs_f32']}")
        whole = [g.argmax(-1) for g in got]
        rep["greedy_equal_assembled"] = all(torch.equal(p, w) for p, w in zip(picks, whole))
        rep["greedy_shared_with_one_rank"] = sum(
            int((w == o.argmax(-1)).sum()) for w, o in zip(whole, refs))
        rep["greedy_of"] = sum(int(w.numel()) for w in whole)
        if not rep["finite"] or any(k != 0 for k in rep["k3_launches"]):
            fails.append(f"{label} decode {name}: finite {rep['finite']}, K3 launched "
                         f"{rep['k3_launches']}")
        out[name] = rep
    return out


def phase_sharded(free_before):
    """Phase 13: mistral-nemo-12b sharded over 4 ranks of one card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.expert import report_of
    from repro_torch.launch.serve import make_requests
    from repro_torch.launch.sharded import assemble_logits

    t0 = time.perf_counter()
    released = [_card_released(free_before)]
    cuda = torch.device("cuda", 0)
    cfg = get_config(SERVE["arch"]).with_(attn_impl="pallas", remat=False,
                                          n_layers=SHARDED_BF16_LAYERS)
    prompts = np.stack([r.prompt for r in make_requests(cfg, SHARDED_PROMPTS,
                                                        SERVE["prompt_len"], 1, SEED)])
    loss_tokens = np.random.default_rng(SEED + 13).integers(0, cfg.vocab_size,
                                                            SHARDED_LOSS_SHAPE)
    long_token = np.random.default_rng(SEED + 29).integers(0, cfg.vocab_size, (LONG["b"], 1))
    ref = _sharded_references(cfg, prompts, loss_tokens, long_token, cuda)
    ref_s = time.perf_counter() - t0
    released.append(_card_released(free_before))

    f32 = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
    full = dict(attn_impl="pallas", remat=False, n_layers=SHARDED_BF16_LAYERS)
    long = dict(tokens=long_token, seed=LONG["seed"], s_max=LONG["s_max"], pos=LONG["pos"])
    cases = []
    for mesh in SHARDED_MESHES:
        cases.append(dict(mesh=mesh, cfg=dict(full, **f32),
                          prefill=dict(tokens=prompts, s_max=DECODE_S_MAX),
                          decode=[dict(tokens=ref["f32"]["fed"]), long],
                          loss=dict(tokens=prompts)))
    for mesh in SHARDED_MESHES:
        reps = SHARDED_REPS if mesh == (1, 4) else 0
        case = dict(mesh=mesh, cfg=full, prefill=dict(tokens=prompts, s_max=DECODE_S_MAX,
                                                      reps=reps))
        if mesh == (1, 4):
            case["decode"] = [dict(tokens=ref["bf16"]["fed"]), long]
        if mesh == (2, 2):
            case["loss"] = dict(tokens=loss_tokens, reps=reps)
        cases.append(case)
    t1 = time.perf_counter()
    res = run_ranks("repro_torch.launch.sharded:run", 4,
                    dict(device="cuda:0", arch=SERVE["arch"], rules=SHARDED_RULES, seed=SEED,
                         cases=cases), timeout_s=SHARDED_LIMIT,
                    env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t1

    b, v = prompts.shape[0], cfg.vocab_size
    err = lambda a, c: float((a - c).abs().max())  # noqa: E731
    out = dict(rules=SHARDED_RULES, prompts=list(prompts.shape), loss_shape=SHARDED_LOSS_SHAPE,
               decode=dict(s_max=DECODE_S_MAX, ticks=DECODE_TICKS, long=LONG),
               reference_s=ref_s, ranks_s=ranks_s, released_s=released,
               bf16_layers=SHARDED_BF16_LAYERS,
               reference_losses=dict(f32_2_layers=ref["f32"]["loss"],
                                     bf16=ref["bf16"]["loss"], f32=ref["bf16"]["loss_f32"]))
    fails = []
    for i, case in enumerate(cases):
        ranks = [r[i] for r in res]
        mesh = dict(zip(("data", "model"), case["mesh"]))
        depth = "f32_2_layers" if "compute_dtype" in case["cfg"] else "bf16"
        label = f"{depth}_{case['mesh'][0]}x{case['mesh'][1]}"
        ccfg = cfg.with_(**case["cfg"])
        size = 4 if depth != "bf16" else 2
        logits = assemble_logits(ranks, b, v)
        k2 = [r["prefill"]["k2_launches"] for r in ranks]
        want = {step: _formula(ccfg, mesh, SHARDED_RULES, *case[step]["tokens"].shape,
                               size, size, step, s_max=DECODE_S_MAX)
                for step in ("prefill", "loss") if step in case}
        for step, ops in want.items():
            if any(r[step]["ops"] != ops for r in ranks):
                fails.append(f"(d) {label} {step}: a rank's ops differ from the formula")
        entry = dict(
            k2_launches=k2,
            collectives={step: dict(count=len(ops), wire_bytes=report_of(ops).by_kind())
                         for step, ops in want.items()},
            prefill_ms=[r["prefill"]["ms"] for r in ranks],
            prefill_staging_s=[r["prefill"]["staging_s"] for r in ranks],
            init_s=[r["init_s"] for r in ranks],
            params_allocated=[r["params_allocated"] for r in ranks],
            max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
            kv_heads=[r["kv_heads"] for r in ranks], route=ranks[0]["route"],
            finite=bool(torch.isfinite(logits).all()))
        if "loss" in case:
            entry.update(losses=[r["loss"]["loss"] for r in ranks],
                         loss_ms=[r["loss"]["ms"] for r in ranks],
                         loss_staging_s=[r["loss"]["staging_s"] for r in ranks])
        if depth != "bf16":
            entry.update(logits_err=err(logits, ref["f32"]["logits"]),
                         loss_err=max(abs(r["loss"]["loss"] - ref["f32"]["loss"]) for r in ranks),
                         tolerance=SHARDED_TOL)
            if not (entry["logits_err"] <= SHARDED_TOL and entry["loss_err"] <= SHARDED_TOL):
                fails.append(f"(a) {label}: logits {entry['logits_err']}, loss "
                             f"{entry['loss_err']} against one rank")
        else:
            l32, l16 = ref["bf16"]["logits_f32"], ref["bf16"]["logits"]
            entry.update(ranks_vs_f32=err(logits, l32), one_rank_vs_f32=err(l16, l32),
                         ranks_vs_one_rank=err(logits, l16), max_abs_logit=float(l32.abs().max()),
                         first_tokens=logits.argmax(-1).tolist(),
                         first_tokens_one_rank=l16.argmax(-1).tolist())
            if not entry["ranks_vs_f32"] <= SHARDED_BF16_FACTOR * entry["one_rank_vs_f32"]:
                fails.append(f"(b) {label}: {entry['ranks_vs_f32']} from float32 against "
                             f"one rank's {entry['one_rank_vs_f32']}")
            if entry["first_tokens"] != entry["first_tokens_one_rank"]:
                fails.append(f"(b) {label}: first tokens {entry['first_tokens']}")
            if "loss" in case:
                d32 = ref["bf16"]["loss_f32"]
                dist = max(abs(r["loss"]["loss"] - d32) for r in ranks)
                bound = _dense_loss_bound(abs(ref["bf16"]["loss"] - d32))
                entry.update(loss_vs_f32=dist, loss_bound=bound)
                if not dist <= bound:
                    fails.append(f"(c) {label}: loss {dist} from float32, bound {bound}")
        if any(k != ccfg.n_layers for k in k2) or not entry["finite"]:
            fails.append(f"{label}: K2 launched {k2} times a prefill of {ccfg.n_layers} layers, "
                         f"finite {entry['finite']}")
        if "decode" in case:
            entry["decode"] = _sharded_decode(ranks, case, ccfg, mesh, ref, label, fails)
        out[label] = entry
    out["phase_s"] = time.perf_counter() - t0
    log("sharded", **out)
    if fails:
        raise AssertionError(f"phase 13: {fails}")
    return out


# -- phase 14 ------------------------------------------------------------------

# mistral-nemo-12b's train step at full width on 4 ranks of the one card
# (``launch/sharded.py``'s "train" entry, gloo, host-staged, as phases 12
# and 13), the rules from ``launch/dryrun.py::policy_rules`` of each mesh's
# policy: (2, 2) under the baseline, (1, 4) under ``opt``, which at 12.2 G
# parameters gives ACT_RULES_TRAIN_OPT.  Depth by the memory reckoning in
# PERF.md's findings: with the step donating its parameters and optimizer
# state, a rank holds about 16 B for each of its (L·272 M + 1.34 G) / 4
# elements (bf16 parameters and a microbatch's gradient, f32 accumulation,
# m and v), 11.9 GB at 6 layers, and the one-rank comparison 47.6 GB; 4
# layers for the script's time (a (2, 2) bf16 step took 27–34 s a rank at
# 6).
TRAIN_MESHES = (((2, 2), "baseline"), ((1, 4), "opt"))
TRAIN_SHAPE = (4, 1024)           # the batch
TRAIN_ACCUM = dict(f32=1, bf16=2)  # microbatches; f32 1 for the script's time (PERF.md §4)
TRAIN_LAYERS = dict(bf16=2, f32=1)     # for the script's time (PERF.md §4; f32 2 → 1)
TRAIN_STEPS = dict(f32=1, bf16=1)      # for the script's time (PERF.md §4)
TRAIN_EVAL_SHAPE = (2, 512)       # the eval through K2 after the bf16 steps
TRAIN_LIMIT = 900                 # seconds for the multi-rank run
# Gates, fixed before the first run.  f32 at 2 layers against the one-rank
# step: the same sums cut over heads, columns and ranks, added in another
# order: the loss within TRAIN_TOL, the grad norm within TRAIN_TOL of
# itself, every leaf of m within TRAIN_M_REL of the leaf's largest |m|.
TRAIN_TOL = 1e-4
TRAIN_M_REL = 1e-3
# bf16 at 4 layers: the ranks sum bf16 gradient shares in another order
# than one rank's products: each step's loss within TRAIN_BF16_LOSS, its
# grad norm within TRAIN_BF16_NORM of itself; the eval through K2 on the
# updated shards within TRAIN_BF16_LOSS of the one-rank model's.
TRAIN_BF16_LOSS = 1e-2
TRAIN_BF16_NORM = 2e-2


def _train_reference(cfg, tokens, eval_tokens, steps, accum, dev, extra=None):
    """The one-rank train step on the card from SEED's parameters, donated
    as the ranks' are → losses, grad norms, the final state's m (on the
    card) and, with ``eval_tokens``, the eval loss through K2 on the
    updated parameters; seconds.  ``extra``: the batch's other inputs
    (numpy: vision embeddings, frames)."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, warmup_cosine

    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100_000))
    state = opt.init(params)
    step = make_train_step(model, opt, accum=accum, donate=True)
    batch = {"tokens": torch.as_tensor(tokens, device=dev).long(),
             **{k: torch.as_tensor(v, device=dev) for k, v in (extra or {}).items()}}
    out = dict(loss=[], grad_norm=[])
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        params, state, metrics = step(params, state, batch)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if eval_tokens is not None:
        del state
        ev = Model(cfg.with_(attn_impl="pallas"))
        with torch.no_grad():
            loss, _ = ev.loss(params, {"tokens": torch.as_tensor(eval_tokens, device=dev).long()})
        out["eval_loss"] = float(loss)
    else:
        out["m"] = state.m
    del params
    out["seconds"] = time.perf_counter() - t0
    return out


def _m_errors(ranks, mesh_shape, m_ref, param_rules, cfg):
    """Per leaf, the largest |error| of any rank's block of m against its
    block of the one-rank ``m_ref`` (on the card), over the leaf's largest
    |m|."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten

    axes = Model(cfg).axes()
    out = {}
    for rank, r in enumerate(ranks):
        mesh = Mesh(("data", "model"), mesh_shape, None, rank, {})
        want = dict(flatten(shard_params(m_ref, axes, mesh, mesh.coords, param_rules)))
        for path, got in flatten(r["train"]["m"]):
            ref = want[path]
            err = float((got.to(ref.device) - ref).abs().max()) / max(float(ref.abs().max()),
                                                                      1e-30)
            out["/".join(path)] = max(out.get("/".join(path), 0.0), err)
    return out


def phase_sharded_train(free_before):
    """Phase 14: mistral-nemo-12b's train step sharded over 4 ranks of one
    card."""
    import torch

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.expert import report_of

    t0 = time.perf_counter()
    released = [_card_released(free_before)]
    cuda = torch.device("cuda", 0)
    arch = SERVE["arch"]
    cfg = get_config(arch)
    rng = np.random.default_rng(SEED + 14)
    tokens = rng.integers(0, cfg.vocab_size, TRAIN_SHAPE)
    eval_tokens = rng.integers(0, cfg.vocab_size, TRAIN_EVAL_SHAPE)
    dense = {a: get_config(a).param_count() for a in ARCH_NAMES
             if get_config(a).family == "dense"}
    depth = {k: dict(n_layers=n) for k, n in TRAIN_LAYERS.items()}
    depth["f32"].update(param_dtype="float32", compute_dtype="float32")
    cases = []
    for key in ("f32", "bf16"):
        for mesh, policy in TRAIN_MESHES:
            case = dict(mesh=mesh, policy=policy, cfg=depth[key],
                        train=dict(tokens=tokens, accum=TRAIN_ACCUM[key], steps=TRAIN_STEPS[key],
                                   host=("m",) if key == "f32" else ()))
            if key == "bf16":
                case["loss"] = dict(tokens=eval_tokens, cfg=dict(attn_impl="pallas"))
            cases.append(case)
    t1 = time.perf_counter()
    res = run_ranks("repro_torch.launch.sharded:run", 4,
                    dict(device="cuda:0", arch=arch, seed=SEED, cases=cases),
                    timeout_s=TRAIN_LIMIT,
                    env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t1
    released.append(_card_released(free_before))

    out = dict(arch=arch, batch=list(TRAIN_SHAPE), accum=TRAIN_ACCUM, layers=TRAIN_LAYERS,
               steps=TRAIN_STEPS, eval_batch=list(TRAIN_EVAL_SHAPE), ranks_s=ranks_s,
               small_dp=("held on the CPU only (tests/test_torch_sharded_train.py): every "
                         "full-width dense config has at least 2e8 parameters, so opt "
                         "never gives small-DP at full width"),
               dense_param_counts=dense)
    fails = []
    refs = {}
    for key in ("f32", "bf16"):
        c = cfg.with_(**depth[key])
        refs[key] = _train_reference(c, tokens, eval_tokens if key == "bf16" else None,
                                     TRAIN_STEPS[key], TRAIN_ACCUM[key], cuda)
        for i, case in enumerate(cases):
            if case["cfg"] is not depth[key]:
                continue
            ranks = [r[i] for r in res]
            label = f"{key}_{case['mesh'][0]}x{case['mesh'][1]}_{case['policy']}"
            mesh_shape = dict(zip(("data", "model"), case["mesh"]))
            r0 = ranks[0]
            size = 4 if key == "f32" else 2
            want = _formula(c, mesh_shape, r0["rules"], *TRAIN_SHAPE, size, size,
                            "train", TRAIN_ACCUM[key], r0["param_rules"])
            if any(r["train"]["ops"] != want for r in ranks):
                fails.append(f"{label}: a rank's train ops differ from the formula")
            entry = dict(
                rules=r0["rules"], param_rules=r0["param_rules"],
                losses=[r["train"]["loss"] for r in ranks],
                grad_norms=[r["train"]["grad_norm"] for r in ranks],
                one_rank=dict(loss=refs[key]["loss"], grad_norm=refs[key]["grad_norm"],
                              max_memory_allocated=refs[key]["max_memory_allocated"],
                              seconds=refs[key]["seconds"]),
                step_ms=[r["train"]["ms"] for r in ranks],
                train_k2_launches=[r["train"]["k2_launches"] for r in ranks],
                collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
                init_s=[r["init_s"] for r in ranks],
                params_allocated=[r["params_allocated"] for r in ranks],
                max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
                route=r0["route"])
            loss_err = max(abs(a - b) for r in ranks
                           for a, b in zip(r["train"]["loss"], refs[key]["loss"]))
            norm_err = max(abs(a - b) / b for r in ranks
                           for a, b in zip(r["train"]["grad_norm"], refs[key]["grad_norm"]))
            entry.update(loss_err=loss_err, grad_norm_rel_err=norm_err)
            finite = all(np.isfinite(r["train"]["loss"] + r["train"]["grad_norm"]).all()
                         for r in ranks)
            if any(r["train"]["k2_launches"] for r in ranks):
                fails.append(f"{label}: K2 launched {entry['train_k2_launches']} times in the "
                             f"train steps, which take the chunked attention")
            if key == "f32":
                m_err = _m_errors(ranks, case["mesh"], refs[key]["m"], r0["param_rules"], c)
                entry.update(m_rel_err=m_err, tolerance=dict(loss=TRAIN_TOL, grad_norm=TRAIN_TOL,
                                                            m=TRAIN_M_REL))
                if not (loss_err <= TRAIN_TOL and norm_err <= TRAIN_TOL
                        and max(m_err.values()) <= TRAIN_M_REL and finite):
                    fails.append(f"(a) {label}: loss {loss_err}, grad norm {norm_err}, m "
                                 f"{max(m_err.values())} against one rank")
            else:
                ev = [r["loss"]["loss"] for r in ranks]
                k2 = [r["loss"]["k2_launches"] for r in ranks]
                eval_err = max(abs(e - refs[key]["eval_loss"]) for e in ev)
                want_ev = _formula(c, mesh_shape, r0["rules"], *TRAIN_EVAL_SHAPE,
                                   size, size, "loss", 1, r0["param_rules"])
                if any(r["loss"]["ops"] != want_ev for r in ranks):
                    fails.append(f"{label}: a rank's eval ops differ from the formula")
                entry.update(eval_losses=ev, eval_one_rank=refs[key]["eval_loss"],
                             eval_err=eval_err, eval_ms=[r["loss"]["ms"] for r in ranks],
                             k2_launches=k2,
                             tolerance=dict(loss=TRAIN_BF16_LOSS, grad_norm=TRAIN_BF16_NORM))
                if not (loss_err <= TRAIN_BF16_LOSS and norm_err <= TRAIN_BF16_NORM
                        and eval_err <= TRAIN_BF16_LOSS and finite):
                    fails.append(f"(b) {label}: loss {loss_err}, grad norm {norm_err}, eval "
                                 f"{eval_err} against one rank")
                if any(k != c.n_layers for k in k2):
                    fails.append(f"(b) {label}: K2 launched {k2} times an eval of "
                                 f"{c.n_layers} layers")
            out[label] = entry
        refs[key].pop("m", None)
        _free()
    out["phase_s"] = time.perf_counter() - t0
    out["released_s"] = released
    log("sharded_train", **out)
    if fails:
        raise AssertionError(f"phase 14: {fails}")
    return out


# -- phase 15 ------------------------------------------------------------------

# falcon-mamba-7b sharded over 4 ranks of the one card (``launch/sharded.py``;
# gloo, host-staged, as phases 12–14): each layer's mamba block on the rank's
# block of d_inner (``d_inner`` over ``model`` under PARAM_RULES and
# ACT_RULES_DECODE), the tied head on the embedding's vocab-parallel block.
# (a) f32 at 2 layers on (1, 4) and (2, 2): the prefill of phase 6's prompt
# shape (2 × 512, falcon's vocabulary), the loss of SSM["loss"], the
# prefill's states handed to SSM["ticks"]["f32"] ticks forced with one
# rank's greedy tokens, and on (2, 2) a train step (accum 2) under
# the baseline; (b) bf16 at SSM["bf16_layers"] of 64 layers on (1, 4): the
# prefill against float32, the eval through K4 on each rank's 2 048
# channels (and the same eval in float32), 4 ticks, one
# tick at decode_32k's shape (B 128) and one at long_500k's (B 1, pos
# 524 287), each on states drawn from a seed (``seeded_caches``); (c) a bf16
# train step on (1, 4) under ``opt`` (ACT_RULES_TRAIN_OPT at 7.0 G
# parameters) at SSM["train_layers"] (the memory reckoning and the script's
# time, PERF.md: 8 layers took 17–18 s a rank on the ranks).  No (2, 2) bf16 run at 64 layers: its weight gathers over
# ``data`` would move about 3.5 GB a rank a pass through host memory.  (b)
# and its float32 eval at 16 of 64 layers, for the script's time (PERF.md
# §4); (c) one step (was 2), for phase 18's time.
SSM = dict(arch="falcon-mamba-7b", meshes=((1, 4), (2, 2)), prompts=2, prompt_len=512,
           loss=(2, 1024), ticks=dict(f32=2, bf16=4), train=(4, 1024), accum=2,
           steps=dict(f32=1, bf16=1), train_layers=4, bf16_layers=16, limit=900)
SSM_SEEDED = dict(decode_32k=dict(b=128, s_max=0, pos=32_000, seed=SEED + 41),
                  long_500k=dict(b=1, s_max=0, pos=524_287, seed=SEED + 43))
# (e) K4 at the ranks' shapes: d_in 8 192 over model 4 and 2.
SSM_K4_SHAPES = [(2, 1024, 2048, 16), (2, 1024, 4096, 16)]
# Gates, fixed before the first run: (a) f32 against one rank within
# SHARDED_TOL; the train step's as phase 14's (a).  (b) bf16: the prefill's
# logits and each tick no farther from float32 than SHARDED_BF16_FACTOR ×
# the one-rank bf16 distance, the first tokens equal; K4 launched once a
# layer on each rank.  (c) as phase 14's (b): loss within TRAIN_BF16_LOSS,
# grad norm TRAIN_BF16_NORM.  The eval's closeness is gated in float32 at
# full depth: the ranks' loss through K4 within SHARDED_TOL of one rank's
# time loop (SSM_EVAL_F32).  The bf16 eval's distance from one rank's time
# loop is reported, not gated: its first two runs were 1.52e-3 and 1.72e-3
# against a bound of 1e-3, and tests/ssm_rounding_probe.py shows any
# reordering of the bf16 sums (K4 against the loop, blocks of d_inner)
# moving this 64-layer loss by up to 1.8e-3, either way (PERF.md).
SSM_EVAL_F32 = dict(param_dtype="float32", compute_dtype="float32")


def _ssm_references(cfg, prompts, loss_tokens, seeded_tokens, dev):
    """The one-rank model on the card, the parameters from SEED: (a) f32 at
    2 layers, the prefill logits, SSM["ticks"]["f32"] greedy ticks (tokens
    fed and logits) and the loss; (b) bf16 at full depth, the prefill
    logits, 8 greedy ticks, the loss through the time loop and a tick on
    each of SSM_SEEDED's states, each also in float32 throughout, and the
    loss through K4; float32 parameters at full depth, the loss through the
    time loop."""
    import torch

    from repro_torch.launch.sharded import seeded_caches
    from repro_torch.models.model import Model

    out = {}
    cfg2 = cfg.with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    for key, c in (("f32", cfg2), ("bf16", cfg)):
        model = Model(c)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        with torch.no_grad():
            logits, caches = model.prefill(params, {"tokens": torch.as_tensor(prompts, device=dev)
                                                    .long()}, prompts.shape[1])
            fed, ticks, last = [], [], logits
            for t in range(SSM["ticks"][key]):
                fed.append(last.argmax(-1)[:, None])
                last, caches = model.decode(params, fed[-1], prompts.shape[1] + t, caches)
                ticks.append(last.float().cpu())
            del caches
            loss, _ = model.loss(params, {"tokens": torch.as_tensor(loss_tokens, device=dev)
                                          .long()})
        fed = torch.cat(fed, 1).cpu().numpy()
        out[key] = dict(logits=logits.float().cpu(), loss=float(loss), fed=fed,
                        ticks=torch.stack(ticks))
        if key == "bf16":
            for name, spec in SSM_SEEDED.items():
                tok = torch.as_tensor(seeded_tokens[name], device=dev).long()
                with torch.no_grad():
                    caches = seeded_caches(model, spec["b"], 0, spec["seed"], dev)
                    out[key][name] = model.decode(params, tok, spec["pos"], caches)[0].float().cpu()
                del caches
                out[key][name + "_f32"] = _seeded_tick_f32(cfg, params, seeded_tokens[name],
                                                           spec, dev).cpu()
            out[key]["logits_f32"] = _prefill_logits_f32(cfg, params, prompts, dev).cpu()
            out[key]["ticks_f32"] = _ticks_f32(cfg, params, prompts, fed, dev).cpu()
            batch = {"tokens": torch.as_tensor(loss_tokens, device=dev).long()}
            with torch.no_grad():
                k4 = Model(c.with_(ssm_impl="pallas")).loss(params, batch)[0]
            out[key]["loss_k4"] = float(k4)
            out[key]["loss_f32"] = _loss_f32(cfg, params, loss_tokens, dev)
        del params
        _free()
    model = Model(cfg.with_(**SSM_EVAL_F32))
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    with torch.no_grad():
        loss, _ = model.loss(params, {"tokens": torch.as_tensor(loss_tokens, device=dev).long()})
    out["eval_f32"] = float(loss)
    del params
    _free()
    return out


def _ssm_k4(cuda):
    """(e): K4 against its plain version at the ranks' shapes, and its time
    beside the plain version's and its bound."""
    import torch

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 47)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)  # > 50 MB L2
    out = {}
    for b, s, d_in, n in SSM_K4_SHAPES:
        inputs = _scan_inputs(rng, b, s, d_in, n, cuda)
        err = float((ops.mamba_scan(*inputs) - ref.mamba_scan_ref(*inputs)).abs().max())
        out[d_in] = dict(shape=dict(B=b, S=s, d_in=d_in, N=n), max_abs_err=err,
                         tolerance=SCAN_TOL,
                         ms=_time_ms(lambda: ops.mamba_scan(*inputs), flush=flush),
                         plain_ms=_time_ms(lambda: ref.mamba_scan_ref(*inputs), reps=5,
                                           flush=flush),
                         library_ms=None, **_k4_bound(b, s, d_in, n))
        del inputs
    return out


def _ssm_serve_checks(ranks, case, ccfg, ref, label, fails):
    """(a)/(b)/(d)/(f) of a prefill, decode and loss case → its report."""
    import torch

    from repro_torch.distributed.sharding import decode_rules
    from repro_torch.launch.expert import report_of
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharded import assemble_logits, assemble_tick

    err = lambda a, c: float((a - c).abs().max())  # noqa: E731
    key = "bf16" if ccfg.compute_dtype == "bfloat16" else "f32"
    size = 2 if key == "bf16" else 4
    mesh = dict(zip(("data", "model"), case["mesh"]))
    rules = ranks[0]["rules"]
    b, v = case["prefill"]["tokens"].shape[0], ccfg.vocab_size
    want = {step: _formula(ccfg, mesh, rules, *case[step]["tokens"].shape, size,
                           size, step, param_rules=ranks[0]["param_rules"])
            for step in ("prefill", "loss")}
    for step, ops in want.items():
        if any(r[step]["ops"] != ops for r in ranks):
            fails.append(f"(d) {label} {step}: a rank's ops differ from the formula")
    logits = assemble_logits(ranks, b, v)
    out = dict(
        collectives={step: dict(count=len(ops), wire_bytes=report_of(ops).by_kind())
                     for step, ops in want.items()},
        prefill_ms=[r["prefill"]["ms"] for r in ranks],
        prefill_staging_s=[r["prefill"]["staging_s"] for r in ranks],
        loss_ms=[r["loss"]["ms"] for r in ranks],
        loss_staging_s=[r["loss"]["staging_s"] for r in ranks],
        losses=[r["loss"]["loss"] for r in ranks],
        k4_launches=[r["loss"]["k4_launches"] for r in ranks],
        prefill_k4_launches=[r["prefill"]["k4_launches"] for r in ranks],
        init_s=[r["init_s"] for r in ranks],
        params_allocated=[r["params_allocated"] for r in ranks],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
        state_block=[tuple(r["prefill"]["caches"]["h"].shape) for r in ranks],
        finite=bool(torch.isfinite(logits).all()) and all(np.isfinite(r["loss"]["loss"])
                                                          for r in ranks))
    if key == "f32":
        out.update(logits_err=err(logits, ref["f32"]["logits"]),
                   loss_err=max(abs(r["loss"]["loss"] - ref["f32"]["loss"]) for r in ranks),
                   tolerance=SHARDED_TOL)
        if not (out["logits_err"] <= SHARDED_TOL and out["loss_err"] <= SHARDED_TOL):
            fails.append(f"(a) {label}: logits {out['logits_err']}, loss {out['loss_err']}")
    else:
        l32, l16 = ref["bf16"]["logits_f32"], ref["bf16"]["logits"]
        out.update(ranks_vs_f32=err(logits, l32), one_rank_vs_f32=err(l16, l32),
                   ranks_vs_one_rank=err(logits, l16), first_tokens=logits.argmax(-1).tolist(),
                   first_tokens_one_rank=l16.argmax(-1).tolist(),
                   eval_one_rank_loop=ref["bf16"]["loss"], eval_one_rank_k4=ref["bf16"]["loss_k4"],
                   eval_float32=ref["bf16"]["loss_f32"])
        loop, k4, f32 = (ref["bf16"][k] for k in ("loss", "loss_k4", "loss_f32"))
        out.update(eval_vs_one_rank_loop=max(abs(g - loop) for g in out["losses"]),
                   eval_vs_one_rank_k4=max(abs(g - k4) for g in out["losses"]),
                   eval_vs_float32=max(abs(g - f32) for g in out["losses"]),
                   one_rank_loop_vs_float32=abs(loop - f32), one_rank_k4_vs_float32=abs(k4 - f32))
        if not out["ranks_vs_f32"] <= SHARDED_BF16_FACTOR * out["one_rank_vs_f32"]:
            fails.append(f"(b) {label}: prefill {out['ranks_vs_f32']} from float32 against "
                         f"one rank's {out['one_rank_vs_f32']}")
        if out["first_tokens"] != out["first_tokens_one_rank"]:
            fails.append(f"(b) {label}: first tokens {out['first_tokens']}")
        if any(k != ccfg.n_layers for k in out["k4_launches"]):
            fails.append(f"(b) {label}: K4 launched {out['k4_launches']} times an eval of "
                         f"{ccfg.n_layers} layers")
    if not out["finite"] or any(out["prefill_k4_launches"]):
        fails.append(f"{label}: finite {out['finite']}, K4 in the prefill "
                     f"{out['prefill_k4_launches']} (it collects the state: the time loop)")
    drules = decode_rules(Mesh(tuple(mesh), tuple(mesh.values())))
    names = ["ticks"] + (list(SSM_SEEDED) if key == "bf16" else [])
    out["decode"] = {}
    for j, name in enumerate(names):
        bt = case["decode"][j]["tokens"].shape[0]
        want = _formula(ccfg, mesh, drules, bt, 1, size, size, "decode")
        if any(ops != want for r in ranks for ops in r["decode"][j]["ops"]):
            fails.append(f"(d) {label} decode {name}: a rank's ops differ from the formula")
        n = len(ranks[0]["decode"][j]["ms"])
        got = [assemble_tick(ranks, j, t, bt, v) for t in range(n)]
        refs = ref[key]["ticks"] if name == "ticks" else ref[key][name][None]
        rep = dict(batch=bt, pos=ranks[0]["decode"][j]["pos"],
                   ms=[r["decode"][j]["ms"] for r in ranks],
                   d_inner_block=[r["decode"][j]["kv"] for r in ranks],
                   collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
                   max_memory_allocated=[r["decode"][j]["max_memory_allocated"] for r in ranks],
                   staging_s=[r["decode"][j]["staging_s"] for r in ranks],
                   finite=all(bool(torch.isfinite(g).all()) for g in got))
        if key == "f32":
            rep.update(errs=[err(g, w) for g, w in zip(got, refs)], tolerance=SHARDED_TOL)
            if not max(rep["errs"]) <= SHARDED_TOL:
                fails.append(f"(a) {label} decode {name}: {rep['errs']} against one rank")
        else:
            f32 = ref[key]["ticks_f32"] if name == "ticks" else ref[key][name + "_f32"][None]
            rep.update(ranks_vs_f32=[err(g, w) for g, w in zip(got, f32)],
                       one_rank_vs_f32=[err(o, w) for o, w in zip(refs, f32)],
                       ranks_vs_one_rank=[err(g, o) for g, o in zip(got, refs)],
                       bound_factor=SHARDED_BF16_FACTOR)
            if any(a > SHARDED_BF16_FACTOR * o for a, o in zip(rep["ranks_vs_f32"],
                                                               rep["one_rank_vs_f32"])):
                fails.append(f"(b) {label} decode {name}: {rep['ranks_vs_f32']} from float32 "
                             f"against one rank's {rep['one_rank_vs_f32']}")
        rep["greedy_shared_with_one_rank"] = sum(
            int((g.argmax(-1) == o.argmax(-1)).sum()) for g, o in zip(got, refs))
        rep["greedy_of"] = sum(int(g.shape[0]) for g in got)
        if not rep["finite"]:
            fails.append(f"{label} decode {name}: not finite")
        out["decode"][name] = rep
    return out


def _ssm_train_checks(ranks, case, c, refs, label, fails):
    """(a)/(c)/(d)/(f) of a train case against the one-rank steps."""
    from repro_torch.launch.expert import report_of

    key = "bf16" if c.compute_dtype == "bfloat16" else "f32"
    size = 2 if key == "bf16" else 4
    mesh_shape = dict(zip(("data", "model"), case["mesh"]))
    r0 = ranks[0]
    want = _formula(c, mesh_shape, r0["rules"], *SSM["train"], size, size, "train",
                    SSM["accum"], r0["param_rules"])
    if any(r["train"]["ops"] != want for r in ranks):
        fails.append(f"(d) {label}: a rank's train ops differ from the formula")
    loss_err = max(abs(a - b) for r in ranks for a, b in zip(r["train"]["loss"], refs["loss"]))
    norm_err = max(abs(a - b) / b for r in ranks
                   for a, b in zip(r["train"]["grad_norm"], refs["grad_norm"]))
    out = dict(rules=r0["rules"], param_rules=r0["param_rules"],
               losses=[r["train"]["loss"] for r in ranks],
               grad_norms=[r["train"]["grad_norm"] for r in ranks],
               one_rank=dict(loss=refs["loss"], grad_norm=refs["grad_norm"],
                             max_memory_allocated=refs["max_memory_allocated"],
                             seconds=refs["seconds"]),
               step_ms=[r["train"]["ms"] for r in ranks],
               k4_launches=[r["train"]["k4_launches"] for r in ranks],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
               init_s=[r["init_s"] for r in ranks],
               params_allocated=[r["params_allocated"] for r in ranks],
               max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
               loss_err=loss_err, grad_norm_rel_err=norm_err)
    finite = all(np.isfinite(r["train"]["loss"] + r["train"]["grad_norm"]).all() for r in ranks)
    if key == "f32":
        m_err = _m_errors(ranks, case["mesh"], refs["m"], r0["param_rules"], c)
        out.update(m_rel_err=m_err, tolerance=dict(loss=TRAIN_TOL, grad_norm=TRAIN_TOL,
                                                   m=TRAIN_M_REL))
        if not (loss_err <= TRAIN_TOL and norm_err <= TRAIN_TOL
                and max(m_err.values()) <= TRAIN_M_REL and finite):
            fails.append(f"(a) {label}: loss {loss_err}, grad norm {norm_err}, m "
                         f"{max(m_err.values())} against one rank")
    else:
        out["tolerance"] = dict(loss=TRAIN_BF16_LOSS, grad_norm=TRAIN_BF16_NORM)
        if not (loss_err <= TRAIN_BF16_LOSS and norm_err <= TRAIN_BF16_NORM and finite):
            fails.append(f"(c) {label}: loss {loss_err}, grad norm {norm_err} against one rank")
    if any(out["k4_launches"]):
        fails.append(f"{label}: K4 launched {out['k4_launches']} times in the train steps "
                     "(they take the time loop)")
    return out


def _ssm_eval_f32(ranks, cfg, ref, fails):
    """(b) in float32: the ranks' eval through K4 at full depth against one
    rank's time loop; (d) its ops; (f) its times."""
    from repro_torch.launch.expert import report_of

    c = cfg.with_(**SSM_EVAL_F32)
    want = _formula(c, dict(data=1, model=4), ranks[0]["rules"], *SSM["loss"], 4, 4,
                    "loss")
    out = dict(losses=[r["loss"]["loss"] for r in ranks], one_rank_loop=ref["eval_f32"],
               err=max(abs(r["loss"]["loss"] - ref["eval_f32"]) for r in ranks),
               tolerance=SHARDED_TOL, k4_launches=[r["loss"]["k4_launches"] for r in ranks],
               ms=[r["loss"]["ms"] for r in ranks],
               staging_s=[r["loss"]["staging_s"] for r in ranks],
               params_allocated=[r["params_allocated"] for r in ranks],
               max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()))
    if any(r["loss"]["ops"] != want for r in ranks):
        fails.append("(d) eval f32: a rank's ops differ from the formula")
    if not out["err"] <= SHARDED_TOL:
        fails.append(f"(b) eval f32: through K4 {out['err']} from one rank's time loop")
    if any(k != c.n_layers for k in out["k4_launches"]):
        fails.append(f"(b) eval f32: K4 launched {out['k4_launches']} times for {c.n_layers} "
                     "layers")
    return out


def phase_sharded_ssm(free_before):
    """Phase 15: falcon-mamba-7b sharded over 4 ranks of one card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.serve import make_requests

    t0 = time.perf_counter()
    released = [_card_released(free_before)]
    cuda = torch.device("cuda", 0)
    arch = SSM["arch"]
    cfg = get_config(arch).with_(n_layers=SSM["bf16_layers"])
    rng = np.random.default_rng(SEED + 15)
    prompts = np.stack([r.prompt for r in make_requests(cfg, SSM["prompts"], SSM["prompt_len"],
                                                        1, SEED)])
    loss_tokens = rng.integers(0, cfg.vocab_size, SSM["loss"])
    train_tokens = rng.integers(0, cfg.vocab_size, SSM["train"])
    seeded_tokens = {name: rng.integers(0, cfg.vocab_size, (spec["b"], 1))
                     for name, spec in SSM_SEEDED.items()}
    k4 = _ssm_k4(cuda)
    ref = _ssm_references(cfg, prompts, loss_tokens, seeded_tokens, cuda)
    ref_s = time.perf_counter() - t0
    released.append(_card_released(free_before))

    f32 = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
    cases = [dict(mesh=mesh, cfg=f32, prefill=dict(tokens=prompts),
                  decode=[dict(tokens=ref["f32"]["fed"])], loss=dict(tokens=loss_tokens))
             for mesh in SSM["meshes"]]
    cases.append(dict(mesh=(2, 2), cfg=f32, train=dict(tokens=train_tokens, accum=SSM["accum"],
                                                         steps=SSM["steps"]["f32"],
                                                         host=("m",))))
    seeded = [dict(tokens=seeded_tokens[name], seed=spec["seed"], s_max=0, pos=spec["pos"])
              for name, spec in SSM_SEEDED.items()]
    bf16 = dict(n_layers=SSM["bf16_layers"])
    cases.append(dict(mesh=(1, 4), cfg=bf16, prefill=dict(tokens=prompts),
                      decode=[dict(tokens=ref["bf16"]["fed"])] + seeded,
                      loss=dict(tokens=loss_tokens, cfg=dict(ssm_impl="pallas"))))
    f32_eval = len(cases)
    cases.append(dict(mesh=(1, 4), cfg=dict(SSM_EVAL_F32, **bf16),
                      loss=dict(tokens=loss_tokens, cfg=dict(ssm_impl="pallas"))))
    train_layers = dict(n_layers=SSM["train_layers"])
    cases.append(dict(mesh=(1, 4), policy="opt", cfg=train_layers,
                      train=dict(tokens=train_tokens, accum=SSM["accum"],
                                 steps=SSM["steps"]["bf16"], host=())))
    t1 = time.perf_counter()
    res = run_ranks("repro_torch.launch.sharded:run", 4,
                    dict(device="cuda:0", arch=arch, seed=SEED, cases=cases),
                    timeout_s=SSM["limit"],
                    env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t1
    released.append(_card_released(free_before))

    out = dict(arch=arch, prompts=list(prompts.shape), loss_shape=list(SSM["loss"]),
               ticks=SSM["ticks"], seeded=SSM_SEEDED, train_batch=list(SSM["train"]),
               accum=SSM["accum"], steps=SSM["steps"], train_layers=SSM["train_layers"],
               bf16_layers=SSM["bf16_layers"],
               reference_s=ref_s, ranks_s=ranks_s, k4_rank_shapes=k4,
               reference_losses=dict(f32_2_layers=ref["f32"]["loss"], bf16=ref["bf16"]["loss"]))
    fails = [f"(e) K4 at d_in {d}: {e['max_abs_err']} from its plain version"
             for d, e in k4.items() if not e["max_abs_err"] <= SCAN_TOL]
    for i, case in enumerate(cases):
        if "train" in case or "prefill" not in case:
            continue
        ranks = [r[i] for r in res]
        ccfg = cfg.with_(**case["cfg"])
        label = (f"{'f32' if 'compute_dtype' in case['cfg'] else 'bf16'}_"
                 f"{case['mesh'][0]}x{case['mesh'][1]}")
        out[label] = _ssm_serve_checks(ranks, case, ccfg, ref, label, fails)
    out["eval_f32"] = _ssm_eval_f32([r[f32_eval] for r in res], cfg, ref, fails)
    del ref
    _free()
    for i, case in enumerate(cases):
        if "train" not in case:
            continue
        ranks = [r[i] for r in res]
        c = cfg.with_(**case["cfg"])
        key = "bf16" if c.compute_dtype == "bfloat16" else "f32"
        label = f"train_{key}_{case['mesh'][0]}x{case['mesh'][1]}_{case.get('policy', 'baseline')}"
        refs = _train_reference(c, train_tokens, None, SSM["steps"][key], SSM["accum"], cuda)
        out[label] = _ssm_train_checks(ranks, case, c, refs, label, fails)
        del refs
        _free()
    out["released_s"] = released
    out["phase_s"] = time.perf_counter() - t0
    log("sharded_ssm", **out)
    if fails:
        raise AssertionError(f"phase 15: {fails}")
    return out


# -- phase 16 ------------------------------------------------------------------

# moonshot-v1-16b-a3b sharded over 4 ranks of the one card
# (``launch/sharded.py``; gloo, host-staged, as phases 12–15), the experts
# over ``model`` by PARAM_RULES.  (a) f32 at 2 layers under the baseline
# (the sharded gather dispatch) on (1, 4) and (2, 2): the prefill of 2 ×
# 512 (into caches of MOE["s_max"]), the loss of MOE["loss"], MOE["ticks"]
# ["f32"] ticks fed from the prefill's caches with one rank's greedy
# tokens, and on (2, 2) one train step (batch MOE["train"], accum 2) at
# MOE["train_layers"] (2 → 1 for phase 18's time: the step is its
# expert stacks' float32 gathers over ``data``, 2.2 GB a layer);
# (b) bf16 on (1, 4) under the baseline at MOE["bf16_layers"] (the memory
# reckoning in PERF.md: 14.0 GB of parameters a rank at 48): the prefill of
# phase 6's first 2 prompts, the loss of MOE["loss"], MOE["ticks"]["bf16"]
# ticks; (c) on (1, 4) under ``opt`` (the a2a dispatch on each rank's block
# of the stream) at MOE["opt_layers"]: one prefill in bf16 and one in
# float32, and a bf16 train step (ACT_RULES_TRAIN_OPT at 28.1 G
# parameters), at MOE_OPT_CF, a capacity no rank's a2a bucket can overflow
# (phase 12's), since the a2a's per-rank capacity drops other entries than
# the one-rank gather's global capacity.  The one-rank references run
# first, on the card, and are freed.  Depths by the script's time (PERF.md
# §4: this phase took 178.7 s with (b) at 48 layers and (c) at 4): (b) at
# 24 of 48 layers, (c) at 2; then (b) at 12 and 4 ticks, (a) 2 ticks; then
# (b) at 6.
MOE = dict(arch="moonshot-v1-16b-a3b", meshes=((1, 4), (2, 2)), prompts=2, prompt_len=512,
           s_max=1024, loss=(2, 1024), ticks=dict(f32=2, bf16=4), train=(4, 1024), accum=2,
           bf16_layers=6, opt_layers=2, train_layers=1, limit=900)
# Gates, fixed before the first run.  (a) logits, losses and ticks within
# MOE_F32_TOL of one rank; the train step's loss within MOE_TRAIN_TOL and
# its grad norm within MOE_TRAIN_TOL of itself.  (b) the prefill's logits
# no farther from float32 than SHARDED_BF16_FACTOR × one rank's bf16, the
# first tokens equal, or a near tie: the float32 logits of the two tokens
# apart by no more than the two bf16 rows' distances from float32
# together; the loss no farther from float32 than SHARDED_BF16_FACTOR ×
# one rank's bf16 loss, and within TRAIN_BF16_LOSS of it.  (c) the float32
# prefill's logits within MOE_F32_TOL of one rank's, the bf16 prefill's
# first tokens by (b)'s rule; the train step's loss within MOE_OPT_LOSS,
# its grad norm within MOE_OPT_NORM of itself.  (d) every rank's ops equal
# to ``sharded_collectives``; K2 once a layer in every prefill and eval.
# The bf16 prefills' logits were first held to SHARDED_BF16_FACTOR × one
# rank's distance from float32 (the dense model's rule) and it did not
# hold for this model (PERF.md §6): (b) 1.37 × at 48 layers, 1.75 × at
# 24; (c) 1.87 × at 4 layers, 0.96 × at 2.  In bf16 the ranks' sums round
# apart from one rank's, a router near tie flips, and the token goes to
# another expert, which moves its output by its own size: the ranks' and
# one rank's distances from float32 are then alike in size and the ratio
# varies around 1.4.  The logits' ratio is reported; the rule holds on the
# loss, whose mean over 2 048 positions does not turn on a few tokens, and
# the sharded dispatch is held to one rank in float32 ((a), and (c)'s
# float32 prefill).
MOE_F32_TOL = 5e-5
MOE_TRAIN_TOL = 1e-5
MOE_OPT_LOSS = 1e-3
MOE_OPT_NORM = 5e-3
MOE_OPT_CF = 11.0                 # ceil(E / k): c_e ≥ a rank's tokens
MOE_NEAR_TIE = 2.0 ** -7          # tests/test_torch_models.py's NEAR_TIE
MOE_SERVE = dict(attn_impl="pallas", remat=False)
MOE_F32 = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")


def _moe_reckoning(cfg):
    """The memory reckoning's elements (PERF.md): one layer's, its
    attention's, the embedding's and head's, and the bf16 bytes a rank of
    (1, 4) holds at MOE["bf16_layers"]."""
    import math

    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten

    leaves = list(flatten(Model(cfg.with_(n_layers=1)).defs()))
    layer = sum(math.prod(p.shape) for path, p in leaves if path[0] == "stack")
    attn = sum(math.prod(p.shape) for path, p in leaves if path[:2] == ("stack", "attn"))
    rest = sum(math.prod(p.shape) for path, p in leaves if path[0] != "stack")
    whole = MOE["bf16_layers"] * layer + rest
    return dict(layer=layer, attention=attn, router_and_experts=layer - attn,
                embed_and_head=rest, elements=whole, bf16_bytes=2 * whole,
                bf16_bytes_a_rank=2 * whole // 4)


def _host_tree(tree):
    """A tree's tensors copied to host memory."""
    return {k: _host_tree(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


def _moe_routing(records):
    """Each recorded MoE call's expert ids, kept entries and probabilities,
    on the host."""
    from repro_torch.models import moe

    return [dict(moe.routing(r), probs=r["probs"].cpu()) for r in records]


def _moe_references(cfg, prompts, loss_tokens, train_tokens, dev):
    """The one-rank model on the card from SEED's parameters: (a) f32 at 2
    layers: the prefill's logits and routing, MOE["ticks"]["f32"] greedy
    ticks (tokens fed, logits), the loss and its routing, one train step
    (at MOE["train_layers"]);
    (b) bf16 at MOE["bf16_layers"]: the same prefill, ticks and loss, and
    each in float32 throughout, layer by layer; (c) at MOE["opt_layers"]
    and MOE_OPT_CF: the prefill's logits and routing in bf16 (and in
    float32 throughout) and with float32 parameters, one bf16 train step."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.model import Model

    out = {}
    legs = (("f32", cfg.with_(**MOE_SERVE, **MOE_F32)),
            ("bf16", cfg.with_(**MOE_SERVE, n_layers=MOE["bf16_layers"])))
    for key, c in legs:
        model = Model(c)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        tok = torch.as_tensor(prompts, device=dev).long()
        with torch.no_grad():
            with moe.recording() as rec:
                logits, caches = model.prefill(params, {"tokens": tok}, MOE["s_max"])
            routing = _moe_routing(rec)
            fed, ticks, last = [], [], logits
            for t in range(MOE["ticks"][key]):
                fed.append(last.argmax(-1)[:, None])
                last, caches = model.decode(params, fed[-1], prompts.shape[1] + t, caches)
                ticks.append(last.float().cpu())
            del caches
            with moe.recording() as rec:
                loss, _ = model.loss(params, {"tokens": torch.as_tensor(loss_tokens, device=dev)
                                              .long()})
            loss_routing = _moe_routing(rec)
        fed = torch.cat(fed, 1).cpu().numpy()
        out[key] = dict(logits=logits.float().cpu(), loss=float(loss), fed=fed,
                        ticks=torch.stack(ticks), routing=routing, loss_routing=loss_routing)
        if key == "bf16":
            out[key]["logits_f32"] = _prefill_logits_f32(c, params, prompts, dev).cpu()
            out[key]["loss_f32"] = _loss_f32(c, params, loss_tokens, dev)
            out[key]["ticks_f32"] = _ticks_f32(c, params, prompts, fed, dev).cpu()
        del params
        _free()
    out["f32"]["train"] = _train_reference(cfg.with_(**dict(MOE_F32,
                                                           n_layers=MOE["train_layers"])),
                                           train_tokens, None, 1, MOE["accum"], dev)
    out["f32"]["train"]["m"] = _host_tree(out["f32"]["train"]["m"])   # the card's for the ranks
    _free()
    opt = dict(MOE_SERVE, n_layers=MOE["opt_layers"], capacity_factor=MOE_OPT_CF)
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    for key, c in (("opt", cfg.with_(**opt)), ("opt_f32", cfg.with_(**opt, **f32))):
        model = Model(c)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        with torch.no_grad(), moe.recording() as rec:
            logits, _ = model.prefill(params, {"tokens": torch.as_tensor(prompts, device=dev)
                                               .long()}, prompts.shape[1])
        out[key] = dict(logits=logits.float().cpu(), routing=_moe_routing(rec))
        if key == "opt":
            out[key]["logits_f32"] = _prefill_logits_f32(c, params, prompts, dev).cpu()
        del params, logits
        _free()
    out["opt"]["train"] = _train_reference(cfg.with_(n_layers=MOE["opt_layers"],
                                                     capacity_factor=MOE_OPT_CF),
                                           train_tokens, None, 1, MOE["accum"], dev)
    out["opt"]["train"].pop("m")
    _free()
    return out


def _routing_agreement(got, want, b, rows, positions):
    """A rank's routing of each MoE call (its ``rows`` of the batch of
    ``b``, its ``positions`` of the sequence) against one rank's: the
    share of (token, choice) entries with the same expert and of those
    kept alike, and the differing ids that are not near ties (MOE_NEAR_TIE
    of the one-rank probabilities), over every call and in the first."""
    out = dict(calls=len(got), calls_one_rank=len(want))
    same = kept = total = far = 0
    for i, (g, w) in enumerate(zip(got, want)):
        pick = lambda x: x.reshape(b, -1, *x.shape[1:])[  # noqa: E731
            rows[0]:rows[1], positions[0]:positions[1]].reshape(-1, *x.shape[1:])
        ids, want_ids, probs = g["gate_idx"], pick(w["gate_idx"]), pick(w["probs"])
        for t, j in (ids != want_ids).nonzero().tolist():
            a, c = float(probs[t, want_ids[t, j]]), float(probs[t, ids[t, j]])
            far += abs(a - c) > MOE_NEAR_TIE * max(a, c)
        same += int((ids == want_ids).sum())
        kept += int((g["kept"] == pick(w["kept"])).sum())
        total += ids.numel()
        if i == 0:
            out.update(first_call_ids_equal=same / total, first_call_flips_not_near_tie=far)
    return dict(out, ids_equal=same / max(total, 1), kept_equal=kept / max(total, 1),
                flips_not_near_tie=far)


def _moe_first_tokens(logits, ref, key):
    """(b)'s first-token rule: each row's argmax equal to one rank's, or a
    near tie: the float32 logits of the two tokens apart by no more than
    the two bf16 rows' distances from float32 together, the most by which
    bf16 rounding can reorder them."""
    l16, l32 = ref[key]["logits"], ref[key]["logits_f32"]
    got, want = logits.argmax(-1), l16.argmax(-1)
    noise = (l16 - l32).abs().max(-1).values + (logits - l32).abs().max(-1).values
    ok = [bool(g == w or abs(float(l32[i, g] - l32[i, w])) <= float(noise[i]))
          for i, (g, w) in enumerate(zip(got.tolist(), want.tolist()))]
    return dict(first_tokens=got.tolist(), first_tokens_one_rank=want.tolist(), near_tie_ok=ok)


def _moe_serve_checks(ranks, case, ccfg, ref, key, label, fails, tag=None, k2=None, k4=None,
                      logits_tol=MOE_F32_TOL, loss_bound=None):
    """(a)/(b)/(c)/(d) of a prefill (and decode and loss) case → its report.
    ``tag``: the gate's letter in a failure (by ``key`` where None); ``k2``:
    K2's launches a prefill or eval should count (default one a layer);
    ``k4``: K4's in an eval (then none in a prefill; default unchecked);
    ``logits_tol``: the float32 prefill logits' bound (the loss's and the
    ticks' stays MOE_F32_TOL); ``loss_bound``: the bf16 loss's bound on its
    distance from float32, of one rank's (default SHARDED_BF16_FACTOR ×
    it)."""
    import torch

    from repro_torch.distributed.sharding import decode_rules
    from repro_torch.launch.expert import report_of
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharded import assemble_logits, assemble_tick

    err = lambda a, c: float((a - c).abs().max())  # noqa: E731
    size = 4 if ccfg.compute_dtype == "float32" else 2
    mesh = dict(zip(("data", "model"), case["mesh"]))
    r0 = ranks[0]
    b, v = case["prefill"]["tokens"].shape[0], ccfg.vocab_size
    steps = [s for s in ("prefill", "loss") if s in case]
    want = {s: _formula(ccfg, mesh, r0["rules"], *case[s]["tokens"].shape, size, size,
                        s, param_rules=r0["param_rules"],
                        s_max=case[s].get("s_max"))
            for s in steps}
    for s, ops in want.items():
        if any(r[s]["ops"] != ops for r in ranks):
            fails.append(f"(d) {label} {s}: a rank's ops differ from the formula")
    logits = assemble_logits(ranks, b, v)
    out = dict(collectives={s: dict(count=len(ops), wire_bytes=report_of(ops).by_kind())
                            for s, ops in want.items()},
               rules=r0["rules"], param_rules=r0["param_rules"],
               init_s=[r["init_s"] for r in ranks],
               params_allocated=[r["params_allocated"] for r in ranks],
               max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
               finite=bool(torch.isfinite(logits).all()))
    k2 = ccfg.n_layers if k2 is None else k2
    for s in steps:
        out[s] = dict(ms=[r[s]["ms"] for r in ranks], staging_s=[r[s]["staging_s"] for r in ranks],
                      k2_launches=[r[s]["k2_launches"] for r in ranks],
                      k4_launches=[r[s]["k4_launches"] for r in ranks])
        if any(k != k2 for k in out[s]["k2_launches"]):
            fails.append(f"(d) {label} {s}: K2 launched {out[s]['k2_launches']} times, not {k2}")
        want_k4 = None if k4 is None else k4 if s == "loss" else 0
        if want_k4 is not None and any(k != want_k4 for k in out[s]["k4_launches"]):
            fails.append(f"(d) {label} {s}: K4 launched {out[s]['k4_launches']} times, not "
                         f"{want_k4}")
    n_data, n_model = mesh["data"], mesh["model"]
    for s, tokens in (("prefill", "routing"), ("loss", "loss_routing")):
        if s in case and tokens in ref[key]:
            bs, sl = case[s]["tokens"].shape
            split = ccfg.moe_impl == "a2a" and r0["rules"].get("seq") == "model"
            out[s]["routing"] = [_routing_agreement(
                r[s]["routing"], ref[key][tokens], bs,
                (r["coords"]["data"] * bs // n_data, (r["coords"]["data"] + 1) * bs // n_data),
                (r["coords"]["model"] * sl // n_model, (r["coords"]["model"] + 1) * sl // n_model)
                if split else (0, sl))
                for r in ranks]
    if "loss" in case:
        out["loss"].update(losses=[r["loss"]["loss"] for r in ranks],
                           one_rank=ref[key]["loss"], aux=[r["loss"]["aux"] for r in ranks])
        out["finite"] &= all(np.isfinite(r["loss"]["loss"]) for r in ranks)
    tag = tag or ("(a)" if key == "f32" else "(b)" if key == "bf16" else "(c)")
    if size == 4:
        out.update(logits_err=err(logits, ref[key]["logits"]), tolerance=MOE_F32_TOL,
                   logits_tolerance=logits_tol,
                   loss_err=max((abs(r["loss"]["loss"] - ref[key]["loss"]) for r in ranks
                                 if "loss" in case), default=0.0))
        if not (out["logits_err"] <= logits_tol and out["loss_err"] <= MOE_F32_TOL):
            fails.append(f"{tag} {label}: logits {out['logits_err']}, loss {out['loss_err']}")
    else:
        l32, l16 = ref[key]["logits_f32"], ref[key]["logits"]
        out.update(ranks_vs_f32=err(logits, l32), one_rank_vs_f32=err(l16, l32),
                   ranks_vs_one_rank=err(logits, l16), bound_factor=SHARDED_BF16_FACTOR,
                   **_moe_first_tokens(logits, ref, key))
        if "loss" in case:
            out["loss"].update(vs_one_rank=max(abs(g - ref[key]["loss"])
                                               for g in out["loss"]["losses"]),
                               vs_float32=max(abs(g - ref[key]["loss_f32"])
                                              for g in out["loss"]["losses"]),
                               one_rank_vs_float32=abs(ref[key]["loss"] - ref[key]["loss_f32"]))
        out["ratio_vs_f32"] = out["ranks_vs_f32"] / out["one_rank_vs_f32"]
        if "loss" in case:
            loss = out["loss"]
            loss["bound"] = (loss_bound or (lambda d: SHARDED_BF16_FACTOR * d))(
                loss["one_rank_vs_float32"])
            if not (loss["vs_float32"] <= loss["bound"]
                    and loss["vs_one_rank"] <= TRAIN_BF16_LOSS):
                fails.append(f"{tag} {label}: loss {loss['vs_float32']} from float32 against "
                             f"one rank's {loss['one_rank_vs_float32']}, "
                             f"{loss['vs_one_rank']} from one rank's")
        if not all(out["near_tie_ok"]):
            fails.append(f"{tag} {label}: first tokens {out['first_tokens']} against "
                         f"{out['first_tokens_one_rank']}, not a near tie")
    if not out["finite"]:
        fails.append(f"{label}: not finite")
    if "decode" not in case:
        return out
    drules = decode_rules(Mesh(tuple(mesh), tuple(mesh.values())))
    bt = case["decode"][0]["tokens"].shape[0]
    want = _formula(ccfg, mesh, drules, bt, 1, size, size, "decode",
                    s_max=case["prefill"]["s_max"])
    if any(ops != want for r in ranks for ops in r["decode"][0]["ops"]):
        fails.append(f"(d) {label} decode: a rank's ops differ from the formula")
    n = len(r0["decode"][0]["ms"])
    got = [assemble_tick(ranks, 0, t, bt, v) for t in range(n)]
    refs = ref[key]["ticks"]
    rep = dict(ms=[r["decode"][0]["ms"] for r in ranks],
               staging_s=[r["decode"][0]["staging_s"] for r in ranks],
               kv_block=[r["decode"][0]["kv"] for r in ranks],
               k3_launches=[r["decode"][0]["k3_launches"] for r in ranks],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
               max_memory_allocated=[r["decode"][0]["max_memory_allocated"] for r in ranks],
               finite=all(bool(torch.isfinite(g).all()) for g in got),
               ranks_vs_one_rank=[err(g, w) for g, w in zip(got, refs)],
               greedy_shared_with_one_rank=sum(int((g.argmax(-1) == o.argmax(-1)).sum())
                                               for g, o in zip(got, refs)),
               greedy_of=sum(int(g.shape[0]) for g in got))
    if key == "f32":
        rep["tolerance"] = MOE_F32_TOL
        if not max(rep["ranks_vs_one_rank"]) <= MOE_F32_TOL:
            fails.append(f"(a) {label} decode: {rep['ranks_vs_one_rank']} against one rank")
    else:
        f32 = ref[key]["ticks_f32"]
        rep.update(ranks_vs_f32=[err(g, w) for g, w in zip(got, f32)],
                   one_rank_vs_f32=[err(o, w) for o, w in zip(refs, f32)])
    if not rep["finite"]:
        fails.append(f"{label} decode: not finite")
    out["decode"] = rep
    return out


def _moe_train_checks(ranks, case, c, refs, label, fails):
    """(a)/(c)/(d) of a train case against the one-rank step."""
    from repro_torch.launch.expert import report_of

    f32 = c.compute_dtype == "float32"
    size = 4 if f32 else 2
    r0 = ranks[0]
    want = _formula(c, dict(zip(("data", "model"), case["mesh"])), r0["rules"],
                    *MOE["train"], size, size, "train", MOE["accum"],
                    r0["param_rules"])
    if any(r["train"]["ops"] != want for r in ranks):
        fails.append(f"(d) {label}: a rank's train ops differ from the formula")
    loss_err = max(abs(r["train"]["loss"][0] - refs["loss"][0]) for r in ranks)
    norm_err = max(abs(r["train"]["grad_norm"][0] - refs["grad_norm"][0]) / refs["grad_norm"][0]
                   for r in ranks)
    finite = all(np.isfinite(r["train"]["loss"] + r["train"]["grad_norm"]).all() for r in ranks)
    out = dict(rules=r0["rules"], param_rules=r0["param_rules"], moe_impl=c.moe_impl,
               losses=[r["train"]["loss"] for r in ranks],
               grad_norms=[r["train"]["grad_norm"] for r in ranks],
               one_rank=dict(loss=refs["loss"], grad_norm=refs["grad_norm"],
                             max_memory_allocated=refs["max_memory_allocated"],
                             seconds=refs["seconds"]),
               step_ms=[r["train"]["ms"] for r in ranks],
               k2_launches=[r["train"]["k2_launches"] for r in ranks],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
               init_s=[r["init_s"] for r in ranks],
               params_allocated=[r["params_allocated"] for r in ranks],
               max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
               loss_err=loss_err, grad_norm_rel_err=norm_err)
    if f32:
        m_err = _m_errors(ranks, case["mesh"], refs["m"], r0["param_rules"], c)
        out.update(m_rel_err_max=max(m_err.values()),
                   tolerance=dict(loss=MOE_TRAIN_TOL, grad_norm=MOE_TRAIN_TOL))
        if not (loss_err <= MOE_TRAIN_TOL and norm_err <= MOE_TRAIN_TOL and finite):
            fails.append(f"(a) {label}: loss {loss_err}, grad norm {norm_err} against one rank")
    else:
        out["tolerance"] = dict(loss=MOE_OPT_LOSS, grad_norm=MOE_OPT_NORM)
        if not (loss_err <= MOE_OPT_LOSS and norm_err <= MOE_OPT_NORM and finite):
            fails.append(f"(c) {label}: loss {loss_err}, grad norm {norm_err} against one rank")
    return out


def phase_sharded_moe(free_before):
    """Phase 16: moonshot-v1-16b-a3b sharded over 4 ranks of one card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.serve import make_requests

    t0 = time.perf_counter()
    released = [_card_released(free_before)]
    cuda = torch.device("cuda", 0)
    arch = MOE["arch"]
    cfg = get_config(arch)
    rng = np.random.default_rng(SEED + 16)
    prompts = np.stack([r.prompt for r in make_requests(cfg, MOE["prompts"], MOE["prompt_len"],
                                                        1, SEED)])
    loss_tokens = rng.integers(0, cfg.vocab_size, MOE["loss"])
    train_tokens = rng.integers(0, cfg.vocab_size, MOE["train"])
    ref = _moe_references(cfg, prompts, loss_tokens, train_tokens, cuda)
    ref_s = time.perf_counter() - t0
    released.append(_card_released(free_before))

    def serve(key):
        return dict(prefill=dict(tokens=prompts, s_max=MOE["s_max"], routing=True),
                    decode=[dict(tokens=ref[key]["fed"])],
                    loss=dict(tokens=loss_tokens, routing=True))

    f32 = dict(MOE_SERVE, **MOE_F32)
    cases = [dict(mesh=mesh, cfg=f32, **serve("f32")) for mesh in MOE["meshes"]]
    cases.append(dict(mesh=(2, 2), cfg=dict(MOE_F32, n_layers=MOE["train_layers"]),
                      train=dict(tokens=train_tokens, accum=MOE["accum"], steps=1,
                                 host=("m",))))
    cases.append(dict(mesh=(1, 4), cfg=dict(MOE_SERVE, n_layers=MOE["bf16_layers"]),
                      **serve("bf16")))
    opt = dict(n_layers=MOE["opt_layers"], capacity_factor=MOE_OPT_CF)
    for dtypes in ({}, dict(param_dtype="float32", compute_dtype="float32")):
        cases.append(dict(mesh=(1, 4), policy="opt", cfg=dict(MOE_SERVE, **opt, **dtypes),
                          prefill=dict(tokens=prompts, s_max=prompts.shape[1], routing=True)))
    cases.append(dict(mesh=(1, 4), policy="opt", cfg=opt,
                      train=dict(tokens=train_tokens, accum=MOE["accum"], steps=1, host=())))
    t1 = time.perf_counter()
    res = run_ranks("repro_torch.launch.sharded:run", 4,
                    dict(device="cuda:0", arch=arch, seed=SEED, cases=cases),
                    timeout_s=MOE["limit"],
                    env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t1
    released.append(_card_released(free_before))

    out = dict(arch=arch, prompts=list(prompts.shape), loss_shape=list(MOE["loss"]),
               ticks=MOE["ticks"], s_max=MOE["s_max"], train_batch=list(MOE["train"]),
               accum=MOE["accum"], bf16_layers=MOE["bf16_layers"],
               opt_layers=MOE["opt_layers"], opt_capacity_factor=MOE_OPT_CF,
               reference_s=ref_s, ranks_s=ranks_s, reckoning=_moe_reckoning(cfg),
               reference_losses=dict(f32_2_layers=ref["f32"]["loss"], bf16=ref["bf16"]["loss"],
                                     bf16_float32=ref["bf16"]["loss_f32"]))
    fails = []
    for i, case in enumerate(cases):
        ranks = [r[i] for r in res]
        c = cfg.with_(**case["cfg"])
        policy = case.get("policy", "baseline")
        if policy == "opt":
            c = c.with_(moe_impl="a2a")
        key = ("opt" if policy == "opt" else "bf16") if c.compute_dtype == "bfloat16" else (
            "opt_f32" if policy == "opt" and "prefill" in case else "f32")
        label = (f"{'train_' if 'train' in case else ''}{key}_{case['mesh'][0]}x"
                 f"{case['mesh'][1]}_{policy}")
        if "train" in case:
            out[label] = _moe_train_checks(ranks, case, c, ref[key]["train"], label, fails)
        else:
            out[label] = _moe_serve_checks(ranks, case, c, ref, key, label, fails)
    out["released_s"] = released
    out["phase_s"] = time.perf_counter() - t0
    log("sharded_moe", **out)
    if fails:
        raise AssertionError(f"phase 16: {fails}")
    return out


# -- phase 17 ------------------------------------------------------------------

# jamba-v0.1-52b sharded over 4 ranks of the one card (``launch/sharded.py``;
# gloo, host-staged, as phases 12–16): each slot of a period as its own
# family on ranks (attention on the rank's heads, mamba on its ``d_inner``
# channels, the MLP on its ``d_ff`` columns, MoE on its experts), one
# slot's weights gathered at a time.  The one-rank references first, on the
# card, then freed.  (a) one period (8 layers) in float32 on (1, 4) under
# the baseline: the prefill of phase 6's first 2 prompts into caches of
# HYBRID["s_max"], the loss of HYBRID["loss"] (routing recorded), 4 ticks
# fed from the prefill's caches with one rank's greedy tokens; (b) one
# period in bf16 on (1, 4): the prefill, the eval through K2 and K4, 4
# ticks; (c) the same period in bf16 on (2, 2): the prefill and 2 ticks,
# each slot's weights gathered over ``data`` (the ticks with the MoE
# slots' expert stacks in place); (d) in the same case, two long_500k
# ticks (batch 1, ``pos`` 524 286 and 524 287) on caches drawn from a
# seed, every slot stationary; (e) one period on (1, 4) under ``opt`` at
# capacity factor E / k = 8 (nothing drops on either side): a float32
# prefill (the parameters as in (a)) and a bf16 one; (f) one bf16 period
# on (1, 4), ``remat`` on: ``Model.loss`` under ``torch.autograd.grad``
# (the ``"grad"`` entry: the loss and the whole grad norm, no optimizer
# state) on 2 × 512.  No AdamW step: one period's is about 213 GB across
# the ranks (PERF.md), so it waits for four cards; phases 14–16 run it,
# the CPU tests hold the hybrid's train cells.  Cut for the script's time
# (phase 17 took 125.8 s alone at first; PERF.md §4): (b) 16 → 8 layers
# (the CPU tests hold two periods), its ticks 8 → 4, (c)'s ticks 4 → 2 →
# 1 (the last for phase 18's time).
HYBRID = dict(arch="jamba-v0.1-52b", prompts=2, prompt_len=512, s_max=1024, loss=(2, 1024),
              ticks=dict(f32=4, bf16=4, gathered=1), layers=8,
              long=dict(b=1, s_max=524_288, pos=524_286, ticks=2, seed=SEED + 53),
              capacity_factor=8.0, limit=900)
HYBRID_SERVE = dict(attn_impl="pallas", ssm_impl="pallas", remat=False)
HYBRID_F32 = dict(param_dtype="float32", compute_dtype="float32")
HYBRID_GRAD = dict(attn_impl="xla", ssm_impl="xla", remat=True)
# Gates, fixed before the first run.  (a) logits, losses and ticks within
# HYBRID_F32_TOL of one rank, routing (ids and kept entries) 100 % equal;
# (b) phase 16 (b)'s bf16 rules: the loss no farther from float32 than
# SHARDED_BF16_FACTOR × one rank's and within TRAIN_BF16_LOSS of it, the
# first tokens equal or a near tie, the logits' ratio and the ticks
# reported; (c) the same rules, and each rank's max_memory_allocated at
# most HYBRID_RANK_BYTES, which a whole period's gather (12.8 GB more)
# cannot meet; (d) each tick no farther from float32 than
# SHARDED_BF16_FACTOR × one rank's, the greedy token equal or a near tie,
# no ``layer`` gather among its ops; (e) the float32 prefill within
# HYBRID_F32_TOL of one rank at the same capacity factor, routing 100 %
# equal (the bf16 prefill's first tokens and routing reported); (f) the
# loss within TRAIN_BF16_LOSS, the grad norm within HYBRID_GRAD_NORM of
# itself; (g) every rank's ops equal to ``sharded_collectives``, K2 once a
# period in every prefill and eval, K4 7 times a period in every eval and
# never in a prefill.  Changed after the first run: the float32 prefill
# logits of (a) and (e) are held to HYBRID_F32_LOGITS_TOL, the float32
# sharded logits' bound of phases 13 and 15 (SHARDED_TOL).  They read
# 8.27e-05 (max |logit| 6.14, median error 1.06e-05), and one process
# summing only ``w_out``'s products as 4 blocks in order, as the ranks
# do, moved one rank's own logits by 5.69e-05 (``dtbc``'s 3.61e-05, the
# MLP's down 4.72e-05; PERF.md): a bound of 5e-05 sits under the noise of
# any float32 reordering of this period's sums.  The losses and ticks keep
# HYBRID_F32_TOL (9.5e-07 and 2.1e-05–2.7e-05).
HYBRID_F32_TOL = 5e-5
HYBRID_F32_LOGITS_TOL = SHARDED_TOL
HYBRID_GRAD_NORM = 5e-3
HYBRID_RANK_BYTES = 14e9


def _hybrid_reckoning(cfg):
    """The memory reckoning's elements (PERF.md): each slot kind's, a
    period's, the embedding's and head's, and the bf16 bytes at one and
    two periods, whole and a rank of four."""
    import math

    from repro_torch.models.model import Model
    from repro_torch.models.params import flatten

    defs = Model(cfg.with_(n_layers=cfg.attn_period)).defs()
    n = lambda tree: sum(math.prod(p.shape) for _, p in flatten(tree))  # noqa: E731
    kinds = {k: n(next(sl[k] for sl in defs["stack"].values() if k in sl))
             for k in ("attn", "mamba", "mlp", "moe")}
    period, rest = n(defs["stack"]), n({k: v for k, v in defs.items() if k != "stack"})
    return dict(slot_kinds=kinds, period=period, embed_and_head=rest,
                **{f"bf16_bytes_{p}_periods": 2 * (p * period + rest) for p in (1, 2)},
                **{f"bf16_bytes_a_rank_{p}_periods": 2 * (p * period + rest) // 4
                   for p in (1, 2)})


def _hybrid_references(cfg, prompts, loss_tokens, long_tokens, dev):
    """The one-rank model on the card from SEED's parameters at one period,
    each leg's parameters freed before the next: (a) f32: the prefill's
    logits and routing, HYBRID["ticks"]["f32"] greedy ticks, the loss and
    its routing; (e) on the same parameters at the capacity factor, the
    prefill's logits and routing; (b)/(c) bf16: the prefill, 4 ticks (the
    first (c)'s) and the eval through K2 and K4, each also in float32
    throughout; (d) on the same parameters, the long ticks on the whole
    seeded caches and in float32 layer by layer; (e) the bf16 prefill at
    the capacity factor (and in float32); (f) the loss and grad norm of the
    prompts (``make_grad_step``)."""
    import torch

    from repro_torch.launch.sharded import seeded_caches
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    out = {}
    cf = dict(capacity_factor=HYBRID["capacity_factor"])
    tok = torch.as_tensor(prompts, device=dev).long()
    legs = (("f32", dict(HYBRID_SERVE, **HYBRID_F32, n_layers=HYBRID["layers"])),
            ("bf16", dict(HYBRID_SERVE, n_layers=HYBRID["layers"])))
    for key, over in legs:
        c = cfg.with_(**over)
        model = Model(c)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        with torch.no_grad():
            with moe.recording() as rec:
                logits, caches = model.prefill(params, {"tokens": tok}, HYBRID["s_max"])
            routing = _moe_routing(rec)
            fed, ticks, last = [], [], logits
            for t in range(HYBRID["ticks"][key]):
                fed.append(last.argmax(-1)[:, None])
                last, caches = model.decode(params, fed[-1], prompts.shape[1] + t, caches)
                ticks.append(last.float().cpu())
            del caches
            with moe.recording() as rec:
                loss, _ = model.loss(params, {"tokens": torch.as_tensor(loss_tokens, device=dev)
                                              .long()})
        fed = torch.cat(fed, 1).cpu().numpy()
        out[key] = dict(logits=logits.float().cpu(), fed=fed, ticks=torch.stack(ticks),
                        routing=routing, loss=float(loss), loss_routing=_moe_routing(rec))
        if key == "f32":
            with torch.no_grad(), moe.recording() as rec:
                logits, _ = Model(c.with_(**cf)).prefill(params, {"tokens": tok},
                                                          prompts.shape[1])
            out["opt_f32"] = dict(logits=logits.float().cpu(), routing=_moe_routing(rec))
        else:
            out[key].update(logits_f32=_prefill_logits_f32(c, params, prompts, dev).cpu(),
                            ticks_f32=_ticks_f32(c, params, prompts, fed, dev).cpu(),
                            loss_f32=_loss_f32(c, params, loss_tokens, dev))
            out["gathered"] = out[key]      # (c) runs its first HYBRID["ticks"]["gathered"]
            spec = HYBRID["long"]
            with torch.no_grad():
                caches = seeded_caches(model, spec["b"], spec["s_max"], spec["seed"], dev)
                long = []
                for t in range(spec["ticks"]):
                    lg, caches = model.decode(params, torch.as_tensor(
                        long_tokens[:, t:t + 1], device=dev).long(), spec["pos"] + t, caches)
                    long.append(lg.float().cpu())
                del caches
            out["long"] = dict(ticks=torch.stack(long),
                               ticks_f32=_seeded_ticks_f32(c, params, long_tokens, spec,
                                                           dev).cpu())
            c8 = c.with_(**cf)
            with torch.no_grad(), moe.recording() as rec:
                logits, _ = Model(c8).prefill(params, {"tokens": tok}, prompts.shape[1])
            out["opt"] = dict(logits=logits.float().cpu(), routing=_moe_routing(rec),
                              logits_f32=_prefill_logits_f32(c8, params, prompts, dev).cpu())
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            grad = make_grad_step(Model(c.with_(**HYBRID_GRAD)))(params, {"tokens": tok})
            out["grad"] = dict(loss=float(grad["loss"]), grad_norm=float(grad["grad_norm"]),
                               seconds=time.perf_counter() - t0,
                               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
            del grad
        del params, model
        _free()
    return out


def _hybrid_long_checks(ranks, case, ccfg, ref, fails):
    """(d)/(g) of the long ticks (the case's second decode entry)."""
    import torch

    from repro_torch.distributed.sharding import decode_rules
    from repro_torch.launch.expert import report_of
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharded import assemble_tick

    err = lambda a, c: float((a - c).abs().max())  # noqa: E731
    spec, mesh = HYBRID["long"], dict(zip(("data", "model"), case["mesh"]))
    want = _formula(ccfg, mesh, decode_rules(Mesh(tuple(mesh), tuple(mesh.values()))),
                    spec["b"], 1, 2, 2, "decode", s_max=spec["s_max"])
    entries = [r["decode"][1] for r in ranks]
    if any(ops != want for e in entries for ops in e["ops"]):
        fails.append("(g) long ticks: a rank's ops differ from the formula")
    got = [assemble_tick(ranks, 1, t, spec["b"], ccfg.vocab_size) for t in range(spec["ticks"])]
    one, f32 = ref["long"]["ticks"], ref["long"]["ticks_f32"]
    rep = dict(pos=entries[0]["pos"], s_max=spec["s_max"], batch=spec["b"],
               stationary=[e["stationary"] for e in entries], kv=[e["kv"] for e in entries],
               d_inner=[e["di"] for e in entries], ms=[e["ms"] for e in entries],
               staging_s=[e["staging_s"] for e in entries],
               max_memory_allocated=[e["max_memory_allocated"] for e in entries],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
               layer_gathers=sum(op[3] == "layer" for op in want),
               ranks_vs_f32=[err(g, w) for g, w in zip(got, f32)],
               one_rank_vs_f32=[err(o, w) for o, w in zip(one, f32)],
               ranks_vs_one_rank=[err(g, o) for g, o in zip(got, one)],
               bound_factor=SHARDED_BF16_FACTOR,
               finite=all(bool(torch.isfinite(g).all()) for g in got))
    near = []
    for g, o, w in zip(got, one, f32):
        a, b = int(g.argmax(-1)[0]), int(o.argmax(-1)[0])
        noise = float((o - w).abs().max() + (g - w).abs().max())
        near.append(a == b or abs(float(w[0, a] - w[0, b])) <= noise)
    rep.update(greedy=[int(g.argmax(-1)[0]) for g in got],
               greedy_one_rank=[int(o.argmax(-1)[0]) for o in one], near_tie_ok=near)
    if any(a > SHARDED_BF16_FACTOR * o for a, o in zip(rep["ranks_vs_f32"],
                                                       rep["one_rank_vs_f32"])):
        fails.append(f"(d) long ticks: {rep['ranks_vs_f32']} from float32 against one rank's "
                     f"{rep['one_rank_vs_f32']}")
    if not (all(near) and rep["finite"] and all(rep["stationary"])
            and rep["layer_gathers"] == 0):
        fails.append(f"(d) long ticks: greedy {rep['greedy']} against {rep['greedy_one_rank']}, "
                     f"finite {rep['finite']}, stationary {rep['stationary']}, "
                     f"{rep['layer_gathers']} layer gathers")
    return rep


def _hybrid_grad_checks(ranks, case, c, ref, fails):
    """(f)/(g) of the gradient case against one rank's."""
    from repro_torch.launch.expert import report_of

    r0 = ranks[0]
    want = _formula(c, dict(zip(("data", "model"), case["mesh"])), r0["rules"],
                    *case["grad"]["tokens"].shape, 2, 2, "train", 1, r0["param_rules"],
                    kind="grad")
    if any(r["grad"]["ops"] != want for r in ranks):
        fails.append("(g) grad: a rank's ops differ from the formula")
    one = ref["grad"]
    out = dict(rules=r0["rules"], losses=[r["grad"]["loss"] for r in ranks],
               grad_norms=[r["grad"]["grad_norm"] for r in ranks], one_rank=one,
               loss_err=max(abs(r["grad"]["loss"] - one["loss"]) for r in ranks),
               grad_norm_rel_err=max(abs(r["grad"]["grad_norm"] - one["grad_norm"])
                                     / one["grad_norm"] for r in ranks),
               tolerance=dict(loss=TRAIN_BF16_LOSS, grad_norm=HYBRID_GRAD_NORM),
               ms=[r["grad"]["ms"] for r in ranks],
               staging_s=[r["grad"]["staging_s"] for r in ranks],
               k2_launches=[r["grad"]["k2_launches"] for r in ranks],
               k4_launches=[r["grad"]["k4_launches"] for r in ranks],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
               params_allocated=[r["params_allocated"] for r in ranks],
               max_memory_allocated=[r["grad"]["max_memory_allocated"] for r in ranks])
    finite = all(np.isfinite([r["grad"]["loss"], r["grad"]["grad_norm"]]).all() for r in ranks)
    if not (out["loss_err"] <= TRAIN_BF16_LOSS and out["grad_norm_rel_err"] <= HYBRID_GRAD_NORM
            and finite):
        fails.append(f"(f) grad: loss {out['loss_err']}, grad norm {out['grad_norm_rel_err']} "
                     "against one rank")
    return out


def _routing_all_equal(rep):
    """Whether every rank's routing of every recorded step is one rank's:
    the same expert ids and the same kept entries."""
    return all(a["ids_equal"] == 1.0 and a["kept_equal"] == 1.0
               for s in ("prefill", "loss") if s in rep for a in rep[s].get("routing", []))


def _hybrid_cases(prompts, loss_tokens, long_tokens, ref):
    """Phase 17's rank cases → [(reference key, gate letter, case)]."""
    one = dict(n_layers=HYBRID["layers"])
    f32 = dict(HYBRID_SERVE, **HYBRID_F32, **one)
    cf = dict(capacity_factor=HYBRID["capacity_factor"])
    long = dict(tokens=long_tokens, seed=HYBRID["long"]["seed"], s_max=HYBRID["long"]["s_max"],
                pos=HYBRID["long"]["pos"])
    serve = lambda key: dict(  # noqa: E731
        prefill=dict(tokens=prompts, s_max=HYBRID["s_max"], routing=True),
        decode=[dict(tokens=ref[key]["fed"])])
    opt_prefill = dict(tokens=prompts, s_max=prompts.shape[1], routing=True)
    return [
        ("f32", "(a)", dict(mesh=(1, 4), cfg=f32, **serve("f32"),
                            loss=dict(tokens=loss_tokens, routing=True))),
        ("opt_f32", "(e)", dict(mesh=(1, 4), policy="opt", cfg=dict(f32, **cf),
                                prefill=opt_prefill)),
        ("bf16", "(b)", dict(mesh=(1, 4), cfg=dict(HYBRID_SERVE, **one), **serve("bf16"),
                             loss=dict(tokens=loss_tokens, routing=True))),
        ("gathered", "(c)", dict(mesh=(2, 2), cfg=dict(HYBRID_SERVE, **one),
                                 prefill=serve("bf16")["prefill"],
                                 decode=[dict(tokens=ref["bf16"]["fed"][
                                     :, :HYBRID["ticks"]["gathered"]]), long])),
        ("opt", "(e)", dict(mesh=(1, 4), policy="opt", cfg=dict(HYBRID_SERVE, **one, **cf),
                            prefill=opt_prefill)),
        ("grad", "(f)", dict(mesh=(1, 4), cfg=dict(HYBRID_GRAD, **one),
                             grad=dict(tokens=prompts))),
    ]


def _hybrid_checks(cfg, cases, res, ref, out):
    """Phase 17's gates over the ranks' results ``res`` of ``cases``; each
    case's report goes into ``out`` → the failures."""
    from repro_torch.launch.sharded import assemble_logits

    fails = []
    for i, (key, tag, case) in enumerate(cases):
        ranks = [r[i] for r in res]
        c = cfg.with_(**case["cfg"])
        policy = case.get("policy", "baseline")
        if policy == "opt":
            c = c.with_(moe_impl="a2a")
        label = f"{key}_{case['mesh'][0]}x{case['mesh'][1]}_{policy}"
        if "grad" in case:
            out[label] = _hybrid_grad_checks(ranks, case, c, ref, fails)
            continue
        n_periods = c.n_layers // c.attn_period
        local = []
        rep = _moe_serve_checks(ranks, case, c, ref, key, label, local, tag, k2=n_periods,
                                k4=(c.attn_period - 1) * n_periods,
                                logits_tol=HYBRID_F32_LOGITS_TOL)
        # (e)'s bf16 prefill is reported; its ops and launches are gated
        fails += [f.replace("(d) ", "(g) ", 1) for f in local
                  if key != "opt" or f.startswith("(d) ")]
        if key in ("f32", "opt_f32"):
            gap = (assemble_logits(ranks, *ref[key]["logits"].shape) - ref[key]["logits"]).abs()
            rep.update(logits_err_median=float(gap.median()),
                       max_abs_logit=float(ref[key]["logits"].abs().max()))
            if not _routing_all_equal(rep):
                fails.append(f"{tag} {label}: routing not one rank's: "
                             f"{[rep[s]['routing'] for s in ('prefill', 'loss') if s in rep]}")
        if key == "gathered":
            rep["long"] = _hybrid_long_checks(ranks, case, c, ref, fails)
            if any(r["max_memory_allocated"] > HYBRID_RANK_BYTES for r in ranks):
                fails.append(f"(c) {label}: max_memory_allocated "
                             f"{[r['max_memory_allocated'] for r in ranks]} over "
                             f"{HYBRID_RANK_BYTES}")
        out[label] = rep
    return fails


def phase_sharded_hybrid(free_before):
    """Phase 17: jamba-v0.1-52b sharded over 4 ranks of one card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.serve import make_requests

    t0 = time.perf_counter()
    released = [_card_released(free_before)]
    cuda = torch.device("cuda", 0)
    # cuBLAS keeps a workspace for each thread's handle (the main thread's,
    # the autograd engine's device thread's) as long as the process lives.
    # Taken here, before the references' tens of GB, they cannot pin a
    # large cached block that the ranks then miss (64 MiB pinned 3.5–7 GiB).
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.ones(8, 8, dtype=dtype, device=cuda, requires_grad=True)
        (w @ w).sum().backward()
    del w
    arch = HYBRID["arch"]
    cfg = get_config(arch)
    rng = np.random.default_rng(SEED + 17)
    prompts = np.stack([r.prompt for r in make_requests(cfg, HYBRID["prompts"],
                                                        HYBRID["prompt_len"], 1, SEED)])
    loss_tokens = rng.integers(0, cfg.vocab_size, HYBRID["loss"])
    long_tokens = rng.integers(0, cfg.vocab_size, (HYBRID["long"]["b"], HYBRID["long"]["ticks"]))
    ref = _hybrid_references(cfg, prompts, loss_tokens, long_tokens, cuda)
    ref_s = time.perf_counter() - t0
    _free()
    released.append(_card_released(free_before))

    cases = _hybrid_cases(prompts, loss_tokens, long_tokens, ref)
    t1 = time.perf_counter()
    res = run_ranks("repro_torch.launch.sharded:run", 4,
                    dict(device="cuda:0", arch=arch, seed=SEED, cases=[c for *_, c in cases]),
                    timeout_s=HYBRID["limit"],
                    env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t1
    released.append(_card_released(free_before))

    out = dict(arch=arch, config=HYBRID, prompts=list(prompts.shape), reference_s=ref_s,
               ranks_s=ranks_s, reckoning=_hybrid_reckoning(cfg),
               reference_losses=dict(f32=ref["f32"]["loss"], bf16=ref["bf16"]["loss"],
                                     bf16_float32=ref["bf16"]["loss_f32"]),
               reference_grad=ref["grad"])
    fails = _hybrid_checks(cfg, cases, res, ref, out)
    out["released_s"] = released
    out["phase_s"] = time.perf_counter() - t0
    log("sharded_hybrid", **out)
    if fails:
        raise AssertionError(f"phase 17: {fails}")
    return out


# -- phase 18 ------------------------------------------------------------------

# internvl2-1b and whisper-base at full width sharded over 4 ranks of the
# one card (``launch/sharded.py``; gloo, host-staged, as phases 12–17):
# the VLM's stream, vision prefix and tokens, in the ranks' blocks; the
# encoder-decoder's encoder on a layout of its own 1 500 positions, its
# output gathered once, the cross-attention on each rank's heads.
# ``attn_impl="pallas"`` in every prefill and eval; the vision embeddings
# and the frames drawn from the seed.  The one-rank references first, on
# the card, from the same seeds.  (a) internvl2-1b in float32, all 24
# layers, on (1, 4) (14 heads: every rank runs every head): the prefill
# of 2 × (256 + 512) into caches of 1 024 positions, the loss of 2 × (256
# + 768), 2 ticks from the prefill's caches; (b) on (2, 2) (7 heads and 1
# kv head a rank): in float32 at ENCVLM["vlm"]["f32_layers"] layers the
# prefill and the loss, in bf16 at all 24 layers the prefill, the eval
# through K2, 2 ticks and one decode_32k tick (B 4, ``pos`` 32 000 of a
# seeded 32 768-position cache); (c) one float32 train step under ``opt``
# (``ACT_RULES_TRAIN_OPT``: 494 M parameters) on (1, 4) at 4 layers, 4 ×
# (256 + 768); (d) whisper-base whole (6 + 6 layers) in float32 on (1, 4)
# and (2, 2): the prefill of 2 × (1 500 frames, 128 tokens) into 448
# positions (whisper's decoder length), the loss of 2 × 384 (K2 takes
# sequences of whole 128-position blocks: 448 is not one), 2 ticks; (e)
# whisper-base in bf16 on (1, 4): the prefill, the eval through K2, 2
# ticks and one decode_32k tick (B 4, ``pos`` 32 000 of 32 768 positions,
# ``ek``/``ev`` of 1 500); (f) whisper-base's float32 train step, whole:
# one under the baseline on (2, 2), one under ``opt`` (small-DP: 97 M
# parameters) on (1, 4).
ENCVLM = dict(
    vlm=dict(arch="internvl2-1b", prompts=2, prompt_len=512, s_max=1024, loss=(2, 768),
             ticks=2, f32_layers=4, train=(4, 768), seed=SEED + 18),
    encdec=dict(arch="whisper-base", prompts=2, prompt_len=128, s_max=448, loss=(2, 384),
                ticks=2, train=(4, 448), seed=SEED + 19),
    long=dict(b=4, s_max=32768, pos=32000, seed=SEED + 61), limit=600)
ENCVLM_SERVE = dict(attn_impl="pallas", remat=False)
ENCVLM_F32 = dict(param_dtype="float32", compute_dtype="float32")
# Gates, fixed before the first run, as phases 13–17's.  Float32: the
# prefill's logits within SHARDED_TOL of one rank, the loss and the ticks
# within ENCVLM_F32_TOL.  bf16: the prefill's logits, each tick and the
# decode_32k tick no farther from float32 than SHARDED_BF16_FACTOR × one
# rank's, the first tokens equal or a near tie (phase 16's rule), the
# eval's loss within TRAIN_BF16_LOSS of one rank's and no farther from
# float32 than phase 13's bound (``_dense_loss_bound``: twice one rank's
# distance, or 1e-3).  Changed after the first run: the loss was first
# held to SHARDED_BF16_FACTOR × one rank's distance (phase 16's rule), and
# (b)'s read 5.58e-4 against one rank's 2.54e-4 (2.2 ×), 3.0e-4 from one
# rank's loss of 12.12, while the same run's float32 losses at 4 and 24
# layers were 9.5e-7 from one rank's: a mean of 1 534 positions' bf16 sums
# in another order, whose one-rank distance is one sample of that noise;
# internvl2-1b's stack is the dense family's, whose loss phase 13 bounds
# so.  Train steps by phase 14 (a):
# the loss within TRAIN_TOL, the grad norm within TRAIN_TOL of itself,
# every leaf of m within TRAIN_M_REL of its largest |m|.  (g) every rank's
# ops equal to ``sharded_collectives``; K2 once a decoder layer in every
# prefill and eval, never in a tick or a train step.
ENCVLM_F32_TOL = 5e-5


def _encvlm_inputs(cfg, tokens, rng):
    """``tokens`` with the family's other input drawn from ``rng``, float32
    standard normal: vision embeddings ``[B, 256, d]`` or frames ``[B,
    1500, d]``."""
    shape = ((cfg.n_vision_tokens, "vision_embeds") if cfg.family == "vlm"
             else (cfg.enc_seq, "frames"))
    return {"tokens": tokens, shape[1]: rng.standard_normal(
        (len(tokens), shape[0], cfg.d_model), dtype=np.float32)}


def _on(batch, dev):
    """A numpy batch on the card, the tokens as integers."""
    import torch

    return {k: torch.as_tensor(v, device=dev).long() if k == "tokens"
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _encvlm_serve(model, params, data, spec, fed, dev):
    """One rank's prefill of ``data["prompts"]`` into ``spec["s_max"]``
    positions, ``spec["ticks"]`` ticks from its caches (greedy, or fed
    ``fed``) and the loss of ``data["loss"]``."""
    import torch

    prompts = _on(data["prompts"], dev)
    n0 = model._n_prefix() + prompts["tokens"].shape[1]
    with torch.no_grad():
        logits, caches = model.prefill(params, prompts, spec["s_max"])
        picks, ticks, last = [], [], logits
        for t in range(spec["ticks"]):
            picks.append(last.argmax(-1)[:, None] if fed is None
                         else torch.as_tensor(fed[:, t:t + 1], device=dev).long())
            last, caches = model.decode(params, picks[-1], n0 + t, caches)
            ticks.append(last.float().cpu())
        del caches
        loss = float(model.loss(params, _on(data["loss"], dev))[0])
    return dict(logits=logits.float().cpu(), fed=torch.cat(picks, 1).cpu().numpy(),
                ticks=torch.stack(ticks), loss=loss)


def _encvlm_references(fam, cfg, data, dev):
    """The one-rank model of one family on the card from SEED's parameters,
    each leg's freed before the next: float32 at full depth ((a), (d)) and
    for the VLM at ENCVLM["vlm"]["f32_layers"] ((b)); bf16 at full depth
    ((b), (e)), and its prefill, ticks (fed one rank's tokens), loss and
    decode_32k tick in float32 throughout (the parameters and the seeded
    caches upcast); the float32 train step ((c) at 4 layers, (f)) → per
    leg its logits, fed tokens, ticks and loss (bf16: ``*_f32`` too,
    ``long``, ``long_f32``), ``train`` (m on the host)."""
    import torch

    from repro_torch.launch.sharded import seeded_caches
    from repro_torch.models.model import Model

    spec, long = ENCVLM[fam], ENCVLM["long"]
    legs = [("f32", cfg.with_(**ENCVLM_SERVE, **ENCVLM_F32)), ("bf16", cfg.with_(**ENCVLM_SERVE))]
    if fam == "vlm":
        legs.insert(1, ("f32_4", cfg.with_(**ENCVLM_SERVE, **ENCVLM_F32,
                                          n_layers=spec["f32_layers"])))
    out = {}
    for key, c in legs:
        model = Model(c)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
        out[key] = r = _encvlm_serve(model, params, data, spec, None, dev)
        if key == "bf16":
            m32 = Model(c.with_(**ENCVLM_F32, attn_impl="xla"))
            p32 = _up(params)
            r32 = _encvlm_serve(m32, p32, data, spec, r["fed"], dev)
            r.update(logits_f32=r32["logits"], loss_f32=r32["loss"], ticks_f32=r32["ticks"])
            tok = torch.as_tensor(data["long"], device=dev).long()
            with torch.no_grad():
                caches = seeded_caches(model, long["b"], long["s_max"], long["seed"], dev)
                c32 = {k: v.float() for k, v in caches.items()}
                r["long"] = model.decode(params, tok, long["pos"], caches)[0].float().cpu()
                del caches
                r["long_f32"] = m32.decode(p32, tok, long["pos"], c32)[0].cpu()
                del c32, p32
        del params, model
        _free()
    c = cfg.with_(**ENCVLM_F32, **({"n_layers": spec["f32_layers"]} if fam == "vlm" else {}))
    train = data["train"]
    out["train"] = _train_reference(c, train["tokens"], None, 1, 1, dev,
                                    extra={k: v for k, v in train.items() if k != "tokens"})
    out["train"]["m"] = _host_tree(out["train"]["m"])
    _free()
    return out


def _encvlm_cases(data, ref):
    """Phase 18's rank cases → [(family, reference key, gate letter, case)]."""
    long = {k: v for k, v in ENCVLM["long"].items() if k != "b"}
    f32 = dict(ENCVLM_SERVE, **ENCVLM_F32)

    def serve(fam, key, mesh, cfg, decode=True, tick_32k=False):
        d, spec = data[fam], ENCVLM[fam]
        case = dict(mesh=mesh, arch=spec["arch"], cfg=cfg, loss=dict(d["loss"]),
                    prefill=dict(d["prompts"], s_max=spec["s_max"]))
        if decode:
            case["decode"] = [dict(tokens=ref[fam][key]["fed"])]
        if tick_32k:
            case["decode"].append(dict(long, tokens=d["long"]))
        return case

    def train(fam, mesh, policy, cfg):
        return dict(mesh=mesh, arch=ENCVLM[fam]["arch"], policy=policy, cfg=cfg,
                    train=dict(data[fam]["train"], steps=1, host=("m",)))

    return [
        ("vlm", "f32", "(a)", serve("vlm", "f32", (1, 4), f32)),
        ("vlm", "f32_4", "(b)", serve("vlm", "f32_4", (2, 2),
                                      dict(f32, n_layers=ENCVLM["vlm"]["f32_layers"]),
                                      decode=False)),
        ("vlm", "bf16", "(b)", serve("vlm", "bf16", (2, 2), ENCVLM_SERVE, tick_32k=True)),
        ("vlm", "train", "(c)", train("vlm", (1, 4), "opt",
                                      dict(ENCVLM_F32, n_layers=ENCVLM["vlm"]["f32_layers"]))),
        ("encdec", "f32", "(d)", serve("encdec", "f32", (1, 4), f32)),
        ("encdec", "f32", "(d)", serve("encdec", "f32", (2, 2), f32)),
        ("encdec", "bf16", "(e)", serve("encdec", "bf16", (1, 4), ENCVLM_SERVE, tick_32k=True)),
        ("encdec", "train", "(f)", train("encdec", (2, 2), "baseline", ENCVLM_F32)),
        ("encdec", "train", "(f)", train("encdec", (1, 4), "opt", ENCVLM_F32)),
    ]


def _encvlm_long_checks(ranks, case, c, ref, tag, label, fails):
    """(b)/(e)/(g) of the decode_32k tick (the case's second decode entry)."""
    import torch

    from repro_torch.distributed.sharding import decode_rules
    from repro_torch.launch.expert import report_of
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharded import assemble_tick

    spec, mesh = ENCVLM["long"], dict(zip(("data", "model"), case["mesh"]))
    want = _formula(c, mesh, decode_rules(Mesh(tuple(mesh), tuple(mesh.values()))),
                    spec["b"], 1, 2, 2, "decode", s_max=spec["s_max"])
    entries = [r["decode"][1] for r in ranks]
    if any(ops != want for e in entries for ops in e["ops"]):
        fails.append(f"(g) {label} decode_32k: a rank's ops differ from the formula")
    got = assemble_tick(ranks, 1, 0, spec["b"], c.vocab_size)
    one, f32 = ref["long"], ref["long_f32"]
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    rep = dict(pos=entries[0]["pos"], s_max=spec["s_max"], batch=spec["b"],
               kv=[e["kv"] for e in entries], ms=[e["ms"] for e in entries],
               staging_s=[e["staging_s"] for e in entries],
               max_memory_allocated=[e["max_memory_allocated"] for e in entries],
               k2_launches=[e["k2_launches"] for e in entries],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
               ranks_vs_f32=err(got, f32), one_rank_vs_f32=err(one, f32),
               ranks_vs_one_rank=err(got, one), bound_factor=SHARDED_BF16_FACTOR,
               finite=bool(torch.isfinite(got).all()))
    noise = (one - f32).abs().max(-1).values + (got - f32).abs().max(-1).values
    pairs = zip(got.argmax(-1).tolist(), one.argmax(-1).tolist())
    rep["near_tie_ok"] = [a == b or abs(float(f32[i, a] - f32[i, b])) <= float(noise[i])
                          for i, (a, b) in enumerate(pairs)]
    if not (rep["ranks_vs_f32"] <= SHARDED_BF16_FACTOR * rep["one_rank_vs_f32"]
            and all(rep["near_tie_ok"]) and rep["finite"]):
        fails.append(f"{tag} {label} decode_32k: {rep['ranks_vs_f32']} from float32 against one "
                     f"rank's {rep['one_rank_vs_f32']}, near ties {rep['near_tie_ok']}, finite "
                     f"{rep['finite']}")
    return rep


def _encvlm_train_checks(ranks, case, c, refs, tag, label, fails):
    """(c)/(f)/(g) of a train case against the one-rank step."""
    from repro_torch.launch.expert import report_of

    r0 = ranks[0]
    want = _formula(c, dict(zip(("data", "model"), case["mesh"])), r0["rules"],
                    *case["train"]["tokens"].shape, 4, 4, "train", 1,
                    r0["param_rules"])
    if any(r["train"]["ops"] != want for r in ranks):
        fails.append(f"(g) {label}: a rank's train ops differ from the formula")
    loss_err = max(abs(r["train"]["loss"][0] - refs["loss"][0]) for r in ranks)
    norm_err = max(abs(r["train"]["grad_norm"][0] - refs["grad_norm"][0]) / refs["grad_norm"][0]
                   for r in ranks)
    m_err = _m_errors(ranks, case["mesh"], refs["m"], r0["param_rules"], c)
    finite = all(np.isfinite(r["train"]["loss"] + r["train"]["grad_norm"]).all() for r in ranks)
    out = dict(rules=r0["rules"], param_rules=r0["param_rules"],
               losses=[r["train"]["loss"] for r in ranks],
               grad_norms=[r["train"]["grad_norm"] for r in ranks],
               one_rank=dict(loss=refs["loss"], grad_norm=refs["grad_norm"],
                             max_memory_allocated=refs["max_memory_allocated"],
                             seconds=refs["seconds"]),
               step_ms=[r["train"]["ms"] for r in ranks],
               k2_launches=[r["train"]["k2_launches"] for r in ranks],
               collectives=dict(count=len(want), wire_bytes=report_of(want).by_kind()),
               init_s=[r["init_s"] for r in ranks],
               params_allocated=[r["params_allocated"] for r in ranks],
               max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
               loss_err=loss_err, grad_norm_rel_err=norm_err, m_rel_err_max=max(m_err.values()),
               tolerance=dict(loss=TRAIN_TOL, grad_norm=TRAIN_TOL, m=TRAIN_M_REL))
    if not (loss_err <= TRAIN_TOL and norm_err <= TRAIN_TOL
            and out["m_rel_err_max"] <= TRAIN_M_REL and finite):
        fails.append(f"{tag} {label}: loss {loss_err}, grad norm {norm_err}, m "
                     f"{out['m_rel_err_max']} against one rank")
    if any(k != 0 for k in out["k2_launches"]):
        fails.append(f"(g) {label}: K2 launched {out['k2_launches']} times in the train step")
    return out


def _encvlm_checks(cases, res, ref, out):
    """Phase 18's gates over the ranks' results ``res`` of ``cases``; each
    case's report goes into ``out`` → the failures."""
    from repro_torch.configs import get_config

    fails = []
    for i, (fam, key, tag, case) in enumerate(cases):
        ranks = [r[i] for r in res]
        c = get_config(case["arch"]).with_(**case["cfg"])
        policy = case.get("policy", "baseline")
        label = f"{fam}_{key}_{case['mesh'][0]}x{case['mesh'][1]}_{policy}"
        if "train" in case:
            out[label] = _encvlm_train_checks(ranks, case, c, ref[fam]["train"], tag, label,
                                              fails)
            continue
        rep = _moe_serve_checks(ranks, case, c, ref[fam], key, label, fails, tag,
                                logits_tol=SHARDED_TOL, loss_bound=_dense_loss_bound)
        for j, entry in enumerate(case.get("decode", [])):
            k2 = [r["decode"][j]["k2_launches"] for r in ranks]
            if any(k != 0 for k in k2):
                fails.append(f"(g) {label} decode {j}: K2 launched {k2} times")
        if c.compute_dtype == "bfloat16":
            ticks = rep["decode"]
            if rep["ratio_vs_f32"] > SHARDED_BF16_FACTOR or any(
                    a > SHARDED_BF16_FACTOR * o for a, o in zip(ticks["ranks_vs_f32"],
                                                                ticks["one_rank_vs_f32"])):
                fails.append(f"{tag} {label}: logits {rep['ranks_vs_f32']} and ticks "
                             f"{ticks['ranks_vs_f32']} from float32 against one rank's "
                             f"{rep['one_rank_vs_f32']} and {ticks['one_rank_vs_f32']}")
            rep["long"] = _encvlm_long_checks(ranks, case, c, ref[fam][key], tag, label, fails)
        out[label] = rep
    return fails


def phase_sharded_encdec_vlm(free_before):
    """Phase 18: internvl2-1b and whisper-base sharded over 4 ranks of one
    card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.serve import make_requests

    t0 = time.perf_counter()
    released = [_card_released(free_before)]
    cuda = torch.device("cuda", 0)
    data, ref = {}, {}
    for fam in ("vlm", "encdec"):
        spec = ENCVLM[fam]
        cfg = get_config(spec["arch"])
        rng = np.random.default_rng(spec["seed"])
        prompts = np.stack([r.prompt for r in make_requests(cfg, spec["prompts"],
                                                            spec["prompt_len"], 1, SEED)])
        data[fam] = dict(prompts=_encvlm_inputs(cfg, prompts, rng),
                         loss=_encvlm_inputs(cfg, rng.integers(0, cfg.vocab_size, spec["loss"]),
                                             rng),
                         train=_encvlm_inputs(cfg, rng.integers(0, cfg.vocab_size,
                                                                spec["train"]), rng),
                         long=rng.integers(0, cfg.vocab_size, (ENCVLM["long"]["b"], 1)))
        ref[fam] = _encvlm_references(fam, cfg, data[fam], cuda)
    ref_s = time.perf_counter() - t0
    _free()
    released.append(_card_released(free_before))

    cases = _encvlm_cases(data, ref)
    t1 = time.perf_counter()
    res = run_ranks("repro_torch.launch.sharded:run", 4,
                    dict(device="cuda:0", seed=SEED, cases=[c for *_, c in cases]),
                    timeout_s=ENCVLM["limit"],
                    env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t1
    released.append(_card_released(free_before))

    out = dict(config=ENCVLM, reference_s=ref_s, ranks_s=ranks_s,
               reference_losses={fam: {k: r["loss"] for k, r in ref[fam].items() if "loss" in r}
                                 for fam in ref})
    fails = _encvlm_checks(cases, res, ref, out)
    out["released_s"] = released
    out["phase_s"] = time.perf_counter() - t0
    log("sharded_encdec_vlm", **out)
    if fails:
        raise AssertionError(f"phase 18: {fails}")
    return out


_ATTENTION_KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:29"),
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:26"),
}


def _attention_entry(name, t, launches, **extra):
    source, replaces = _ATTENTION_KERNELS[name]
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library_ms"],
             "design": ATTN_DESIGNS[name],
             "profiled_ms": t["profiled"]["ms_per_call"],
             "library_profiled_ms": t["library_profiled"]["ms_per_call"], **extra}
    if name == "flash_decode":
        entry["launches_note"] = ("on no path, the sharded decode's included: the "
                                  "model's decode takes the plain path, as the "
                                  "reference's does")
    return entry


def _k2_family_launches(models):
    """K2's launches on phase 9's serve paths, for the kernel line."""
    return {f"launches_{fam}_serve_path": models[fam]["run"]["k2_launches"]
            for fam in ("moe", "hybrid", "encdec")}


def kernel_times() -> int:
    """``--kernel-times``: build, then time K1 (the window form at the fleet
    shape; the column form at the failure leg's commonest and widest launch
    shapes, recorded on one ``cuda`` failure leg) and K4 at the model's
    shape, and print them as one JSON line.  For comparing two trees'
    kernels in one call: copy this script into each and run it there."""
    import torch

    _name, smi = phase_device()
    cuda = torch.device("cuda", 0)
    probes = _k1_probes(cuda)
    shapes = {}
    _failure_leg("cuda", shapes=shapes)
    gc.collect()
    out = dict(nvidia_smi=smi, probes=probes, k1_window=_k1_window_timing(cuda, probes),
               k1_columns=_k1_failure_timing(shapes, probes),
               k4=_k4_timing(cuda, np.random.default_rng(SEED)))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "kernel_times.json"), "w") as fh:
        json.dump(dict(out, ptxas=REPORT["ptxas"]), fh, indent=1, default=float)
    print(json.dumps(out, default=float))
    return 0


def _bytecode_cache():
    """Compiled Python under ``build/pycache`` for this process and every
    process it starts (the ranks, the trainer's legs, the dry runs): the
    card's machine sets ``PYTHONDONTWRITEBYTECODE``, so each process
    compiled every module it imported anew; importing torch with
    ``torch._dynamo`` (a checkpointed step's first call) took 20.5–23.0 s a
    process there, 10.7–12.8 s from the cache (PERF.md §6)."""
    prefix = os.path.join(HERE, "build", "pycache")
    os.makedirs(prefix, exist_ok=True)
    sys.pycache_prefix, sys.dont_write_bytecode = prefix, False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


# -- phase 19 ------------------------------------------------------------------

# The port's five example scripts (examples/*_torch.py), in this process.
EXAMPLE_SCHEDULERS = ("quickstart", "bass_cluster_demo", "failover_demo")


def _example(name):
    import importlib

    path = os.path.join(HERE, "examples")
    sys.path.insert(0, path)
    try:
        return importlib.import_module(f"{name}_torch")
    finally:
        sys.path.remove(path)


def _example_run(fn):
    """``fn()`` with its standard output captured → (its result, the
    output, seconds, K1's launches over it)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, buf.getvalue(), secs, _counts()[0].get("launches", 0)


def phase_examples():
    """Phase 19: the five port examples on the card.  The three scheduler
    scripts on ``cuda`` and then on ``numpy``: the same standard output,
    K1 launched on ``cuda``; ``serve_batch_torch`` routes and finishes every
    request; ``train_e2e_torch`` (its default arguments, checkpoints under
    ``build/``, removed after) ends with a loss below its first."""
    import shutil

    from repro_torch.kernels import ts_plan

    t0 = time.perf_counter()
    out, fails = {}, []
    for name in EXAMPLE_SCHEDULERS:
        mod = _example(name)
        runs = {b: _example_run(lambda b=b: mod.main(["--backend", b])) for b in BACKENDS}
        cuda, ref = runs[BACKENDS[0]], runs[BACKENDS[-1]]
        out[name] = dict(lines=len(cuda[1].splitlines()), identical=cuda[1] == ref[1],
                         k1_launches=cuda[3], seconds={b: r[2] for b, r in runs.items()})
        if cuda[1] != ref[1] or cuda[3] == 0:
            fails.append(f"{name}: stdout identical {cuda[1] == ref[1]}, K1 {cuda[3]}")
    ts_plan.set_backend("cuda")
    serve = _example("serve_batch")
    res, text, secs, k1 = _example_run(lambda: serve.main(serve.ARGV + ["--device", "cuda"]))
    reqs = res["requests"]
    routed = sum(line.startswith("req ") and " -> " in line for line in text.splitlines())
    done = [len(r.tokens_out) == r.max_new for r in reqs]
    out["serve_batch"] = dict(requests=len(reqs), routed=routed, finished=sum(done),
                              seconds=secs, k1_launches=k1, tail=text.splitlines()[-1])
    if not all(done) or routed != len(reqs) or text.count("finished on") != len(reqs):
        fails.append(f"serve_batch: {sum(done)} of {len(reqs)} finished, {routed} routed")
    train = _example("train_e2e")
    ckdir = os.path.join(HERE, "build", "ckpt_e2e_torch")
    shutil.rmtree(ckdir, ignore_errors=True)
    argv = train.ARGV[:-1] + [ckdir, "--device", "cuda"]
    try:
        res, text, secs, k1 = _example_run(lambda: train.main(argv))
        steps = sorted(os.listdir(ckdir))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    losses = [loss for _, loss in res["losses"]]
    out["train_e2e"] = dict(losses=res["losses"], seconds=secs, k1_launches=k1,
                            checkpoints=steps, tokens_s=res["tokens_s"])
    if not losses[-1] < losses[0] or "step_000000300" not in steps or k1 == 0:
        fails.append(f"train_e2e: losses {losses[0]} → {losses[-1]}, checkpoints {steps}, "
                     f"K1 {k1}")
    k1_total = sum(e["k1_launches"] for e in out.values())
    log("examples", seconds=time.perf_counter() - t0, k1_launches=k1_total, **out)
    if fails:
        raise AssertionError(f"phase 19: {fails}")
    return dict(out, k1_launches=k1_total)


def main() -> int:
    _bytecode_cache()
    import torch

    if sys.argv[1:] == ["--kernel-times"]:
        return kernel_times()
    alone = {"--sharded-train": phase_sharded_train, "--sharded": phase_sharded,
             "--sharded-ssm": phase_sharded_ssm, "--sharded-moe": phase_sharded_moe,
             "--sharded-hybrid": phase_sharded_hybrid,
             "--sharded-encdec-vlm": phase_sharded_encdec_vlm}
    if len(sys.argv) == 2 and sys.argv[1] in alone:
        phase_device()
        alone[sys.argv[1]](torch.cuda.mem_get_info()[0])
        log("meta_rank_programs", **_meta_summary())
        return 0
    if sys.argv[1:] == ["--examples"]:
        phase_device()
        phase_examples()
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--kernel-times | --sharded-train | --sharded "
                         "| --sharded-ssm | --sharded-moe | --sharded-hybrid "
                         "| --sharded-encdec-vlm | --examples]")
    wall = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        wall[phase.__name__] = time.perf_counter() - t0
        return out

    t_start = time.perf_counter()
    name, smi = timed(phase_device)
    _start_dryruns()     # phase 11's, on the host's cores beside phases 2–10
    timing = timed(phase_kernels)
    main_cuda = timed(phase_main_path)
    fail_cuda = timed(phase_failure, timing)
    attn = timed(phase_attention)
    serve = timed(phase_serve)
    train = timed(phase_train)
    sched = timed(phase_scheduler)
    models = timed(phase_models)
    trainer = timed(phase_trainer)
    timed(phase_cost)
    expert = timed(phase_expert)
    free = expert["free_bytes"]
    sharded = timed(phase_sharded, free)
    sharded_train = timed(phase_sharded_train, free)
    sharded_ssm = timed(phase_sharded_ssm, free)
    sharded_moe = timed(phase_sharded_moe, free)
    sharded_hybrid = timed(phase_sharded_hybrid, free)
    sharded_encdec_vlm = timed(phase_sharded_encdec_vlm, free)
    log("meta_rank_programs", **_meta_summary())
    examples = timed(phase_examples)
    log("wall", phases_s=wall, total_s=time.perf_counter() - t_start)
    kernels = {"kernels": [{
        "name": "ts_plan_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ts_plan.cu",
        "replaces": "src/repro/kernels/ts_plan_device.py:424",
        "launches": main_cuda["stats"]["launches"],
        "launches_failure_path": fail_cuda["stats"]["launches"],
        "launches_serve_path": serve["k1_launches"],
        "launches_hierarchy_path": sched["launches"]["hierarchy"],
        "launches_recovery_path": sched["launches"]["recovery"],
        "launches_fault_storm_path": sched["launches"]["fault_storm"],
        "launches_trainer_path": trainer["trainer"]["k1_launches"],
        "launches_epoch_placement": trainer["epoch"]["k1_launches"],
        "launches_fault_storm_acceptance_path": sched["launches"]["fault_storm_acceptance"],
        "launches_examples_path": examples["k1_launches"],
        "max_abs_err": timing["max_abs_err"],
        "checked": timing["checked"],
        "bitwise": True,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "empty_launch_ms": timing["empty_launch_ms"],
        "dadd_latency_ns": timing["dadd_latency_ns"],
        "failure_shape": fail_cuda["k1"]["commonest"]["shape"],
        "ms_failure_shape": fail_cuda["k1"]["commonest"]["ms"],
        "bound_ms_failure_shape": fail_cuda["k1"]["commonest"]["bound_ms"],
        "failure_shape_widest": fail_cuda["k1"]["widest"]["shape"],
        "ms_failure_shape_widest": fail_cuda["k1"]["widest"]["ms"],
        "bound_ms_failure_shape_widest": fail_cuda["k1"]["widest"]["bound_ms"],
    }, _attention_entry("flash_attention", attn["flash_attention"], serve["k2_launches"],
                        **_k2_family_launches(models),
                        launches_a2a_serve_path=expert["moe"]["k2_launches"][0],
                        launches_sharded_serve_path=sharded["bf16_2x2"]["k2_launches"][0],
                        launches_sharded_train_path=sharded_train[
                            "bf16_2x2_baseline"]["train_k2_launches"][0],
                        launches_sharded_train_eval=sharded_train[
                            "bf16_2x2_baseline"]["k2_launches"][0],
                        launches_sharded_moe_serve_path=sharded_moe[
                            "bf16_1x4_baseline"]["prefill"]["k2_launches"][0],
                        launches_sharded_hybrid_serve_path=sharded_hybrid[
                            "bf16_1x4_baseline"]["prefill"]["k2_launches"][0],
                        launches_sharded_vlm_serve_path=sharded_encdec_vlm[
                            "vlm_bf16_2x2_baseline"]["prefill"]["k2_launches"][0],
                        launches_sharded_encdec_serve_path=sharded_encdec_vlm[
                            "encdec_bf16_1x4_baseline"]["prefill"]["k2_launches"][0]),
        _attention_entry("flash_decode", attn["flash_decode"], serve["k3_launches"],
                         launches_sharded_decode_path=sharded["bf16_1x4"]["decode"]["ticks"][
                             "k3_launches"][0]), {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:69",
        "launches": train["launches"],
        "launches_note": f"on the eval path ({TRAIN['n_layers']} layers); the train "
                         "step takes the "
                         "plain scan, as the reference's must (K4 has no backward)",
        "launches_hybrid_eval_path": models["hybrid"]["eval"]["launches"]["mamba_scan"],
        "launches_sharded_eval_path": sharded_ssm["bf16_1x4"]["k4_launches"],
        "launches_sharded_note": f"on each of the 4 ranks of phase 15's bf16 eval "
                                 f"({SSM['bf16_layers']} of 64 layers, d_in 2 048 a rank); "
                                 "0 in its prefills, ticks and train steps",
        "launches_sharded_hybrid_eval_path": sharded_hybrid[
            "bf16_1x4_baseline"]["loss"]["k4_launches"][0],
        "launches_sharded_hybrid_note": "on each of the 4 ranks of phase 17 (b)'s bf16 eval "
                                        "(one period: 7 mamba slots, d_in 2 048 a rank); 0 in "
                                        "its prefills and ticks",
        "sharded_rank_shapes": {str(d): {k: e[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "bound_by")}
                                for d, e in sharded_ssm["k4_rank_shapes"].items()},
        "max_abs_err": train["scan"]["max_abs_err"],
        "ms": train["scan"]["ms"],
        "plain_ms": train["scan"]["plain_ms"],
        "bound_ms": train["scan"]["bound_ms"],
        "bound_by": train["scan"]["bound_by"],
        "library_ms": None,
    }]}
    REPORT.update(kernels)
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(REPORT, fh, indent=1, default=float)
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
