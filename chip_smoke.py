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
4. failure  — a k=8 fat-tree with a core switch killed mid-stream; the
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
              width, 16 of its 64 layers (bf16, seeded random parameters,
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
              3 000 tasks (host kills, stragglers, retries, LATE
              speculation) on both reroute engines.  K1's launches on each
              path go on the kernel line.
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
              ``torch.cuda.max_memory_allocated`` over it.  (b) ``--preset 100m``: 8 straight steps
              against 4 then ``--resume`` for 4 more, each leg its own
              process; the two step-8 checkpoints the same bytes.  (c)
              ``plan_epoch`` and ``prefetch_epoch`` of 16 384 shards of
              512 MB on the 4 096 hosts of phase 3, ``cuda`` then
              ``numpy``, byte-identical (a leg past 60 s halves the shard
              count, printed).  (d) ``tree_compress_with_feedback`` over
              (a)'s gradient tree on the card against a CPU copy, bit for
              bit, and ``cross_pod_allreduce`` plain and compressed over a
              one-rank NCCL group against the host's sum.
11. cost    — (a) ``python -m repro_torch.launch.dryrun`` for
              internvl2-1b × train_4k, falcon-mamba-7b × prefill_32k and
              moonshot-v1-16b-a3b × prefill_32k (``--mesh single``), one
              process each, all started together: every record ``ok``.
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

The last three lines are the kernel table as JSON, the card's name and
power limit as ``nvidia-smi`` prints them, and ``{"ok": true, ...}``.  A
full report goes to ``build/chip_smoke.json``.

    python3 chip_smoke.py --kernel-times

builds the kernels and prints only K1's times (fleet shape, the failure
leg's commonest and widest launch shapes) and K4's, as one JSON line (and
``build/kernel_times.json``): copied into two trees, it compares their
kernels in one call.
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
    """The fleet run on ``cuda`` and ``numpy`` in turns (cuda, numpy, numpy,
    cuda), so that host noise shows as the spread within each backend.
    Every leg's schedule must equal the first numpy leg's."""
    from repro_torch.convert import canon

    legs, ref = [], None
    for backend in ("cuda", "numpy", "numpy", "cuda"):
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


def _failure_leg(backend: str, k=8, n_tasks=3000, shapes=None):
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
# shares mistral's), then mistral-nemo-12b's prefill of a 512-token prompt
# (last: phase 5 times it) and its decode over 4 slots of a 1 024-position
# cache.
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 256, 6, 2, 64),
                (1, 512, 4, 4, 128), (1, 128, 14, 2, 64),
                (1, 40, 4, 2, 64), (1, 40, 4, 2, 128), (2, 96, 4, 2, 64),
                (1, 96, 8, 2, 128), (1, 384, 8, 2, 128), (1, 128, 14, 2, 128),
                (1, 512, 16, 16, 128), (1, 128, 8, 8, 64),
                (1, 512, 32, 8, 128)]
DECODE_SHAPES = [(2, 512, 4, 2, 64, 137), (1, 1024, 8, 8, 128, 1023),
                 (2, 256, 6, 2, 64, 0), (1, 512, 16, 16, 64, 300),
                 (4, 1024, 32, 8, 128, 639), (4, 1024, 32, 8, 128, 1023),
                 (4, 1024, 32, 8, 128, 0), (4, 4096, 32, 8, 128, 4095),
                 (4, 1024, 32, 8, 128, 600)]
# K2's bfloat16 path is also held against the plain version of its own
# arithmetic, ``ref.attention_ref(..., p_dtype=bfloat16, p_block=64)`` (P
# rounded to bf16 against the running max of each 64-key tile): |got - want|
# <= rtol |want| + atol, rtol one bf16 ulp at the bottom of a binade.  The
# scores' float32 sums differ in order, which flips a rare rounding of P;
# atol covers those flips (largest reading on the H100: 7.3e-4).
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


def _prefill_logits_f32(cfg, params, prompt, dev):
    """The prefill's last-position logits in float32 throughout, on the
    plain attention path, with each layer's bf16 weights upcast as the
    layer runs (a float32 copy of all the weights would not fit beside
    the bf16 ones).  A uniform stack: dense or MoE."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model

    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32", attn_impl="xla")
    model = Model(cfg32)

    def up(tree):
        return {k: up(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    with torch.no_grad():
        x = params["embed"][torch.as_tensor(prompt[None, :], device=dev).long()].float()
        rope = model._rope(torch.arange(x.shape[1], device=dev))
        mixer, ffn = tf._slot_kind(cfg, 0)
        for li in range(cfg.n_layers):
            lp = up(tf._index_tree(params["stack"], li))
            x, _, _ = tf._apply_layer_full(lp, x, cfg32, rope, mixer, ffn, False)
        head = up({"ln_f": params["ln_f"], "lm_head": params["lm_head"]})
        return model._head(head, x[:, -1:])[0, 0]


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
TRAIN = dict(arch="falcon-mamba-7b", n_layers=16, batch=2, seq=1024, steps=3,
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
    nbytes = 4 * (3 * b * s * d_in + d_in * n + 2 * b * s * n)
    n_exp = b * s * d_in * n
    flops = b * s * d_in * (1 + 6 * n)  # Δx; per state Δ·A, ⊙h, ·B, +, ·C, Σ
    bound = {"bytes": nbytes / HBM_BYTES_S,
             "operations": max(flops / F32_FLOP_S, n_exp / SFU_EXP_S)}
    by = max(bound, key=bound.get)
    return dict(
        shape=dict(B=b, S=s, d_in=d_in, N=n, dtype="float32"),
        ms=_time_ms(lambda: ops.mamba_scan(*inputs), flush=flush),
        ms_l2_warm=_time_ms(lambda: ops.mamba_scan(*inputs)),
        plain_ms=_time_ms(lambda: ref.mamba_scan_ref(*inputs), flush=flush),
        library_ms=None, bound_ms=bound[by] * 1e3, bound_by=by, bytes=nbytes,
        flops=flops, exps=n_exp, flops_ms=flops / F32_FLOP_S * 1e3,
        exps_ms=n_exp / SFU_EXP_S * 1e3, **probe)


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
    run = dict(config=TRAIN, cut="n_layers 64 -> 16 (one H100 holds the bf16 "
               "parameters, gradients and float32 moments of 16 layers, not of 64)",
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
STORM = dict(k=8, tasks=3000, crashes=6, stragglers=16)
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


def _storm_leg(backend, engine):
    """(c) bench_faults.py's storm: host kills, stragglers, retries and
    LATE speculation, under one reroute engine."""
    import torch

    from repro_torch.kernels import ts_plan
    from repro_torch.tools.dump_schedules import fault_storm_setup

    cfg = STORM
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
    return dict(legs=legs, identical=identical)


def phase_scheduler():
    """Phase 8: the rest of the scheduler, each leg on ``cuda`` and then on
    ``numpy`` in one process, byte-identical."""
    t0 = time.perf_counter()
    hier = _phase8_hierarchy()
    rec = _phase8_recovery()
    storm = _phase8_storm()
    first = BACKENDS[0]
    launches = dict(
        hierarchy=hier["legs"][0]["k1_launches"],
        recovery=rec["runs"][first]["k1_launches"],
        fault_storm=sum(leg["k1_launches"] for leg in storm["legs"]
                        if leg["backend"] == first),
    )
    log("scheduler", hierarchy=hier, recovery=rec, storm=storm, k1_launches=launches,
        seconds=time.perf_counter() - t0)
    bad = [k for k, ok in [("hierarchy", hier["identical"]), ("storm", storm["identical"])]
           + list(rec["checks"].items()) if not ok]
    if bad:
        raise AssertionError(f"phase 8: not byte-identical across backends: {bad}")
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
# (b) the 126 M preset at full size: 8 straight steps, and 4 then --resume
# for 4 more, each leg its own process; the two step-8 checkpoints equal.
RESTART = dict(preset="100m", steps=8, cut=4, batch=8, seq=256)
# (c) plan_epoch then prefetch_epoch on phase 3's 4 096 hosts with
# examples/bass_cluster_demo.py's 512 MB shards, three replicas, seed 7, an
# idle backlog; a cuda leg past EPOCH_LIMIT_S halves the shard count.
EPOCH = dict(pods=16, hosts=256, shards=16_384, size_bytes=512e6, replication=3, seed=7)
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
    """(b) ``python -m repro_torch.launch.train --preset 100m``: 8 straight
    steps in one process, beside 4 steps and then ``--resume`` for 4 more
    in two others; every leaf of the two step-8 checkpoints must be the same
    bytes."""
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

# (a) the dry run's CLI, one process per cell, all started together: the
# trainer's cell, the mamba time scan at full size (by formula) and the MoE
# dispatch at 32k.
DRYRUN_CELLS = [("internvl2-1b", "train_4k"), ("falcon-mamba-7b", "prefill_32k"),
                ("moonshot-v1-16b-a3b", "prefill_32k")]


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
    out_dir = os.path.join(HERE, "build", "dryrun_torch")
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "src")}
    procs = {f"{a}__{s}": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
         "--mesh", "single", "--out", out_dir, "--force"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for a, s in DRYRUN_CELLS}

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

    records = {}
    for cell, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        path = os.path.join(out_dir, f"{cell}__pod256.json")
        rec = json.load(open(path)) if os.path.exists(path) else {"ok": False}
        records[cell] = dict(ok=rec["ok"] and proc.returncode == 0,
                             returncode=proc.returncode, tail=stdout.strip()[-200:],
                             **{k: rec.get(k) for k in ("accounting", "roofline", "memory",
                                                        "error")})
        if not records[cell]["ok"]:
            bad.append(f"dryrun {cell}: {rec.get('error')} {stderr[-500:]}")
    log("cost", seconds=time.perf_counter() - t0, steps=steps, dryrun=records,
        region_noop=noop, chip=H100_SXM.name, peak_bf16_flop_s=BF16_FLOP_S,
        hbm_bytes_s=HBM_BYTES_S)
    if bad:
        raise AssertionError(f"phase 11: {bad}")
    return steps


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
        entry["launches_note"] = ("not on the serve path: the model's decode takes "
                                  "the plain path, as the reference's does")
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


def main() -> int:
    import torch

    if sys.argv[1:] == ["--kernel-times"]:
        return kernel_times()
    if sys.argv[1:]:
        raise SystemExit(f"usage: {sys.argv[0]} [--kernel-times]")
    name, smi = phase_device()
    timing = phase_kernels()
    main_cuda = phase_main_path()
    fail_cuda = phase_failure(timing)
    attn = phase_attention()
    serve = phase_serve()
    train = phase_train()
    sched = phase_scheduler()
    models = phase_models()
    trainer = phase_trainer()
    phase_cost()
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
                        **_k2_family_launches(models)),
        _attention_entry("flash_decode", attn["flash_decode"], serve["k3_launches"]), {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:69",
        "launches": train["launches"],
        "launches_note": "on the eval path (16 layers); the train step takes the "
                         "plain scan, as the reference's must (K4 has no backward)",
        "launches_hybrid_eval_path": models["hybrid"]["eval"]["launches"]["mamba_scan"],
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
