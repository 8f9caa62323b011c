#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line of output each; any failure exits non-zero before the
result lines are printed:

1. device   — CUDA present and capability (9, 0); build the kernel library
              from ``src/repro_torch/kernels/csrc`` with nvcc.
2. kernels  — the planning-scan kernel (K1) in all three gather forms against
              its plain PyTorch version on CPU copies of the same seeded
              non-dyadic inputs, bit for bit; its time at the main path's
              shape beside the plain version's and the card's bound.
3. main     — BASS wavefront placement of 40 000 tasks on a 4 096-host fleet
              through ``ClusterController``, on the ``cuda`` backend (ledger
              mirror on the card) and on ``numpy``; the schedules must be
              byte-identical and every wave must have launched the kernel.
4. failure  — a k=8 fat-tree with a core switch killed mid-stream; the
              reroute engine's column scans run on the card; schedules and
              reroute logs identical to the ``numpy`` backend's.

The last three lines are the kernel table as JSON, the card's name and
power limit as ``nvidia-smi`` prints them, and ``{"ok": true, ...}``.  A
full report goes to ``build/chip_smoke.json``.
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and vector float64.
HBM_BYTES_S = 3.35e12
F64_FLOP_S = 34e12
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


# -- phase 1 -------------------------------------------------------------------


def phase_device():
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke needs an H100")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    if cap != (9, 0):
        raise SystemExit(f"{name} has capability {cap}, not (9, 0)")
    t0 = time.perf_counter()
    _build.library()
    log("device", name=name, capability=list(cap), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=time.perf_counter() - t0, nvcc_s=_build.build_info["build_s"],
        library=os.path.relpath(_build.build_info["path"], HERE))
    REPORT["ptxas"] = _build.build_info["log"]
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


def _shapes():
    for W in (1, 16, 64, 200, 1024, 4096, 65536):
        ns = (1, 9, 33, 1024) if W <= 200 else ((1, 9, 33) if W == 1024 else (1, 9))
        for n in ns:
            for L in (1, 4, 9):
                yield n, L, W


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

    # Timing at the main path's shape: one wave of the fleet run gathers
    # n≈1 000 candidates × L=4 links × w=64 slots from a 4 112 × 8 192 mirror.
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
    bytes_moved = 8 * (n * L * W + n * L + 6 * n + 3 * n * W + 2 * n)
    flops = n * W * (L + 4) + 8 * n
    bound_s = {"bytes": bytes_moved / HBM_BYTES_S, "operations": flops / F64_FLOP_S}
    bound_by = max(bound_s, key=bound_s.get)
    timing = dict(shape=[n, L, W], mirror=[R, Wm], ms=ms, ms_l2_warm=ms_warm,
                  plain_ms=plain_ms, plain_cpu_ms=plain_cpu_ms,
                  bound_ms=bound_s[bound_by] * 1e3, bound_by=bound_by,
                  bytes=bytes_moved, flops=flops)
    log("kernels", checked=checked, bitwise=True, max_abs_err=max_err, **timing)
    return dict(checked=checked, max_abs_err=max_err, **timing)


# -- phase 3 -------------------------------------------------------------------


def fleet_instance(pods: int, hosts: int, n_tasks: int):
    """The repository's fleet configuration: ``pods × hosts`` TPU-fleet DCN,
    256–640 MB input shards with 3 seeded replicas, 0.1 s slots."""
    from repro_torch.core import Instance, Task, tpu_dcn_fabric

    n_hosts = pods * hosts
    fab = tpu_dcn_fabric(n_pods=pods, hosts_per_pod=hosts)
    workers = [f"pod{p}/host{h}" for p in range(pods) for h in range(hosts)]
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, n_hosts, size=(n_tasks, 3))
    tasks = [
        Task(tid=i, size=float(256e6 + (i % 7) * 64e6), compute=float(0.05),
             replicas=tuple(workers[j] for j in idx[i]))
        for i in range(n_tasks)
    ]
    idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
    return Instance(fabric=fab, workers=workers, idle=idle, tasks=tasks,
                    slot_duration=0.1)


def _reset_counts():
    from repro_torch.kernels import ts_plan, ts_plan_device

    ts_plan_device.stats.reset()
    ts_plan.calls.reset()


def _counts():
    from repro_torch.kernels import ts_plan, ts_plan_device

    return dict(ts_plan_device.stats), dict(ts_plan.calls)


def _fleet_leg(backend: str, pods=16, hosts=256, n_tasks=40_000, batch=1024):
    import torch

    from repro_torch.core import ClusterController
    from repro_torch.kernels import ts_plan

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


def _failure_leg(backend: str, k=8, n_tasks=3000):
    """Sources in the lower pods, workers in the upper ones, so every shard
    crosses the core; half the tasks are placed, core0_0 dies under their
    transfers, then the other half arrive on the degraded fabric."""
    from repro_torch.core import ClusterController, Task, storage_hosts
    from repro_torch.kernels import ts_plan
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
    ts_plan.set_backend(backend)
    _reset_counts()
    t0 = time.perf_counter()
    ctrl = ClusterController(fab, workers, "bass", idle=idle, slot_duration=0.1)
    half = n_tasks // 2
    ctrl.submit(tasks[:half], at=0.0)
    ctrl.run_until(0.0)
    ctrl.fail_switch("core0_0", at=0.5)
    ctrl.submit(tasks[half:], at=1.0)
    ctrl.run()
    dt = time.perf_counter() - t0
    stats, calls = _counts()
    return ctrl, dict(backend=backend, tasks=n_tasks, seconds=dt,
                      rerouted=len(ctrl.reroute_log), stats=stats, calls=calls)


def phase_failure():
    from repro_torch.convert import canon

    def log_canon(c):
        return [(r.flow, r.old_path, r.new_path, float(r.delivered).hex(),
                 float(r.remaining).hex(), float(r.new_end).hex())
                for r in c.reroute_log]

    ctrl, cuda = _failure_leg("cuda")
    ref_ctrl, numpy_leg = _failure_leg("numpy")
    same = canon(ctrl.schedule().assignments) == canon(ref_ctrl.schedule().assignments)
    same_log = log_canon(ctrl) == log_canon(ref_ctrl)
    log("failure", cuda=cuda, numpy=numpy_leg, identical=same, reroute_identical=same_log)
    if not (same and same_log and cuda["rerouted"] > 0):
        raise AssertionError("failure path differs from the numpy backend's")
    if not cuda["stats"]["launches_columns"] > 0:
        raise AssertionError("the reroute engine launched no column scan")
    return cuda


def main() -> int:
    import torch

    name, smi = phase_device()
    timing = phase_kernels()
    main_cuda = phase_main_path()
    fail_cuda = phase_failure()
    kernels = {"kernels": [{
        "name": "ts_plan_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ts_plan.cu",
        "replaces": "src/repro/kernels/ts_plan_device.py:424",
        "launches": main_cuda["stats"]["launches"],
        "launches_failure_path": fail_cuda["stats"]["launches"],
        "max_abs_err": timing["max_abs_err"],
        "checked": timing["checked"],
        "bitwise": True,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
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
