"""One run of one cell: read the cell from ``BENCHMARK.json``, find its
configuration, traffic mix and limits by name, hand them to the traffic
mix's driver, read every metric of the cell with its own reader, decide
``correct`` and print the result.

Everything that belongs to one configuration, traffic mix, metric or cell
lives in a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``),
``metrics/<metric>.py`` (a ``read(run)`` that returns a number, or None
where the run has nothing for it to read) and ``limits/<cell>.json`` (the
limit of each number that the cell's ``correct`` comparison holds)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..reference.dense import Dims
from .trace import DeviceTrace, Spans

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
#: Top-level modules that no run may have loaded: the JAX package beside
#: the program, and JAX itself (compared by whole top-level name, since the
#: program's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a driver records of one run, for the metric readers."""

    workload: str
    conf: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process0: float
    dims: Dims = None
    window: Tuple[float, float] = (0.0, 0.0)
    spans: Spans = field(default_factory=Spans)
    #: (start, end, tokens) of each piece of served work: an admission (its
    #: prompt and first token) or a tick (a token for each active slot).
    work: List[Tuple[float, float, int]] = field(default_factory=list)
    requests: List[dict] = field(default_factory=list)
    #: Training: steps completed in the window and positions a step.
    steps: int = 0
    step_positions: int = 0
    counters: Dict[str, float] = field(default_factory=dict)
    device_trace: Optional[DeviceTrace] = None
    window_peak_bytes: int = 0
    process_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, float] = field(default_factory=dict)
    #: The program's objects, freed by the traffic mix's ``check`` once the window closes.
    state: Dict[str, Any] = field(default_factory=dict)

    @property
    def out_dir(self) -> Path:
        return ROOT / "build" / "portbench" / self.workload / f"seed-{self.seed}"


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(name: str, spec: dict = None) -> Tuple[dict, dict, dict, dict]:
    """→ (the workload's entry, its configuration, traffic mix, limits)."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return (entry, load_json(ROOT / conf_entry["file"]),
            load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            load_json(HERE / "limits" / f"{name}.json"))


def metric_names(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def read_metric(name: str, run: Run) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared within its limit; a number without a limit or
    a limit without its number is a fault of the benchmark."""
    if set(checks) != set(limits):
        raise ValueError(f"checks {sorted(checks)} against limits {sorted(limits)}")
    return all(math.isfinite(v) and v <= limits[k] for k, v in checks.items())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(run: Run, driver: str, spec: dict) -> dict:
    """Drive ``run`` and read it → the result line's object, ``checks``
    last."""
    mod = importlib.import_module(f"portbench.drivers.{driver}")
    run.dims = Dims.of(run.conf)
    mod.run(run)
    t0, t1 = run.window
    log(f"set-up {t0 - run.t_process0:.2f} s, window {t1 - t0:.2f} s, "
        f"{run.attempted} attempted, {run.failed} failed")
    names = metric_names(spec, run.workload, run.trace)
    metrics = {}
    for m in names:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if run.trace:     # beside the untraced runs' numbers, they give the tracing's cost
        for m in metric_names(spec, run.workload, False):
            log(f"traced run's {m['name']} {read_metric(m['name'], run)!r}")
    breakdown = None
    if run.device_trace is not None:
        tb = time.perf_counter()
        breakdown = run.device_trace.breakdown(run.spans)
        run.device_trace.export(run.out_dir / "trace.json.gz", run.spans)
        log(f"trace: {len(run.device_trace.ops)} device operations read and written in "
            f"{time.perf_counter() - tb:.2f} s, profiler clock {run.device_trace.clock_offset_s:+.6f} s "
            f"from the host's")
    tc = time.perf_counter()
    mod.check(run)
    log(f"check {time.perf_counter() - tc:.2f} s")
    limits = run.limits["checks"]
    out = {"correct": judge(run.checks, limits), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device_record(run)}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in run.checks.items()}
    return out


def device_record(run: Run) -> dict:
    import torch

    rec = {"platform": "gpu" if run.device == "cuda" else run.device,
           "kind": torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.process_peak_bytes}
    if run.device_trace is not None:
        t0, t1 = run.device_trace.window
        rec.update(busy_s=run.device_trace.busy_s(), window_s=t1 - t0)
    return rec


def main(args, t_process0: float) -> int:
    spec = load_json(ROOT / "BENCHMARK.json")
    entry, conf, traffic, limits = cell(args.workload, spec)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"{n} available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    run = Run(workload=args.workload, conf=conf, traffic=traffic, limits=limits,
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda",
              t_process0=t_process0)
    out = execute(run, traffic["driver"], spec)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
