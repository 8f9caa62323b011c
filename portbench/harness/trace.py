"""Host spans and the device trace of a run.

``Spans`` records the benchmark's own spans around the calls into the
program's layers (``route``, ``admit``, ``tick``, ``data``, ``upload``,
``step``) on the host's clock.  ``DeviceTrace`` runs ``torch.profiler`` on
the device only over the measured window of a ``--trace 1`` run and reads
the kernels' intervals straight from the profiler's results, without the
profiler's per-event Python processing; the profiler stamps them on the
wall clock, which a pair of readings at the start maps onto the host's
``perf_counter``."""
from __future__ import annotations

import bisect
import gzip
import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple


class Spans:
    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def within(self, name: str, t0: float, t1: float) -> List[Tuple[float, float]]:
        """Spans of ``name`` that start in [t0, t1)."""
        return [(a, b) for n, a, b in self.items if n == name and t0 <= a < t1]

    def mean_ms(self, name: str, t0: float, t1: float) -> Optional[float]:
        """Mean milliseconds of the spans of ``name`` that start in [t0, t1)."""
        spans = self.within(name, t0, t1)
        return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None


#: How far the profiler's first stamp may lie from the wall clock read as it
#: starts; a build that stamps another clock lies days or years away.
CLOCK_TOLERANCE_NS = 1_000_000_000


class DeviceTrace:
    """The device's operations in a window: ``ops`` (name, start, end) in
    host ``perf_counter`` seconds, clipped to the window."""

    def __init__(self):
        self.ops: List[Tuple[str, float, float]] = []
        self.window: Tuple[float, float] = (0.0, 0.0)
        self.clock_offset_s = 0.0
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._perf0, self._wall0 = time.perf_counter(), time.time_ns()

    def stop(self, t0: float, t1: float) -> None:
        """End the trace (after the device has finished) and keep the
        operations inside [t0, t1]."""
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        res = self._prof.profiler.kineto_results
        start = res.trace_start_ns()
        if abs(start - self._wall0) > CLOCK_TOLERANCE_NS:
            raise RuntimeError(f"the profiler's clock starts {(start - self._wall0) / 1e9:+.3f} s "
                               "from the wall clock: its stamps cannot be placed on the host's")
        self.clock_offset_s = (start - self._wall0) / 1e9
        self.window = (t0, t1)
        ops = []
        for ev in res.events():
            if not str(ev.device_type()).endswith("CUDA"):
                continue
            a = self._perf0 + (ev.start_ns() - self._wall0) / 1e9
            b = a + ev.duration_ns() / 1e9
            if b > t0 and a < t1:
                ops.append((ev.name(), max(a, t0), min(b, t1)))
        ops.sort(key=lambda o: o[1])
        self.ops = ops
        self._prof = None

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals."""
        merged: List[List[float]] = []
        for _, a, b in self.ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        for name, a, b in self.ops:
            out[name][0] += 1
            out[name][1] += b - a
        return {k: (v[0], v[1]) for k, v in out.items()}

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, cur = [], self.window[0]
        for a, b in self.busy():
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.window[1] > cur:
            gaps.append((cur, self.window[1]))
        return gaps

    def breakdown(self, spans: Spans) -> dict:
        """The ten device operations that took most time, and the idle time
        by the benchmark's span open on the host (the innermost) at each
        gap's middle, ``none`` where no span was open."""
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:10]
        host = sorted((a, b, n) for n, a, b in spans.items)
        starts = [s[0] for s in host]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in self.idle_gaps():
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1     # the drivers' spans do not nest
            label = host[i][2] if i >= 0 and host[i][1] >= mid else "none"
            idle[label] += b - a
        return {"device_ops": [[name[:160], secs] for name, (_, secs) in top],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10]}

    def export(self, path: Path, spans: Spans) -> None:
        """A Chrome trace of the window's device operations and host spans,
        gzipped, in microseconds from the window's start."""
        t0 = self.window[0]
        events = [{"name": n, "ph": "X", "pid": 0, "tid": 0, "ts": (a - t0) * 1e6,
                   "dur": (b - a) * 1e6} for n, a, b in self.ops]
        events += [{"name": n, "ph": "X", "pid": 1, "tid": 0, "ts": (a - t0) * 1e6,
                    "dur": (b - a) * 1e6} for n, a, b in spans.items
                   if b >= self.window[0] and a <= self.window[1]]
        path.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(path, "wt", compresslevel=1) as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)

