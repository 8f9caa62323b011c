"""ProgressRate estimation — paper §V.A, verbatim.

``ProgressRate = ProgressScore / T`` (score ∈ [0,1], T = running time) and
``ΥI = (1 − ProgressScore) / ProgressRate`` estimates when a node frees up.
The paper uses it to feed ``ΥI_j`` into BASS; we use it identically for the
data-ingest backlog *and* as the straggler detector: a worker whose
estimated remaining time exceeds ``straggler_factor ×`` the median is
flagged, and its unfinished shards are re-dispatched through BASS Case 2
(locality starvation → best remote with a TS reservation).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TaskProgress:
    task_id: int
    worker: str
    started_at: float
    score: float = 0.0               # ProgressScore ∈ [0, 1]
    updated_at: float = 0.0


class ProgressTracker:
    def __init__(self, straggler_factor: float = 2.0):
        self.straggler_factor = straggler_factor
        self._tasks: Dict[int, TaskProgress] = {}

    def start(self, task_id: int, worker: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._tasks[task_id] = TaskProgress(task_id, worker, now, 0.0, now)

    def update(self, task_id: int, score: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        tp = self._tasks[task_id]
        tp.score = min(max(score, 0.0), 1.0)
        tp.updated_at = now

    def finish(self, task_id: int) -> None:
        self._tasks.pop(task_id, None)

    # -- paper formulas -------------------------------------------------------
    def remaining(self, task_id: int, now: Optional[float] = None) -> float:
        """ΥI = (1 − ProgressScore) / ProgressRate."""
        now = time.monotonic() if now is None else now
        tp = self._tasks[task_id]
        t = max(now - tp.started_at, 1e-6)
        rate = tp.score / t
        if rate <= 0:
            return float("inf")
        return (1.0 - tp.score) / rate

    def worker_idle_times(self, now: Optional[float] = None) -> Dict[str, float]:
        """ΥI_j per worker = max remaining over its running tasks."""
        now = time.monotonic() if now is None else now
        out: Dict[str, float] = {}
        for tp in self._tasks.values():
            r = self.remaining(tp.task_id, now)
            out[tp.worker] = max(out.get(tp.worker, 0.0), r)
        return out

    def stragglers(self, now: Optional[float] = None) -> List[int]:
        """Tasks whose estimated remaining time ≫ the median (speculative
        re-execution candidates)."""
        now = time.monotonic() if now is None else now
        rem = {tid: self.remaining(tid, now) for tid in self._tasks}
        finite = [v for v in rem.values() if np.isfinite(v)]
        if len(finite) < 2:
            return []
        med = float(np.median(finite))
        if med <= 0:
            return []
        return [tid for tid, v in rem.items() if v > self.straggler_factor * med]
