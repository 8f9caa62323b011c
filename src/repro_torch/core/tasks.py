"""Problem formalization — paper §III, Eq. (1)–(5).

``TM_ij = SZ_i / BW(dataSrc, j)``       (1)  data-movement time
``TE_ij = TP_ij + TM_ij``               (2)  execution time
``ΥC_ij = TE_ij + ΥI_j``                (3)  completion time
``ND_j  = argmin_j ΥC_ij``              (4)  per-task objective
``min max_i ΥC_ij``                     (5)  job-level makespan objective
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from .timeslot import TimeSlotLedger, TransferPlan
from .topology import Fabric


@dataclass(frozen=True)
class Task:
    """A map/reduce task ``TK_i`` with a replicated input split."""

    tid: int
    size: float                    # SZ_i in capacity-units·sec (Mbit @ Mbps)
    compute: float                 # TP_ij (homogeneous cluster → scalar)
    replicas: Tuple[str, ...]      # nodes storing the input split
    kind: str = "map"              # map | reduce (for two-phase workloads)


@dataclass
class Assignment:
    """Scheduler output for one task."""

    tid: int
    node: str
    source: Optional[str]              # replica the data moved from, None if local
    transfer: Optional[TransferPlan]   # committed TS reservation, None if local
    start: float                       # compute start time
    finish: float                      # ΥC_ij
    bw_needed: Optional[float] = None  # BW_{i,minnow} from Algorithm 1 line 8

    @property
    def local(self) -> bool:
        return self.source is None


@dataclass(frozen=True)
class BackgroundFlow:
    """Ongoing cross-traffic (the paper's repetitively-executed background
    job): occupies ``fraction`` of every link on src→dst during [start, end).
    The SDN controller sees it in the ledger; bandwidth-oblivious schedulers
    do not account for it when deciding — but their transfers still pay."""

    src: str
    dst: str
    fraction: float
    start: float
    end: float


@dataclass
class Instance:
    """A scheduling problem: cluster + initial load + task list.

    ``workers`` are the *available* nodes (may be a subset of the fabric's
    hosts when the cluster is shared — the paper's locality-starvation case);
    ``idle`` is the initial ``ΥI_j`` per worker (estimated in practice via the
    ProgressRate scheme, §V.A — see ``runtime.progress``).
    """

    fabric: Fabric
    workers: List[str]
    idle: Dict[str, float]
    tasks: List[Task]
    slot_duration: float = 1.0
    background: List[BackgroundFlow] = field(default_factory=list)

    def fresh_ledger(self, horizon_slots: int = 256) -> TimeSlotLedger:
        ledger = TimeSlotLedger(self.fabric, self.slot_duration, horizon_slots)
        for bg in self.background:
            rows = ledger.rows(self.fabric.path(bg.src, bg.dst))
            ledger.occupy(rows, bg.start, bg.end, bg.fraction)
        return ledger


@dataclass
class Schedule:
    """A complete job schedule + derived paper metrics."""

    assignments: List[Assignment]
    ledger: TimeSlotLedger
    kinds: Dict[int, str] = field(default_factory=dict)  # tid -> map|reduce

    @property
    def makespan(self) -> float:
        """Job completion time JT — Eq. (5) objective value."""
        return max((a.finish for a in self.assignments), default=0.0)

    @property
    def locality_ratio(self) -> float:
        """LR = data-local tasks / total tasks (Table I)."""
        if not self.assignments:
            return 0.0
        return sum(1 for a in self.assignments if a.local) / len(self.assignments)

    def by_node(self) -> Dict[str, List[Assignment]]:
        out: Dict[str, List[Assignment]] = {}
        for a in sorted(self.assignments, key=lambda a: (a.start, a.tid)):
            out.setdefault(a.node, []).append(a)
        return out

    def phase_completion(self, kind: str) -> float:
        """MT / RT columns of Table I (latest finish among tasks of ``kind``)."""
        vals = [
            a.finish for a in self.assignments if self.kinds.get(a.tid, "map") == kind
        ]
        return max(vals) if vals else 0.0

    def latest(self) -> Assignment:
        return max(self.assignments, key=lambda a: (a.finish, a.tid))


def movement_time(size: float, bandwidth: float) -> float:
    """Eq. (1): ``TM = SZ / BW`` (0 for a data-local run)."""
    if size <= 0:
        return 0.0
    if bandwidth <= 0:
        return float("inf")
    return size / bandwidth

def execution_time(compute: float, tm: float) -> float:
    """Eq. (2): ``TE = TP + TM``."""
    return compute + tm

def completion_time(compute: float, tm: float, idle: float) -> float:
    """Eq. (3): ``ΥC = TE + ΥI``."""
    return execution_time(compute, tm) + idle


def argmin_completion(
    task: Task,
    nodes: Sequence[str],
    idle: Dict[str, float],
    tm_of: Dict[str, float],
) -> str:
    """Eq. (4): node with the earliest completion time (deterministic ties)."""
    best = min(nodes, key=lambda n: (completion_time(task.compute, tm_of[n], idle[n]), n))
    return best


def makespan_objective(finishes: Sequence[float]) -> float:
    """Eq. (5) evaluated for a fixed assignment."""
    return max(finishes) if len(finishes) else 0.0
