"""Independent discrete-event replay of a schedule.

The schedulers compute completion times with Eq. (1)–(3) arithmetic; this
module *replays* an emitted :class:`~repro.core.tasks.Schedule` against the
fabric as an event simulation and re-derives every task's timeline from
first principles.  It is the cross-check oracle used by the property tests:

* node exclusivity — a node runs one task at a time;
* causality        — compute starts only after the task's transfer ends and
                     after the node's previous task finishes;
* link capacity    — summed reservations on any link/slot never exceed 1;
* agreement        — replayed finish times equal the scheduler's to 1e-6.

It also provides :func:`evaluate`, the two-phase (map → shuffle → reduce)
MapReduce makespan evaluator used by the Table-I workload benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tasks import Assignment, Instance, Schedule, Task
from .timeslot import TimeSlotLedger


@dataclass
class ReplayReport:
    makespan: float
    finish: Dict[int, float]
    violations: List[str]

    @property
    def ok(self) -> bool:
        return not self.violations


def _replay_nodes(
    schedule: Schedule,
    tasks: Dict[int, Task],
    idle: Dict[str, float],
    violations: List[str],
    arrival: Optional[Dict[int, float]] = None,
    atol: float = 1e-6,
) -> Dict[int, float]:
    """Per-node sequential replay shared by :func:`replay` (one frozen job)
    and :func:`replay_online` (multi-job arrival streams).

    ``arrival`` maps tid → job submission time; a task can never start (nor
    its transfer be planned) before its job arrived.
    """
    finish: Dict[int, float] = {}
    for node, queue in schedule.by_node().items():
        t = idle.get(node, 0.0)
        for a in queue:
            task = tasks[a.tid]
            ready = a.transfer.end if a.transfer is not None else 0.0
            if arrival is not None:
                ready = max(ready, arrival.get(a.tid, 0.0))
            start = max(t, ready)
            if a.start + atol < start:
                violations.append(
                    f"task {a.tid} on {node} starts at {a.start} before feasible {start}"
                )
            # Schedulers never idle a node: the emitted start must equal the
            # feasible start exactly (prefetch slack is a bug, not a freedom —
            # Pre-BASS recomputes starts as max(node avail, transfer end)).
            if a.start > start + atol:
                violations.append(
                    f"task {a.tid} on {node} idles until {a.start} although "
                    f"feasible at {start}"
                )
            end = a.start + task.compute  # replay honours the schedule's start
            if abs(end - a.finish) > atol:
                violations.append(
                    f"task {a.tid} finish mismatch: schedule {a.finish} replay {end}"
                )
            if a.transfer is not None and a.transfer.end > a.start + atol:
                violations.append(
                    f"task {a.tid} computes at {a.start} before transfer ends "
                    f"at {a.transfer.end}"
                )
            if (
                arrival is not None
                and a.transfer is not None
                and a.transfer.slot_fracs
                and a.transfer.start + atol < arrival.get(a.tid, 0.0)
            ):
                violations.append(
                    f"task {a.tid} transfer starts at {a.transfer.start} "
                    f"before its job arrived at {arrival[a.tid]}"
                )
            if a.start + atol < t:
                violations.append(
                    f"task {a.tid} overlaps previous task on {node}: {a.start} < {t}"
                )
            t = max(t, end)
            finish[a.tid] = end
    return finish


def _check_ledger(schedule: Schedule, violations: List[str]) -> None:
    """Link over-booking (the ledger matrix is the committed state).

    Under the rolling horizon (DESIGN.md §7) the matrix covers only the
    live window — retired columns held delivered history that was subject
    to this same check while it was live, and every replayed plan's
    ``slot_fracs``/times are absolute, so the oracle's causality checks
    below are origin-invariant by construction."""
    res = schedule.ledger.reserved
    if (res > 1.0 + 1e-6).any():
        worst = float(res.max())
        violations.append(f"link over-booked: max reserved fraction {worst:.6f}")


def replay(instance: Instance, schedule: Schedule, atol: float = 1e-6) -> ReplayReport:
    tasks = {t.tid: t for t in instance.tasks}
    violations: List[str] = []
    _check_ledger(schedule, violations)
    finish = _replay_nodes(schedule, tasks, instance.idle, violations, atol=atol)

    missing = set(tasks) - set(finish)
    if missing:
        violations.append(f"unscheduled tasks: {sorted(missing)}")

    mk = max(finish.values()) if finish else 0.0
    return ReplayReport(mk, finish, violations)


def replay_online(
    jobs: Sequence[Tuple[float, Sequence[Task]]],
    schedule: Schedule,
    idle: Dict[str, float],
    atol: float = 1e-6,
) -> ReplayReport:
    """Online cross-check: replay a multi-job stream's combined schedule.

    ``jobs`` is the arrival stream ``[(submit_at, tasks), ...]`` (what was
    fed to :meth:`~repro.core.controller.ClusterController.submit`);
    ``schedule`` is the controller's combined output and ``idle`` the
    cluster's initial ``ΥI_j``.  On top of the offline invariants (node
    exclusivity, transfer-before-compute, no over-booking, no idling past
    the feasible start) it checks *arrival causality*: no task starts — and
    no transfer delivers — before its job was submitted.
    """
    tasks: Dict[int, Task] = {}
    arrival: Dict[int, float] = {}
    violations: List[str] = []
    for submit_at, job_tasks in jobs:
        for t in job_tasks:
            if t.tid in tasks:
                violations.append(f"duplicate tid {t.tid} across jobs")
            tasks[t.tid] = t
            arrival[t.tid] = submit_at

    _check_ledger(schedule, violations)
    finish = _replay_nodes(
        schedule, tasks, idle, violations, arrival=arrival, atol=atol
    )

    missing = set(tasks) - set(finish)
    if missing:
        violations.append(f"unscheduled tasks: {sorted(missing)}")

    mk = max(finish.values()) if finish else 0.0
    return ReplayReport(mk, finish, violations)


# ---------------------------------------------------------------------------
# Two-phase MapReduce evaluation (Table-I-style workloads)
# ---------------------------------------------------------------------------

Scheduler = Callable[[Instance, Optional[TimeSlotLedger]], Schedule]


@dataclass
class JobMetrics:
    """Table-I row: map/reduce/job completion + locality ratio."""

    mt: float
    rt: float
    jt: float
    lr: float
    rerouted: int = 0  # transfers re-planned after link/switch failures
    reexecuted: int = 0     # tasks killed by host crashes and re-placed
    speculative: int = 0    # LATE backup copies launched
    wasted_bytes: float = 0.0  # delivered bytes discarded (kills + spec losers)

    def to_dict(self) -> dict:
        """Plain-dict form for the obs snapshot / JSON artifacts."""
        return {
            "mt": self.mt,
            "rt": self.rt,
            "jt": self.jt,
            "lr": self.lr,
            "rerouted": self.rerouted,
            "reexecuted": self.reexecuted,
            "speculative": self.speculative,
            "wasted_bytes": self.wasted_bytes,
        }


def evaluate_mapreduce(
    map_instance: Instance,
    scheduler: Scheduler,
    reduce_tasks: Sequence[Task],
    shuffle_per_reduce: float,
) -> JobMetrics:
    """Schedule the map phase, then build the reduce phase on the same ledger.

    Reduce tasks start after all maps finish (barrier, as in the paper's JT
    measurements), each shuffles ``shuffle_per_reduce`` units from the map
    nodes (modelled as a transfer from the busiest map node — the shuffle
    bottleneck path) unless the reducer lands there.
    """
    mp = scheduler(map_instance, None)
    ledger = mp.ledger
    mt = mp.makespan

    # Reduce instance: nodes become idle at their last map finish (or their
    # initial idle if they ran nothing), barrier at mt for shuffle start.
    idle = dict(map_instance.idle)
    for a in mp.assignments:
        idle[a.node] = max(idle.get(a.node, 0.0), a.finish)
    for n in idle:
        idle[n] = max(idle[n], mt)

    reduce_instance = Instance(
        fabric=map_instance.fabric,
        workers=list(map_instance.workers),
        idle=idle,
        tasks=list(reduce_tasks),
        slot_duration=map_instance.slot_duration,
    )
    rp = scheduler(reduce_instance, ledger)
    rt = rp.makespan - mt
    jt = max(mp.makespan, rp.makespan)

    n_total = len(mp.assignments) + len(rp.assignments)
    n_local = sum(1 for a in mp.assignments if a.local) + sum(
        1 for a in rp.assignments if a.local
    )
    return JobMetrics(mt=mt, rt=rt, jt=jt, lr=n_local / max(n_total, 1))
