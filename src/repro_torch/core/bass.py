"""BASS — Bandwidth-Aware Scheduling with Sdn in hadoop (Algorithm 1).

Faithful implementation of the paper's Algorithm 1, per task ``TK_i``:

* Case 1   — a data-local node ``ND_loc`` exists (pick the least-loaded
  replica holder among available workers).
* Case 1.1 — ``ND_loc ≡ ND_minnow`` or ``ΥI_loc ≤ ΥI_minnow`` → run local
  (zero movement cost by Eq. 1).
* Case 1.2 — otherwise compute the bandwidth ``BW_{i,minnow}`` needed for the
  remote completion to beat the local one; if the real-time residue ``BW_rl``
  (the TS ledger, §IV.A) can supply it, run remote and reserve the slots of
  every link on the path ``ND_dataSrc → ND_minnow``.
* Case 1.3 — insufficient residue → run local.
* Case 2   — locality starvation (no replica holder is an available worker)
  → run on ``ND_minnow`` with a slot reservation.

The transfer starts at the destination's idle time ``ΥI_minnow`` — base BASS
does *not* prefetch (that is Pre-BASS, Example 2) — and by the paper's policy
consumes the full path residue until done, i.e. ``TM = SZ / BW_rl``.

The decision logic lives in :class:`repro.core.controller.BassPolicy`
operating on a shared :class:`~repro.core.controller.ClusterState`; this
module is the historical offline entry point — a thin wrapper that remains
byte-identical to the pre-refactor batch scheduler (DESIGN.md §1).  Batch
placement routes through the wavefront engine (``core.wavefront``,
DESIGN.md §5): fused frontier-skipped candidate scans replace the
per-task ledger re-scans, bit-identically — the 4 096-host/40 000-task
fleet config of ``benchmarks/bench_sched_scale.py`` runs several times
faster than the per-task loop.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .controller import (  # noqa: F401  (re-exported legacy surface)
    BassPolicy,
    MinnowHeap,
    choose_source,
    pick_local,
    pick_minnow,
    run_policy,
)
from .tasks import Instance, Schedule, Task
from .timeslot import TimeSlotLedger


def pick_source(
    task: Task,
    dst: str,
    ledger: TimeSlotLedger,
    at: float,
    idle: Optional[Dict[str, float]] = None,
    prefer_least_loaded: bool = False,
) -> Tuple[str, Tuple[int, ...]]:
    """Choose the replica to move data *from* (``ND_dataSrc``).

    Base BASS picks the replica whose path to ``dst`` has the most residual
    bandwidth at transfer time (ties: fewer hops, then name).  Pre-BASS
    prefers the least-loaded holder (Discussion 2: "always moved from the
    least loaded node storing the replica").
    """
    load = idle if (prefer_least_loaded and idle) else None
    return choose_source(task, dst, ledger, at, load=load)


def schedule_bass(
    instance: Instance,
    ledger: Optional[TimeSlotLedger] = None,
    order: Optional[Sequence[int]] = None,
) -> Schedule:
    """Run Algorithm 1 over ``instance.tasks`` (in submission order).

    ``ND_minnow`` is tracked with a lazy min-heap so scheduling stays
    O(m·(log n + R)) for m tasks, n nodes, R replicas — the 4 000-node /
    40 000-task regime of ``benchmarks/bench_sched_scale.py`` runs in
    seconds, which is what "deployable at 1000+ nodes" requires of a
    central controller.
    """
    return run_policy(BassPolicy(), instance, ledger, order=order)
