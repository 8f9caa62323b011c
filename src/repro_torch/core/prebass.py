"""Pre-BASS — prefetching extension (Discussion 2 / Example 2).

Run BASS first, then for every data-remote task release its reservation and
re-plan the transfer *as early as the TS ledger allows* (instead of at the
destination's idle time), moving the block from the least-loaded replica
holder.  Compute on each node then starts at ``max(node availability,
transfer end)``, which can pull every later task on that node forward —
Example 2: TK1's transfer moves from TS4..TS8 to TS1..TS5, node N1 finishes
at 32 s instead of 35 s and the job at 34 s (last finisher becomes TK8).

The algorithm lives in :class:`repro.core.controller.PreBassPolicy`; this
wrapper is the historical offline entry point (DESIGN.md §1).  Both the
guard probe and the base BASS pass route through the wavefront engine
(``core.wavefront``, DESIGN.md §5); only the prefetch re-plan loop is
inherently sequential (each re-plan's window depends on the previous
release/commit pair).
"""
from __future__ import annotations

from typing import Optional

from .controller import PreBassPolicy, run_policy  # noqa: F401
from .tasks import Instance, Schedule
from .timeslot import TimeSlotLedger


def schedule_prebass(
    instance: Instance, ledger: Optional[TimeSlotLedger] = None
) -> Schedule:
    """BASS + prefetch refinement; never worse than plain BASS.

    The controller holds the global view, so when it owns the ledger (no
    shared ledger passed in) it evaluates the prefetched schedule against
    the base one and adopts whichever finishes earlier — prefetching with a
    different (least-loaded) source can, on adversarial ledgers, push a
    later task's window back, and the paper's intent ("further reduce the
    job completion time") is a refinement, not a regression."""
    return run_policy(PreBassPolicy(guard=ledger is None), instance, ledger)
