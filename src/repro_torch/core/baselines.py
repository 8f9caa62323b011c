"""Paper baselines: HDS (Hadoop Default Scheduler) and BAR (BAlance-Reduce).

HDS (Discussion 1): node-driven greedy.  Whenever a node becomes idle it
takes an unstarted *data-local* task (lowest task id for determinism — the
paper says "randomly" for the non-local fallback); if no local task remains
it takes the lowest-id remaining task and pays the movement time.  HDS is
bandwidth-*oblivious* in its decisions, but its transfers still traverse the
shared network: movement time is evaluated against the same ledger (without
advance reservation the residue it sees is whatever is left).

BAR (Jin et al., CCGrid'11, as summarized in Discussion 1): phase 1 produces
the data-local allocation (= HDS result); phase 2 repeatedly takes the task
with the *latest* completion time and moves it to a remote node iff that
yields an earlier completion, until no such move exists.  BAR reasons with
static link bandwidth (it "disregards available bandwidth" — no TS ledger).

Both algorithms live in :mod:`repro.core.controller` as policies
(:class:`~repro.core.controller.HdsPolicy`,
:class:`~repro.core.controller.BarPolicy`); these wrappers are the
historical offline entry points, byte-identical to the pre-refactor batch
schedulers (DESIGN.md §1).
"""
from __future__ import annotations

from typing import Optional

from .controller import (  # noqa: F401  (re-exported legacy surface)
    BarPolicy,
    HdsPolicy,
    nearest_source as _nearest_source,
    run_policy,
)
from .tasks import Instance, Schedule
from .timeslot import TimeSlotLedger


def schedule_hds(
    instance: Instance, ledger: Optional[TimeSlotLedger] = None
) -> Schedule:
    return run_policy(HdsPolicy(), instance, ledger)


def schedule_bar(
    instance: Instance, ledger: Optional[TimeSlotLedger] = None
) -> Schedule:
    """BAR: HDS phase-1 allocation, then latest-task remote adjustment."""
    return run_policy(BarPolicy(), instance, ledger)
