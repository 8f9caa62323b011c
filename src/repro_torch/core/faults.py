"""Seeded, deterministic fault injection (DESIGN.md §10).

A :class:`FaultPlan` is a frozen script of host crashes/recoveries,
straggler onsets and link flaps, generated *up front* from a single
``random.Random(seed)`` stream and independent of anything the controller
later decides.  Applying the same plan to the same workload is therefore
reproducible down to the byte: every kill, retry, backoff, blacklist
decision and speculation outcome happens at a scripted sim time, and the
controller's own event loop is already deterministic (heap order =
``(at, submission seq)``), so same seed ⇒ byte-identical schedule dumps.

The plan *compiles to controller events* — ``apply()`` queues each fault
through the public ``fail_host`` / ``recover_host`` / ``straggle`` /
``fail_link`` / ``recover_link`` entry points, the same calls a live
operator (or the heartbeat sweep) would make.  Nothing here reaches into
controller internals.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class HostCrash:
    """Host dies at ``at``; recovers at ``recover_at`` (None: stays dead)."""

    node: str
    at: float
    recover_at: Optional[float] = None


@dataclass(frozen=True)
class StragglerOnset:
    """Whatever runs on ``node`` at ``at`` needs ``factor``× its remaining
    compute (the progress-rate model)."""

    node: str
    at: float
    factor: float


@dataclass(frozen=True)
class LinkFlap:
    """Link dies at ``at`` and comes back at ``up_at``."""

    link: str
    at: float
    up_at: float


@dataclass(frozen=True)
class ControllerCrash:
    """The control plane itself dies at ``at``; recovers at ``recover_at``
    (None: stays headless — the data plane finishes what was installed
    and everything else waits)."""

    at: float
    recover_at: Optional[float] = None


FaultEvent = "HostCrash | StragglerOnset | LinkFlap | ControllerCrash"


@dataclass(frozen=True)
class FaultPlan:
    """A frozen fault script: generate once, apply to any controller."""

    seed: int
    events: Tuple[object, ...] = field(default_factory=tuple)

    @classmethod
    def generate(
        cls,
        seed: int,
        hosts: Sequence[str],
        t0: float,
        t1: float,
        links: Sequence[str] = (),
        n_crashes: int = 0,
        mttr: float = 0.0,
        n_stragglers: int = 0,
        slow_factor: Tuple[float, float] = (2.0, 6.0),
        n_flaps: int = 0,
        flap_duration: float = 1.0,
        n_ctrl_crashes: int = 0,
        ctrl_mttr: float = 1.0,
    ) -> "FaultPlan":
        """Draw a plan from ``random.Random(seed)`` — one stream, fixed
        draw order (crashes, then stragglers, then flaps, then controller
        crashes), so the script is a pure function of the arguments and
        plans drawn before controller crashes existed are byte-identical.

        Crash/straggle/flap times are uniform in ``[t0, t1)``; a crash
        recovers ``mttr`` sim-seconds later (``mttr <= 0``: stays dead);
        straggler factors are uniform in ``slow_factor``.  Hosts are
        sampled without replacement per category (a host can both crash
        and straggle — that is realistic churn).  Controller crashes
        recover ``ctrl_mttr`` later (``<= 0``: stays headless).
        """
        rng = random.Random(seed)
        hosts = list(hosts)
        links = list(links)
        events: List[object] = []
        for node in rng.sample(hosts, min(n_crashes, len(hosts))):
            at = rng.uniform(t0, t1)
            events.append(HostCrash(
                node, at, at + mttr if mttr > 0.0 else None
            ))
        for node in rng.sample(hosts, min(n_stragglers, len(hosts))):
            at = rng.uniform(t0, t1)
            events.append(StragglerOnset(
                node, at, rng.uniform(*slow_factor)
            ))
        for link in rng.sample(links, min(n_flaps, len(links))):
            at = rng.uniform(t0, t1)
            events.append(LinkFlap(link, at, at + flap_duration))
        for _ in range(n_ctrl_crashes):
            at = rng.uniform(t0, t1)
            events.append(ControllerCrash(
                at, at + ctrl_mttr if ctrl_mttr > 0.0 else None
            ))
        events.sort(key=lambda e: (e.at, type(e).__name__, _key(e)))
        return cls(seed=seed, events=tuple(events))

    def apply(self, ctrl) -> None:
        """Queue every scripted fault on the controller's event heap."""
        for ev in self.events:
            if isinstance(ev, HostCrash):
                ctrl.fail_host(ev.node, at=ev.at)
                if ev.recover_at is not None:
                    ctrl.recover_host(ev.node, at=ev.recover_at)
            elif isinstance(ev, StragglerOnset):
                ctrl.straggle(ev.node, ev.factor, at=ev.at)
            elif isinstance(ev, LinkFlap):
                ctrl.fail_link(ev.link, at=ev.at)
                ctrl.recover_link(ev.link, at=ev.up_at)
            elif isinstance(ev, ControllerCrash):
                ctrl.fail_controller(at=ev.at)
                if ev.recover_at is not None:
                    ctrl.recover_controller(at=ev.recover_at)
            else:
                raise TypeError(f"not a fault event: {ev!r}")

    def __str__(self) -> str:
        lines = [f"FaultPlan(seed={self.seed}, {len(self.events)} events)"]
        for ev in self.events:
            lines.append(f"  [t={ev.at:8.2f}] {ev}")
        return "\n".join(lines)


def _key(ev) -> str:
    return getattr(ev, "node", None) or getattr(ev, "link", "")
