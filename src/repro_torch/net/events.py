"""Network-churn events and reroute records — link failure made schedulable.

The paper's SDN story assumes the controller *reacts*: a link dies, the
global view updates, in-flight transfers move to surviving paths.  These
dataclasses are the vocabulary of that loop.  They flow through
``ClusterController`` like job arrivals do — ``inject_net(LinkDown("Trunk0",
at=12.0))`` queues the failure, and when it fires the controller releases
every affected transfer's unconsumed slots, replans the remaining bytes on
the best surviving candidate path, and appends a :class:`RerouteRecord` to
its ``reroute_log``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Hashable, Optional, Tuple, Union

from .paths import UnroutableError  # noqa: F401  (re-export: routing failure)


@dataclass(frozen=True)
class LinkDown:
    """Link failure at time ``at`` — in-flight transfers on it reroute."""

    link: str
    at: float


@dataclass(frozen=True)
class LinkUp:
    """Link recovery at time ``at`` — suspended raw flows resume."""

    link: str
    at: float


@dataclass(frozen=True)
class SwitchDown:
    """Switch failure: every incident link goes down at ``at``."""

    node: str
    at: float


@dataclass(frozen=True)
class SwitchUp:
    """Switch recovery: incident links return unless individually failed."""

    node: str
    at: float


@dataclass(frozen=True)
class HostDown:
    """Host crash at ``at``: its NIC links die, queued/running tasks are
    killed and re-placed through the normal (bandwidth-aware) policy path."""

    node: str
    at: float


@dataclass(frozen=True)
class HostUp:
    """Host recovery at ``at`` — the worker is re-admitted (unless
    blacklisted) with its idle clock set to the recovery time."""

    node: str
    at: float


@dataclass(frozen=True)
class ControllerDown:
    """Control-plane crash at ``at``: the data plane keeps forwarding on
    installed rules (in-flight transfers complete), but scheduling stops —
    new submissions queue in a bounded mailbox, heartbeat/telemetry chains
    are suspended, and every other event is deferred until recovery."""

    at: float


@dataclass(frozen=True)
class ControllerUp:
    """Control-plane recovery at ``at``: reconcile lapsed rule expiries,
    forgive the heartbeat gap, drain the mailbox in arrival order, and
    re-arm the polling chains."""

    at: float


NetworkEvent = Union[
    LinkDown, LinkUp, SwitchDown, SwitchUp, HostDown, HostUp,
    ControllerDown, ControllerUp,
]


@dataclass(frozen=True)
class RerouteRecord:
    """One successful reroute: what moved, from where, to where, at what cost.

    ``delivered`` is the size already transferred on the dead path (kept —
    its slots before the failure stay consumed); ``remaining`` was replanned
    on ``new_path``.  ``flow`` is the transfer's cookie: ``("job", jid,
    tid)`` for task transfers, the caller's tag for raw flows.
    """

    at: float
    flow: Hashable
    dead_links: Tuple[str, ...]
    src: Optional[str]
    dst: Optional[str]
    old_path: Tuple[str, ...]
    new_path: Tuple[str, ...]
    delivered: float
    remaining: float
    old_end: float
    new_end: float

    def __str__(self) -> str:
        frm = f"{self.src}->{self.dst}" if self.src else str(self.flow)
        return (
            f"[t={self.at:8.2f}] reroute {frm}: dead {sorted(self.dead_links)}"
            f" | {'/'.join(self.old_path)} -> {'/'.join(self.new_path)}"
            f" | {self.delivered:.0f} delivered, {self.remaining:.0f} replanned,"
            f" end {self.old_end:.2f} -> {self.new_end:.2f}"
        )
