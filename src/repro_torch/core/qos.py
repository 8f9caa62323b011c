"""OpenFlow QoS queues — Discussion 3 / Example 3.

The paper's scheme: an egress port with a maximum rate (150 Mbps in Example
3) is split into rate-limited queues — Q1 = 100 Mbps for shuffle traffic,
Q2 = 40 Mbps for other Hadoop traffic, Q3 = 10 Mbps for background — and
flow entries steer traffic classes into queues.  The claim: shuffle
completion beats the default single shared-rate queue whenever background
traffic competes.

We model HTB-style queues with a *fluid* simulator: each queue's active
flows share the queue's guaranteed rate equally, and unused guaranteed
rate is lent to other active queues (work-conserving).  How it is lent is
the port's ``borrowing`` mode: ``"priority"`` (default) hands all spare to
the single most important active class — OVS max-rate borrowing, and the
behavior every Example-3 number in this repo was produced with — while
``"proportional"`` splits spare across active classes proportionally to
their active-flow demand, classic HTB.  The same model prioritizes
gradient-sync vs data-input vs checkpoint traffic on the TPU DCN (see
``checkpoint`` and ``data``).

:class:`TenantSpec`/:class:`TenantBook` extend the class-level queues to
*per-tenant* QoS: token-bucket admission control plus WFQ-style weighted
fairness accounting, consumed by ``serving.router`` (DESIGN.md §12).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_EPS = 1e-9


@dataclass
class Flow:
    name: str
    size: float          # capacity-units·sec (Mbit at Mbps)
    queue: str           # traffic class
    arrival: float = 0.0
    finish: Optional[float] = None
    _left: float = field(default=0.0, repr=False)


@dataclass(frozen=True)
class QueueSpec:
    name: str
    rate: float          # guaranteed rate
    priority: int = 0    # lower = more important (borrowing order)


class QosPort:
    """One egress port with HTB-like queues (work-conserving borrowing).

    ``borrowing`` selects how spare guaranteed rate is lent:

    * ``"priority"`` (default) — all spare goes to the single
      highest-priority active queue (lowest ``QueueSpec.priority``, name
      tie-break), like OVS max-rate borrowing.  This is the historical
      behavior of this class.
    * ``"proportional"`` — spare is split across the active queues
      proportionally to their active-flow counts, classic HTB sharing.
    """

    BORROWING = ("priority", "proportional")

    def __init__(self, max_rate: float, queues: Sequence[QueueSpec],
                 borrowing: str = "priority"):
        total = sum(q.rate for q in queues)
        if total > max_rate + _EPS:
            raise ValueError(f"queue rates {total} exceed port max_rate {max_rate}")
        if borrowing not in self.BORROWING:
            raise ValueError(
                f"borrowing must be one of {self.BORROWING}, got {borrowing!r}"
            )
        self.max_rate = max_rate
        self.queues = {q.name: q for q in queues}
        self.borrowing = borrowing

    def rates(self, demand: Dict[str, int]) -> Dict[str, float]:
        """Instantaneous per-queue service rate given active-flow counts.

        Every active queue gets its guaranteed rate; spare capacity (the
        port max minus active guarantees) is lent per the port's
        ``borrowing`` mode — entirely to the most important active class
        (``"priority"``), or split proportionally to each active class's
        flow count (``"proportional"``)."""
        active = {q: n for q, n in demand.items() if n > 0}
        if not active:
            return {q: 0.0 for q in self.queues}
        rates = {q: (self.queues[q].rate if q in active else 0.0) for q in self.queues}
        spare = self.max_rate - sum(rates.values())
        if spare <= _EPS:
            return rates
        if self.borrowing == "priority":
            # All spare to the most important active class.
            q = min(active, key=lambda q: (self.queues[q].priority, q))
            rates[q] += spare
        else:
            total_n = sum(active.values())
            for q, n in active.items():
                rates[q] += spare * (n / total_n)
        return rates

    def simulate(self, flows: Sequence[Flow]) -> Dict[str, float]:
        """Fluid simulation → finish time per flow name."""
        flows = [Flow(f.name, f.size, f.queue, f.arrival) for f in flows]
        for f in flows:
            f._left = f.size
        t = 0.0
        pending = sorted(flows, key=lambda f: f.arrival)
        done: Dict[str, float] = {}
        guard = 0
        while len(done) < len(flows):
            guard += 1
            if guard > 100000:
                raise RuntimeError("qos fluid sim did not converge")
            active = [f for f in pending if f.arrival <= t + _EPS and f._left > _EPS]
            next_arrival = min(
                (f.arrival for f in pending if f.arrival > t + _EPS), default=None
            )
            if not active:
                if next_arrival is None:
                    break
                t = next_arrival
                continue
            demand = {}
            for f in active:
                demand[f.queue] = demand.get(f.queue, 0) + 1
            qrates = self.rates(demand)
            per_flow = {
                q: (qrates[q] / n if n else 0.0) for q, n in demand.items()
            }
            # Advance until first completion or next arrival.
            dt_complete = min(
                f._left / per_flow[f.queue] if per_flow[f.queue] > _EPS else float("inf")
                for f in active
            )
            dt = dt_complete
            if next_arrival is not None:
                dt = min(dt, next_arrival - t)
            for f in active:
                f._left -= per_flow[f.queue] * dt
                if f._left <= _EPS:
                    f._left = 0.0
                    done[f.name] = t + dt
            t += dt
        return done


def example3_port(borrowing: str = "priority") -> QosPort:
    """Example 3: max 150 Mbps, Q1=100 (shuffle), Q2=40 (hadoop), Q3=10 (bg)."""
    return QosPort(
        150.0,
        [
            QueueSpec("Q1", 100.0, priority=0),
            QueueSpec("Q2", 40.0, priority=1),
            QueueSpec("Q3", 10.0, priority=2),
        ],
        borrowing=borrowing,
    )


def single_queue_port(max_rate: float = 150.0) -> QosPort:
    """The paper's default scheme: all traffic in one shared queue."""
    return QosPort(max_rate, [QueueSpec("Q", max_rate, priority=0)])


def shuffle_vs_default(
    shuffle_mbit: float, background_mbit: float, n_background: int = 1
) -> Tuple[float, float]:
    """Example-3 comparison: (queued finish, single-queue finish) of shuffle."""
    qport = example3_port()
    flows_q = [Flow("shuffle", shuffle_mbit, "Q1")] + [
        Flow(f"bg{i}", background_mbit, "Q3") for i in range(n_background)
    ]
    queued = qport.simulate(flows_q)["shuffle"]

    dport = single_queue_port()
    flows_d = [Flow("shuffle", shuffle_mbit, "Q")] + [
        Flow(f"bg{i}", background_mbit, "Q") for i in range(n_background)
    ]
    default = dport.simulate(flows_d)["shuffle"]
    return queued, default


# ---------------------------------------------------------------------------
# Per-tenant QoS: token-bucket admission + weighted fairness (DESIGN.md §12)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's QoS class.

    ``weight`` is the WFQ fair-share weight (2.0 earns twice the service
    of 1.0 before counting as over-share); ``rate``/``burst`` parameterize
    the admission token bucket — ``rate`` admissions per second sustained,
    ``burst`` admissions of depth.  The default spec admits everything and
    shares equally."""

    name: str
    weight: float = 1.0
    rate: float = float("inf")
    burst: float = 1.0

    def __post_init__(self):
        if self.weight <= 0.0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.rate <= 0.0 or self.burst <= 0.0:
            raise ValueError(
                f"tenant rate/burst must be > 0, got {self.rate}/{self.burst}"
            )


class TenantBook:
    """Admission control + weighted-fairness accounting over tenants.

    * :meth:`admit` is a per-tenant token bucket: a request costs one
      token, tokens refill at ``spec.rate`` per second up to
      ``spec.burst`` — a tenant over its configured rate is *rejected*
      (hard admission control, before any scheduling work happens).
    * :meth:`charge` is WFQ-style virtual time: serving ``service_s``
      seconds of work advances the tenant's virtual clock by
      ``service_s / weight``, floored at the book-wide minimum so an idle
      tenant re-enters at the current fairness frontier instead of
      claiming its whole idle period as credit.
    * :meth:`lag` is how far a tenant's virtual clock runs ahead of the
      frontier — the router treats tenants beyond a slack as over their
      fair share and denies them the migration fast path (they still run,
      data-local, without new boundary reservations).
    """

    def __init__(self, specs: Sequence[TenantSpec]):
        if not specs:
            raise ValueError("TenantBook needs at least one TenantSpec")
        self.specs: Dict[str, TenantSpec] = {}
        for s in specs:
            if s.name in self.specs:
                raise ValueError(f"duplicate tenant {s.name!r}")
            self.specs[s.name] = s
        self._tokens = {s.name: float(s.burst) for s in specs}
        self._stamp = {s.name: 0.0 for s in specs}
        self._vt = {s.name: 0.0 for s in specs}

    def spec(self, name: str) -> TenantSpec:
        """The tenant's spec; KeyError for unknown tenants (a config
        error, not a policy decision)."""
        return self.specs[name]

    def admit(self, name: str, now: float, cost: float = 1.0) -> bool:
        spec = self.specs[name]
        tok = self._tokens[name]
        if spec.rate != float("inf"):
            dt = now - self._stamp[name]
            if dt > 0.0:
                tok = min(spec.burst, tok + dt * spec.rate)
        else:
            tok = spec.burst
        self._stamp[name] = max(self._stamp[name], now)
        if tok + _EPS < cost:
            self._tokens[name] = tok
            return False
        self._tokens[name] = tok - cost
        return True

    def charge(self, name: str, service_s: float) -> None:
        base = max(self._vt[name], self.floor())
        self._vt[name] = base + service_s / self.specs[name].weight

    def floor(self) -> float:
        """The fairness frontier: the minimum tenant virtual time."""
        return min(self._vt.values())

    def lag(self, name: str) -> float:
        """Weighted service the tenant has received beyond the frontier."""
        return self._vt[name] - self.floor()
