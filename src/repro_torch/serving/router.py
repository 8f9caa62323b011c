"""BASS request router — the paper's scheduler at the serving layer.

The mapping is one-to-one with Algorithm 1:

* ``ND_loc``    — replica(s) holding a warm prefix/KV for the request's
  ``prefix_hash`` (data locality: reusing the cache skips prefill compute
  *and* context transfer);
* ``ΥI_j``      — per-replica backlog seconds (ProgressRate-style estimate
  from the engines);
* ``TM``        — context-migration time: moving the prompt/KV bytes to a
  less-loaded replica through the DCN, against the live TS ledger;
* Case 1.2     — migrate iff the bandwidth exists to make the remote
  completion strictly earlier; reserve the slots when we do;
* Case 2       — cold prefixes go to ``ND_minnow`` with a reservation.

The router and the training-side shard placement share ``core`` — one
scheduler, two surfaces, exactly the paper's "global view" point.  The
controller's planning scans run on the ``kernels.ts_plan`` backend in
force — ``cuda`` by default — so on the card every routing decision that
reaches the wavefront planner launches the planning-scan kernel.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.controller import BassPolicy, ClusterController
from ..core.qos import TenantBook, TenantSpec
from ..core.tasks import Assignment, Task
from ..core.topology import Fabric, tpu_dcn_fabric
from ..obs.device import span
from .engine import Request

#: Backlog surcharge (seconds) pricing an unreachable replica out of the
#: minnow choice while it is partitioned from the fabric.
_DEAD_BACKLOG_S = 1e15

#: A routing decision on the timeline (``obs``), keyed by the request's rid.
_ROUTE = span("router.route", device=False)


@dataclass
class RouteDecision:
    rid: int
    replica: str
    migrated_from: Optional[str]
    ready_at: float
    slots: Tuple[int, ...]
    #: True when every replica stayed unreachable through the retry window:
    #: nothing was committed, ``ready_at`` is +inf, and ``replica`` is only
    #: a parking hint (the coldest configured replica) — shed or requeue.
    degraded: bool = False
    #: True when tenant admission control turned the request away before
    #: any scheduling work: nothing committed, ``replica`` is empty.
    rejected: bool = False


class BassRouter:
    def __init__(
        self,
        replicas: Sequence[str],
        fabric: Optional[Fabric] = None,
        decode_s_per_token: float = 0.02,
        bytes_per_ctx_token: float = 2 * 8 * 128 * 2,  # kv bf16, 8 heads × 128
        slot_duration: float = 0.05,
        nic_bytes_per_s: float = 25e9,
        max_retries: int = 3,
        retry_backoff_s: float = 0.05,
        controller=None,
        tenants: Sequence["TenantSpec"] = (),
        fairness_slack_s: float = 1.0,
    ):
        #: Transient all-replicas-dead windows (mid-failover) are retried
        #: with exponential sim-time backoff before degrading — a router
        #: that propagates UnroutableError turns a 50 ms blip into a
        #: caller-visible crash.
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.replicas = list(replicas)
        if controller is not None:
            # Injected backend — typically a ``core.hierarchy``
            # HierarchicalController so per-pod replica groups ride the
            # pod-local fast path; any object with the controller surface
            # (state.set_idle, submit/run_until, jobs, dataplane, obs)
            # works.  The caller owns its configuration.
            missing = [r for r in self.replicas
                       if r not in controller.state.idle]
            if missing:
                raise ValueError(
                    f"injected controller does not own replicas: {missing!r}"
                )
            self.controller = controller
            self.fabric = controller.fabric
        else:
            if fabric is None:
                # star fabric over the replica names (25 GB/s NICs)
                fabric = Fabric()
                for i, r in enumerate(self.replicas):
                    fabric.add_uplink(f"nic{i}", r, "agg", nic_bytes_per_s)
            self.fabric = fabric
            # The long-lived controller owns the ledger: every routed
            # request's context migration is a committed TS reservation
            # that later requests (and other traffic on a shared fabric)
            # must respect.
            self.controller = ClusterController(
                self.fabric,
                self.replicas,
                BassPolicy(),
                slot_duration=slot_duration,
                horizon_slots=2048,
            )
        self.ledger = self.controller.state.ledger
        # Per-tenant QoS (core.qos): token-bucket admission + WFQ weighted
        # fairness.  Tenants beyond ``fairness_slack_s`` of weighted
        # service past the fairness frontier lose the migration fast path
        # (pinned data-local, no new boundary reservations) until the
        # frontier catches up.
        self.tenants = TenantBook(tenants) if tenants else None
        self.fairness_slack_s = fairness_slack_s
        # Routing outcomes in the controller's obs registry, so degraded/
        # load-shed decisions show up in Registry.snapshot() alongside the
        # scheduler counters (bench_recovery asserts shed counts here).
        self.stats = self.controller.obs.group(
            "router",
            ("routed", "migrated", "degraded", "retries", "rejected",
             "pinned"),
        )
        self.decode_s_per_token = decode_s_per_token
        self.bytes_per_ctx_token = bytes_per_ctx_token
        self.prefix_home: Dict[int, List[str]] = {}   # prefix_hash -> replicas
        self.backlog: Dict[str, float] = {r: 0.0 for r in self.replicas}

    def update_backlog(self, backlog: Dict[str, float]) -> None:
        self.backlog.update(backlog)

    # -- network churn (SDN data plane) ------------------------------------
    def fail_link(self, name: str) -> None:
        """A replica NIC/fabric link died: reroute in-flight migrations now
        and steer subsequent requests away from unreachable replicas."""
        self.controller.fail_link(name)
        self.controller.run_until(self.controller.now)

    def recover_link(self, name: str) -> None:
        self.controller.recover_link(name)
        self.controller.run_until(self.controller.now)

    def _alive(self, replica: str) -> bool:
        return self.controller.dataplane.host_alive(replica)

    def _tenant_stats(self, tenant: str):
        return self.controller.obs.group(
            f"tenant.{tenant}",
            ("admitted", "rejected", "pinned", "migrated"),
        )

    def route(self, req: Request, now: float = 0.0,
              tenant: Optional[str] = None) -> RouteDecision:
        with _ROUTE(req.rid):
            work_s = req.max_new * self.decode_s_per_token
            tg = None
            if tenant is not None:
                if self.tenants is None:
                    raise ValueError(
                        f"request tagged tenant={tenant!r} but the router was "
                        "built without tenants"
                    )
                tg = self._tenant_stats(tenant)
                if not self.tenants.admit(tenant, now):
                    # Hard admission control: over-rate tenants are turned
                    # away before any scheduling work or reservation happens.
                    tg["rejected"] += 1
                    self.stats["rejected"] += 1
                    return RouteDecision(
                        rid=req.rid,
                        replica="",
                        migrated_from=None,
                        ready_at=float("inf"),
                        slots=(),
                        degraded=True,
                        rejected=True,
                    )
                tg["admitted"] += 1
            at = max(now, self.controller.now)
            attempt = 0
            while not any(self._alive(r) for r in self.replicas):
                if attempt >= self.max_retries:
                    # Degraded mode: every replica stayed unreachable through
                    # the whole backoff window.  Commit nothing and surface a
                    # non-routable decision instead of raising — parking a
                    # request on a partitioned replica would strand it behind
                    # the 1e15 s backlog surcharge, and propagating would turn
                    # a transient failover window into a caller-visible crash.
                    self.stats["degraded"] += 1
                    return RouteDecision(
                        rid=req.rid,
                        replica=self._coldest(),
                        migrated_from=None,
                        ready_at=float("inf"),
                        slots=(),
                        degraded=True,
                    )
                attempt += 1
                self.stats["retries"] += 1
                # Advance sim time so queued recoveries (link_up/host_up events
                # already on the controller heap) get a chance to fire.
                at += self.retry_backoff_s * (2 ** (attempt - 1))
                self.controller.run_until(at)
            holders = [
                r
                for r in self.prefix_home.get(req.prefix_hash, [])
                if r in self.replicas and self._alive(r)
            ]
            if (tenant is not None
                    and self.tenants.lag(tenant) > self.fairness_slack_s + 1e-9):
                # Weighted fairness: this tenant is past its fair share, so it
                # loses the migration fast path — served data-local (coldest
                # holder, or coldest replica on a cold prefix) with no new
                # boundary reservation, leaving the fabric to tenants the
                # fairness frontier still owes service.
                node = (
                    min(holders, key=lambda r: (self.backlog.get(r, 0.0), r))
                    if holders
                    else self._coldest()
                )
                ready = at + self.backlog.get(node, 0.0)
                self.backlog[node] = self.backlog.get(node, 0.0) + work_s
                home = self.prefix_home.setdefault(req.prefix_hash, [])
                if node not in home:
                    home.append(node)
                self.tenants.charge(tenant, work_s)
                tg["pinned"] += 1
                self.stats["pinned"] += 1
                self.stats["routed"] += 1
                return RouteDecision(
                    rid=req.rid,
                    replica=node,
                    migrated_from=None,
                    ready_at=ready,
                    slots=(),
                )
            # Cold prefix: no usable holders — route to the coldest replica
            # (Case 2-style single-holder task; the data is born there).
            task = Task(
                tid=req.rid,
                size=len(req.prompt) * self.bytes_per_ctx_token,
                compute=work_s,
                replicas=tuple(holders) if holders else (self._coldest(),),
            )
            # ΥI_j = engine backlog (ProgressRate-style estimate), refreshed per
            # request; the controller then places the request as a one-task job.
            # Clamp against the controller clock: request timestamps from
            # concurrent frontends may arrive slightly out of order.
            # Unreachable replicas (dead NIC / partitioned) are priced out of the
            # minnow choice instead of removed — recovery needs no rebuild.
            at = max(at, self.controller.now)
            self.controller.state.set_idle(
                {
                    r: at + self.backlog.get(r, 0.0)
                    if self._alive(r)
                    else at + _DEAD_BACKLOG_S
                    for r in self.replicas
                }
            )
            jid = self.controller.submit([task], at=at)
            self.controller.run_until(at)
            # The router is a long-lived service: drop the per-request record
            # once read (the ledger keeps the reservations) or memory grows
            # with total request count.
            a = self.controller.jobs.pop(jid).assignments[0]
            self.backlog[a.node] = self.backlog.get(a.node, 0.0) + work_s
            self.prefix_home.setdefault(req.prefix_hash, [])
            if a.node not in self.prefix_home[req.prefix_hash]:
                self.prefix_home[req.prefix_hash].append(a.node)
            self.stats["routed"] += 1
            if a.source is not None:
                self.stats["migrated"] += 1
            if tenant is not None:
                self.tenants.charge(tenant, work_s)
                if a.source is not None:
                    tg["migrated"] += 1
            return RouteDecision(
                rid=req.rid,
                replica=a.node,
                migrated_from=a.source,
                ready_at=a.start,
                slots=a.transfer.slots if a.transfer else (),
            )

    def _coldest(self) -> str:
        live = [r for r in self.replicas if self._alive(r)] or self.replicas
        return min(live, key=lambda r: (self.backlog.get(r, 0.0), r))
