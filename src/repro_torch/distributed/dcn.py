"""Cross-pod gradient synchronization over DCN, scheduled by BASS.

Inside a pod, the compiled collectives own the intra-pod links.  *Between*
pods the wire is the data-center network — shared with input-shard
prefetch (Q2) and checkpoint pushes (Q3).  This module gives that hop the
paper's treatment:

* the per-step pod all-reduce is a known-size flow (grad bytes / pod),
  registered with the BASS controller as a Q1 (highest-priority) transfer
  whose TS slots are reserved on the pod trunks *for the projected step
  cadence* — Pre-BASS-style, slots are booked one step ahead so the flow
  never waits;
* optional int8 error-feedback compression (``grad_compress``) shrinks the
  flow 4× when the DCN term dominates the roofline;
* ``cross_pod_allreduce`` is the pod all-reduce (the DCN hop) over a
  ``torch.distributed`` process group whose ranks are the pods.

The controller-side bookkeeping (:class:`StepFlow`, :class:`CrossPodSync`)
is copied from ``repro.distributed.dcn`` unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..core.controller import ClusterController
from ..core.timeslot import TimeSlotLedger, TransferPlan
from ..core.topology import Fabric, storage_hosts, tpu_dcn_fabric


def cross_pod_allreduce(x, group=None, compressed: bool = False):
    """All-reduce ``x`` over ``group``, the process group whose ranks are
    the pods (default: the whole world) — the DCN hop only.

    Uncompressed it is ``all_reduce(SUM)``.  With ``compressed=True`` the
    payload crosses the pod axis as int8 + per-block scales: every rank's
    (payload, scales) pair is all-gathered and the dequantised values are
    summed in rank order — the exact sum of per-pod approximations, as the
    reference's ``shard_map`` body computes it (error feedback is applied
    by the caller, which owns the residual state).  The result is float32."""
    import torch
    import torch.distributed as dist

    from .grad_compress import compress

    if not compressed:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out
    q, scale = compress(x)
    world = dist.get_world_size(group)
    qg = [torch.empty_like(q) for _ in range(world)]
    sg = [torch.empty_like(scale) for _ in range(world)]
    dist.all_gather(qg, q, group=group)
    dist.all_gather(sg, scale, group=group)
    vals = qg[0].float() * sg[0][:, None]
    for q_r, s_r in zip(qg[1:], sg[1:]):
        vals = vals + q_r.float() * s_r[:, None]
    return vals.reshape(-1)[: x.numel()].reshape(x.shape)


@dataclass
class StepFlow:
    """One scheduled cross-pod flow (grad sync for step N)."""

    step: int
    plan: TransferPlan
    bytes: float


class CrossPodSync:
    """BASS-side bookkeeping for the recurring gradient flow.

    The controller holds the DCN fabric + ledger shared with data placement
    and checkpoint traffic; each training step's sync is reserved ahead of
    time (Pre-BASS) at Q1 priority, i.e. other traffic classes see the
    residual bandwidth only.
    """

    def __init__(
        self,
        fabric: Optional[Fabric] = None,
        n_pods: int = 2,
        hosts_per_pod: int = 64,
        grad_bytes: float = 0.0,
        compress: bool = False,
        slot_duration: float = 0.05,
    ):
        self.fabric = fabric or tpu_dcn_fabric(n_pods, hosts_per_pod)
        # The DCN ledger is the controller's: gradient sync shares it with
        # input-shard placement (Q2) and checkpoint pushes (Q3).
        self.controller = ClusterController(
            self.fabric,
            storage_hosts(self.fabric),
            "bass",
            slot_duration=slot_duration,
            horizon_slots=4096,
        )
        self.ledger = self.controller.state.ledger
        self.n_pods = n_pods
        self.compress = compress
        self.grad_bytes = grad_bytes
        self.flows: Dict[int, StepFlow] = {}

    def wire_bytes(self) -> float:
        eff = self.grad_bytes / 4.0 if self.compress else self.grad_bytes
        return 2.0 * eff * (self.n_pods - 1) / self.n_pods

    def _trunks(self) -> list:
        return [f"pod{p}/trunk" for p in range(self.n_pods)]

    def reserve_step(self, step: int, not_before: float) -> StepFlow:
        """Book TS slots on the pod trunks for step ``step``'s sync."""
        rows = self.ledger.rows(self._trunks())
        size = self.wire_bytes()
        plan = self.ledger.plan_transfer(size, rows, not_before=not_before)
        self.ledger.commit(plan)
        flow = StepFlow(step, plan, size)
        self.flows[step] = flow
        return flow

    def register_steps(
        self,
        first_step: int,
        n_steps: int,
        cadence_s: float,
        start_time: float = 0.0,
    ) -> None:
        """Register the next ``n_steps`` syncs as recurring controller
        events at the projected step cadence — Pre-BASS-style, each step's
        slots are booked when its event fires, one step ahead of the
        compute that needs them.  Drive with :meth:`advance_to`.
        """
        size = self.wire_bytes()
        for k in range(n_steps):
            step = first_step + k
            self.controller.reserve_transfer_at(
                start_time + k * cadence_s, size, self._trunks(), tag=step
            )

    def advance_to(self, t: float) -> Dict[int, StepFlow]:
        """Fire every registered sync event with cadence time ≤ ``t``;
        returns the newly materialized per-step flows.

        Also refreshes steps whose plan the controller replaced — a trunk
        failure suspends the flow's unconsumed remainder and recovery
        re-plans it, so the controller-side plan is authoritative."""
        before = set(self.flows)
        self.controller.run_until(t)
        size = self.wire_bytes()
        for tag, plan in self.controller.flows.items():
            if not isinstance(tag, int):
                continue
            cur = self.flows.get(tag)
            if cur is None or cur.plan is not plan:
                self.flows[tag] = StepFlow(tag, plan, size)
        return {s: f for s, f in self.flows.items() if s not in before}

    # -- network churn (SDN data plane) ------------------------------------
    def fail_link(self, name: str, at: Optional[float] = None) -> None:
        """A DCN trunk died: the in-flight sync's unconsumed slots are
        released and its remainder suspends until :meth:`recover_link`
        (explicit-link flows cannot detour — a pod trunk has no sibling)."""
        self.controller.fail_link(name, at=at)
        self.controller.run_until(self.controller.now)

    def recover_link(self, name: str, at: Optional[float] = None) -> None:
        self.controller.recover_link(name, at=at)
        self.controller.run_until(self.controller.now)

    def projected_sync_seconds(self) -> float:
        """What the reservation implies for the roofline's DCN term."""
        rows = self.ledger.rows(self._trunks())
        bw = self.ledger.path_bandwidth(rows, 0.0)
        return self.wire_bytes() / bw if bw > 0 else float("inf")
