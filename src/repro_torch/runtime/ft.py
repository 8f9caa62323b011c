"""Fault tolerance: heartbeats, failure handling, elastic re-meshing.

The control flow a 1000+-node fleet needs:

1. ``HeartbeatMonitor`` — hosts report liveness; misses ≥ ``grace`` mark a
   host dead (in-process this is driven by the launcher's event loop; on a
   real fleet the reports arrive over the coordinator service).
2. On failure the ``TrainSupervisor`` (a) pauses stepping, (b) rebuilds the
   mesh from the survivors via ``elastic_mesh_shape`` (largest (data×model)
   grid that divides the remaining chip count while keeping the ``model``
   axis intact — TP degree is a property of the checkpoint layout),
   (c) re-lowers the step, (d) restores the latest checkpoint re-sharded
   onto the new mesh, and (e) resumes from the checkpointed step — the data
   pipeline is stateless-addressable so no samples are replayed or skipped.
3. Stragglers (ProgressRate, §V.A) trigger *speculative shard re-dispatch*
   through BASS rather than whole-job restarts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class HostState:
    name: str
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    """Liveness by heartbeat age.

    ``clock`` is the time source consulted whenever a call omits ``now``;
    it defaults to ``time.monotonic`` for the real launcher, but any
    controller integration must inject a *sim-time* clock (see
    ``ClusterController.attach_heartbeats``) — wall-clock sweeps inside a
    discrete-event loop are nondeterministic by construction.
    """

    def __init__(self, hosts: Sequence[str], grace_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        now = clock()
        self.grace_s = grace_s
        self.hosts: Dict[str, HostState] = {
            h: HostState(h, now) for h in hosts
        }

    def beat(self, host: str, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        st = self.hosts[host]
        st.last_beat = now
        st.alive = True

    def revive(self, host: str, now: Optional[float] = None) -> None:
        """Re-admit a recovered host (a beat on a dead host also revives)."""
        self.beat(host, now)

    def suspend_accrual(self, dt: float, now: Optional[float] = None) -> None:
        """Forgive ``dt`` seconds of missed-beat accrual on every live host.

        A dead *controller* hears no heartbeats: when it comes back after a
        ``dt``-second outage, every healthy host looks ``dt`` seconds stale
        and a naive sweep would mass-declare the fleet dead.  Shifting
        ``last_beat`` forward by the outage (capped at ``now`` — a beat
        cannot come from the future) makes the first post-recovery sweep
        judge hosts only on staleness accrued while the controller could
        actually hear them.  Hosts already marked dead stay dead — the
        outage is not evidence of recovery.
        """
        if dt <= 0:
            return
        now = self.clock() if now is None else now
        for st in self.hosts.values():
            if st.alive:
                st.last_beat = min(st.last_beat + dt, now)

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """→ newly-dead hosts."""
        now = self.clock() if now is None else now
        dead = []
        for st in self.hosts.values():
            if st.alive and now - st.last_beat > self.grace_s:
                st.alive = False
                dead.append(st.name)
        return dead

    def alive(self) -> List[str]:
        return [h for h, st in self.hosts.items() if st.alive]


def elastic_mesh_shape(
    n_chips: int, model_axis: int, prefer_pods: Optional[int] = None
) -> Tuple[int, ...]:
    """Largest usable (data, model) grid after losing chips.

    The ``model`` axis is pinned (checkpoint TP layout); we shrink ``data``
    to the largest value with data×model ≤ n_chips.  Returns () if not even
    one model group survives.
    """
    if n_chips < model_axis:
        return ()
    data = n_chips // model_axis
    if prefer_pods and prefer_pods > 1 and data % prefer_pods == 0:
        return (prefer_pods, data // prefer_pods, model_axis)
    return (data, model_axis)


@dataclass
class RestartEvent:
    step: int
    reason: str
    lost_hosts: Tuple[str, ...]
    new_mesh: Tuple[int, ...]


class TrainSupervisor:
    """Deterministic restart policy driven by injected callbacks — unit
    testable without devices; the real launcher wires jax/mesh/checkpoint
    implementations in (see ``launch.train``)."""

    def __init__(
        self,
        monitor: HeartbeatMonitor,
        chips_per_host: int,
        model_axis: int,
        rebuild: Callable[[Tuple[int, ...]], None],
        restore: Callable[[], int],
    ):
        self.monitor = monitor
        self.chips_per_host = chips_per_host
        self.model_axis = model_axis
        self.rebuild = rebuild
        self.restore = restore
        self.events: List[RestartEvent] = []

    def on_tick(self, step: int, now: Optional[float] = None) -> Optional[RestartEvent]:
        dead = self.monitor.sweep(now)
        if not dead:
            return None
        alive = self.monitor.alive()
        shape = elastic_mesh_shape(
            len(alive) * self.chips_per_host, self.model_axis
        )
        if not shape:
            raise RuntimeError(
                f"unrecoverable: {len(alive)} hosts cannot hold one model group"
            )
        self.rebuild(shape)
        restored_step = self.restore()
        ev = RestartEvent(restored_step, "heartbeat-loss", tuple(dead), shape)
        self.events.append(ev)
        return ev
