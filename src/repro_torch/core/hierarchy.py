"""Hierarchical controller — the fat-tree's pod structure in the control
plane (DESIGN.md §12).

The flat :class:`~repro.core.controller.ClusterController` owns every host,
every ledger row and one minnow heap; at fleet scale its per-event
``advance`` walks all n workers and every placement scans one global
surface.  This module shards that state machine along the topology:

* :class:`PodController` — the pod-scope reusable unit: the pod's host
  slice, its :class:`~repro.core.timeslot.TimeSlotLedger` shard (the
  pod-internal link rows, own rolling window and §7 origin shift), its
  per-pod counter group, and — in pod-affine mode — its own
  :class:`~repro.core.controller.ClusterState` whose wavefront planner
  plans the pod's arrivals concurrently with every other pod's.
* :class:`HierarchicalState` — an implementation of the
  :class:`~repro.core.controller.SchedulingSurface` protocol over per-pod
  shards: a lazily-clamped idle view plus per-pod lazy minnow structures,
  so the clock advances in O(pods) instead of O(workers) while every value
  any policy reads is bit-identical to the flat, eagerly-clamped state.
* :class:`HierarchicalController` — the root: it owns only the
  core/aggregation (boundary) ledger shard, routes cross-pod placements,
  and periodically rebalances load between pods with the same
  compressed-column residual scoring ``core.reroute`` uses.

Two modes, one byte-parity contract:

* **exact** (default) — placements run the unmodified
  :class:`~repro.core.controller.BassPolicy` Algorithm-1 state machine
  over :class:`HierarchicalState`.  Because the sharded ledger facade is
  float-exact against the flat ledger and the lazy idle/minnow structures
  resolve the same ``(idle, name)`` order, schedule dumps diff empty
  against the flat controller on *any* workload — single-pod or
  cross-pod — as long as the rebalancer is off (it requires affinity).
* **affine** (``affinity=True``) — each task is homed to the pod holding
  most of its replicas and placed by that pod's own state machine against
  the pod shard only; the root handles replica-less and rebalanced tasks
  over the full fabric.  This trades the global Eq.-(1) argmin for pod
  locality and is the mode the rebalancer operates in.

Faults, telemetry, multipath and speculation stay flat-controller
features: the hierarchy schedules healthy fabrics (v1), and the flat
controller remains the oracle for everything else.
"""
from __future__ import annotations

import copy
import heapq
from dataclasses import replace as dc_replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..obs import Registry
from .controller import (
    _EPS,
    BassPolicy,
    ClusterState,
    EventQueue,
    JobRecord,
    MinnowHeap,
    choose_source,
)
from .tasks import Assignment, Schedule, Task
from .timeslot import ShardedLedger, TransferPlan
from .topology import Fabric


class PodController:
    """One pod's slice of the control plane: hosts, ledger shard, counters,
    and (pod-affine mode) its own flat scheduling state machine."""

    __slots__ = ("name", "hosts", "hosts_set", "shard", "stats", "state",
                 "row_map")

    def __init__(self, name, hosts, shard, stats, row_map):
        self.name = name
        self.hosts = list(hosts)
        self.hosts_set = frozenset(hosts)
        self.shard = shard          # the pod-internal TimeSlotLedger shard
        self.stats = stats          # per-pod counter group (repro.obs)
        self.state = None           # affine mode: pod-local ClusterState
        #: local shard row -> global (flat-numbering) row, so pod-placed
        #: transfer plans can be re-expressed in the facade's row space.
        self.row_map = row_map

    def globalize(self, a: Assignment) -> Assignment:
        """Rewrite a pod-placed assignment's transfer rows into global
        facade numbering (the committed shard bookings are untouched —
        this only normalizes the *record* so one Schedule speaks one row
        space)."""
        plan = a.transfer
        if plan is not None and plan.links:
            a.transfer = TransferPlan(
                tuple(self.row_map[r] for r in plan.links),
                plan.start, plan.end, plan.slot_fracs,
            )
        return a


class _LazyIdle(Mapping):
    """The ``ΥI_j`` view of :class:`HierarchicalState`: reads clamp against
    ``now`` lazily, so values equal what the flat state's eager per-event
    ``advance`` loop would have written — without the O(workers) walk."""

    __slots__ = ("_raw", "_state")

    def __init__(self, raw: Dict[str, float], state: "HierarchicalState"):
        self._raw = raw
        self._state = state

    def __getitem__(self, node: str) -> float:
        v = self._raw[node]
        now = self._state.now
        return v if v > now else now

    def __iter__(self):
        return iter(self._raw)

    def __len__(self) -> int:
        return len(self._raw)


class _PodMinnow:
    """Per-pod lazy minnow structure.

    The flat state keeps one exact :class:`MinnowHeap` and re-clamps every
    worker on every ``advance``.  Here each pod splits its workers into a
    heap of *future* entries (raw idle > now) and a name-ordered *stale*
    pool (raw idle <= now, effective key exactly ``(now, name)`` under the
    lazy clamp); advancing the clock costs nothing, and the pod's candidate
    minimum is an O(1) peek after an amortized sync.  The resolved
    ``(idle, name)`` order is identical to the flat heap's.
    """

    __slots__ = ("raw", "hosts", "heap", "stale_heap", "stale_set")

    def __init__(self, raw: Dict[str, float], hosts: Sequence[str],
                 now: float):
        self.raw = raw              # shared with the owning state
        self.hosts = list(hosts)
        self.rebuild(now)

    def rebuild(self, now: float) -> None:
        future = [n for n in self.hosts if self.raw[n] > now]
        self.heap = MinnowHeap({n: self.raw[n] for n in future}, future)
        stale = [n for n in self.hosts if self.raw[n] <= now]
        heapq.heapify(stale)
        self.stale_heap = stale
        self.stale_set = set(stale)

    def _sync(self, now: float) -> None:
        """Move entries the clock has passed into the stale pool."""
        h = self.heap._heap
        while h and h[0][0] <= now:
            n = h[0][1]
            self.heap.remove(n)
            heapq.heappush(self.stale_heap, n)
            self.stale_set.add(n)

    def min_key(self, now: float) -> Optional[Tuple[float, str]]:
        """The pod's minimal ``(clamped idle, name)``, or None if empty."""
        self._sync(now)
        sh, ss = self.stale_heap, self.stale_set
        while sh and sh[0] not in ss:
            heapq.heappop(sh)       # lazily deleted ghost
        best = (now, sh[0]) if sh else None
        h = self.heap._heap
        if h and (best is None or h[0] < best):
            best = h[0]
        return best

    def busy(self, node: str, finish: float, now: float) -> None:
        """Commit path: the worker's idle clock moves to ``finish``."""
        if node in self.stale_set:
            self.stale_set.discard(node)  # heap entry becomes a ghost
        elif node in self.heap._pos:
            self.heap.remove(node)
        self.raw[node] = finish
        if finish > now:
            self.heap.insert(node, finish)
        else:
            self.stale_set.add(node)
            heapq.heappush(self.stale_heap, node)


class HierarchicalState:
    """:class:`~repro.core.controller.SchedulingSurface` over pod shards.

    Same decision surface as the flat :class:`ClusterState` — ``idle``,
    ``workers_set``, ``minnow``, ``choose_source``, ``commit_local``/
    ``commit_remote`` — but idle clamping is lazy, the minnow argmin is a
    min over per-pod candidates, and ``ledger`` is the
    :class:`~repro.core.timeslot.ShardedLedger` facade.  Every value a
    policy reads is bit-identical to the flat state's, so the unmodified
    ``BassPolicy.place`` drives it (parity-tested in
    ``tests/test_hierarchy.py``).
    """

    def __init__(self, fabric: Fabric, partition, workers: Sequence[str],
                 idle: Optional[Dict[str, float]], ledger: ShardedLedger,
                 obs: Registry):
        self.fabric = fabric
        self.partition = partition
        self.workers = list(workers)
        self.workers_set = frozenset(self.workers)
        idle = idle or {}
        self._raw: Dict[str, float] = {
            n: float(idle.get(n, 0.0)) for n in self.workers
        }
        self.idle = _LazyIdle(self._raw, self)
        self.ledger = ledger
        self.now = 0.0
        self.obs = obs
        self.dataplane = None
        self.belief = None
        self.background: list = []
        self._pods: Dict[str, _PodMinnow] = {}
        unpodded = [w for w in self.workers if partition.pod_of(w) is None]
        if unpodded:
            raise ValueError(
                f"workers outside every pod cannot be sharded: {unpodded!r}"
            )
        for p in partition.pods:
            hosts = [h for h in partition.pod_hosts[p]
                     if h in self.workers_set]
            if hosts:
                self._pods[p] = _PodMinnow(self._raw, hosts, self.now)
        self._pod_list = list(self._pods.values())

    # -- queries ------------------------------------------------------------
    def minnow(self) -> str:
        best = None
        for pm in self._pod_list:
            k = pm.min_key(self.now)
            if k is not None and (best is None or k < best):
                best = k
        if best is None:
            raise ValueError("no workers")
        return best[1]

    def choose_source(self, task: Task, dst: str, at: float,
                      load: Optional[Dict[str, float]] = None, belief=None):
        return choose_source(task, dst, self.ledger, at, load=load,
                             belief=belief)

    # -- mutations ----------------------------------------------------------
    def advance(self, t: float) -> None:
        """Online clock in O(pods): the idle view clamps lazily, so only
        the rolling-horizon retire hook needs the new time."""
        if t < self.now:
            raise ValueError(f"time moves backwards: {t} < {self.now}")
        self.now = t
        self.ledger.maybe_retire(t)

    def set_idle(self, idle: Dict[str, float]) -> None:
        """Replace idle estimates wholesale.  Values below ``now`` read
        back clamped to ``now`` — the flat state reaches the same values
        one ``advance`` later, before any placement can observe them."""
        for n, v in idle.items():
            if n in self._raw:
                self._raw[n] = float(v)
        for pm in self._pod_list:
            pm.rebuild(self.now)

    def _busy(self, node: str, finish: float) -> None:
        self._pods[self.partition.host_pod[node]].busy(node, finish, self.now)

    # -- the single Assignment-emission path (SchedulingSurface) ------------
    def commit_local(self, task: Task, node: str,
                     bw_needed: Optional[float] = None) -> Assignment:
        start = self.idle[node]
        finish = start + task.compute
        self._busy(node, finish)
        return Assignment(task.tid, node, None, None, start, finish,
                          bw_needed)

    def commit_remote(self, task: Task, node: str, src: str,
                      plan: TransferPlan,
                      bw_needed: Optional[float] = None) -> Assignment:
        self.ledger.commit(plan)
        start = plan.end if plan.slot_fracs else self.idle[node]
        finish = start + task.compute
        self._busy(node, finish)
        return Assignment(task.tid, node, src, plan, start, finish,
                          bw_needed)


class _AffineStateView:
    """The slim ``controller.state`` surface in pod-affine mode: idle
    reads/refreshes fan out to the pod states (what ``serving.router``
    needs); everything else lives on the pods themselves."""

    __slots__ = ("_ctl",)

    def __init__(self, ctl: "HierarchicalController"):
        self._ctl = ctl

    @property
    def ledger(self):
        return self._ctl.ledger

    @property
    def now(self) -> float:
        return self._ctl.now

    @property
    def idle(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for pc in self._ctl.pods.values():
            out.update(pc.state.idle)
        return out

    def set_idle(self, idle: Dict[str, float]) -> None:
        for pc in self._ctl.pods.values():
            sub = {n: v for n, v in idle.items() if n in pc.state.idle}
            if sub:
                pc.state.set_idle(sub)


class HierarchicalController:
    """Root of the pod hierarchy: owns the boundary (core/aggregation)
    ledger shard, routes cross-pod placements, and rebalances pod load.

    ``affinity=False`` (default) is the byte-parity mode described in the
    module docstring; ``affinity=True`` homes each task to the pod holding
    most of its replicas and lets the pods place independently.
    ``rebalance_interval`` (affine only) arms a periodic load check: after
    ``rebalance_hysteresis`` consecutive checks where the most loaded
    pod's backlog exceeds ``rebalance_ratio``× the mean, arrivals homed to
    that pod are re-routed for one interval to the pod with the best
    boundary residual (the same compressed-column scoring
    ``core.reroute`` uses), then a cooldown suppresses re-triggering.
    """

    def __init__(
        self,
        fabric: Fabric,
        workers: Sequence[str],
        policy: "BassPolicy | str" = "bass",
        idle: Optional[Dict[str, float]] = None,
        slot_duration: float = 1.0,
        horizon_slots: int = 256,
        partition=None,
        affinity: bool = False,
        rebalance_interval: Optional[float] = None,
        rebalance_ratio: float = 1.25,
        rebalance_hysteresis: int = 2,
        rebalance_cooldown: Optional[float] = None,
        k_paths: int = 4,
    ) -> None:
        if isinstance(policy, str):
            if policy != "bass":
                raise ValueError(
                    f"hierarchical controller schedules with BASS only, "
                    f"got {policy!r}"
                )
            policy = BassPolicy()
        if not isinstance(policy, BassPolicy) or policy.multipath \
                or policy.telemetry:
            raise ValueError(
                "hierarchical controller v1 supports single-path, "
                "oracle-ledger BassPolicy only"
            )
        self.policy = policy
        self.fabric = fabric
        if partition is None:
            from ..net.fattree import pod_partition

            partition = pod_partition(fabric)
        self.partition = partition
        self.workers = list(workers)
        self.slot_duration = float(slot_duration)
        self.horizon_slots = int(horizon_slots)
        self.affinity = bool(affinity)
        if rebalance_interval is not None and not self.affinity:
            raise ValueError(
                "rebalancing requires affinity=True — exact mode is the "
                "flat controller's byte-parity oracle and must not re-home"
            )
        self.rebalance_interval = rebalance_interval
        self.rebalance_ratio = float(rebalance_ratio)
        self.rebalance_hysteresis = int(rebalance_hysteresis)
        self.rebalance_cooldown = (
            2.0 * rebalance_interval if rebalance_cooldown is None
            and rebalance_interval is not None else rebalance_cooldown
        )
        self.ledger = ShardedLedger(
            fabric, partition.groups(), slot_duration=slot_duration,
            horizon_slots=horizon_slots,
        )
        self.obs = Registry()
        self._stats = self.obs.group(
            "hier",
            ("events", "jobs", "tasks", "cross_pod", "rehomed",
             "rebalance_checks", "rebalance_triggers"),
        )
        wset = frozenset(self.workers)
        self.pods: Dict[str, PodController] = {}
        grow = self.ledger._row
        for p in partition.pods:
            hosts = [h for h in partition.pod_hosts[p] if h in wset]
            if not hosts:
                continue
            shard = self.ledger.shards[p]
            row_map = tuple(grow[name] for name in shard._names)
            self.pods[p] = PodController(
                p, hosts, shard,
                self.obs.group(f"pod.{p}",
                               ("tasks", "local", "remote",
                                "cross_in", "cross_out", "rehomed")),
                row_map,
            )
        covered = frozenset(h for pc in self.pods.values() for h in pc.hosts)
        missing = [w for w in self.workers if w not in covered]
        if missing:
            raise ValueError(f"workers outside every pod: {missing!r}")
        if self.affinity:
            idle = idle or {}
            for pc in self.pods.values():
                pc.state = ClusterState(
                    fabric, pc.hosts,
                    {n: float(idle.get(n, 0.0)) for n in pc.hosts},
                    ledger=pc.shard, slot_duration=slot_duration,
                )
            self.state = _AffineStateView(self)
        else:
            self.state = HierarchicalState(
                fabric, partition, self.workers, idle, self.ledger, self.obs
            )
        # The SDN data plane (liveness queries for serving.router; the
        # hierarchy never mutates it — faults stay a flat-controller
        # feature).  Lazy import keeps core→net one-way at module load.
        from ..net.dataplane import DataPlane

        self.dataplane = DataPlane(fabric, k=k_paths)
        self.jobs: Dict[int, JobRecord] = {}
        self._queue = EventQueue()
        self._next_jid = 0
        self.now = 0.0
        # -- rebalancer state ------------------------------------------------
        self._reb_pending = False   # a rebalance tick is queued
        self._reb_streak = 0        # consecutive imbalanced checks
        self._rehome_from: Optional[str] = None
        self._rehome_until = 0.0
        self._cooldown_until = 0.0
        self._loads: Dict[str, float] = {}
        # -- crash recovery --------------------------------------------------
        self.journal = None
        self._replaying = False
        self._in_run = False
        self.obs.register_provider("hierarchy", self._hier_obs)

    # -- write-ahead journal (per-shard WAL segments, DESIGN.md §12) --------
    def attach_journal(self, journal=None):
        """Attach a :class:`~repro.core.journal.ShardedJournal` (default)
        or a plain :class:`~repro.core.journal.Journal`: every public
        entry-point call (``submit``, ``run_until``, ``run``) is recorded
        with resolved arguments.  With a sharded journal, a submit whose
        tasks home to one pod lands in that pod's segment; the clock
        advances land in the root segment."""
        if self.journal is not None:
            raise RuntimeError("journal already attached")
        from .journal import ShardedJournal

        self.journal = journal if journal is not None else ShardedJournal()
        return self.journal

    def _journal(self, op: str, *args, shard: Optional[str] = None) -> None:
        j = self.journal
        if j is None or self._replaying or self._in_run:
            return
        from .journal import ShardedJournal

        if isinstance(j, ShardedJournal):
            j.append(op, *args, shard=shard or ShardedJournal.ROOT)
        else:
            j.append(op, *args)

    # -- entry points -------------------------------------------------------
    def submit(self, tasks: Sequence[Task], at: float = 0.0,
               jid: Optional[int] = None) -> int:
        """Queue a job (its full task list) to arrive at time ``at``."""
        if jid is None:
            jid = self._next_jid
        if jid in self.jobs:
            raise ValueError(f"duplicate job id {jid}")
        shard = None
        if self.affinity and tasks:
            shard = self._home_pod(tasks[0])
        self._journal("submit", float(at), int(jid), tuple(tasks),
                      shard=shard)
        self._next_jid = max(self._next_jid, jid + 1)
        self.jobs[jid] = JobRecord(jid, at, list(tasks))
        self._push(at, "job", (jid,))
        return jid

    def _push(self, at: float, kind: str, payload: tuple) -> None:
        if at < self.now - _EPS:
            raise ValueError(
                f"event at {at} is in the controller's past {self.now}"
            )
        self._queue.push(at, kind, payload)
        if (self.rebalance_interval is not None and not self._reb_pending
                and self._queue.n_real):
            self._arm_rebalance()

    def _arm_rebalance(self) -> None:
        """Same chain pattern as the flat controller's poll/heartbeat
        ticks: the tick re-arms only while real work is queued, so
        ``run()`` still terminates."""
        self._reb_pending = True
        self._queue.push(self.now + self.rebalance_interval, "rebalance", ())

    def run_until(self, t: float) -> None:
        """Process every queued event with fire time ≤ ``t``, in time
        order (ties: submission order) — the flat loop's contract."""
        self._journal("run_until", float(t))
        q = self._queue
        while q and q.next_at() <= t + _EPS:
            at, _seq, kind, payload = q.pop()
            self.now = max(self.now, at)
            self._clock(self.now)
            self._stats["events"] += 1
            if kind == "job":
                (jid,) = payload
                self._stats["jobs"] += 1
                with self.obs.span("hier.drain"):
                    self._drain(self.jobs[jid])
            elif kind == "rebalance":
                self._reb_pending = False
                self._on_rebalance()
                if q.n_real:
                    self._arm_rebalance()
        self.now = max(self.now, t)
        self.ledger.maybe_retire(self.now)

    def run(self) -> None:
        """Drain the event queue completely."""
        self._journal("run")
        was_in_run, self._in_run = self._in_run, True
        try:
            while self._queue:
                self.run_until(self._queue.next_at())
        finally:
            self._in_run = was_in_run

    def _clock(self, t: float) -> None:
        if self.affinity:
            # Pod states advance lazily at placement; the facade still
            # retires fully-past slots so windows stay O(horizon).
            self.ledger.maybe_retire(t)
        else:
            self.state.advance(max(self.state.now, t))

    # -- placement ----------------------------------------------------------
    def _drain(self, rec: JobRecord) -> None:
        if self.affinity:
            self._drain_affine(rec)
        else:
            # Exact mode: the unmodified Algorithm-1 state machine over the
            # hierarchical surface.  The per-task loop is bit-identical to
            # the flat controller's wavefront batch path (the wavefront's
            # own contract), so dumps diff empty against flat.
            out = []
            for task in rec.tasks:
                a = self.policy.place(task, self.state)
                self._account(task, a)
                out.append(a)
            rec.assignments = out
            rec.placed = True

    def _account(self, task: Task, a: Assignment) -> None:
        dpod = self.partition.host_pod[a.node]
        g = self.pods[dpod].stats
        g["tasks"] += 1
        self._stats["tasks"] += 1
        if a.source is None:
            g["local"] += 1
            return
        g["remote"] += 1
        spod = self.partition.host_pod.get(a.source)
        if spod != dpod:
            g["cross_in"] += 1
            self._stats["cross_pod"] += 1
            if spod in self.pods:
                self.pods[spod].stats["cross_out"] += 1

    # -- pod-affine placement ------------------------------------------------
    def _home_pod(self, task: Task) -> Optional[str]:
        """The pod holding most of the task's replicas (ties: lexically
        first pod name); None when no replica is a live pod worker."""
        counts: Dict[str, int] = {}
        for r in task.replicas:
            p = self.partition.host_pod.get(r)
            if p in self.pods and r in self.pods[p].hosts_set:
                counts[p] = counts.get(p, 0) + 1
        if not counts:
            return None
        return min(counts, key=lambda p: (-counts[p], p))

    def _rehome_active(self, home: Optional[str]) -> bool:
        return (home is not None and home == self._rehome_from
                and self.now < self._rehome_until and len(self.pods) > 1)

    def _drain_affine(self, rec: JobRecord) -> None:
        at = self.now
        by_pod: Dict[str, List[Task]] = {}
        cross: List[Tuple[Task, Optional[str]]] = []
        for task in rec.tasks:
            home = self._home_pod(task)
            if home is None or self._rehome_active(home):
                cross.append((task, home))
            else:
                by_pod.setdefault(home, []).append(task)
        by_tid: Dict[int, Assignment] = {}
        for pname in sorted(by_pod):
            pc = self.pods[pname]
            st = pc.state
            st.advance(max(st.now, at))
            # Clip each task's replica set to the pod so the pod's planner
            # (and its wavefront) only ever touches shard-local rows; the
            # home-pod argmax guarantees at least one replica survives.
            ptasks = [
                t if all(r in pc.hosts_set for r in t.replicas)
                else dc_replace(t, replicas=tuple(
                    r for r in t.replicas if r in pc.hosts_set))
                for t in by_pod[pname]
            ]
            placed = self.policy.place_batch(ptasks, st)
            for t, a in zip(by_pod[pname], placed):
                by_tid[t.tid] = pc.globalize(a)
                self._account(t, a)
        for task, home in cross:
            a = self._place_cross(task, self._pick_target(task, home),
                                  rehomed=home is not None)
            by_tid[task.tid] = a
            self._account(task, a)
        rec.assignments = [by_tid[t.tid] for t in rec.tasks]
        rec.placed = True

    def _place_cross(self, task: Task, pod_name: str,
                     rehomed: bool = False) -> Assignment:
        """Root-routed placement: destination is ``pod_name``'s minnow,
        data moves over the full fabric (boundary shard included) through
        the facade ledger."""
        pc = self.pods[pod_name]
        st = pc.state
        st.advance(max(st.now, self.now))
        dst = st.minnow()
        at_dst = st.idle[dst]
        if rehomed:
            self._stats["rehomed"] += 1
            pc.stats["rehomed"] += 1
        if dst in task.replicas or not task.replicas:
            return st.commit_local(task, dst)
        src, rows = choose_source(task, dst, self.ledger, at_dst)
        plan = self.ledger.plan_transfer(task.size, rows, not_before=at_dst)
        self.ledger.commit(plan)
        start = plan.end if plan.slot_fracs else at_dst
        finish = start + task.compute
        st.idle[dst] = finish
        st.heap.update(dst, finish)
        return Assignment(task.tid, dst, src, plan, start, finish)

    # -- rebalancer ----------------------------------------------------------
    def _pod_loads(self) -> Dict[str, float]:
        """Mean per-worker backlog (idle beyond ``now``) per pod."""
        now = self.now
        out = {}
        for p, pc in self.pods.items():
            tot = 0.0
            for n in pc.state.workers:
                v = pc.state.idle[n] - now
                if v > 0.0:
                    tot += v
            out[p] = tot / len(pc.state.workers)
        return out

    def _on_rebalance(self) -> None:
        self._stats["rebalance_checks"] += 1
        self._loads = loads = self._pod_loads()
        if len(loads) < 2:
            return
        mean = sum(loads.values()) / len(loads)
        hi = max(loads, key=lambda p: (loads[p], p))
        imbalanced = mean > 0.0 and loads[hi] > self.rebalance_ratio * mean
        if not imbalanced:
            self._reb_streak = 0
            self._rehome_from = None
            return
        self._reb_streak += 1
        if (self._reb_streak >= self.rebalance_hysteresis
                and self.now >= self._cooldown_until):
            self._stats["rebalance_triggers"] += 1
            self._rehome_from = hi
            self._rehome_until = self.now + self.rebalance_interval
            self._cooldown_until = self.now + self.rebalance_cooldown
            self._reb_streak = 0

    def _pick_target(self, task: Task, home: Optional[str]) -> str:
        """Where a cross-pod task lands: lowest-load pod first, ties broken
        by the boundary path's residual bandwidth from the task's best
        home replica — the same compressed-column ledger scoring
        ``core.reroute`` ranks failover candidates with."""
        cands = [p for p in sorted(self.pods) if p != home]
        if not cands:
            return home
        if len(cands) == 1:
            return cands[0]
        rep = None
        if home is not None:
            reps = [r for r in task.replicas
                    if self.partition.host_pod.get(r) == home]
            rep = min(reps) if reps else None
        if rep is None and task.replicas:
            rep = min(task.replicas)
        loads = self._loads
        if rep is None:
            return min(cands, key=lambda p: (loads.get(p, 0.0), p))
        scores = []
        for p in cands:
            if self.partition.host_pod.get(rep) == p:
                scores.append(float("inf"))
                continue
            rows = self.ledger.path_rows(rep, self.pods[p].hosts[0])
            scores.append(float(self.ledger.path_bandwidth(rows, self.now)))
        best = min(
            range(len(cands)),
            key=lambda i: (loads.get(cands[i], 0.0), -scores[i], cands[i]),
        )
        return cands[best]

    # -- results -------------------------------------------------------------
    def schedule(self) -> Schedule:
        """All placed assignments across jobs, as one Schedule (global
        facade row numbering in both modes)."""
        out = [a for rec in self.jobs.values() for a in rec.assignments]
        kinds = {
            t.tid: t.kind for rec in self.jobs.values() for t in rec.tasks
        }
        out.sort(key=lambda a: a.tid)
        return Schedule(out, self.ledger, kinds=kinds)

    def job_metrics(self, jid: int):
        """Per-job Table-I row relative to arrival: MT/RT/JT/LR — the flat
        controller's exact formula."""
        from .simulator import JobMetrics

        rec = self.jobs[jid]
        if not rec.placed:
            raise ValueError(f"job {jid} not placed yet (run_until?)")
        kinds = {t.tid: t.kind for t in rec.tasks}
        jt = rec.makespan - rec.submit_at
        maps = [a.finish for a in rec.assignments
                if kinds.get(a.tid, "map") == "map"]
        mt = (max(maps) - rec.submit_at) if maps else jt
        n = len(rec.assignments)
        lr = sum(1 for a in rec.assignments if a.local) / n if n else 0.0
        return JobMetrics(mt=mt, rt=jt - mt, jt=jt, lr=lr)

    # -- observability --------------------------------------------------------
    def _hier_obs(self) -> dict:
        out = {
            "pods": len(self.pods),
            "affinity": int(self.affinity),
            "boundary_links": len(self.partition.boundary_links),
            "rebalance_streak": self._reb_streak,
            "rehome_from": self._rehome_from or "",
        }
        for p, pc in sorted(self.pods.items()):
            out[f"{p}.hosts"] = len(pc.hosts)
            out[f"{p}.links"] = len(pc.shard._names)
            if self._loads:
                out[f"{p}.load"] = self._loads.get(p, 0.0)
        return out

    # -- full-fidelity snapshots + recovery (DESIGN.md §12) ------------------
    def snapshot(self):
        """A :class:`~repro.core.journal.ControllerSnapshot` of the whole
        hierarchy at the current journal position: per-shard ledger
        windows, per-pod (or lazy global) idle clocks, the event heap
        verbatim, jobs, rebalancer state and the obs counters —
        ``recover_from`` restores a byte-identical twin."""
        from .journal import ControllerSnapshot

        with self.obs.span("recovery.snapshot"):
            if self.affinity:
                idle = {
                    p: (dict(pc.state.idle), pc.state.now)
                    for p, pc in self.pods.items()
                }
            else:
                idle = (dict(self.state._raw), self.state.now)
            payload = {
                "config": {
                    "workers": list(self.workers),
                    "slot_duration": self.slot_duration,
                    "horizon_slots": self.horizon_slots,
                    "affinity": self.affinity,
                    "rebalance_interval": self.rebalance_interval,
                    "rebalance_ratio": self.rebalance_ratio,
                    "rebalance_hysteresis": self.rebalance_hysteresis,
                    "rebalance_cooldown": self.rebalance_cooldown,
                },
                "now": self.now,
                "ledger": self.ledger.dump_state(),
                "events": list(self._queue.items),
                "seq": self._queue.seq,
                "n_real": self._queue.n_real,
                "jobs": copy.deepcopy(self.jobs),
                "next_jid": self._next_jid,
                "idle": idle,
                "rebalance": (self._reb_streak, self._rehome_from,
                              self._rehome_until, self._cooldown_until,
                              dict(self._loads)),
                "obs": self.obs.dump_values(),
            }
        lsn = self.journal.lsn if self.journal is not None else 0
        return ControllerSnapshot(lsn=lsn, payload=payload)

    @classmethod
    def recover_from(cls, fabric: Fabric, snapshot,
                     journal=None) -> "HierarchicalController":
        """Restore a snapshot and replay ``journal.since(snapshot.lsn)``
        through the public entry points — byte-identical to a hierarchy
        that never crashed (property-tested in ``tests/test_hierarchy.py``).
        With a :class:`~repro.core.journal.ShardedJournal`, the per-shard
        segments are merged back into global LSN order first."""
        p = snapshot.payload
        cfg = p["config"]
        ctl = cls(
            fabric, cfg["workers"],
            slot_duration=cfg["slot_duration"],
            horizon_slots=cfg["horizon_slots"],
            affinity=cfg["affinity"],
            rebalance_interval=cfg["rebalance_interval"],
            rebalance_ratio=cfg["rebalance_ratio"],
            rebalance_hysteresis=cfg["rebalance_hysteresis"],
            rebalance_cooldown=cfg["rebalance_cooldown"],
        )
        ctl.ledger.load_state(p["ledger"])
        ctl._queue.items = list(p["events"])
        ctl._queue.seq = p["seq"]
        ctl._queue.n_real = p["n_real"]
        ctl._reb_pending = any(
            ev[2] == "rebalance" for ev in ctl._queue.items
        )
        ctl.jobs = copy.deepcopy(p["jobs"])
        ctl._next_jid = p["next_jid"]
        ctl.now = p["now"]
        if ctl.affinity:
            for pname, (idle, pnow) in p["idle"].items():
                st = ctl.pods[pname].state
                st.now = pnow
                st.set_idle(idle)
        else:
            raw, snow = p["idle"]
            ctl.state._raw.update(raw)
            ctl.state.now = snow
            for pm in ctl.state._pod_list:
                pm.rebuild(snow)
        (ctl._reb_streak, ctl._rehome_from, ctl._rehome_until,
         ctl._cooldown_until, loads) = p["rebalance"]
        ctl._loads = dict(loads)
        ctl.obs.load_values(p["obs"])
        if journal is not None:
            ctl._replaying = True
            try:
                for rec in journal.since(snapshot.lsn):
                    op, a = rec.op, rec.args
                    if op == "submit":
                        ctl.submit(list(a[2]), at=a[0], jid=a[1])
                    elif op == "run_until":
                        ctl.run_until(a[0])
                    elif op == "run":
                        ctl.run()
                    else:
                        raise ValueError(f"unknown journal op {op!r}")
            finally:
                ctl._replaying = False
            ctl.journal = journal
        return ctl
