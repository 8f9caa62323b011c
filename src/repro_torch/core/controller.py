"""Online event-driven scheduling core (see DESIGN.md §1).

The paper's BASS controller is inherently *online*: tasks and background
flows arrive while the SDN controller holds a live global view.  This module
is that controller, split into three layers:

* :class:`ClusterState` — the shared mutable world: idle map ``ΥI_j``, the
  lazy :class:`MinnowHeap`, the :class:`~repro.core.timeslot.TimeSlotLedger`
  and the fabric.  ``commit_local`` / ``commit_remote`` are the *single*
  source of truth for Assignment emission — every policy books work through
  them, so idle times, the minnow heap and the ledger can never drift apart.
* :class:`SchedulingPolicy` — the per-event decision protocol.  ``place``
  handles one arriving task, ``place_batch`` a job's task list.  BASS, HDS,
  BAR and Pre-BASS are policies (:data:`POLICIES`); the historical
  ``schedule_*(instance, ledger)`` entry points in ``bass``/``baselines``/
  ``prebass`` are thin offline wrappers that build a state, run the policy
  once, and wrap the result in a :class:`~repro.core.tasks.Schedule` —
  byte-identical to the pre-refactor batch schedulers.
* :class:`ClusterController` — the event loop: ``submit(tasks, at=...)``
  queues a job arrival, ``inject_flow`` queues dynamic background
  cross-traffic, ``reserve_transfer_at`` queues a raw flow reservation
  (training-side gradient sync), and ``run_until(t)`` / ``run()`` drain the
  event queue in time order, producing per-job assignments and
  :class:`~repro.core.simulator.JobMetrics`.
"""
from __future__ import annotations

import copy
import heapq
from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
)

from ..obs import Registry
from .tasks import (
    Assignment,
    BackgroundFlow,
    Instance,
    Schedule,
    Task,
    completion_time,
)
from .timeslot import TimeSlotLedger, TransferPlan
from .topology import Fabric, UnroutableError

_EPS = 1e-9


def _believed_tm(belief, rows, size: float, at: float) -> float:
    """Estimated transfer time from a flat belief: size / believed BW_rl."""
    if size <= 0.0:
        return 0.0
    bw = belief.path_bandwidth(rows, at)
    return size / bw if bw > _EPS else float("inf")


class MinnowHeap:
    """Position-indexed min-heap over worker idle times (deterministic
    name tie-break).

    One entry per worker, kept exact by :meth:`update` (an
    increase/decrease-key sift), so ``ND_minnow`` is an O(1) peek and a
    placement costs one O(log n) sift — no stale-entry repair loops, and
    the heap never grows past n.  The selected minimum is the same
    ``(idle, name)`` tuple order the historical lazy heap resolved, so
    every policy decision is unchanged.
    """

    def __init__(self, idle: Dict[str, float], workers: Sequence[str]):
        self._heap = [(idle[n], n) for n in workers]
        heapq.heapify(self._heap)
        self._pos = {e[1]: i for i, e in enumerate(self._heap)}

    def minnow(self, idle: Optional[Dict[str, float]] = None) -> str:
        """The worker with minimal (idle, name); ``idle`` is accepted for
        backwards compatibility and ignored — entries are kept exact."""
        return self._heap[0][1]

    def update(self, node: str, new_idle: float) -> None:
        h, pos = self._heap, self._pos
        i = pos[node]
        item = (new_idle, node)
        while i > 0:  # sift up
            parent = (i - 1) >> 1
            if item < h[parent]:
                h[i] = h[parent]
                pos[h[i][1]] = i
                i = parent
            else:
                break
        n = len(h)
        while True:  # sift down
            c = 2 * i + 1
            if c >= n:
                break
            r = c + 1
            if r < n and h[r] < h[c]:
                c = r
            if h[c] < item:
                h[i] = h[c]
                pos[h[i][1]] = i
                i = c
            else:
                break
        h[i] = item
        pos[node] = i

    def insert(self, node: str, idle: float) -> None:
        """Admit a (re)joining worker: push + sift, one O(log n) pass."""
        h, pos = self._heap, self._pos
        if node in pos:
            raise ValueError(f"worker {node!r} already in heap")
        h.append((float("inf"), node))
        pos[node] = len(h) - 1
        self.update(node, idle)

    def remove(self, node: str) -> None:
        """Evict a crashed worker: swap-with-last + sift, O(log n)."""
        h, pos = self._heap, self._pos
        i = pos.pop(node)
        last = h.pop()
        if i < len(h):
            h[i] = last
            pos[last[1]] = i
            # Re-sift the moved entry to restore the invariant either way.
            self.update(last[1], last[0])


def pick_minnow(idle: Dict[str, float], workers: Sequence[str]) -> str:
    """``ND_minnow``: the worker whose available idle time is minimum."""
    return min(workers, key=lambda n: (idle[n], n))


def pick_local(
    task: Task, idle: Dict[str, float], workers: Sequence[str]
) -> Optional[str]:
    """``ND_loc``: least-loaded *available* replica holder, or None (Case 2).

    ``workers`` is any membership container; pass a set at fleet scale —
    a list turns every placement into an O(n_workers · R) string scan
    (``ClusterState.workers_set`` exists for exactly this)."""
    holders = [n for n in task.replicas if n in workers]
    if not holders:
        return None
    return min(holders, key=lambda n: (idle[n], n))


def choose_source(
    task: Task,
    dst: str,
    ledger: TimeSlotLedger,
    at: float,
    load: Optional[Dict[str, float]] = None,
    belief=None,
) -> Tuple[str, Tuple[int, ...]]:
    """Choose the replica to move data *from* (``ND_dataSrc``).

    Base BASS picks the replica whose path to ``dst`` has the most residual
    bandwidth at transfer time (ties: fewer hops, then name); with ``load``
    given (Pre-BASS, Discussion 2) the least-loaded holder wins first.  All
    candidate (source, destination) pairs are scored in one numpy pass via
    :meth:`TimeSlotLedger.path_bandwidth_batch`.  With ``belief`` given
    (telemetry mode) candidates are ranked by the *estimated* residual
    bandwidth instead of oracle ledger state — same query surface, stale
    answers (DESIGN.md §9).
    """
    cands = [rep for rep in task.replicas if rep != dst]
    assert cands, f"task {task.tid} has no off-node replica"
    rows_list = [ledger.path_rows(rep, dst) for rep in cands]
    bws = (ledger if belief is None else belief).path_bandwidth_batch(rows_list, at)
    best = min(
        range(len(cands)),
        key=lambda i: (
            load.get(cands[i], 0.0) if load is not None else 0.0,
            -bws[i],
            len(rows_list[i]),
            cands[i],
        ),
    )
    return cands[best], rows_list[best]


def nearest_source(
    task: Task, dst: str, ledger: TimeSlotLedger
) -> Tuple[str, Tuple[int, ...]]:
    """Fewest-hop replica (HDS/BAR's bandwidth-oblivious choice)."""
    best = None
    for rep in task.replicas:
        if rep == dst:
            continue
        rows = ledger.path_rows(rep, dst)
        key = (len(rows), rep)
        if best is None or key < best[0]:
            best = (key, rep, rows)
    assert best is not None
    return best[1], best[2]


# ---------------------------------------------------------------------------
# EventQueue — the deterministic event heap, extracted for pod-scope reuse
# ---------------------------------------------------------------------------


class EventQueue:
    """Deterministic controller event heap: ``(at, seq, kind, payload)``.

    Extracted from :class:`ClusterController` so pod-scope controllers
    (``core.hierarchy``) reuse the exact ordering contract — time first,
    then a monotonically increasing sequence number (FIFO among same-time
    events); kind/payload are never compared.  ``items`` is a live
    ``heapq`` list and stays a plain attribute on purpose: controller
    snapshots store it verbatim, because heapq's internal layout is part
    of the deterministic tie-break story.

    ``n_real`` counts queued events that are *work* — everything except
    the telemetry poll / heartbeat chain ticks — so those self-re-arming
    chains can key off pending work without counting each other.
    """

    #: Event kinds that are chain ticks, not work: the telemetry poll and
    #: heartbeat sweeps here, plus the hierarchical controller's periodic
    #: rebalance tick (``core.hierarchy``) — all three re-arm themselves
    #: only while real work is queued, so none can keep ``run()`` alive.
    CHAIN_KINDS = ("poll", "hb", "rebalance")

    __slots__ = ("items", "seq", "n_real")

    def __init__(self) -> None:
        self.items: List[Tuple[float, int, str, tuple]] = []
        self.seq = 0
        self.n_real = 0

    def __bool__(self) -> bool:
        return bool(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def next_at(self) -> float:
        return self.items[0][0]

    def push(self, at: float, kind: str, payload: tuple) -> None:
        heapq.heappush(self.items, (at, self.seq, kind, payload))
        self.seq += 1
        if kind not in self.CHAIN_KINDS:
            self.n_real += 1

    def pop(self) -> Tuple[float, int, str, tuple]:
        ev = heapq.heappop(self.items)
        if ev[2] not in self.CHAIN_KINDS:
            self.n_real -= 1
        return ev


# ---------------------------------------------------------------------------
# ClusterState — the shared mutable world every policy operates on
# ---------------------------------------------------------------------------


class ClusterState:
    """Idle map + minnow heap + TS ledger + fabric, with commit_* as the
    single Assignment-emission path (DESIGN.md §1)."""

    def __init__(
        self,
        fabric: Fabric,
        workers: Sequence[str],
        idle: Optional[Dict[str, float]] = None,
        ledger: Optional[TimeSlotLedger] = None,
        slot_duration: float = 1.0,
        horizon_slots: int = 256,
        background: Sequence[BackgroundFlow] = (),
    ) -> None:
        self.fabric = fabric
        self.workers = list(workers)
        self.workers_set = frozenset(self.workers)
        idle = idle or {}
        self.idle: Dict[str, float] = {
            n: float(idle.get(n, 0.0)) for n in self.workers
        }
        self.ledger = (
            ledger
            if ledger is not None
            else TimeSlotLedger(fabric, slot_duration, horizon_slots)
        )
        self.background: List[BackgroundFlow] = list(background)
        self.heap = MinnowHeap(self.idle, self.workers)
        self.now = 0.0
        #: Optional SDN data plane (``repro.net.DataPlane``), attached by
        #: ClusterController.  When present and carrying failures, source/
        #: path choices route around dead links; with no failures the code
        #: paths below are byte-identical to the dataplane-less ones.
        self.dataplane = None
        #: Per-state observability registry (``repro.obs``): the wavefront
        #: planner, reroute engine and controller all report through it.
        self.obs = Registry()
        #: Optional telemetry belief (``repro.net.telemetry.BeliefState``),
        #: attached by ClusterController.attach_telemetry.  Only consulted
        #: by policies constructed with ``telemetry=True``.
        self.belief = None

    @classmethod
    def from_instance(
        cls, instance: Instance, ledger: Optional[TimeSlotLedger] = None
    ) -> "ClusterState":
        """Offline-wrapper entry: ledger defaults to ``instance.fresh_ledger()``
        (background flows pre-booked, exactly as the batch schedulers did)."""
        return cls(
            instance.fabric,
            instance.workers,
            instance.idle,
            ledger=ledger if ledger is not None else instance.fresh_ledger(),
            slot_duration=instance.slot_duration,
            background=instance.background,
        )

    # -- queries ------------------------------------------------------------
    def minnow(self) -> str:
        return self.heap.minnow(self.idle)

    def _routing_live(self) -> bool:
        """True when failure-aware routing must be consulted."""
        return self.dataplane is not None and self.dataplane.has_failures()

    def choose_source(
        self,
        task: Task,
        dst: str,
        at: float,
        load: Optional[Dict[str, float]] = None,
        belief=None,
    ) -> Tuple[str, Tuple[int, ...]]:
        if not self._routing_live():
            return choose_source(task, dst, self.ledger, at, load=load,
                                 belief=belief)
        # Failure-aware single-path: each replica contributes its best
        # surviving path; dead replicas drop out of the candidate set.
        cands: List[str] = []
        rows_list: List[Tuple[int, ...]] = []
        for rep in task.replicas:
            if rep == dst:
                continue
            try:
                # k=1: only the shortest surviving path is consumed, and
                # Yen's first path is exactly that — skip the spur searches.
                paths = self.dataplane.candidates(rep, dst, k=1)
            except UnroutableError:
                continue
            cands.append(rep)
            rows_list.append(self.ledger.rows(paths[0]))
        if not cands:
            raise UnroutableError(
                f"task {task.tid}: no replica has a surviving path to {dst!r}"
            )
        bws = (self.ledger if belief is None else belief).path_bandwidth_batch(
            rows_list, at
        )
        best = min(
            range(len(cands)),
            key=lambda i: (
                load.get(cands[i], 0.0) if load is not None else 0.0,
                -bws[i],
                len(rows_list[i]),
                cands[i],
            ),
        )
        return cands[best], rows_list[best]

    def choose_source_path(
        self,
        task: Task,
        dst: str,
        at: float,
        load: Optional[Dict[str, float]] = None,
        k: Optional[int] = None,
        size: Optional[float] = None,
        belief=None,
    ) -> Tuple[str, Tuple[int, ...], TransferPlan]:
        """Multipath ``ND_dataSrc``: greedily plan the transfer on *every*
        surviving (replica, path) pair in one
        :meth:`TimeSlotLedger.plan_transfer_batch` pass and return the one
        that completes earliest — Eq. (4)'s argmin applied to paths, not
        just nodes.  Ties break to fewer hops, replica name, candidate
        order.  Returns ``(source, rows, plan)`` — the winning plan is the
        uncommitted greedy plan itself, so callers don't re-plan it.
        Requires a dataplane; falls back to :meth:`choose_source` without
        one.  ``size`` overrides ``task.size`` (rerouting scores the
        *remaining* bytes)."""
        if self.dataplane is None:
            src, rows = self.choose_source(task, dst, at, load=load,
                                           belief=belief)
            plan = self.ledger.plan_transfer(
                task.size if size is None else size, rows, not_before=at
            )
            return src, rows, plan
        pairs: List[Tuple[str, int, Tuple[int, ...]]] = []
        for rep in task.replicas:
            if rep == dst:
                continue
            try:
                paths = self.dataplane.candidates(rep, dst, k=k)
            except UnroutableError:
                continue
            for pi, p in enumerate(paths):
                pairs.append((rep, pi, self.ledger.rows(p)))
        if not pairs:
            raise UnroutableError(
                f"task {task.tid}: no replica has a surviving path to {dst!r}"
            )
        sz = task.size if size is None else size
        if belief is not None:
            # Telemetry mode: rank every pair by its *estimated* completion
            # (size / believed residual bandwidth, flat in time) and plan
            # only the winner on the true ledger — belief can misrank, the
            # realized transfer still books real residue (DESIGN.md §9).
            bws = belief.path_bandwidth_batch([r for _, _, r in pairs], at)
            best = min(
                range(len(pairs)),
                key=lambda i: (
                    load.get(pairs[i][0], 0.0) if load is not None else 0.0,
                    at + (sz / bws[i] if bws[i] > _EPS else float("inf")),
                    len(pairs[i][2]),
                    pairs[i][0],
                    pairs[i][1],
                ),
            )
            plan = self.ledger.plan_transfer(sz, pairs[best][2], not_before=at)
            return pairs[best][0], pairs[best][2], plan
        plans = self.ledger.plan_transfer_batch(
            sz,
            [r for _, _, r in pairs],
            not_before=at,
        )
        best = min(
            range(len(pairs)),
            key=lambda i: (
                load.get(pairs[i][0], 0.0) if load is not None else 0.0,
                plans[i].end,
                len(pairs[i][2]),
                pairs[i][0],
                pairs[i][1],
            ),
        )
        return pairs[best][0], pairs[best][2], plans[best]

    def nearest_source(
        self, task: Task, dst: str
    ) -> Tuple[str, Tuple[int, ...]]:
        """Fewest-hop replica, failure-aware when the dataplane carries
        failures (HDS/BAR stay bandwidth-oblivious but must not book dead
        links)."""
        if not self._routing_live():
            return nearest_source(task, dst, self.ledger)
        best = None
        for rep in task.replicas:
            if rep == dst:
                continue
            try:
                paths = self.dataplane.candidates(rep, dst, k=1)
            except UnroutableError:
                continue
            rows = self.ledger.rows(paths[0])
            key = (len(rows), rep)
            if best is None or key < best[0]:
                best = (key, rep, rows)
        if best is None:
            raise UnroutableError(
                f"task {task.tid}: no replica has a surviving path to {dst!r}"
            )
        return best[1], best[2]

    def scratch_ledger(
        self, horizon_slots: Optional[int] = None
    ) -> TimeSlotLedger:
        """A fresh ledger seeded with every background flow seen so far —
        what BAR uses for its static-belief phase-1/adjustment reasoning.

        Inherits the live ledger's horizon and rolling origin by default:
        a hardcoded 256-slot horizon under-provisioned workloads the real
        ledger handles, and an origin-0 scratch in a long-running
        controller would re-allocate the whole elapsed history just to
        plan at ``now`` (``occupy`` clamps background flows that started
        before the live window)."""
        ledger = TimeSlotLedger(
            self.fabric,
            self.ledger.slot_duration,
            self.ledger.reserved.shape[1]
            if horizon_slots is None
            else horizon_slots,
        )
        ledger.base_slot = self.ledger.base_slot
        ledger.retire_stride = self.ledger.retire_stride
        for bg in self.background:
            ledger.occupy(
                ledger.rows(self.fabric.path(bg.src, bg.dst)),
                bg.start,
                bg.end,
                bg.fraction,
            )
        return ledger

    # -- mutations ----------------------------------------------------------
    def advance(self, t: float) -> None:
        """Online clock: nothing can start before ``t``, so clamp ΥI_j up.

        Rebuilds the minnow heap once instead of pushing per-worker
        entries — an event stream on a big fleet would otherwise grow the
        heap by O(workers) per event without ever popping them.

        Also the rolling-horizon hook: once the clock has moved a stride
        past the ledger origin, fully-past slots are retired so the live
        matrix stays O(horizon) regardless of elapsed simulated time
        (DESIGN.md §7)."""
        if t < self.now:
            raise ValueError(f"time moves backwards: {t} < {self.now}")
        self.now = t
        dirty = False
        for n in self.workers:
            if self.idle[n] < t:
                self.idle[n] = t
                dirty = True
        if dirty:
            self.reheap()
        self.ledger.maybe_retire(t)

    def set_idle(self, idle: Dict[str, float]) -> None:
        """Replace idle estimates wholesale (ProgressRate refresh, §V.A)."""
        for n, v in idle.items():
            if n in self.idle:
                self.idle[n] = float(v)
        self.reheap()

    def reheap(self) -> None:
        self.heap = MinnowHeap(self.idle, self.workers)

    def remove_worker(self, node: str) -> None:
        """Evict a crashed host from every placement surface at once:
        the worker list/set (``pick_local`` membership), the idle map and
        the minnow heap — a dead machine must never win Eq. (1)'s argmin."""
        if node not in self.workers_set:
            return
        self.workers.remove(node)
        self.workers_set = frozenset(self.workers)
        self.heap.remove(node)
        del self.idle[node]

    def add_worker(self, node: str, idle: Optional[float] = None) -> None:
        """(Re-)admit a recovered host with its idle clock at ``idle``
        (default: the current sim time — a fresh machine starts empty)."""
        if node in self.workers_set:
            return
        t = self.now if idle is None else float(idle)
        self.workers.append(node)
        self.workers_set = frozenset(self.workers)
        self.idle[node] = t
        self.heap.insert(node, t)

    def observe_flow(self, flow: BackgroundFlow) -> None:
        """Dynamic background cross-traffic: book it on the ledger and
        remember it so scratch ledgers (BAR) see it too."""
        self.background.append(flow)
        self.ledger.occupy(
            self.ledger.rows(self.fabric.path(flow.src, flow.dst)),
            flow.start,
            flow.end,
            flow.fraction,
        )

    # -- the single Assignment-emission path -------------------------------
    def commit_local(
        self, task: Task, node: str, bw_needed: Optional[float] = None
    ) -> Assignment:
        """Run ``task`` data-locally on ``node`` (Eq. 1 with BW=∞)."""
        start = self.idle[node]
        finish = start + task.compute
        self.idle[node] = finish
        self.heap.update(node, finish)
        return Assignment(task.tid, node, None, None, start, finish, bw_needed)

    def commit_remote(
        self,
        task: Task,
        node: str,
        src: str,
        plan: TransferPlan,
        bw_needed: Optional[float] = None,
    ) -> Assignment:
        """Run ``task`` on ``node`` with data moved from ``src``: reserve the
        plan's TS slots on every path link and book the compute."""
        self.ledger.commit(plan)
        start = plan.end if plan.slot_fracs else self.idle[node]
        finish = start + task.compute
        self.idle[node] = finish
        self.heap.update(node, finish)
        return Assignment(task.tid, node, src, plan, start, finish, bw_needed)

    # -- snapshots (Pre-BASS guard, what-if planning) -----------------------
    def snapshot(self) -> Tuple:
        return (dict(self.idle), self.ledger.reserved.copy(),
                self.ledger.base_slot, self.ledger.retired_slots,
                self.now, len(self.background))

    def restore(self, snap: Tuple) -> None:
        idle, reserved, base_slot, retired_slots, now, n_bg = snap
        self.idle = dict(idle)
        # Through the ``reserved`` setter: any attached device mirror is
        # invalidated and re-uploads the full window on its next sync —
        # a restore crossing a retire must not leave mirrored columns
        # aligned to the pre-restore origin.
        self.ledger.reserved = reserved.copy()
        self.ledger.base_slot = base_slot
        self.ledger.retired_slots = retired_slots
        self.now = now
        del self.background[n_bg:]
        self.reheap()

    def clone(self) -> "ClusterState":
        dup = ClusterState.__new__(ClusterState)
        dup.fabric = self.fabric
        dup.workers = list(self.workers)
        dup.workers_set = self.workers_set
        dup.idle = dict(self.idle)
        dup.ledger = TimeSlotLedger.__new__(TimeSlotLedger)
        dup.ledger.fabric = self.ledger.fabric
        dup.ledger.slot_duration = self.ledger.slot_duration
        dup.ledger._row = self.ledger._row
        dup.ledger._names = self.ledger._names
        dup.ledger.capacity = self.ledger.capacity
        dup.ledger.reserved = self.ledger.reserved.copy()
        dup.ledger.base_slot = self.ledger.base_slot
        dup.ledger.retired_slots = self.ledger.retired_slots
        dup.ledger.retire_stride = self.ledger.retire_stride
        dup.ledger.batch_scan_cells = 0
        dup.ledger._path_rows = self.ledger._path_rows  # shared read cache
        dup.ledger._path_rows_version = self.ledger._path_rows_version
        dup.background = list(self.background)
        dup.heap = MinnowHeap(dup.idle, dup.workers)
        dup.now = self.now
        dup.dataplane = self.dataplane  # shared: liveness is global state
        dup.obs = Registry()            # fresh: probe stats must not pollute
        dup.belief = self.belief        # shared: belief is read-only here
        return dup


# ---------------------------------------------------------------------------
# SchedulingPolicy protocol + the four paper policies
# ---------------------------------------------------------------------------


class SchedulingSurface(Protocol):
    """The exact state surface :meth:`BassPolicy.place` consumes — the
    scheduling state machine as a *pod-scope reusable unit* (DESIGN.md
    §12).  :class:`ClusterState` is the flat implementation;
    ``repro.core.hierarchy.HierarchicalState`` implements the same surface
    over per-pod shards (lazily-clamped idle map, per-pod minnow heaps, a
    sharded ledger) so one Algorithm-1 implementation drives both and the
    byte-parity contract is structural, not re-derived.
    """

    #: ``ΥI_j`` — a mapping view; implementations may clamp lazily against
    #: ``now`` instead of eagerly advancing every worker.
    idle: Dict[str, float]
    #: Membership container for ``pick_local`` (a set at fleet scale).
    workers_set: frozenset
    #: Plan/commit surface (flat ``TimeSlotLedger`` or ``ShardedLedger``).
    ledger: TimeSlotLedger
    obs: Registry

    def minnow(self) -> str:
        """``ND_minnow`` under the (idle, name) order."""
        ...

    def choose_source(
        self,
        task: Task,
        dst: str,
        at: float,
        load: Optional[Dict[str, float]] = None,
        belief=None,
    ) -> Tuple[str, Tuple[int, ...]]:
        ...

    def commit_local(
        self, task: Task, node: str, bw_needed: Optional[float] = None
    ) -> Assignment:
        ...

    def commit_remote(
        self,
        task: Task,
        node: str,
        src: str,
        plan: TransferPlan,
        bw_needed: Optional[float] = None,
    ) -> Assignment:
        ...


class SchedulingPolicy(Protocol):
    """Per-event scheduling decisions over a shared :class:`ClusterState`."""

    name: str

    def place(self, task: Task, state: ClusterState) -> Assignment:
        """Decide one arriving task."""
        ...

    def place_batch(
        self, tasks: Sequence[Task], state: ClusterState
    ) -> List[Assignment]:
        """Decide a job's task list (arrival of a whole job)."""
        ...


class BassPolicy:
    """Algorithm 1, one decision per arriving task (see ``bass`` module docs
    for the Case 1.1/1.2/1.3/2 taxonomy).

    ``multipath=True`` scores every surviving (replica, candidate-path)
    pair from the controller's data plane instead of one shortest path per
    replica — on fabrics with path diversity (fat-tree, multi-spine Clos)
    the transfer takes whichever parallel path has the most residue.
    Requires a dataplane-carrying state to differ from base BASS; with
    ``multipath=False`` (default) behaviour is byte-identical to before.

    ``telemetry=True`` scores the Case 1.2/1.3 tradeoff and the source
    choice against the controller's measured-bandwidth belief
    (``state.belief``, attached by ``ClusterController.attach_telemetry``)
    instead of the oracle ledger; commits still plan and book real slots
    on the true ledger — the belief decides *where*, never *what is
    booked* (DESIGN.md §9).  With ``telemetry=False`` (default) the
    belief is never consulted and schedules are byte-identical to before.
    """

    name = "bass"

    def __init__(
        self,
        multipath: bool = False,
        k_paths: Optional[int] = None,
        telemetry: bool = False,
    ):
        self.multipath = multipath
        self.k_paths = k_paths
        self.telemetry = telemetry

    def _belief(self, state: ClusterState):
        if not self.telemetry:
            return None
        belief = getattr(state, "belief", None)
        if belief is None:
            raise RuntimeError(
                "BassPolicy(telemetry=True) needs a belief state — attach a "
                "monitor via ClusterController.attach_telemetry() first"
            )
        return belief

    def _source(
        self, state: ClusterState, task: Task, dst: str, at: float
    ) -> Tuple[str, Tuple[int, ...], Optional[TransferPlan]]:
        """(source, rows, plan) — the multipath scorer already produced the
        winning greedy plan (true-ledger, belief-ranked under telemetry);
        single-path mode returns ``None`` and the caller plans the rows
        itself."""
        belief = self._belief(state)
        if self.multipath:
            return state.choose_source_path(
                task, dst, at, k=self.k_paths, belief=belief
            )
        src, rows = state.choose_source(task, dst, at=at, belief=belief)
        return src, rows, None

    @staticmethod
    def _trace(state, a: Assignment, task: Task, reason: str) -> Assignment:
        rec = state.obs.trace
        if rec.enabled:
            rec.record(
                "decision",
                tid=a.tid,
                node=a.node,
                src=a.source,
                reason=reason,
                cands=sum(1 for r in task.replicas if r != a.node),
                start=a.start,
                finish=a.finish,
            )
        return a

    def place(self, task: Task, state: ClusterState) -> Assignment:
        idle = state.idle
        minnow = state.minnow()
        loc = pick_local(task, idle, state.workers_set)

        if loc is not None and (minnow == loc or idle[loc] <= idle[minnow] + _EPS):
            # Case 1.1 — local is optimal, no movement (Eq. 1 with BW=∞).
            return self._trace(
                state, state.commit_local(task, loc), task, "local-optimal"
            )

        belief = self._belief(state)
        if loc is not None:
            # Case 1.2 / 1.3 — tradeoff governed by the TS ledger (oracle)
            # or by the telemetry belief's flat bandwidth estimate.
            yc_loc = completion_time(task.compute, 0.0, idle[loc])
            src, rows, plan = self._source(state, task, minnow, at=idle[minnow])
            if belief is None:
                if plan is None:
                    plan = state.ledger.plan_transfer(
                        task.size, rows, not_before=idle[minnow]
                    )
                tm = plan.end - plan.start if plan.slot_fracs else 0.0
            else:
                tm = _believed_tm(belief, rows, task.size, idle[minnow])
            yc_min = completion_time(task.compute, 0.0, idle[minnow]) + tm
            # Algorithm 1 line 8: bandwidth needed so that ΥC_minnow < ΥC_loc.
            tm_budget = yc_loc - task.compute - idle[minnow]
            bw_needed = task.size / tm_budget if tm_budget > _EPS else float("inf")
            if yc_min < yc_loc - _EPS:
                # Case 1.2 — BW_{i,minnow} ≤ BW_rl: go remote, reserve slots.
                if plan is None:
                    # Belief said remote: realize the plan on the true ledger.
                    plan = state.ledger.plan_transfer(
                        task.size, rows, not_before=idle[minnow]
                    )
                return self._trace(
                    state,
                    state.commit_remote(task, minnow, src, plan,
                                        bw_needed=bw_needed),
                    task,
                    "remote-faster",
                )
            # Case 1.3 — residue insufficient: stay local.
            return self._trace(
                state,
                state.commit_local(task, loc, bw_needed=bw_needed),
                task,
                "local-bw-insufficient",
            )

        # Case 2 — locality starvation: remote on ND_minnow with reservation.
        src, rows, plan = self._source(state, task, minnow, at=idle[minnow])
        if plan is None:
            plan = state.ledger.plan_transfer(
                task.size, rows, not_before=idle[minnow]
            )
        return self._trace(
            state,
            state.commit_remote(task, minnow, src, plan),
            task,
            "locality-starved",
        )

    def place_batch(
        self, tasks: Sequence[Task], state: ClusterState
    ) -> List[Assignment]:
        """Batch arrivals route through the wavefront engine
        (``core.wavefront``): one broadcasted (task × replica × path)
        scoring pass per wave instead of per-task ledger re-scans —
        bit-identical to the per-task ``place`` loop, including under
        live failure-aware routing (the planner threads the data plane's
        dead-link set through candidate enumeration, so degraded batches
        keep wavefront throughput instead of reverting to the loop).

        Telemetry mode falls back to the sequential loop: the wavefront's
        speculative curves are oracle-ledger artifacts and its whole
        contract is bit-identity with oracle ``place`` — belief-scored
        decisions are made per task instead (DESIGN.md §9)."""
        if len(tasks) > 1 and not self.telemetry:
            from .wavefront import WavefrontPlanner

            return WavefrontPlanner.for_state(state).place_batch(
                tasks, multipath=self.multipath, k_paths=self.k_paths
            )
        return [self.place(t, state) for t in tasks]


class HdsPolicy:
    """Hadoop Default Scheduler (Discussion 1): node-driven greedy, local
    tasks first, bandwidth-oblivious decisions whose transfers still pay."""

    name = "hds"

    def place(self, task: Task, state: ClusterState) -> Assignment:
        return self.place_batch([task], state)[0]

    def place_batch(
        self, tasks: Sequence[Task], state: ClusterState
    ) -> List[Assignment]:
        idle = state.idle
        unstarted = {t.tid: t for t in tasks}
        out: List[Assignment] = []
        # Event heap of (idle_time, node); deterministic tie-break on name.
        heap: List[Tuple[float, str]] = sorted(
            (idle[n], n) for n in state.workers
        )
        heapq.heapify(heap)

        while unstarted and heap:
            t_idle, node = heapq.heappop(heap)
            if abs(idle[node] - t_idle) > _EPS:
                continue  # stale entry
            local = [tid for tid, t in unstarted.items() if node in t.replicas]
            if local:
                task = unstarted.pop(min(local))
                out.append(state.commit_local(task, node))
            else:
                task = unstarted.pop(min(unstarted))
                src, rows = state.nearest_source(task, node)
                plan = state.ledger.plan_transfer(
                    task.size, rows, not_before=t_idle
                )
                out.append(state.commit_remote(task, node, src, plan))
            heapq.heappush(heap, (idle[node], node))

        out.sort(key=lambda a: a.tid)
        return out


class BarPolicy:
    """BAR (Jin et al., CCGrid'11): HDS phase-1 allocation, latest-task
    remote adjustment with *static* bandwidth beliefs, then realization of
    the chosen queues against the real ledger."""

    name = "bar"

    def place(self, task: Task, state: ClusterState) -> Assignment:
        return self.place_batch([task], state)[0]

    def place_batch(
        self, tasks_seq: Sequence[Task], state: ClusterState
    ) -> List[Assignment]:
        tasks = {t.tid: t for t in tasks_seq}
        base_idle = dict(state.idle)
        fabric = state.fabric

        # Phase 1 + move decisions run on a scratch state (BAR's own beliefs);
        # the caller-visible ledger only receives the realized transfers.
        scratch = ClusterState(
            fabric, state.workers, base_idle, ledger=state.scratch_ledger()
        )
        phase1 = HdsPolicy().place_batch(tasks_seq, scratch)
        queues: Dict[str, List[Assignment]] = {}
        for a in sorted(phase1, key=lambda a: (a.start, a.tid)):
            queues.setdefault(a.node, []).append(a)

        def static_tm(task: Task, node: str) -> Tuple[float, Optional[str]]:
            if node in task.replicas:
                return 0.0, None
            best = None
            for rep in task.replicas:
                bw = fabric.path_capacity(rep, node)
                tm = task.size / bw if bw > 0 else float("inf")
                if best is None or tm < best[0]:
                    best = (tm, rep)
            assert best is not None
            return best

        def recompute(queues: Dict[str, List[Assignment]]) -> None:
            for node, q in queues.items():
                t = base_idle.get(node, 0.0)
                for a in q:
                    tm, src = static_tm(tasks[a.tid], node)
                    a.node, a.source, a.transfer = node, src, None
                    a.start = t + tm
                    a.finish = a.start + tasks[a.tid].compute
                    t = a.finish

        recompute(queues)

        while True:
            all_assign = [a for q in queues.values() for a in q]
            latest = max(all_assign, key=lambda a: (a.finish, a.tid))
            task = tasks[latest.tid]
            # Candidate: append to another node's queue end.
            best: Optional[Tuple[float, str]] = None
            for node in state.workers:
                if node == latest.node:
                    continue
                q = queues.setdefault(node, [])
                t_avail = q[-1].finish if q else base_idle.get(node, 0.0)
                tm, _src = static_tm(task, node)
                yc = t_avail + tm + task.compute
                if yc < latest.finish - _EPS and (best is None or (yc, node) < best):
                    best = (yc, node)
            if best is None:
                break
            _yc, node = best
            queues[latest.node].remove(latest)
            queues[node].append(latest)
            recompute(queues)

        # --- Realization: BAR's *decisions* used static beliefs; the chosen
        # per-node queues now replay against the real shared state so
        # contended moves pay their true movement time (paper §I critique
        # "disregard available bandwidth", made honest).
        heads: Dict[str, int] = {n: 0 for n in queues}
        out: List[Assignment] = []
        while True:
            ready = [n for n, q in queues.items() if heads[n] < len(q)]
            if not ready:
                break
            node = min(ready, key=lambda n: (state.idle[n], n))
            a = queues[node][heads[node]]
            heads[node] += 1
            task = tasks[a.tid]
            if node in task.replicas:
                out.append(state.commit_local(task, node))
            else:
                src, rows = state.nearest_source(task, node)
                plan = state.ledger.plan_transfer(
                    task.size, rows, not_before=state.idle[node]
                )
                out.append(state.commit_remote(task, node, src, plan))

        out.sort(key=lambda a: a.tid)
        return out


class PreBassPolicy:
    """Pre-BASS (Discussion 2 / Example 2): BASS, then prefetch every remote
    transfer as early as the ledger allows, from the least-loaded holder.

    With ``guard=True`` (the default, and the offline-wrapper behaviour when
    no shared ledger is passed) the refined schedule is adopted only if it
    does not finish later than plain BASS — prefetching with a different
    source can, on adversarial ledgers, push a later task's window back.

    Both the guard probe and the base pass route through
    ``BassPolicy.place_batch`` and therefore the wavefront engine; only
    the prefetch re-plan loop is inherently sequential (each re-plan's
    window depends on the previous release/commit pair).
    """

    name = "prebass"

    def __init__(self, guard: bool = True, telemetry: bool = False):
        self.guard = guard
        self.telemetry = telemetry

    def _bass(self) -> "BassPolicy":
        return BassPolicy(telemetry=self.telemetry)

    def place(self, task: Task, state: ClusterState) -> Assignment:
        return self.place_batch([task], state)[0]

    def place_batch(
        self, tasks_seq: Sequence[Task], state: ClusterState
    ) -> List[Assignment]:
        base_mk: Optional[float] = None
        if self.guard:
            probe = self._bass().place_batch(tasks_seq, state.clone())
            base_mk = max((a.finish for a in probe), default=0.0)
        snap = state.snapshot() if self.guard else None
        out = self._prefetch(tasks_seq, state)
        refined_mk = max((a.finish for a in out), default=0.0)
        if base_mk is not None and refined_mk > base_mk + 1e-9:
            assert snap is not None
            state.restore(snap)
            return self._bass().place_batch(tasks_seq, state)
        return out

    def _prefetch(
        self, tasks_seq: Sequence[Task], state: ClusterState
    ) -> List[Assignment]:
        idle0 = dict(state.idle)
        # Prefetch can start no earlier than the job's arrival (state.now;
        # 0.0 for the offline wrappers) — replanning at t=0 for a job that
        # arrived at t=25 would book bandwidth that already elapsed.
        origin = state.now
        base = self._bass().place_batch(tasks_seq, state)
        ledger = state.ledger
        tasks = {t.tid: t for t in tasks_seq}

        # Release every remote transfer, then re-plan in assignment order.
        remote = [a for a in base if a.transfer is not None]
        for a in remote:
            ledger.release(a.transfer)

        # Node availability proxy for "least loaded replica holder".
        load: Dict[str, float] = dict(idle0)
        for a in base:
            load[a.node] = max(load.get(a.node, 0.0), a.finish)

        ready: Dict[int, float] = {}
        for a in base:
            if a.transfer is None:
                ready[a.tid] = 0.0
                continue
            task = tasks[a.tid]
            # state-level choice: failure-aware when the dataplane carries
            # dead links (identical to the module fn otherwise); belief-
            # ranked under telemetry, like the base pass.
            src, rows = state.choose_source(
                task, a.node, at=origin, load=load,
                belief=state.belief if self.telemetry else None,
            )
            plan = ledger.plan_transfer(task.size, rows, not_before=origin)
            ledger.commit(plan)
            a.source, a.transfer = src, plan
            ready[a.tid] = plan.end

        # Recompute per-node timelines with prefetched readiness.
        queues: Dict[str, List[Assignment]] = {}
        for a in sorted(base, key=lambda a: (a.start, a.tid)):
            queues.setdefault(a.node, []).append(a)
        out: List[Assignment] = []
        for node, queue in queues.items():
            t = idle0.get(node, 0.0)
            for a in queue:
                a.start = max(t, ready.get(a.tid, 0.0))
                a.finish = a.start + tasks[a.tid].compute
                t = a.finish
                out.append(a)
            # Prefetch pulled the node's timeline forward: resync the shared
            # idle map (BASS's bookkeeping assumed the un-prefetched starts).
            state.idle[node] = t
        state.reheap()

        out.sort(key=lambda a: a.tid)
        return out


POLICIES: Dict[str, Callable[[], SchedulingPolicy]] = {
    "bass": BassPolicy,
    "hds": HdsPolicy,
    "bar": BarPolicy,
    "prebass": PreBassPolicy,
}


def run_policy(
    policy: SchedulingPolicy,
    instance: Instance,
    ledger: Optional[TimeSlotLedger] = None,
    order: Optional[Sequence[int]] = None,
) -> Schedule:
    """Offline wrapper core: one batch decision over a frozen Instance.

    This is what ``schedule_bass``/``schedule_hds``/``schedule_bar``/
    ``schedule_prebass`` now are — byte-identical to the historical batch
    schedulers (enforced by the equivalence tests).
    """
    state = ClusterState.from_instance(instance, ledger)
    if order is not None:
        tasks_by_id = {t.tid: t for t in instance.tasks}
        tasks: Sequence[Task] = [tasks_by_id[tid] for tid in order]
    else:
        tasks = instance.tasks
    out = policy.place_batch(tasks, state)
    return Schedule(
        out, state.ledger, kinds={t.tid: t.kind for t in instance.tasks}
    )


# ---------------------------------------------------------------------------
# ClusterController — the online event loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded task re-execution under host crashes (Hadoop-style).

    A killed task is re-placed through the normal policy path (so retries
    stay bandwidth-aware) after ``backoff(attempt)`` sim-seconds; a retry
    that finds no live replica (transient all-replicas-dead window) burns
    an attempt and backs off again, and exhausting ``max_attempts`` raises
    :class:`UnroutableError` — no silent stalls, matching the reroute
    contract.  A host that crashes ``blacklist_after`` times is not
    re-admitted on recovery (its replicas stay priced out).
    """

    max_attempts: int = 4
    backoff_s: float = 1.0
    backoff_factor: float = 2.0
    blacklist_after: int = 3

    def backoff(self, attempt: int) -> float:
        """Sim-time delay before retry number ``attempt`` (0-based)."""
        return self.backoff_s * (self.backoff_factor ** attempt)


@dataclass
class _SpecRecord:
    """One in-flight LATE speculation: primary vs backup, first finisher
    wins at the resolve event."""

    jid: int
    primary: Assignment
    backup: Assignment


@dataclass
class JobRecord:
    """One submitted job: arrival time, tasks, and (once placed) results."""

    jid: int
    submit_at: float
    tasks: List[Task]
    assignments: List[Assignment] = field(default_factory=list)
    placed: bool = False
    rerouted: int = 0  # transfers re-planned after a path died
    reexecuted: int = 0     # tasks killed by a host crash and re-placed
    speculative: int = 0    # LATE backup copies launched
    wasted_bytes: float = 0.0  # delivered bytes thrown away (kills + losers)
    shed: bool = False  # load-shed by a headless controller's full mailbox

    @property
    def makespan(self) -> float:
        """Absolute completion time of the job's last task."""
        return max((a.finish for a in self.assignments), default=self.submit_at)


def _kernel_obs() -> dict:
    """Device-kernel snapshot section: backend + compile-cache counters
    (all zeros until the device module is actually imported — reading
    stats must never *cause* a jax import)."""
    from ..kernels import ts_plan

    out = {"backend": ts_plan.get_backend()}
    out.update(
        ts_plan.device_stats()
        or {k: 0 for k in ("traces", "cache_hits", "mirror_syncs",
                           "mirror_cells", "mirror_uploads")}
    )
    return out


class ClusterController:
    """The SDN controller as a long-lived service: multi-job arrival
    streams, dynamic background flows, and raw flow reservations share one
    :class:`ClusterState` and one :class:`SchedulingPolicy`."""

    def __init__(
        self,
        fabric: Fabric,
        workers: Sequence[str],
        policy: "SchedulingPolicy | str" = "bass",
        idle: Optional[Dict[str, float]] = None,
        slot_duration: float = 1.0,
        horizon_slots: int = 256,
        background: Sequence[BackgroundFlow] = (),
        k_paths: int = 4,
        retry: Optional[RetryPolicy] = None,
        speculation: bool = False,
        mailbox_limit: int = 64,
    ) -> None:
        if isinstance(policy, str):
            policy = POLICIES[policy]()
        self.policy = policy
        self.state = ClusterState(
            fabric,
            workers,
            idle,
            slot_duration=slot_duration,
            horizon_slots=horizon_slots,
        )
        for bg in background:
            self.state.observe_flow(bg)
        # The SDN data plane: link liveness, k-shortest-path candidates,
        # per-switch flow tables.  Lazy import keeps core→net one-way at
        # module load (net imports core.topology/timeslot).
        from ..net.dataplane import DataPlane

        self.dataplane = DataPlane(fabric, k=k_paths)
        self.state.dataplane = self.dataplane
        self.jobs: Dict[int, JobRecord] = {}
        self.flows: Dict[object, TransferPlan] = {}
        self.reroute_log: List[object] = []     # RerouteRecords, in fire order
        #: The deterministic event heap (see :class:`EventQueue`; the
        #: ``_events``/``_seq``/``_n_real_events`` names below stay as
        #: delegating properties because snapshots and the dispatch loop
        #: address the heap list and counters directly).  ``n_real``
        #: counts queued events that are *work* (everything except the
        #: poll/hb chain ticks); the chains re-arm only while it is
        #: non-zero — keying off the heap itself would let the two chains
        #: count each other as pending work and sustain themselves forever
        #: once both telemetry and heartbeats are attached.
        self._queue = EventQueue()
        self._next_jid = 0       # monotonic: ids stay unique if jobs are pruned
        self._auto_flow = 0      # untagged reservations get ("flow", n) keys
        self._idle0 = dict(self.state.idle)     # initial ΥI_j, for re-timelining
        self._live_jobs: Dict[int, float] = {}  # jid -> latest transfer end
        self._suspended: List[Tuple[object, Tuple[str, ...], float]] = []
        self._expiry: List[Tuple[float, int, object]] = []  # (end, gen, cookie)
        self._flow_gen: Dict[object, int] = {}
        #: Failure-replan implementation: "batched" (core.reroute engine)
        #: or "sequential" (the per-victim reference loop — the oracle the
        #: property tests and bench_failover_scale compare against).
        self.reroute_engine = "batched"
        #: One observability registry per controller, shared with the
        #: state so the wavefront planner reports into the same snapshot
        #: (DESIGN.md §9).  ``reroute_stats`` keeps its historical
        #: dict-style surface (events handled, victims replanned, prescan
        #: curve hits vs live re-scores, invariant-guard fallbacks) but is
        #: now a live view over registry counters.
        self.obs = self.state.obs
        self.reroute_stats = self.obs.group(
            "reroute", ("events", "victims", "hits", "misses", "fallbacks")
        )
        self._ev_stats = self.obs.group(
            "controller",
            ("events", "jobs", "flows", "transfers", "net_events", "polls"),
        )
        # Pre-register the wavefront group so the snapshot always carries
        # the section (zeros until the planner engages); the planner later
        # grabs this same group by prefix.
        self.obs.group("wavefront", ("hits", "misses", "waves", "spec_tasks"))
        self.obs.register_provider("ledger", self._ledger_obs)
        self.obs.register_provider("jobs", self._jobs_obs)
        self.obs.register_provider("kernels", _kernel_obs)
        #: Telemetry monitor (``repro.net.telemetry.LinkStatsMonitor``),
        #: None until attach_telemetry(); drives "poll" events.
        self.telemetry = None
        self._poll_pending = False
        # -- task-plane robustness (DESIGN.md §10) --------------------------
        #: Bounded re-execution policy for tasks killed by host crashes.
        self.retry = retry if retry is not None else RetryPolicy()
        #: LATE-style speculative execution: on straggler onset, launch a
        #: backup copy iff the ledger's residual bandwidth says it finishes
        #: before the straggler's projected finish (first finisher wins).
        self.speculation = speculation
        #: Per-host crash count; hosts reaching ``retry.blacklist_after``
        #: are not re-admitted on recovery.
        self._host_failures: Dict[str, int] = {}
        self.blacklist: set = set()
        self._specs: Dict[int, _SpecRecord] = {}  # tid -> live speculation
        self.fault_stats = self.obs.group(
            "faults",
            ("host_down", "host_up", "killed", "retries", "reexecuted",
             "spec_launch", "spec_win", "blacklisted", "wasted_bytes"),
        )
        #: Heartbeat monitor (``repro.runtime.ft.HeartbeatMonitor``), None
        #: until attach_heartbeats(); drives "hb" sweep events in sim time.
        self.heartbeats = None
        self._hb_pending = False
        self._hb_interval = 0.0
        self._hb_last = 0.0
        # -- control-plane crash-recovery (DESIGN.md §11) -------------------
        #: Write-ahead journal (``core.journal.Journal``), None until
        #: attach_journal(); records every public entry-point call.
        self.journal = None
        self._replaying = False  # replay must not re-journal its own calls
        self._in_run = False     # run() journals once, not its inner targets
        #: Headless data-plane mode: while the control plane is down, the
        #: data plane keeps forwarding on installed rules but scheduling
        #: stops — job arrivals queue in a bounded mailbox (overflow →
        #: load-shed), every other event is deferred to recovery, and the
        #: poll/heartbeat chains are suspended.
        self.ctrl_down = False
        self._down_since = 0.0
        self.mailbox_limit = int(mailbox_limit)
        self._mailbox: List[Tuple[str, tuple]] = []  # deferred, arrival order
        self._mailbox_jobs = 0
        self.shed_jobs: List[int] = []
        self.ha_stats = self.obs.group(
            "ha",
            ("ctrl_down", "ctrl_up", "mailbox_queued", "mailbox_shed",
             "deferred", "reconciled_rules"),
        )
        self.now = 0.0

    # -- event-queue delegation ---------------------------------------------
    # The dispatch loop, the poll/hb chains and the snapshot machinery all
    # address the heap list and its counters by these historical names;
    # the queue object itself is what pod-scope controllers reuse.
    @property
    def _events(self) -> List[Tuple[float, int, str, tuple]]:
        return self._queue.items

    @_events.setter
    def _events(self, items: List[Tuple[float, int, str, tuple]]) -> None:
        self._queue.items = items

    @property
    def _seq(self) -> int:
        return self._queue.seq

    @_seq.setter
    def _seq(self, value: int) -> None:
        self._queue.seq = value

    @property
    def _n_real_events(self) -> int:
        return self._queue.n_real

    @_n_real_events.setter
    def _n_real_events(self, value: int) -> None:
        self._queue.n_real = value

    @classmethod
    def from_instance(
        cls, instance: Instance, policy: "SchedulingPolicy | str" = "bass"
    ) -> "ClusterController":
        return cls(
            instance.fabric,
            instance.workers,
            policy,
            idle=instance.idle,
            slot_duration=instance.slot_duration,
            background=instance.background,
        )

    # -- write-ahead journal (DESIGN.md §11) --------------------------------
    def attach_journal(self, journal=None):
        """Attach a :class:`~repro.core.journal.Journal`: from now on every
        public entry-point call (``submit``, ``inject_flow``,
        ``reserve_transfer_at``, ``fail_*``/``recover_*``, ``straggle``,
        ``fail_controller``/``recover_controller``, ``attach_telemetry``/
        ``attach_heartbeats``, ``run_until``/``run``) is recorded with its
        *resolved* arguments before the mutation happens.  Returns the
        journal (a fresh one by default)."""
        if self.journal is not None:
            raise RuntimeError("journal already attached")
        from .journal import Journal

        self.journal = journal if journal is not None else Journal()
        return self.journal

    def _journal(self, op: str, *args) -> None:
        if self.journal is None or self._replaying or self._in_run:
            return
        self.journal.append(op, *args)

    def _apply_record(self, rec) -> None:
        """Re-issue one journaled entry-point call (replay dispatch)."""
        op, a = rec.op, rec.args
        if op == "submit":
            self.submit(list(a[2]), at=a[0], jid=a[1])
        elif op == "inject_flow":
            self.inject_flow(a[0], at=a[1])
        elif op == "reserve_transfer":
            self.reserve_transfer_at(a[0], a[1], a[2], tag=a[3])
        elif op == "fail_link":
            self.fail_link(a[0], at=a[1])
        elif op == "recover_link":
            self.recover_link(a[0], at=a[1])
        elif op == "fail_switch":
            self.fail_switch(a[0], at=a[1])
        elif op == "recover_switch":
            self.recover_switch(a[0], at=a[1])
        elif op == "fail_host":
            self.fail_host(a[0], at=a[1])
        elif op == "recover_host":
            self.recover_host(a[0], at=a[1])
        elif op == "straggle":
            self.straggle(a[0], a[1], at=a[2])
        elif op == "fail_controller":
            self.fail_controller(at=a[0])
        elif op == "recover_controller":
            self.recover_controller(at=a[0])
        elif op == "attach_telemetry":
            self.attach_telemetry(
                poll_interval=a[0], estimator=a[1], **a[2]
            )
        elif op == "attach_heartbeats":
            self.attach_heartbeats(interval=a[0], grace_s=a[1])
        elif op == "run_until":
            self.run_until(a[0])
        elif op == "run":
            self.run()
        else:
            raise ValueError(f"unknown journal op {op!r}")

    def replay_journal(self, journal, from_lsn: int = 0) -> int:
        """Re-issue ``journal``'s records from ``from_lsn`` through the
        normal entry points; returns the number of records applied.
        Replayed calls are not re-journaled."""
        self._replaying = True
        try:
            n = 0
            for rec in journal.since(from_lsn):
                self._apply_record(rec)
                n += 1
            return n
        finally:
            self._replaying = False

    # -- full-fidelity snapshots + recovery (DESIGN.md §11) -----------------
    def _policy_spec(self) -> Tuple[str, Optional[dict]]:
        """(name, kwargs) rebuilding this controller's policy, or
        ``(name, None)`` for a custom policy object ``recover_from`` cannot
        reconstruct on its own (pass ``policy=`` explicitly there)."""
        p = self.policy
        if type(p) is BassPolicy:
            return ("bass", {"multipath": p.multipath, "k_paths": p.k_paths,
                             "telemetry": p.telemetry})
        if type(p) is PreBassPolicy:
            return ("prebass", {"guard": p.guard, "telemetry": p.telemetry})
        if type(p) is HdsPolicy:
            return ("hds", {})
        if type(p) is BarPolicy:
            return ("bar", {})
        return (getattr(p, "name", type(p).__name__), None)

    def snapshot(self):
        """Full-fidelity :class:`~repro.core.journal.ControllerSnapshot` at
        the current journal position.

        Coverage matrix (field → captured-by) is documented in DESIGN.md
        §11; everything is plain picklable data — no fabric, registry or
        callable references.  Jobs, assignments and live speculations are
        deep-copied *together* so the ``_SpecRecord.primary is assignment``
        identity links survive both the dump and the restore.
        """
        st, led, dp = self.state, self.state.ledger, self.dataplane
        with self.obs.span("recovery.snapshot"):
            jobs, specs = copy.deepcopy((self.jobs, self._specs))
            hb = None
            if self.heartbeats is not None:
                hb = {
                    "grace_s": self.heartbeats.grace_s,
                    "interval": self._hb_interval,
                    "last": self._hb_last,
                    "hosts": [(h.name, h.last_beat, h.alive)
                              for h in self.heartbeats.hosts.values()],
                }
            payload = {
                "config": {
                    "policy": self._policy_spec(),
                    "slot_duration": led.slot_duration,
                    "k_paths": dp.engine.k,
                    "retry": (self.retry.max_attempts, self.retry.backoff_s,
                              self.retry.backoff_factor,
                              self.retry.blacklist_after),
                    "speculation": self.speculation,
                    "mailbox_limit": self.mailbox_limit,
                    "reroute_engine": self.reroute_engine,
                },
                "now": self.now,
                "state": {
                    "workers": list(st.workers),
                    "idle": dict(st.idle),
                    "now": st.now,
                    "background": list(st.background),
                    "idle0": dict(self._idle0),
                },
                "ledger": led.dump_state(),
                "liveness": dp.dump_liveness(),
                "tables": dp.tables.dump_state(),
                "jobs": jobs,
                "specs": specs,
                "flows": dict(self.flows),
                "reroute_log": list(self.reroute_log),
                # The heap list verbatim: heapq's layout is part of the
                # deterministic tie-break story, so restore must not
                # re-heapify a differently-shaped but equivalent heap.
                "events": list(self._events),
                "seq": self._seq,
                "next_jid": self._next_jid,
                "auto_flow": self._auto_flow,
                "live_jobs": dict(self._live_jobs),
                "suspended": list(self._suspended),
                "expiry": list(self._expiry),
                "flow_gen": dict(self._flow_gen),
                "host_failures": dict(self._host_failures),
                "blacklist": sorted(self.blacklist),
                "poll_pending": self._poll_pending,
                "hb_pending": self._hb_pending,
                "ctrl_down": self.ctrl_down,
                "down_since": self._down_since,
                "mailbox": list(self._mailbox),
                "mailbox_jobs": self._mailbox_jobs,
                "shed_jobs": list(self.shed_jobs),
                "obs": self.obs.dump_values(),
                "telemetry": (None if self.telemetry is None
                              else self.telemetry.dump_state()),
                "heartbeats": hb,
            }
        from .journal import ControllerSnapshot

        self.obs.counter("recovery.snapshots").inc()
        lsn = 0 if self.journal is None else self.journal.lsn
        return ControllerSnapshot(lsn=lsn, payload=payload)

    def _restore_full(self, payload: dict) -> None:
        """Overwrite this (freshly-constructed) controller's mutable state
        with a snapshot payload.  The inverse of :meth:`snapshot`."""
        cfg = payload["config"]
        self.reroute_engine = cfg["reroute_engine"]
        self.mailbox_limit = cfg["mailbox_limit"]
        st = self.state
        ps = payload["state"]
        st.workers = list(ps["workers"])
        st.workers_set = frozenset(st.workers)
        st.idle = dict(ps["idle"])
        st.background = list(ps["background"])
        st.heap = MinnowHeap(st.idle, st.workers)
        st.now = ps["now"]
        # Drop any cached wavefront planner: it holds pre-restore ledger
        # state (placements are bit-identical either way; its hit/miss
        # counters are cache artifacts outside the equivalence canon).
        st.__dict__.pop("_wavefront", None)
        st.ledger.load_state(payload["ledger"])
        self.dataplane.load_liveness(payload["liveness"])
        self.dataplane.tables.load_state(payload["tables"])
        # Deep-copy again so one snapshot can seed several recoveries.
        self.jobs, self._specs = copy.deepcopy(
            (payload["jobs"], payload["specs"])
        )
        self.flows = dict(payload["flows"])
        self.reroute_log = list(payload["reroute_log"])
        self._events = list(payload["events"])
        self._n_real_events = sum(
            1 for ev in self._events if ev[2] not in ("poll", "hb")
        )
        self._seq = payload["seq"]
        self._next_jid = payload["next_jid"]
        self._auto_flow = payload["auto_flow"]
        self._idle0 = dict(ps["idle0"])
        self._live_jobs = dict(payload["live_jobs"])
        self._suspended = list(payload["suspended"])
        self._expiry = list(payload["expiry"])
        self._flow_gen = dict(payload["flow_gen"])
        self._host_failures = dict(payload["host_failures"])
        self.blacklist = set(payload["blacklist"])
        self._poll_pending = payload["poll_pending"]
        self._hb_pending = payload["hb_pending"]
        self.ctrl_down = payload["ctrl_down"]
        self._down_since = payload["down_since"]
        self._mailbox = list(payload["mailbox"])
        self._mailbox_jobs = payload["mailbox_jobs"]
        self.shed_jobs = list(payload["shed_jobs"])
        self.now = payload["now"]
        # Counters before the telemetry monitor: its stats group must find
        # the restored cells when it re-registers by prefix.
        self.obs.load_values(payload["obs"])
        if payload["telemetry"] is not None:
            from ..net.telemetry import LinkStatsMonitor

            mon = LinkStatsMonitor.load_state(
                st.ledger, payload["telemetry"], obs=self.obs
            )
            self.telemetry = mon
            st.belief = mon.belief
            self.obs.register_provider("telemetry", mon.snapshot)
        hb = payload["heartbeats"]
        if hb is not None:
            from ..runtime.ft import HeartbeatMonitor, HostState

            mon = HeartbeatMonitor(
                [], grace_s=hb["grace_s"], clock=lambda: self.now
            )
            mon.hosts = {
                name: HostState(name, last_beat, alive)
                for name, last_beat, alive in hb["hosts"]
            }
            self.heartbeats = mon
            self._hb_interval = hb["interval"]
            self._hb_last = hb["last"]

    @classmethod
    def recover_from(
        cls, fabric: Fabric, snapshot, journal=None, policy=None
    ) -> "ClusterController":
        """Rebuild a controller from a :meth:`snapshot` and replay the
        journaled suffix ``journal.since(snapshot.lsn)`` through the normal
        entry points — byte-identical (schedule dumps, reroute logs,
        behavioral obs counters, ledger bytes) to a controller that never
        crashed.  ``policy=`` overrides reconstruction for custom policy
        objects the snapshot cannot describe."""
        payload = snapshot.payload
        cfg = payload["config"]
        if policy is None:
            name, kwargs = cfg["policy"]
            if kwargs is None:
                raise ValueError(
                    f"snapshot carries custom policy {name!r}; pass policy="
                )
            policy = POLICIES[name](**kwargs)
        ledger_state = payload["ledger"]
        ctrl = cls(
            fabric,
            payload["state"]["workers"],
            policy,
            slot_duration=cfg["slot_duration"],
            horizon_slots=max(1, ledger_state["reserved"].shape[1]),
            k_paths=cfg["k_paths"],
            retry=RetryPolicy(*cfg["retry"]),
            speculation=cfg["speculation"],
            mailbox_limit=cfg["mailbox_limit"],
        )
        with ctrl.obs.span("recovery.restore"):
            ctrl._restore_full(payload)
        ctrl.obs.counter("recovery.recoveries").inc()
        if journal is not None:
            with ctrl.obs.span("recovery.replay"):
                n = ctrl.replay_journal(journal, from_lsn=snapshot.lsn)
            ctrl.obs.counter("recovery.replayed").inc(n)
            # Re-attach *after* replay so the replayed suffix is not
            # double-journaled.
            ctrl.journal = journal
        return ctrl

    # -- telemetry ------------------------------------------------------------
    def attach_telemetry(
        self,
        poll_interval: Optional[float] = None,
        estimator: "str | object" = "ewma",
        **est_kwargs,
    ):
        """Attach a :class:`~repro.net.telemetry.LinkStatsMonitor` driven by
        this event loop: the monitor polls the ledger's per-link counters
        every ``poll_interval`` sim-seconds (default: one slot) while work
        is queued, and keeps ``state.belief`` fresh for policies running
        with ``telemetry=True``.  Attaching a monitor alone never changes
        schedules — oracle policies don't read the belief.  Returns the
        monitor."""
        if self.telemetry is not None:
            raise RuntimeError("telemetry monitor already attached")
        if (self.journal is not None and not self._replaying
                and not self._in_run and not isinstance(estimator, str)):
            raise ValueError(
                "a journaled controller needs a named estimator (str) — "
                "estimator objects are not replayable"
            )
        self._journal("attach_telemetry", poll_interval, estimator,
                      dict(est_kwargs))
        from ..net.telemetry import LinkStatsMonitor

        mon = LinkStatsMonitor(
            self.state.ledger,
            poll_interval=poll_interval,
            estimator=estimator,
            obs=self.obs,
            **est_kwargs,
        )
        self.telemetry = mon
        self.state.belief = mon.belief
        self.obs.register_provider("telemetry", mon.snapshot)
        mon.poll(self.now)
        if self._n_real_events:
            self._arm_poll()
        return mon

    def _arm_poll(self) -> None:
        """Schedule the next counter poll.  The chain only lives while
        other events are queued — ``run()`` drains the queue completely,
        so an unconditional self-rescheduling poll would never let it
        terminate; instead the chain dies with the last real event and is
        re-armed by the next ``_push``."""
        at = max(self.now, self.telemetry.last_poll + self.telemetry.poll_interval)
        self._poll_pending = True
        heapq.heappush(self._events, (at, self._seq, "poll", ()))
        self._seq += 1

    # -- heartbeats ---------------------------------------------------------
    def attach_heartbeats(
        self, interval: Optional[float] = None, grace_s: Optional[float] = None
    ):
        """Attach a :class:`~repro.runtime.ft.HeartbeatMonitor` over this
        controller's workers, driven by the event loop in *sim time* (the
        same poll-chain pattern as ``attach_telemetry`` — never
        ``time.monotonic``, so runs stay deterministic).  Every ``interval``
        sim-seconds (default: one ledger slot) the monitor sweeps; hosts
        whose last beat is older than ``grace_s`` (default: 3 intervals)
        emit ``fail_host``.  Call ``monitor.beat(host, now)`` from the
        workload to keep hosts alive; a recovered host needs an explicit
        ``recover_host`` (plus a beat) to rejoin.  Returns the monitor."""
        if self.heartbeats is not None:
            raise RuntimeError("heartbeat monitor already attached")
        from ..runtime.ft import HeartbeatMonitor

        interval = (self.state.ledger.slot_duration if interval is None
                    else float(interval))
        if interval <= 0.0:
            raise ValueError(f"heartbeat interval must be > 0, got {interval}")
        grace_s = 3.0 * interval if grace_s is None else float(grace_s)
        self._journal("attach_heartbeats", interval, grace_s)
        mon = HeartbeatMonitor(
            list(self.state.workers),
            grace_s=grace_s,
            clock=lambda: self.now,
        )
        self.heartbeats = mon
        self._hb_interval = interval
        self._hb_last = self.now
        if self._n_real_events:
            self._arm_hb()
        return mon

    def _arm_hb(self) -> None:
        """Schedule the next heartbeat sweep — like ``_arm_poll``, the
        chain lives only while real events are queued, else ``run()``
        would never terminate."""
        at = max(self.now, self._hb_last + self._hb_interval)
        self._hb_pending = True
        heapq.heappush(self._events, (at, self._seq, "hb", ()))
        self._seq += 1

    def _hb_sweep(self, at: float) -> None:
        """Missed beats become host failures, inline at the sweep time."""
        self._hb_last = at
        for host in self.heartbeats.sweep(at):
            if (host in self.state.workers_set
                    and host not in self.dataplane.dead_hosts):
                self._on_host_down(host, at)

    # -- event submission ---------------------------------------------------
    def _push(self, at: float, kind: str, payload: tuple) -> None:
        if at < self.now - _EPS:
            raise ValueError(f"event at {at} is in the controller's past {self.now}")
        heapq.heappush(self._events, (at, self._seq, kind, payload))
        self._seq += 1
        self._n_real_events += 1
        # A down controller neither polls nor sweeps — chains stay dead
        # until _on_ctrl_up re-arms them.
        if self.ctrl_down:
            return
        if self.telemetry is not None and not self._poll_pending:
            self._arm_poll()
        if self.heartbeats is not None and not self._hb_pending:
            self._arm_hb()

    def submit(
        self,
        tasks: Sequence[Task],
        at: float = 0.0,
        jid: Optional[int] = None,
    ) -> int:
        """Queue a job (its full task list) to arrive at time ``at``."""
        if jid is None:
            jid = self._next_jid
        if jid in self.jobs:
            raise ValueError(f"duplicate job id {jid}")
        # Journal with the *resolved* jid so a replayed auto-assignment
        # lands on the same id regardless of the restored counter.
        self._journal("submit", float(at), int(jid), tuple(tasks))
        self._next_jid = max(self._next_jid, jid + 1)
        self.jobs[jid] = JobRecord(jid, at, list(tasks))
        self._push(at, "job", (jid,))
        return jid

    def inject_flow(
        self, flow: BackgroundFlow, at: Optional[float] = None
    ) -> None:
        """Queue dynamic background cross-traffic (defaults to its start)."""
        at = flow.start if at is None else at
        self._journal("inject_flow", flow, float(at))
        self._push(at, "flow", (flow,))

    def reserve_transfer_at(
        self,
        at: float,
        size: float,
        links: Sequence[str],
        tag: object = None,
    ) -> None:
        """Queue a raw flow reservation on explicit links at time ``at`` —
        the training-side gradient-sync entry (``distributed.dcn``)."""
        self._journal("reserve_transfer", float(at), float(size),
                      tuple(links), tag)
        self._push(at, "transfer", (size, tuple(links), tag))

    # -- network churn ------------------------------------------------------
    def fail_link(self, name: str, at: Optional[float] = None) -> None:
        """Queue a link failure: in-flight transfers on it reroute when it
        fires (UnroutableError if a victim has no surviving path)."""
        self.state.fabric.link(name)  # validate early: KeyError on unknown
        at = self.now if at is None else at
        self._journal("fail_link", name, float(at))
        self._push(at, "link_down", (name,))

    def recover_link(self, name: str, at: Optional[float] = None) -> None:
        # Validate like fail_link: a typo'd recovery would otherwise be a
        # silent no-op that stalls suspended flows forever.
        self.state.fabric.link(name)
        at = self.now if at is None else at
        self._journal("recover_link", name, float(at))
        self._push(at, "link_up", (name,))

    def fail_switch(self, node: str, at: Optional[float] = None) -> None:
        """Queue a switch failure — every incident link goes down."""
        if not self.state.fabric.has_node(node):
            raise ValueError(f"unknown node {node!r}")
        at = self.now if at is None else at
        self._journal("fail_switch", node, float(at))
        self._push(at, "switch_down", (node,))

    def recover_switch(self, node: str, at: Optional[float] = None) -> None:
        if not self.state.fabric.has_node(node):
            raise ValueError(f"unknown node {node!r}")
        at = self.now if at is None else at
        self._journal("recover_switch", node, float(at))
        self._push(at, "switch_up", (node,))

    def fail_host(self, node: str, at: Optional[float] = None) -> None:
        """Queue a host crash: when it fires, the worker leaves every
        placement surface, its queued/running tasks are killed (transfer
        tails released), and the kills are re-placed through the normal
        policy path under :class:`RetryPolicy`."""
        if not self.state.fabric.has_node(node):
            raise ValueError(f"unknown node {node!r}")
        at = self.now if at is None else at
        self._journal("fail_host", node, float(at))
        self._push(at, "host_down", (node,))

    def recover_host(self, node: str, at: Optional[float] = None) -> None:
        """Queue a host recovery — re-admitted empty unless blacklisted."""
        if not self.state.fabric.has_node(node):
            raise ValueError(f"unknown node {node!r}")
        at = self.now if at is None else at
        self._journal("recover_host", node, float(at))
        self._push(at, "host_up", (node,))

    def straggle(self, node: str, factor: float, at: Optional[float] = None) -> None:
        """Queue a straggler onset: the task running on ``node`` when the
        event fires has its *remaining* compute inflated by ``factor``
        (the progress-rate model).  With ``speculation=True`` the LATE
        rule may launch a backup copy against ledger residuals."""
        if factor < 1.0:
            raise ValueError(f"straggle factor must be >= 1, got {factor}")
        at = self.now if at is None else at
        self._journal("straggle", node, float(factor), float(at))
        self._push(at, "straggle", (node, factor))

    # -- control-plane lifecycle (headless data-plane mode) -----------------
    def fail_controller(self, at: Optional[float] = None) -> None:
        """Queue a control-plane crash: when it fires, the data plane keeps
        forwarding on installed rules (in-flight transfers complete) but
        scheduling stops — new jobs queue in the bounded mailbox (overflow
        → load-shed), all other events are deferred, and the poll/heartbeat
        chains are suspended until :meth:`recover_controller`."""
        at = self.now if at is None else at
        self._journal("fail_controller", float(at))
        self._push(at, "ctrl_down", ())

    def recover_controller(self, at: Optional[float] = None) -> None:
        """Queue a control-plane recovery: reconcile lapsed rule expiries,
        forgive the heartbeat gap, drain the mailbox in arrival order and
        re-arm the polling chains."""
        at = self.now if at is None else at
        self._journal("recover_controller", float(at))
        self._push(at, "ctrl_up", ())

    def inject_net(self, event) -> None:
        """Queue a ``repro.net.events`` NetworkEvent at its own ``at``."""
        from ..net.events import (
            ControllerDown,
            ControllerUp,
            HostDown,
            HostUp,
            LinkDown,
            LinkUp,
            SwitchDown,
            SwitchUp,
        )

        if isinstance(event, ControllerDown):
            self.fail_controller(at=event.at)
            return
        if isinstance(event, ControllerUp):
            self.recover_controller(at=event.at)
            return
        if isinstance(event, LinkDown):
            self.fail_link(event.link, at=event.at)
        elif isinstance(event, LinkUp):
            self.recover_link(event.link, at=event.at)
        elif isinstance(event, SwitchDown):
            self.fail_switch(event.node, at=event.at)
        elif isinstance(event, SwitchUp):
            self.recover_switch(event.node, at=event.at)
        elif isinstance(event, HostDown):
            self.fail_host(event.node, at=event.at)
        elif isinstance(event, HostUp):
            self.recover_host(event.node, at=event.at)
        else:
            raise TypeError(f"not a network event: {event!r}")

    # -- the loop -----------------------------------------------------------
    def run_until(self, t: float) -> None:
        """Process every queued event with fire time ≤ ``t``, in time order
        (ties: submission order)."""
        self._journal("run_until", float(t))
        while self._events and self._events[0][0] <= t + _EPS:
            at, _seq, kind, payload = heapq.heappop(self._events)
            if kind not in ("poll", "hb"):
                self._n_real_events -= 1
            self.now = max(self.now, at)
            self.state.advance(max(self.state.now, at))
            if not self.ctrl_down:
                # Headless: rule expiry is a *control-plane* action — the
                # data plane keeps forwarding on whatever is installed
                # until recovery reconciles the lapsed entries.
                self._gc_tables(at)
            self._ev_stats["events"] += 1
            if self.ctrl_down and kind != "ctrl_up":
                self._headless_event(at, kind, payload)
                continue
            self._dispatch(at, kind, payload)
        self.now = max(self.now, t)
        if not self.ctrl_down:
            self._gc_tables(self.now)
        # Rolling horizon: a quiet controller (no events near ``t``) still
        # retires up to its target time — any later event may fire no
        # earlier than ``now - _EPS``, which maybe_retire's guard slot
        # covers (DESIGN.md §7).
        self.state.ledger.maybe_retire(self.now)

    def run(self) -> None:
        """Drain the event queue completely."""
        self._journal("run")
        was_in_run, self._in_run = self._in_run, True
        try:
            while self._events:
                self.run_until(self._events[0][0])
        finally:
            self._in_run = was_in_run

    def _dispatch(self, at: float, kind: str, payload: tuple) -> None:
        """Apply one popped (or mailbox-drained) event at time ``at``."""
        if kind == "job":
            (jid,) = payload
            self._ev_stats["jobs"] += 1
            with self.obs.span("controller.drain"):
                self._drain(self.jobs[jid])
        elif kind == "poll":
            self._poll_pending = False
            if self.telemetry is not None:
                self._ev_stats["polls"] += 1
                self.telemetry.poll(at)
                if self._n_real_events:
                    self._arm_poll()
        elif kind == "flow":
            (flow,) = payload
            self._ev_stats["flows"] += 1
            self.state.observe_flow(flow)
        elif kind == "transfer":
            size, links, tag = payload
            self._ev_stats["transfers"] += 1
            if tag is None:
                tag = ("flow", self._auto_flow)
                self._auto_flow += 1
            dead = self.dataplane.all_dead_links()
            if any(l in dead for l in links):
                # Requested links are down: suspend until recovery.
                self._suspended.append((tag, links, size))
            else:
                rows = self.state.ledger.rows(links)
                plan = self.state.ledger.plan_transfer(
                    size, rows, not_before=at
                )
                self.state.ledger.commit(plan)
                self.flows[tag] = plan
        elif kind == "link_down":
            (name,) = payload
            self._ev_stats["net_events"] += 1
            self.dataplane.fail_link(name)
            self._reroute_dead(at)
        elif kind == "link_up":
            (name,) = payload
            self._ev_stats["net_events"] += 1
            self.dataplane.recover_link(name)
            self._resume_flows(at)
        elif kind == "switch_down":
            (node,) = payload
            self._ev_stats["net_events"] += 1
            self.dataplane.fail_switch(node)
            self._reroute_dead(at)
        elif kind == "switch_up":
            (node,) = payload
            self._ev_stats["net_events"] += 1
            self.dataplane.recover_switch(node)
            self._resume_flows(at)
        elif kind == "host_down":
            (node,) = payload
            self._ev_stats["net_events"] += 1
            self._on_host_down(node, at)
        elif kind == "host_up":
            (node,) = payload
            self._ev_stats["net_events"] += 1
            self._on_host_up(node, at)
        elif kind == "straggle":
            node, factor = payload
            self._on_straggle(node, factor, at)
        elif kind == "task_retry":
            jid, tid, attempt = payload
            self._retry_task(jid, tid, attempt, at)
        elif kind == "spec_resolve":
            (tid,) = payload
            self._resolve_spec(tid, at)
        elif kind == "hb":
            self._hb_pending = False
            if self.heartbeats is not None:
                # A sweep can _push retries, which re-arms the chain —
                # don't arm twice.
                self._hb_sweep(at)
                if self._n_real_events and not self._hb_pending:
                    self._arm_hb()
        elif kind == "ctrl_down":
            self._on_ctrl_down(at)
        elif kind == "ctrl_up":
            self._on_ctrl_up(at)

    # -- headless data-plane mode (DESIGN.md §11) ---------------------------
    def _headless_event(self, at: float, kind: str, payload: tuple) -> None:
        """One event firing while the control plane is down.

        The data plane needs no controller to finish what was installed —
        transfers already booked on the ledger complete on their reserved
        slots and their rules stay up until recovery reconciles expiries.
        Everything needing a *decision* waits: job arrivals enter the
        bounded mailbox (overflow → load-shed, surfaced as a ``degraded``
        reject by ``serving.router``), and every other event (flows, raw
        transfers, net churn, retries, speculation resolves) is deferred
        in arrival order.  Deferred net events apply their liveness change
        at drain time — a path that died headless reroutes at recovery,
        with the outage bytes counted delivered (the documented
        approximation: in-flight completion is only guaranteed on paths
        that stay alive).  Poll/heartbeat chain events are dropped with
        their pending flags cleared — the chains die (a dead controller
        neither polls counters nor hears beats) and recovery re-arms them.
        """
        if kind == "ctrl_down":
            return  # duplicate crash while already down
        if kind in ("poll", "hb"):
            if kind == "poll":
                self._poll_pending = False
            else:
                self._hb_pending = False
            return
        if kind == "job":
            (jid,) = payload
            if self._mailbox_jobs >= self.mailbox_limit:
                self.jobs[jid].shed = True
                self.shed_jobs.append(jid)
                self.ha_stats["mailbox_shed"] += 1
                return
            self._mailbox_jobs += 1
            self.ha_stats["mailbox_queued"] += 1
        else:
            self.ha_stats["deferred"] += 1
        self._mailbox.append((kind, payload))

    def _on_ctrl_down(self, at: float) -> None:
        if self.ctrl_down:
            return  # duplicate crash event
        self.ctrl_down = True
        self._down_since = at
        self.ha_stats["ctrl_down"] += 1
        rec_t = self.obs.trace
        if rec_t.enabled:
            rec_t.record("ctrl_down", at=at)

    def _on_ctrl_up(self, at: float) -> None:
        if not self.ctrl_down:
            return  # never crashed (or duplicate recovery)
        self.ctrl_down = False
        outage = at - self._down_since
        self.ha_stats["ctrl_up"] += 1
        # A dead controller heard no beats: forgive the gap so the first
        # post-recovery sweep doesn't mass-declare healthy hosts dead.
        if self.heartbeats is not None:
            self.heartbeats.suspend_accrual(outage, now=at)
        # Reconcile rule expiries that lapsed during the outage.
        n0 = self.dataplane.tables.n_rules()
        self._gc_tables(at)
        self.ha_stats["reconciled_rules"] += (
            n0 - self.dataplane.tables.n_rules()
        )
        # Drain the mailbox in arrival order, all at recovery time.
        backlog, self._mailbox, self._mailbox_jobs = self._mailbox, [], 0
        for kind, payload in backlog:
            self._dispatch(at, kind, payload)
        # Re-arm the suspended chains.
        if (self.telemetry is not None and self._n_real_events
                and not self._poll_pending):
            self._arm_poll()
        if (self.heartbeats is not None and self._n_real_events
                and not self._hb_pending):
            self._arm_hb()
        rec_t = self.obs.trace
        if rec_t.enabled:
            rec_t.record("ctrl_up", at=at, outage=outage,
                         drained=len(backlog))

    def _drain(self, rec: "JobRecord") -> None:
        """Place one arrived job's task list and install its flow rules.

        ``policy.place_batch`` routes through the wavefront engine
        (``core.wavefront``) healthy or degraded — a fleet-scale arrival
        is planned in broadcast waves rather than per-task ledger
        re-scans, with dead links priced out of candidate enumeration —
        byte-identical either way."""
        rec.assignments = self.policy.place_batch(rec.tasks, self.state)
        rec.placed = True
        for a in rec.assignments:
            if a.transfer is not None and a.transfer.slot_fracs:
                self._install(("job", rec.jid, a.tid), a.source, a.node,
                              a.transfer)
                self._live_jobs[rec.jid] = max(
                    self._live_jobs.get(rec.jid, 0.0), a.transfer.end
                )

    # -- data-plane bookkeeping ---------------------------------------------
    def _install(self, cookie, src: Optional[str], dst: str,
                 plan: TransferPlan) -> None:
        """Push the transfer's per-switch rules; schedule their expiry."""
        if src is None:
            return
        links = self.state.ledger.link_names(plan.links)
        self.dataplane.tables.install_path(cookie, src, dst, links)
        gen = self._flow_gen.get(cookie, 0) + 1
        self._flow_gen[cookie] = gen
        heapq.heappush(self._expiry, (plan.end, gen, cookie))

    def _gc_tables(self, now: float) -> None:
        """Uninstall rules of transfers that have completed by ``now``.

        Generation guard: a reroute reinstalls under the same cookie with a
        later end — the stale expiry entry must not strip the new rules.
        """
        while self._expiry and self._expiry[0][0] <= now + _EPS:
            _end, gen, cookie = heapq.heappop(self._expiry)
            if self._flow_gen.get(cookie) == gen:
                self.dataplane.tables.uninstall(cookie)
                del self._flow_gen[cookie]

    # -- failure-aware rerouting --------------------------------------------
    def _reroute_dead(self, at: float) -> None:
        """Re-plan every in-flight transfer whose path just died.

        Semantics (DESIGN.md §4): slots consumed before the failure slot
        stay booked (those bytes arrived); the failure slot and everything
        after are released, and the remaining bytes are re-planned on the
        best surviving (replica, path) candidate starting at ``at``.
        Raises :class:`UnroutableError` when a victim has no surviving
        path — there are no silent stalls.

        The batched engine (``core.reroute``, DESIGN.md §6) replans the
        whole storm in fused array passes, byte-identical to the
        sequential per-victim loop, which survives as the reference
        oracle (``reroute_engine = "sequential"``).
        """
        from .reroute import RerouteEngine, sequential_reroute

        n0 = len(self.reroute_log)
        with self.obs.span("controller.reroute"):
            if self.reroute_engine == "sequential":
                sequential_reroute(self, at)
            else:
                RerouteEngine(self).run(at)
        rec = self.obs.trace
        if rec.enabled:
            rec.record("reroute", at=at, victims=len(self.reroute_log) - n0)
        self._compact_expiry()

    def _compact_expiry(self) -> None:
        """Drop stale flow-rule expiry entries (lazy-deletion compaction).

        A reroute reinstalls rules under the same cookie with a newer
        generation; the superseded heap entry only disappears once its
        old end time passes.  Across a long failure storm of mass
        reinstalls the heap would otherwise accumulate one stale entry
        per reroute — compact whenever stale entries outnumber live
        cookies."""
        if len(self._expiry) > 64 and len(self._expiry) > 2 * len(self._flow_gen):
            self._expiry = [
                e for e in self._expiry if self._flow_gen.get(e[2]) == e[1]
            ]
            heapq.heapify(self._expiry)

    def _resume_flows(self, at: float) -> None:
        """Re-plan suspended raw flows whose links are all alive again."""
        dead = self.dataplane.all_dead_links()
        still = []
        for tag, links, remaining in self._suspended:
            if any(l in dead for l in links):
                still.append((tag, links, remaining))
                continue
            rows = self.state.ledger.rows(links)
            plan = self.state.ledger.plan_transfer(
                remaining, rows, not_before=at
            )
            self.state.ledger.commit(plan)
            self.flows[tag] = plan
        self._suspended = still

    # -- host lifecycle + task re-execution (DESIGN.md §10) -----------------
    def _kill_assignment(self, rec: "JobRecord", a: Assignment, at: float,
                         cookie=None) -> float:
        """Tear one unfinished assignment down: release the transfer's
        unconsumed tail (``release_after`` — the boundary slot is
        forfeited whole), account the delivered-but-unusable bytes as
        waste, drop its flow rule, and remove it from the job record.
        Returns the wasted byte count."""
        ledger = self.state.ledger
        wasted = 0.0
        if a.transfer is not None and a.transfer.slot_fracs:
            kept = ledger.release_after(a.transfer, at)
            a.transfer = kept
            wasted = ledger.plan_bytes(kept)
            if cookie is None:
                cookie = ("job", rec.jid, a.tid)
            if cookie in self._flow_gen:
                self.dataplane.tables.uninstall(cookie)
                del self._flow_gen[cookie]
        rec.wasted_bytes += wasted
        self.fault_stats["wasted_bytes"] += wasted
        rec.assignments.remove(a)
        return wasted

    def _on_host_down(self, node: str, at: float) -> None:
        """Host crash: leave every placement surface, kill the machine's
        unfinished work, then reroute in-flight transfers it was sourcing.

        Ordering matters: kills run *before* ``_reroute_dead`` so the
        victim sweep never tries to replan a transfer toward a dead
        destination (which has no surviving path by definition); the
        sweep then only sees transfers *from* the dead host's replicas
        toward live nodes, which reroute to surviving replicas."""
        if node in self.dataplane.dead_hosts:
            return  # duplicate crash event
        self.fault_stats["host_down"] += 1
        n_fail = self._host_failures.get(node, 0) + 1
        self._host_failures[node] = n_fail
        if n_fail >= self.retry.blacklist_after and node not in self.blacklist:
            self.blacklist.add(node)
            self.fault_stats["blacklisted"] += 1
        self.dataplane.fail_host(node)
        self.state.remove_worker(node)
        retries: List[Tuple[int, int]] = []
        for jid in sorted(self.jobs):
            rec = self.jobs[jid]
            if not rec.placed:
                continue
            for a in [x for x in rec.assignments
                      if x.node == node and x.finish > at + _EPS]:
                self.fault_stats["killed"] += 1
                spec = self._specs.get(a.tid)
                if spec is not None and (spec.primary is a or spec.backup is a):
                    # Its speculation partner survives: resolve by forfeit
                    # instead of re-executing.
                    self._kill_assignment(
                        rec, a, at,
                        cookie=("spec", jid, a.tid) if spec.backup is a
                        else None,
                    )
                    del self._specs[a.tid]
                    if spec.backup is not a:
                        self.fault_stats["spec_win"] += 1
                    elif self.speculation:
                        # The backup died with the host but the straggler
                        # is still slow — relaunch against the post-crash
                        # ledger (LATE keeps one live backup per task).
                        self._maybe_speculate(rec, spec.primary, at)
                    continue
                self._kill_assignment(rec, a, at)
                retries.append((jid, a.tid))
        self._reroute_dead(at)
        if self.retry.max_attempts > 0:
            for jid, tid in retries:
                self._push(at + self.retry.backoff(0), "task_retry",
                           (jid, tid, 0))
        rec_t = self.obs.trace
        if rec_t.enabled:
            rec_t.record("host_down", node=node, at=at, killed=len(retries))

    def _on_host_up(self, node: str, at: float) -> None:
        """Host recovery: re-admit the worker empty (idle = now) unless it
        crashed its way onto the blacklist — then it stays priced out."""
        if node not in self.dataplane.dead_hosts:
            return  # never failed (or duplicate recovery)
        if node in self.blacklist:
            return  # administratively down
        self.fault_stats["host_up"] += 1
        self.dataplane.recover_host(node)
        self.state.add_worker(node, at)
        self._resume_flows(at)

    def _retry_task(self, jid: int, tid: int, attempt: int, at: float) -> None:
        """Re-place one killed task through the normal (bandwidth-aware)
        policy path; a transient all-replicas-dead window burns an attempt
        and backs off, exhaustion raises — no silent stalls."""
        rec = self.jobs.get(jid)
        if rec is None:
            return
        task = next(t for t in rec.tasks if t.tid == tid)
        self.fault_stats["retries"] += 1
        try:
            a = self.policy.place(task, self.state)
        except UnroutableError:
            nxt = attempt + 1
            if nxt >= self.retry.max_attempts:
                raise UnroutableError(
                    f"task {tid}: no live replica after {nxt} attempts"
                )
            self._push(at + self.retry.backoff(nxt), "task_retry",
                       (jid, tid, nxt))
            return
        rec.assignments.append(a)
        rec.reexecuted += 1
        self.fault_stats["reexecuted"] += 1
        if a.transfer is not None and a.transfer.slot_fracs:
            self._install(("job", jid, tid), a.source, a.node, a.transfer)
            self._live_jobs[jid] = max(
                self._live_jobs.get(jid, 0.0), a.transfer.end
            )

    # -- stragglers + LATE speculation --------------------------------------
    def _on_straggle(self, node: str, factor: float, at: float) -> None:
        """Progress-rate drop: the task running on ``node`` now needs
        ``factor``× its remaining compute.  Node exclusivity means at most
        one assignment is running; queued tasks are not stragglers yet."""
        victim = vrec = None
        for rec in self.jobs.values():
            for a in rec.assignments:
                if a.node != node or a.finish <= at + _EPS:
                    continue
                # Running task wins; otherwise the node's next queued task
                # (the slowdown is a property of the machine at ``at``).
                key = (a.start > at + _EPS, a.start, a.tid)
                if victim is None or key < (victim.start > at + _EPS,
                                            victim.start, victim.tid):
                    victim, vrec = a, rec
        if victim is None:
            return
        # Remaining (running) or whole (queued) compute inflates.
        t0 = max(at, victim.start)
        victim.finish = t0 + (victim.finish - t0) * factor
        self._retime_nodes({node})
        if self.speculation and victim.tid not in self._specs:
            self._maybe_speculate(vrec, victim, at)

    def _maybe_speculate(self, rec: "JobRecord", a: Assignment,
                         at: float) -> None:
        """The LATE rule, priced by the ledger: launch a backup copy on
        the least-loaded other worker iff the ledger's *residual* slots
        say the backup (data movement included) finishes before the
        straggler's projected finish.  A progress-rate-only rule would
        launch backups whose transfers crawl through congested links and
        finish after the straggler anyway — pure waste."""
        task = next(t for t in rec.tasks if t.tid == a.tid)
        state = self.state
        cands = [n for n in state.workers if n != a.node]
        if not cands:
            return
        bnode = min(cands, key=lambda n: (state.idle[n], n))
        plan = src = None
        if bnode in task.replicas:
            backup_finish = state.idle[bnode] + task.compute
        else:
            try:
                src, _rows, plan = state.choose_source_path(
                    task, bnode, at=state.idle[bnode]
                )
            except UnroutableError:
                return
            start = plan.end if plan.slot_fracs else state.idle[bnode]
            backup_finish = start + task.compute
        if backup_finish >= a.finish - _EPS:
            return  # residuals say the backup loses: don't burn bandwidth
        if plan is None:
            b = state.commit_local(task, bnode)
        else:
            b = state.commit_remote(task, bnode, src, plan)
            self._install(("spec", rec.jid, a.tid), src, bnode, plan)
            self._live_jobs[rec.jid] = max(
                self._live_jobs.get(rec.jid, 0.0), plan.end
            )
        rec.assignments.append(b)
        rec.speculative += 1
        self.fault_stats["spec_launch"] += 1
        self._specs[a.tid] = _SpecRecord(rec.jid, a, b)
        self._push(min(a.finish, b.finish), "spec_resolve", (a.tid,))

    def _resolve_spec(self, tid: int, at: float) -> None:
        """First finisher wins; the loser's remaining slots are released
        and its delivered bytes counted as waste.  Retimes may have pushed
        both copies past the scheduled resolve time — re-arm at the new
        earliest finish instead of guessing."""
        spec = self._specs.get(tid)
        if spec is None:
            return  # resolved by forfeit (host crash) meanwhile
        p, b = spec.primary, spec.backup
        done = min(p.finish, b.finish)
        if done > at + _EPS:
            self._push(done, "spec_resolve", (tid,))
            return
        winner, loser = (p, b) if p.finish <= b.finish + _EPS else (b, p)
        del self._specs[tid]
        rec = self.jobs[spec.jid]
        self._kill_assignment(
            rec, loser, at,
            cookie=("spec", spec.jid, tid) if loser is b else None,
        )
        if winner is b:
            self.fault_stats["spec_win"] += 1
        # The loser's node genuinely lost a queue entry: let its remaining
        # tasks rewind to their natural no-idle starts (same contract as a
        # reroute's retime) — otherwise the win never reaches tasks queued
        # behind the dead straggler and speculation can't move makespan.
        rewind = {a2.tid for r2 in self.jobs.values()
                  for a2 in r2.assignments if a2.node == loser.node}
        self._retime_nodes({loser.node}, rewind)
        rec_t = self.obs.trace
        if rec_t.enabled:
            rec_t.record("spec_resolve", tid=tid, at=at,
                         winner=winner.node, loser=loser.node)

    def _retime_nodes(self, nodes, rerouted_tids=frozenset()) -> None:
        """Recompute the compute timeline of every touched node.

        Mirrors the replay oracle: tasks keep their committed order (old
        start, tid), each starts at max(previous finish, its transfer's
        end, its job's arrival), never before the node's initial idle
        time.  Tasks whose transfer was *not* rerouted additionally never
        move earlier than their committed start — external idle estimates
        (``set_idle`` backlog refreshes) are folded into committed starts
        and must not be rewound by a retime that only knows ``_idle0``.
        The shared idle map and minnow heap are resynced.

        One grouping pass over the assignment set feeds every node's
        replay (the per-node scan is a genuine recurrence and stays in
        python floats — the same doubles, in the same order); the
        historical per-node re-scan of all jobs made a storm's retime
        O(touched nodes × assignments).
        """
        by_node: Dict[str, List[Tuple[float, "Assignment"]]] = {
            n: [] for n in nodes
        }
        for rec in self.jobs.values():
            submit_at = rec.submit_at
            for a in rec.assignments:
                q = by_node.get(a.node)
                if q is not None:
                    q.append((submit_at, a))
        for node, items in by_node.items():
            items.sort(key=lambda sa: (sa[1].start, sa[1].tid))
            t = self._idle0.get(node, 0.0)
            for submit_at, a in items:
                ready = submit_at
                if a.transfer is not None and a.transfer.slot_fracs:
                    ready = max(ready, a.transfer.end)
                task_compute = a.finish - a.start  # TP is start-invariant
                start = max(t, ready)
                if a.tid not in rerouted_tids:
                    start = max(start, a.start)  # committed history holds
                a.start = start
                a.finish = start + task_compute
                t = a.finish
            self.state.idle[node] = max(t, self.state.now)
        self.state.reheap()

    # -- results ------------------------------------------------------------
    def job_schedule(self, jid: int) -> Schedule:
        rec = self.jobs[jid]
        return Schedule(
            list(rec.assignments),
            self.state.ledger,
            kinds={t.tid: t.kind for t in rec.tasks},
        )

    def schedule(self) -> Schedule:
        """All placed assignments across jobs, as one Schedule."""
        out = [a for rec in self.jobs.values() for a in rec.assignments]
        kinds = {
            t.tid: t.kind for rec in self.jobs.values() for t in rec.tasks
        }
        out.sort(key=lambda a: a.tid)
        return Schedule(out, self.state.ledger, kinds=kinds)

    # -- observability providers (lazily evaluated at snapshot time) --------
    def _ledger_obs(self) -> dict:
        led = self.state.ledger
        return {
            "batch_scan_cells": led.batch_scan_cells,
            "base_slot": led.base_slot,
            "retired_slots": led.retired_slots,
            "live_slots": int(led.reserved.shape[1]),
            "links": int(led.reserved.shape[0]),
            "utilization": led.utilization(),
        }

    def _jobs_obs(self) -> dict:
        return {
            str(jid): self.job_metrics(jid).to_dict()
            for jid, rec in self.jobs.items()
            if rec.placed
        }

    def job_metrics(self, jid: int):
        """Per-job Table-I row relative to the job's arrival: MT/RT/JT/LR."""
        from .simulator import JobMetrics

        rec = self.jobs[jid]
        if not rec.placed:
            raise ValueError(f"job {jid} not placed yet (run_until?)")
        kinds = {t.tid: t.kind for t in rec.tasks}
        jt = rec.makespan - rec.submit_at
        maps = [
            a.finish for a in rec.assignments if kinds.get(a.tid, "map") == "map"
        ]
        mt = (max(maps) - rec.submit_at) if maps else jt
        n = len(rec.assignments)
        lr = sum(1 for a in rec.assignments if a.local) / n if n else 0.0
        return JobMetrics(mt=mt, rt=jt - mt, jt=jt, lr=lr,
                          rerouted=rec.rerouted,
                          reexecuted=rec.reexecuted,
                          speculative=rec.speculative,
                          wasted_bytes=rec.wasted_bytes)
