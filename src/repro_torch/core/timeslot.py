"""Time-Slot (TS) bandwidth allocation — paper §IV.A.

Each link's residual bandwidth is disintegrated into equal-duration time slots
``TS_1, TS_2, …``; a task that moves data over a path during ``(t_m, t_n)`` has
the corresponding slots reserved *on every link of that path* in advance, and
the usable bandwidth of a path in a slot is the minimum residual over its
links.  The paper's allocation policy is deliberately simple ("always provide
tasks requiring data movement with the most residue bandwidth, then take it
back after the occupation") — a transfer greedily consumes the full residual
of its path slot-by-slot until the bytes are delivered.

The ledger is a dense ``[n_links, n_slots]`` float matrix of *reserved
fractions* (0 = free, 1 = fully booked), vectorized with numpy so the same
code schedules a 4-node Hadoop testbed and a 4 000-host TPU-fleet DCN (see
``benchmarks/bench_sched_scale.py``).

**Rolling horizon (DESIGN.md §7).**  A long-lived controller advances
simulated time forever, but only the slots at/after "now" can still be
planned, committed or released — fully-past slots hold delivered history
nobody re-reads through the matrix.  The ledger therefore carries a
``base_slot`` origin: physical column ``j`` stores absolute slot
``base_slot + j``, and :meth:`retire` drops fully-past columns so the
live matrix stays O(live window) instead of O(elapsed time).  Every
public API (and ``TransferPlan.slot_fracs``) speaks *absolute* slots
throughout — compaction is invisible to callers, and a compacted ledger
answers every query/plan/commit identically to a never-compacted twin
(property-tested in ``tests/test_compaction.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels import ts_plan
from ..obs import Counter
from .topology import Fabric

_EPS = 1e-9
assert ts_plan.EPS == _EPS, "ts_plan kernel and ledger must share one epsilon"


@dataclass(frozen=True)
class TransferPlan:
    """An uncommitted transfer: slot reservations + continuous start/end times."""

    links: Tuple[int, ...]           # ledger row indices
    start: float                     # seconds (continuous)
    end: float                       # seconds (continuous)
    slot_fracs: Tuple[Tuple[int, float], ...]  # (slot index, fraction reserved)

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def slots(self) -> Tuple[int, ...]:
        """1-based slot numbers à la paper (TS_1 covers [0, slot_dur))."""
        return tuple(s + 1 for s, _ in self.slot_fracs)


class TimeSlotLedger:
    """Per-link slotted reservation calendar (the SDN controller's ``SL_rl``)."""

    #: Device-resident mirror (``kernels.ts_plan_device.DeviceMirror``),
    #: attached lazily by :meth:`device_mirror`.  Class-level default so
    #: ``__new__``-based clones (controller snapshots) start mirror-free.
    _mirror = None

    def __init__(
        self,
        fabric: Fabric,
        slot_duration: float = 1.0,
        horizon_slots: int = 256,
    ) -> None:
        self.fabric = fabric
        self.slot_duration = float(slot_duration)
        names = sorted(fabric.links)
        self._row: Dict[str, int] = {n: i for i, n in enumerate(names)}
        self._names = names
        self.capacity = np.array(
            [fabric.link(n).capacity for n in names], dtype=np.float64
        )
        # Capacity-backed storage: ``reserved`` is a view into ``_buf``
        # starting at column ``_col0`` — growth re-slices within capacity
        # and origin retirement advances the offset, both copy-free
        # (see :meth:`_ensure` / :meth:`retire_to`).
        self._buf = np.zeros((len(names), horizon_slots), dtype=np.float64)
        self._col0 = 0
        self._res = self._buf
        #: Rolling-horizon origin: ``reserved[:, 0]`` holds absolute slot
        #: ``base_slot``.  Public APIs are absolute; only physical column
        #: indices shift (DESIGN.md §7).
        self.base_slot = 0
        #: Telemetry: columns dropped by :meth:`retire` so far.
        self.retired_slots = 0
        #: :meth:`maybe_retire` compacts once this many fully-past slots
        #: have accumulated; ``None`` disables auto-compaction (the
        #: never-compacted twin the equivalence tests compare against).
        self.retire_stride: Optional[int] = max(64, horizon_slots)
        #: Instrumentation: candidate·slot cells scanned by
        #: :meth:`plan_transfer_batch` (the escalation-freeze regression
        #: test pins that one oversized outlier no longer re-scans the
        #: whole batch at 4× the window).  Backed by a ``repro.obs``
        #: counter (see the property below) so the obs snapshot reads it
        #: live; int-style use (`led.batch_scan_cells += n`, `= 0`) is
        #: unchanged.
        self.batch_scan_cells = 0
        self._path_rows: Dict[Tuple[str, str], Tuple[int, ...]] = {}
        self._path_rows_version = fabric.version

    @classmethod
    def for_links(
        cls,
        fabric: Fabric,
        link_names: Iterable[str],
        slot_duration: float = 1.0,
        horizon_slots: int = 256,
    ) -> "TimeSlotLedger":
        """A ledger *shard*: same calendar machinery, rows restricted to
        ``link_names`` (a pod's internal links, or the boundary slice).

        Row numbering is local to the shard (sorted subset order) — the
        :class:`ShardedLedger` facade owns the global↔local translation.
        Built via ``__new__`` like ``ClusterState.clone`` so the flat
        constructor's full-fabric row map is never materialized."""
        led = cls.__new__(cls)
        led.fabric = fabric
        led.slot_duration = float(slot_duration)
        names = sorted(link_names)
        led._row = {n: i for i, n in enumerate(names)}
        led._names = names
        led.capacity = np.array(
            [fabric.link(n).capacity for n in names], dtype=np.float64
        )
        led._buf = np.zeros((len(names), horizon_slots), dtype=np.float64)
        led._col0 = 0
        led._res = led._buf
        led.base_slot = 0
        led.retired_slots = 0
        led.retire_stride = max(64, horizon_slots)
        led.batch_scan_cells = 0
        led._path_rows = {}
        led._path_rows_version = fabric.version
        return led

    # -- plumbing -----------------------------------------------------------
    # ``batch_scan_cells`` counter cell: class default None so instances
    # built via ``__new__`` (ClusterState.clone) lazily create theirs on
    # first assignment.
    _scan_cells: Optional[Counter] = None

    @property
    def batch_scan_cells(self) -> int:
        cell = self._scan_cells
        return 0 if cell is None else cell.value

    @batch_scan_cells.setter
    def batch_scan_cells(self, value: int) -> None:
        cell = self._scan_cells
        if cell is None:
            self._scan_cells = Counter("ledger.batch_scan_cells", value)
        else:
            cell.value = value

    def rows(self, link_names: Sequence[str]) -> Tuple[int, ...]:
        return tuple(self._row[n] for n in link_names)

    def link_names(self, rows: Sequence[int]) -> Tuple[str, ...]:
        return tuple(self._names[r] for r in rows)

    def path_rows(self, src: str, dst: str) -> Tuple[int, ...]:
        """``rows(fabric.path(src, dst))``, cached per endpoint pair.

        The scheduling loop re-derives the same path-row tuples for every
        placement (every replica of every task); the fabric's own path
        cache still pays a name→row translation per link per call.  Keyed
        on ``fabric.version`` so a topology mutation can never serve a
        pre-mutation row set.
        """
        if self.fabric.version != self._path_rows_version:
            self._path_rows.clear()
            self._path_rows_version = self.fabric.version
        hit = self._path_rows.get((src, dst))
        if hit is None:
            hit = self.rows(self.fabric.path(src, dst))
            if len(self._path_rows) > (1 << 18):
                self._path_rows.clear()
            self._path_rows[(src, dst)] = hit
        return hit

    @property
    def reserved(self) -> np.ndarray:
        """Live ``[n_links, width]`` reservation window (column 0 holds
        absolute slot :attr:`base_slot`) — a view into the wider capacity
        buffer, so its identity changes whenever the window grows or the
        origin shifts."""
        return self._res

    @reserved.setter
    def reserved(self, arr: np.ndarray) -> None:
        # Wholesale replacement (controller snapshot/restore/clone): the
        # array becomes the new capacity buffer and any device mirror is
        # stale by definition.
        self._buf = arr
        self._col0 = 0
        self._res = arr
        if self._mirror is not None:
            self._mirror.invalidate()

    def _ensure(self, slot: int) -> None:
        """Grow the live window so absolute ``slot`` has a live column.

        Growth within capacity just widens the view — no copy, no
        zeroing (pages arrive zeroed from the allocator).  A capacity
        miss reallocates at 8× the requested width, so the copy cost per
        cell amortizes to O(1) over a run; the old at-least-double
        zeros+copy was the dominant wall-clock cost at fleet scale.
        """
        n = self._res.shape[1]
        need = slot - self.base_slot
        if need < n:
            return
        width = need + 1
        if self._col0 + width > self._buf.shape[1]:
            cap = max(width * 8, 64)
            wider = np.zeros((self._res.shape[0], cap))
            wider[:, :n] = self._res
            self._buf = wider
            self._col0 = 0
        self._res = self._buf[:, self._col0 : self._col0 + width]

    def device_mirror(self):
        """The lazily-attached device-resident mirror of :attr:`reserved`
        (``kernels.ts_plan_device.DeviceMirror``) — the device backend's
        gather source.  Narrow sync API: the mutators journal every cell
        write through it and the mirror folds the journal in at its next
        ``sync()`` (DESIGN.md §8)."""
        if self._mirror is None:
            from ..kernels.ts_plan_device import DeviceMirror

            self._mirror = DeviceMirror(self)
        return self._mirror

    def mirror_invalidate(self) -> None:
        """Drop the device mirror's incremental state after a direct
        :attr:`reserved` write that bypassed the journaling mutators; the
        next sync re-uploads the full window."""
        if self._mirror is not None:
            self._mirror.invalidate()

    # -- full-state serialization (controller crash-recovery) ---------------
    def dump_state(self) -> dict:
        """Plain-data serialization of the rolling reservation window —
        everything :meth:`load_state` needs to make a same-fabric ledger
        byte-identical: the live matrix, its absolute origin, the
        compaction telemetry/stride, and the batch-scan counter (DESIGN.md
        §11).  Static structure (row map, capacities) is derived from the
        fabric at construction and is not serialized."""
        return {
            "reserved": self.reserved.copy(),
            "base_slot": self.base_slot,
            "retired_slots": self.retired_slots,
            "retire_stride": self.retire_stride,
            "scan_cells": self.batch_scan_cells,
        }

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`dump_state` dict in place.  Goes through the
        ``reserved`` setter, so any attached device mirror is invalidated
        and re-uploads the full window on its next sync."""
        self.reserved = state["reserved"].copy()
        self.base_slot = state["base_slot"]
        self.retired_slots = state["retired_slots"]
        self.retire_stride = state["retire_stride"]
        self.batch_scan_cells = state["scan_cells"]

    def slot_of(self, t: float) -> int:
        return int(math.floor(t / self.slot_duration + _EPS))

    # -- rolling-horizon compaction -----------------------------------------
    def retire(self, t: float) -> int:
        """Drop every fully-past slot — absolute slots ``< slot_of(t)`` —
        and shift the origin there.  Returns the number of columns dropped.

        Retire-safety (DESIGN.md §7): no code path *writes* a slot before
        ``slot_of(now)`` (plans start at ``not_before >= now``, tail
        releases cut at ``slot_of(at >= now)``, ``occupy`` clamps), and
        the only reads of delivered history go through the plan objects
        themselves (``plan_bytes``/``release_after`` keep-arithmetic),
        never the matrix — so in-flight plans' tails survive intact and
        dropped columns are unreachable.  Read-only queries aimed at the
        retired past answer "free" (see :meth:`residual_fraction`).
        """
        return self.retire_to(self.slot_of(t))

    def retire_to(self, cut: int) -> int:
        """Make ``cut`` the new origin (no-op when it is not ahead)."""
        drop = cut - self.base_slot
        if drop <= 0:
            return 0
        width = self._res.shape[1]
        if drop >= width:
            # Everything booked is in the past: restart with a minimal
            # window (columns beyond the old width were never allocated
            # and are zero by definition).  Assigning through the setter
            # also invalidates any device mirror.
            self.reserved = np.zeros((self._res.shape[0], 64))
        else:
            # Origin shift = view-offset advance, copy-free; the retired
            # columns stay in the capacity buffer until the next realloc.
            # A device mirror re-bases itself at its next sync.
            self._col0 += drop
            self._res = self._buf[:, self._col0 : self._col0 + (width - drop)]
        self.base_slot = cut
        self.retired_slots += drop
        return drop

    def maybe_retire(self, t: float) -> int:
        """Hysteresis wrapper the controller calls per clock advance:
        compact only once ``retire_stride`` fully-past slots accumulated
        (so the slice-copy amortizes), and keep one *guard slot* behind
        ``slot_of(t)`` — queued events may legally fire up to ``_EPS``
        before ``t``, which can land one slot earlier after flooring."""
        stride = self.retire_stride
        if stride is None:
            return 0
        cut = self.slot_of(t) - 1
        if cut - self.base_slot < stride:
            return 0
        return self.retire_to(cut)

    # -- queries ------------------------------------------------------------
    #
    # Read-only queries never allocate: a slot past the live horizon holds
    # no reservation by definition, and a retired slot is delivered history
    # the forward-looking ledger has dropped — both answer "free" (full
    # residue) without growing the matrix.  (They historically called
    # ``_ensure`` and silently doubled the allocation on lookup.)

    def residual_fraction(self, rows: Sequence[int], slot: int) -> float:
        """Min residual fraction over ``rows`` in ``slot`` (path residue)."""
        if not rows:
            return 1.0
        p = slot - self.base_slot
        if p < 0 or p >= self.reserved.shape[1]:
            return 1.0
        return float(1.0 - self.reserved[list(rows), p].max())

    def path_bandwidth(self, rows: Sequence[int], t: float) -> float:
        """``BW_rl`` of a path at time ``t`` = min over links of residual bw."""
        if not rows:
            return float("inf")
        idx = list(rows)
        p = self.slot_of(t) - self.base_slot
        if p < 0 or p >= self.reserved.shape[1]:
            return float(self.capacity[idx].min())
        resid = (1.0 - self.reserved[idx, p]) * self.capacity[idx]
        return float(resid.min())

    def path_bandwidth_batch(
        self, rows_list: Sequence[Sequence[int]], t: float
    ) -> np.ndarray:
        """``BW_rl`` for many candidate paths in one numpy pass.

        Element ``i`` equals ``path_bandwidth(rows_list[i], t)`` exactly —
        the per-candidate min runs over a padded row matrix whose padding
        repeats one of the candidate's own links, so duplicates cannot
        change the minimum.
        """
        n = len(rows_list)
        out = np.full(n, float("inf"))
        live = [i for i in range(n) if rows_list[i]]
        if not live:
            return out
        pad = self._padded_rows([rows_list[i] for i in live])
        p = self.slot_of(t) - self.base_slot
        if p < 0 or p >= self.reserved.shape[1]:
            out[live] = self.capacity[pad].min(axis=1)
            return out
        resid = (1.0 - self.reserved[:, p][pad]) * self.capacity[pad]
        out[live] = resid.min(axis=1)
        return out

    def min_path_bandwidth(self, rows: Sequence[int], t0: float, t1: float) -> float:
        """Worst-case ``BW_rl`` over the continuous window [t0, t1)."""
        if not rows:
            return float("inf")
        s0, s1 = self.slot_of(t0), self.slot_of(max(t0, t1 - _EPS))
        idx = list(rows)
        capmin = float(self.capacity[idx].min())
        width = self.reserved.shape[1]
        lo = max(s0 - self.base_slot, 0)
        hi = min(s1 - self.base_slot + 1, width)
        if lo >= hi:
            return capmin  # window entirely outside the live matrix: free
        # Slots clamped away (retired past / beyond the horizon) are free
        # and would contribute exactly capmin — never less than the live
        # part's minimum (reserved ∈ [0, 1] ⇒ per-slot path min ≤ capmin),
        # so the live slice alone decides.
        resid = (1.0 - self.reserved[idx, lo:hi]) * self.capacity[idx, None]
        return float(resid.min(axis=0).min())

    # -- planning -----------------------------------------------------------
    def plan_transfer(
        self,
        size: float,
        rows: Sequence[int],
        not_before: float = 0.0,
        bandwidth_cap: Optional[float] = None,
        max_slots: int = 1 << 16,
    ) -> TransferPlan:
        """Greedy paper-policy transfer plan: start at the first slot with any
        residue at/after ``not_before`` and consume the path residue (up to
        ``bandwidth_cap``) slot-by-slot until ``size`` is delivered.

        ``size`` is in capacity-units·seconds (e.g. Mbit when capacity is
        Mbps).  Returns a plan; nothing is committed until :meth:`commit`.

        Dedicated single-path fast version of :meth:`plan_transfer_batch`
        (the scheduling hot loop plans one chosen path per remote task);
        the two must stay bit-identical — a property test enforces it.
        """
        if size <= 0 or not rows:
            return TransferPlan(tuple(rows), not_before, not_before, ())
        idx = list(rows)
        cap = float(self.capacity[idx].min())
        t0 = float(not_before)
        s0 = self.slot_of(t0)
        p0 = s0 - self.base_slot
        if p0 < 0:
            raise ValueError(
                f"plan_transfer: slot {s0} precedes retired origin "
                f"{self.base_slot} (not_before={t0})"
            )
        window = 64
        while window <= max_slots:
            self._ensure(s0 + window - 1)
            # Vectorized residue over [s0, s0+window): path residue per slot.
            resid_frac = 1.0 - self.reserved[idx, p0 : p0 + window].max(axis=0)
            bw = resid_frac * cap
            if bandwidth_cap is not None:
                bw = np.minimum(bw, bandwidth_cap)
            # Usable seconds per slot (first slot may be partial).
            secs = np.full(window, self.slot_duration)
            secs[0] = (s0 + 1) * self.slot_duration - t0
            deliverable = bw * secs
            cum = np.cumsum(deliverable)
            hit = int(np.searchsorted(cum, size - _EPS))
            if hit >= window:
                window *= 4
                continue
            active = bw > _EPS
            sel = np.nonzero(active[: hit + 1])[0]
            first = int(sel[0])
            start = max(t0, (s0 + first) * self.slot_duration)
            before = float(cum[hit - 1]) if hit > 0 else 0.0
            t_in = max(t0, (s0 + hit) * self.slot_duration)
            end = t_in + (size - before) / float(bw[hit])
            if bandwidth_cap is None:
                fr = resid_frac
            else:
                fr = bw / cap
            fracs = tuple((s0 + int(i), float(fr[i])) for i in sel)
            return TransferPlan(tuple(rows), start, end, fracs)
        raise RuntimeError("transfer does not fit within max_slots horizon")

    def _padded_rows(self, rows_list: Sequence[Sequence[int]]) -> np.ndarray:
        """Rectangular [n_candidates, max_path_len] row-index matrix; padding
        repeats the candidate's own first link so max/min reductions over the
        link axis are unaffected.  Callers must pass non-empty row lists."""
        width = max(len(r) for r in rows_list)
        pad = np.empty((len(rows_list), width), dtype=np.intp)
        for i, r in enumerate(rows_list):
            pad[i, : len(r)] = r
            pad[i, len(r) :] = r[0]
        return pad

    def booked_window(
        self, pad: np.ndarray, s0: np.ndarray, window: int
    ) -> np.ndarray:
        """``[n_cand, width, window]`` reserved-fraction gather: candidate
        ``k``'s padded link rows over slots ``[s0[k], s0[k] + window)``.
        ``s0`` may be a scalar (shared start) or per-candidate array.
        Slots are absolute; the gather shifts to physical columns."""
        s0 = np.asarray(s0)
        if int(s0.min()) < self.base_slot:
            raise ValueError(
                f"booked_window: slot {int(s0.min())} precedes retired "
                f"origin {self.base_slot}"
            )
        self._ensure(int(s0.max()) + window - 1)
        off = s0 - self.base_slot
        idx = off.reshape(-1, 1, 1) if off.ndim else off
        return self.reserved[pad[:, :, None], idx + np.arange(window)[None, None, :]]

    def _plan_from_scan(
        self,
        rows: Tuple[int, ...],
        s0: int,
        t0: float,
        size: float,
        bw_row: np.ndarray,
        resid_row: np.ndarray,
        cum_row: np.ndarray,
        hit: int,
        cap: Optional[float] = None,
    ) -> TransferPlan:
        """Materialize one greedy plan from a ``ts_plan.plan_scan`` row —
        the exact tail arithmetic of :meth:`plan_transfer` (bit-identical).
        ``cap`` is the candidate's bottleneck capacity, passed only when a
        ``bandwidth_cap`` squeezed ``bw`` below the residue."""
        active = bw_row > _EPS
        sel = np.nonzero(active[: hit + 1])[0]
        first = int(sel[0])
        start = max(t0, (s0 + first) * self.slot_duration)
        before = float(cum_row[hit - 1]) if hit > 0 else 0.0
        t_in = max(t0, (s0 + hit) * self.slot_duration)
        end = t_in + (size - before) / float(bw_row[hit])
        fr = resid_row if cap is None else bw_row / cap
        fracs = tuple((s0 + int(j), float(fr[j])) for j in sel)
        return TransferPlan(rows, start, end, fracs)

    def plan_transfer_batch(
        self,
        size: float,
        rows_list: Sequence[Sequence[int]],
        not_before: float = 0.0,
        bandwidth_cap: Optional[float] = None,
        max_slots: int = 1 << 16,
    ) -> List[TransferPlan]:
        """Greedy paper-policy plans for *all* candidate paths in one
        :func:`repro.kernels.ts_plan.plan_scan` pass — the controller
        scores every (source, destination) option without a Python loop
        per replica.

        Element ``i`` is bit-identical to planning ``rows_list[i]`` alone
        against the current ledger state; nothing is committed.  Window
        escalation freezes finished candidates: a plan found at window
        ``W`` is final (the scan is prefix-stable), so only the candidates
        whose transfer did not fit re-scan at ``4W`` — one oversized
        outlier no longer forces the whole batch to re-scan.  A candidate
        that cannot fit within ``max_slots`` raises, matching a
        ``plan_transfer`` loop over the same list.
        """
        n = len(rows_list)
        if n == 0:
            return []
        plans: List[Optional[TransferPlan]] = [None] * n
        live: List[int] = []
        for i, rows in enumerate(rows_list):
            if size <= 0 or not rows:
                plans[i] = TransferPlan(tuple(rows), not_before, not_before, ())
            else:
                live.append(i)
        if not live:
            return plans  # type: ignore[return-value]
        pad = self._padded_rows([rows_list[i] for i in live])
        caps = self.capacity[pad].min(axis=1)
        t0 = float(not_before)
        s0 = self.slot_of(t0)
        window = 64
        unresolved = np.arange(len(live))
        while window <= max_slots:
            sub = unresolved
            booked = self.booked_window(pad[sub], np.asarray(s0), window)
            # Usable seconds per slot (first slot may be partial).
            secs = np.full((len(sub), window), self.slot_duration)
            secs[:, 0] = (s0 + 1) * self.slot_duration - t0
            sizes = np.full(len(sub), size)
            self.batch_scan_cells += len(sub) * window
            resid, bw, cum, hits = ts_plan.plan_scan(
                booked, caps[sub], secs, sizes, bandwidth_cap
            )
            done = hits < window
            for k in np.nonzero(done)[0]:
                i = live[sub[k]]
                plans[i] = self._plan_from_scan(
                    tuple(rows_list[i]), s0, t0, size,
                    bw[k], resid[k], cum[k], int(hits[k]),
                    None if bandwidth_cap is None else float(caps[sub[k]]),
                )
            unresolved = sub[~done]
            if unresolved.size == 0:
                return plans  # type: ignore[return-value]
            window *= 4
        raise RuntimeError("transfer does not fit within max_slots horizon")

    def commit(self, plan: TransferPlan) -> None:
        """Reserve the plan's slot fractions on every path link — one
        ``(rows × slots)`` scatter instead of a per-slot Python loop, with
        a single joint over-reservation check (slots within a plan are
        distinct, so the scatter equals the sequential loop exactly)."""
        if not plan.slot_fracs:
            return
        base = self.base_slot
        if len(plan.slot_fracs) == 1 and len(plan.links) <= 8:
            # Frontier-landing common case: scalar python floats (same
            # doubles as the vector scatter, no ufunc dispatch).
            slot, frac = plan.slot_fracs[0]
            p = slot - base
            if p < 0:
                raise ValueError(
                    f"commit: slot {slot} precedes retired origin {base}"
                )
            if p >= self.reserved.shape[1]:
                self._ensure(slot)
            res = self.reserved
            vals = [res.item(r, p) + frac for r in plan.links]
            mx = max(vals)
            if mx > 1.0 + 1e-6:
                raise ValueError(
                    f"over-reservation on slot {slot}: {mx:.6f} > 1"
                )
            for r, v in zip(plan.links, vals):
                res[r, p] = v if v < 1.0 else 1.0
            if self._mirror is not None:
                self._mirror.note_flat(
                    np.asarray(plan.links),
                    np.full(len(plan.links), slot, dtype=np.int64),
                    np.minimum(vals, 1.0),
                )
            return
        slots = [s for s, _ in plan.slot_fracs]
        fracs = np.array([f for _, f in plan.slot_fracs])
        if min(slots) < base:
            raise ValueError(
                f"commit: slot {min(slots)} precedes retired origin {base}"
            )
        self._ensure(max(slots))
        rr = np.asarray(plan.links)[:, None]  # open mesh: (rows × slots)
        cc = np.asarray(slots) - base
        new = self.reserved[rr, cc] + fracs[None, :]
        over = new > 1.0 + 1e-6
        if over.any():
            col = int(over.any(axis=0).argmax())
            raise ValueError(
                f"over-reservation on slot {slots[col]}: "
                f"{new[:, col].max():.6f} > 1"
            )
        clamped = np.minimum(new, 1.0)
        self.reserved[rr, cc] = clamped
        if self._mirror is not None:
            self._mirror.note_grid(np.asarray(plan.links), np.asarray(slots), clamped)

    def commit_batch(self, plans: Sequence[TransferPlan]) -> None:
        """Commit many plans whose (link, slot) cells are pairwise disjoint
        in one concatenated scatter (the reroute engine's grouped commit).

        Disjointness is the caller's contract — the engine's conflict walk
        only groups winners whose reads (a superset of their writes) were
        untouched by every earlier winner in the group — so a plain fancy-
        index add equals committing the plans one by one, in any order.
        A single joint over-reservation check mirrors :meth:`commit`.
        """
        rr_parts: List[np.ndarray] = []
        cc_parts: List[np.ndarray] = []
        vv_parts: List[np.ndarray] = []
        for plan in plans:
            n_slots = len(plan.slot_fracs)
            if not n_slots:
                continue
            links = np.asarray(plan.links)
            slots = np.fromiter(
                (s for s, _ in plan.slot_fracs), dtype=np.int64, count=n_slots
            )
            fracs = np.fromiter(
                (f for _, f in plan.slot_fracs), dtype=np.float64,
                count=n_slots,
            )
            rr_parts.append(np.repeat(links, n_slots))
            cc_parts.append(np.tile(slots, links.size))
            vv_parts.append(np.tile(fracs, links.size))
        if not rr_parts:
            return
        rr = np.concatenate(rr_parts)
        cc = np.concatenate(cc_parts)
        if int(cc.min()) < self.base_slot:
            raise ValueError(
                f"commit_batch: slot {int(cc.min())} precedes retired "
                f"origin {self.base_slot}"
            )
        self._ensure(int(cc.max()))
        ccp = cc - self.base_slot
        # The disjointness contract is load-bearing (fancy-index assignment
        # is last-write-wins): a violation must fail loudly, not silently
        # drop a reservation.
        cells = rr * self.reserved.shape[1] + ccp
        if np.unique(cells).size != cells.size:
            raise ValueError("commit_batch: plans share a (link, slot) cell")
        new = self.reserved[rr, ccp] + np.concatenate(vv_parts)
        over = new > 1.0 + 1e-6
        if over.any():
            k = int(over.argmax())
            raise ValueError(
                f"over-reservation on slot {cc[k]}: {new[k]:.6f} > 1"
            )
        clamped = np.minimum(new, 1.0)
        self.reserved[rr, ccp] = clamped
        if self._mirror is not None:
            self._mirror.note_flat(rr, cc, clamped)

    def occupy(
        self, rows: Sequence[int], start: float, end: float, fraction: float
    ) -> None:
        """Book ``fraction`` of every row over the continuous window
        [start, end) — background cross-traffic the controller observes but
        did not plan (saturates at 1.0 instead of raising).  The portion
        falling before the retired origin is delivered history and is
        skipped (a scratch ledger replays old background flows whose
        start predates the live window)."""
        s0 = self.slot_of(start)
        s1 = self.slot_of(max(start, end - _EPS))
        if s1 < self.base_slot:
            return
        s0 = max(s0, self.base_slot)
        self._ensure(s1)
        p0, p1 = s0 - self.base_slot, s1 - self.base_slot
        idx = list(rows)
        block = np.minimum(self.reserved[idx, p0 : p1 + 1] + fraction, 1.0)
        self.reserved[idx, p0 : p1 + 1] = block
        if self._mirror is not None:
            self._mirror.note_grid(
                np.asarray(idx), np.arange(s0, s1 + 1, dtype=np.int64), block
            )

    def release(self, plan: TransferPlan) -> None:
        """Exact inverse of :meth:`commit` — one ``(rows × slots)`` scatter.
        Slots already retired hold delivered history with no live column;
        they are skipped (there is nothing left to free)."""
        if not plan.slot_fracs:
            return
        base = self.base_slot
        live = [(s, f) for s, f in plan.slot_fracs if s >= base]
        if not live:
            return
        fracs = np.array([f for _, f in live])
        rr = np.asarray(plan.links)[:, None]
        slots = np.array([s for s, _ in live], dtype=np.int64)
        cc = slots - base
        freed = np.maximum(self.reserved[rr, cc] - fracs[None, :], 0.0)
        self.reserved[rr, cc] = freed
        if self._mirror is not None:
            self._mirror.note_grid(np.asarray(plan.links), slots, freed)

    def plan_bytes(self, plan: TransferPlan, until: Optional[float] = None) -> float:
        """Capacity-units·seconds the plan delivers by ``until`` (default:
        the whole plan — i.e. the transfer's total size as booked)."""
        if not plan.slot_fracs:
            return 0.0
        cap = float(self.capacity[list(plan.links)].min())
        t1 = plan.end if until is None else min(float(until), plan.end)
        slots = np.array([s for s, _ in plan.slot_fracs])
        fracs = np.array([f for _, f in plan.slot_fracs])
        lo = np.maximum(plan.start, slots * self.slot_duration)
        hi = np.minimum(t1, (slots + 1) * self.slot_duration)
        return float((fracs * cap * np.clip(hi - lo, 0.0, None)).sum())

    def release_after(self, plan: TransferPlan, t: float) -> TransferPlan:
        """Release the unconsumed tail of a committed plan (reroute support).

        Every slot at/after ``t``'s slot is released; slots that completed
        strictly before it stay committed.  The boundary slot — the one
        ``t`` falls inside — is released *whole*: its bytes are forfeited
        and must be retransmitted (see DESIGN.md §4; since controller
        replans always use ``not_before >= t``, the freed past fraction
        can never be double-booked).  Returns the kept (truncated) plan,
        whose :meth:`plan_bytes` is exactly the delivered size.
        """
        if not plan.slot_fracs or t >= plan.end:
            return plan
        if t <= plan.start:
            cut = plan.slot_fracs[0][0]
        else:
            cut = self.slot_of(t)
        keep = tuple((s, f) for s, f in plan.slot_fracs if s < cut)
        idx = list(plan.links)
        # The physical scatter skips tail slots already retired (possible
        # only when a caller cuts behind the live origin; the controller
        # always cuts at the failure instant, ahead of it).
        wipe = max(cut, self.base_slot)
        tail_slots = [s for s, _ in plan.slot_fracs if s >= wipe]
        if tail_slots:
            tail_fracs = np.array([f for s, f in plan.slot_fracs if s >= wipe])
            rr = np.asarray(idx)[:, None]
            cc = np.asarray(tail_slots) - self.base_slot
            freed = np.maximum(self.reserved[rr, cc] - tail_fracs[None, :], 0.0)
            self.reserved[rr, cc] = freed
            if self._mirror is not None:
                self._mirror.note_grid(
                    np.asarray(idx), np.asarray(tail_slots, dtype=np.int64), freed
                )
        if not keep:
            return TransferPlan(plan.links, plan.start, plan.start, ())
        new_end = min(plan.end, cut * self.slot_duration)
        return TransferPlan(plan.links, plan.start, new_end, keep)

    # -- convenience --------------------------------------------------------
    def transfer_time(
        self, size: float, rows: Sequence[int], not_before: float = 0.0
    ) -> float:
        """Duration the greedy plan would take (no commit) — Eq. (1) with the
        real-time ledger standing in for ``BW_{dataSrc,j}``."""
        plan = self.plan_transfer(size, rows, not_before)
        return plan.end - plan.start if plan.slot_fracs else 0.0

    def earliest_window(
        self,
        rows: Sequence[int],
        size: float,
        not_before: float,
        deadline: float,
    ) -> Optional[TransferPlan]:
        """Earliest greedy plan finishing by ``deadline`` (Pre-BASS prefetch)."""
        plan = self.plan_transfer(size, rows, not_before)
        if plan.end <= deadline + _EPS:
            return plan
        return None

    def utilization(self) -> float:
        """Mean reserved fraction over the *live booked window* — physical
        columns up to the last slot holding any reservation.

        The historical definition divided by the entire allocated matrix,
        so every ``_ensure`` doubling (and, for a long-running controller,
        sheer elapsed time) diluted the value toward 0 regardless of load.
        Measuring against the booked window makes it allocation-invariant
        (regression-pinned across a doubling in
        ``tests/test_compaction.py``)."""
        res = self.reserved
        booked = np.flatnonzero(res.any(axis=0))
        if booked.size == 0:
            return 0.0
        n = int(booked[-1]) + 1
        return float(res[:, :n].sum() / (res.shape[0] * n))


# ---------------------------------------------------------------------------
# ShardedLedger — per-pod shards behind the flat ledger's surface
# ---------------------------------------------------------------------------


class ShardedLedger:
    """Pod-partitioned reservation calendar: one :class:`TimeSlotLedger`
    shard per link group (each pod's internal links + one boundary shard
    for the core/aggregation slice), behind the flat ledger's query/plan/
    commit surface with the flat ledger's *global* row numbering.

    Byte-parity contract (DESIGN.md §12): every public method returns the
    exact floats the flat ledger would — the reservation matrix is
    conceptually infinite with zeros outside each live window, so a
    per-shard gather with per-shard origins reads the same cell values a
    single matrix would, and max/min reductions over a row partition equal
    the unpartitioned reduction (IEEE max/min are order-invariant).  Plans
    carry global rows throughout, so ``TransferPlan`` equality against a
    flat-ledger plan is structural.

    Each shard keeps its own §7 rolling origin; :meth:`maybe_retire` fans
    the clock out, and identical strides keep the origins in lockstep.
    :meth:`commit` distributes a plan's cells shard-by-shard — the
    over-reservation check runs per shard, so a rejected commit may leave
    earlier shards booked (callers never over-reserve planned transfers;
    the flat ledger's joint check is atomic, this one is loud-but-partial).
    """

    def __init__(
        self,
        fabric: Fabric,
        groups: Dict[str, Sequence[str]],
        slot_duration: float = 1.0,
        horizon_slots: int = 256,
    ) -> None:
        self.fabric = fabric
        self.slot_duration = float(slot_duration)
        names = sorted(fabric.links)
        self._row: Dict[str, int] = {n: i for i, n in enumerate(names)}
        self._names = names
        self.capacity = np.array(
            [fabric.link(n).capacity for n in names], dtype=np.float64
        )
        owner: Dict[str, str] = {}
        for g, lns in groups.items():
            for n in lns:
                if n in owner:
                    raise ValueError(
                        f"link {n!r} in shards {owner[n]!r} and {g!r}"
                    )
                owner[n] = g
        missing = set(names) - set(owner)
        if missing:
            raise ValueError(f"links not covered by any shard: {sorted(missing)[:4]}")
        self.shard_names = tuple(sorted(groups))
        self.shards: Dict[str, TimeSlotLedger] = {
            g: TimeSlotLedger.for_links(
                fabric, groups[g], slot_duration, horizon_slots
            )
            for g in self.shard_names
        }
        self._shard_list = [self.shards[g] for g in self.shard_names]
        # Global row → (owning shard index, shard-local row).
        self._shard_idx = np.empty(len(names), dtype=np.intp)
        self._local_row = np.empty(len(names), dtype=np.intp)
        for gi, g in enumerate(self.shard_names):
            sh = self.shards[g]
            for n in sh._names:
                r = self._row[n]
                self._shard_idx[r] = gi
                self._local_row[r] = sh._row[n]
        self._path_rows: Dict[Tuple[str, str], Tuple[int, ...]] = {}
        self._path_rows_version = fabric.version

    # -- plumbing (flat-surface mirrors) ------------------------------------
    def rows(self, link_names: Sequence[str]) -> Tuple[int, ...]:
        return tuple(self._row[n] for n in link_names)

    def link_names(self, rows: Sequence[int]) -> Tuple[str, ...]:
        return tuple(self._names[r] for r in rows)

    def path_rows(self, src: str, dst: str) -> Tuple[int, ...]:
        if self.fabric.version != self._path_rows_version:
            self._path_rows.clear()
            self._path_rows_version = self.fabric.version
        hit = self._path_rows.get((src, dst))
        if hit is None:
            hit = self.rows(self.fabric.path(src, dst))
            if len(self._path_rows) > (1 << 18):
                self._path_rows.clear()
            self._path_rows[(src, dst)] = hit
        return hit

    def slot_of(self, t: float) -> int:
        return int(math.floor(t / self.slot_duration + _EPS))

    @property
    def base_slot(self) -> int:
        """Rolling origin (identical across shards under lockstep strides;
        reported as the minimum so a mixed state stays conservative)."""
        return min(sh.base_slot for sh in self._shard_list)

    @property
    def retired_slots(self) -> int:
        return min(sh.retired_slots for sh in self._shard_list)

    @property
    def reserved(self) -> np.ndarray:
        """Materialized global ``[n_links, width]`` reservation window in
        flat row order (column 0 at the facade's :attr:`base_slot`),
        gathered from each shard's live window at its origin offset —
        cells outside a shard's window are zero, exactly the flat
        ledger's conceptually-infinite matrix.  Read-only and built per
        call: it exists for external auditors (the replay oracle's
        over-booking sweep, tests); planning paths never touch it."""
        origin = self.base_slot
        width = max(
            sh.base_slot - origin + sh.reserved.shape[1]
            for sh in self._shard_list
        )
        out = np.zeros((len(self._names), width), dtype=np.float64)
        for sh in self._shard_list:
            win = sh.reserved
            off = sh.base_slot - origin
            grows = np.fromiter(
                (self._row[n] for n in sh._names), dtype=np.intp,
                count=len(sh._names),
            )
            lrows = np.fromiter(
                (sh._row[n] for n in sh._names), dtype=np.intp,
                count=len(sh._names),
            )
            out[grows, off:off + win.shape[1]] = win[lrows]
        return out

    @property
    def retire_stride(self) -> Optional[int]:
        return self._shard_list[0].retire_stride

    @retire_stride.setter
    def retire_stride(self, stride: Optional[int]) -> None:
        for sh in self._shard_list:
            sh.retire_stride = stride

    @property
    def batch_scan_cells(self) -> int:
        return sum(sh.batch_scan_cells for sh in self._shard_list)

    @batch_scan_cells.setter
    def batch_scan_cells(self, value: int) -> None:
        for sh in self._shard_list:
            sh.batch_scan_cells = 0
        self._shard_list[0].batch_scan_cells = value

    def _split(
        self, rows: Sequence[int]
    ) -> List[Tuple[TimeSlotLedger, List[int]]]:
        """Group global rows by owning shard (insertion-ordered, so the
        grouping is deterministic in the path's link order)."""
        per: Dict[int, List[int]] = {}
        sidx, lrow = self._shard_idx, self._local_row
        for r in rows:
            per.setdefault(int(sidx[r]), []).append(int(lrow[r]))
        return [(self._shard_list[si], lr) for si, lr in per.items()]

    # -- serialization (crash recovery) -------------------------------------
    def dump_state(self) -> dict:
        return {
            "shards": {g: self.shards[g].dump_state() for g in self.shard_names}
        }

    def load_state(self, state: dict) -> None:
        for g, st in state["shards"].items():
            self.shards[g].load_state(st)

    # -- rolling-horizon compaction -----------------------------------------
    def retire(self, t: float) -> int:
        return sum(sh.retire(t) for sh in self._shard_list)

    def retire_to(self, cut: int) -> int:
        return sum(sh.retire_to(cut) for sh in self._shard_list)

    def maybe_retire(self, t: float) -> int:
        return sum(sh.maybe_retire(t) for sh in self._shard_list)

    # -- queries ------------------------------------------------------------
    def residual_fraction(self, rows: Sequence[int], slot: int) -> float:
        if not rows:
            return 1.0
        best = 1.0
        for sh, lr in self._split(rows):
            p = slot - sh.base_slot
            if p < 0 or p >= sh.reserved.shape[1]:
                continue  # free slice: contributes exactly 1.0
            v = float(1.0 - sh.reserved[lr, p].max())
            if v < best:
                best = v
        return best

    def path_bandwidth(self, rows: Sequence[int], t: float) -> float:
        if not rows:
            return float("inf")
        s = self.slot_of(t)
        best = float("inf")
        for sh, lr in self._split(rows):
            caps = sh.capacity[lr]
            p = s - sh.base_slot
            if p < 0 or p >= sh.reserved.shape[1]:
                m = float(caps.min())
            else:
                m = float(((1.0 - sh.reserved[lr, p]) * caps).min())
            if m < best:
                best = m
        return best

    def path_bandwidth_batch(
        self, rows_list: Sequence[Sequence[int]], t: float
    ) -> np.ndarray:
        return np.array(
            [self.path_bandwidth(r, t) for r in rows_list], dtype=np.float64
        )

    def min_path_bandwidth(
        self, rows: Sequence[int], t0: float, t1: float
    ) -> float:
        if not rows:
            return float("inf")
        s0, s1 = self.slot_of(t0), self.slot_of(max(t0, t1 - _EPS))
        n = s1 - s0 + 1
        vals: Optional[np.ndarray] = None
        for sh, lr in self._split(rows):
            caps = sh.capacity[lr]
            block = np.zeros((len(lr), n))
            lo = max(s0 - sh.base_slot, 0)
            hi = min(s1 - sh.base_slot + 1, sh.reserved.shape[1])
            if lo < hi:
                a0 = sh.base_slot + lo - s0
                block[:, a0 : a0 + (hi - lo)] = sh.reserved[lr, lo:hi]
            v = ((1.0 - block) * caps[:, None]).min(axis=0)
            vals = v if vals is None else np.minimum(vals, v)
        assert vals is not None
        return float(vals.min())

    # -- planning -----------------------------------------------------------
    def plan_transfer(
        self,
        size: float,
        rows: Sequence[int],
        not_before: float = 0.0,
        bandwidth_cap: Optional[float] = None,
        max_slots: int = 1 << 16,
    ) -> TransferPlan:
        """The flat greedy plan over a cross-shard path: per-shard window
        slices are stacked and max-reduced (order-invariant, so the path
        residue per slot is bit-identical to the flat matrix gather), then
        the tail arithmetic is :meth:`TimeSlotLedger.plan_transfer`'s own,
        verbatim."""
        if size <= 0 or not rows:
            return TransferPlan(tuple(rows), not_before, not_before, ())
        idx = list(rows)
        cap = float(self.capacity[idx].min())
        t0 = float(not_before)
        s0 = self.slot_of(t0)
        split = self._split(idx)
        for sh, _ in split:
            if s0 < sh.base_slot:
                raise ValueError(
                    f"plan_transfer: slot {s0} precedes retired origin "
                    f"{sh.base_slot} (not_before={t0})"
                )
        window = 64
        while window <= max_slots:
            booked: Optional[np.ndarray] = None
            for sh, lr in split:
                sh._ensure(s0 + window - 1)
                p0 = s0 - sh.base_slot
                m = sh.reserved[lr, p0 : p0 + window].max(axis=0)
                booked = m if booked is None else np.maximum(booked, m)
            resid_frac = 1.0 - booked
            bw = resid_frac * cap
            if bandwidth_cap is not None:
                bw = np.minimum(bw, bandwidth_cap)
            secs = np.full(window, self.slot_duration)
            secs[0] = (s0 + 1) * self.slot_duration - t0
            deliverable = bw * secs
            cum = np.cumsum(deliverable)
            hit = int(np.searchsorted(cum, size - _EPS))
            if hit >= window:
                window *= 4
                continue
            active = bw > _EPS
            sel = np.nonzero(active[: hit + 1])[0]
            first = int(sel[0])
            start = max(t0, (s0 + first) * self.slot_duration)
            before = float(cum[hit - 1]) if hit > 0 else 0.0
            t_in = max(t0, (s0 + hit) * self.slot_duration)
            end = t_in + (size - before) / float(bw[hit])
            if bandwidth_cap is None:
                fr = resid_frac
            else:
                fr = bw / cap
            fracs = tuple((s0 + int(i), float(fr[i])) for i in sel)
            return TransferPlan(tuple(rows), start, end, fracs)
        raise RuntimeError("transfer does not fit within max_slots horizon")

    def plan_transfer_batch(
        self,
        size: float,
        rows_list: Sequence[Sequence[int]],
        not_before: float = 0.0,
        bandwidth_cap: Optional[float] = None,
        max_slots: int = 1 << 16,
    ) -> List[TransferPlan]:
        """Per-candidate :meth:`plan_transfer` loop.  The flat batch path
        documents element-wise bit-identity with ``plan_transfer``, so a
        loop over the facade matches it exactly; the fused scan stays a
        flat-matrix (and per-shard wavefront) optimization."""
        return [
            self.plan_transfer(size, rows, not_before, bandwidth_cap, max_slots)
            for rows in rows_list
        ]

    # -- mutations ----------------------------------------------------------
    def commit(self, plan: TransferPlan) -> None:
        if not plan.slot_fracs:
            return
        for sh, lr in self._split(plan.links):
            sh.commit(
                TransferPlan(tuple(lr), plan.start, plan.end, plan.slot_fracs)
            )

    def commit_batch(self, plans: Sequence[TransferPlan]) -> None:
        for plan in plans:
            self.commit(plan)

    def occupy(
        self, rows: Sequence[int], start: float, end: float, fraction: float
    ) -> None:
        for sh, lr in self._split(rows):
            sh.occupy(lr, start, end, fraction)

    def release(self, plan: TransferPlan) -> None:
        if not plan.slot_fracs:
            return
        for sh, lr in self._split(plan.links):
            sh.release(
                TransferPlan(tuple(lr), plan.start, plan.end, plan.slot_fracs)
            )

    def release_after(self, plan: TransferPlan, t: float) -> TransferPlan:
        if not plan.slot_fracs or t >= plan.end:
            return plan
        if t <= plan.start:
            cut = plan.slot_fracs[0][0]
        else:
            cut = self.slot_of(t)
        keep = tuple((s, f) for s, f in plan.slot_fracs if s < cut)
        tail = tuple((s, f) for s, f in plan.slot_fracs if s >= cut)
        if tail:
            # Per-shard tail wipe: ``release`` skips already-retired slots,
            # exactly the flat ``wipe = max(cut, base_slot)`` clamp.
            for sh, lr in self._split(plan.links):
                sh.release(TransferPlan(tuple(lr), plan.start, plan.start, tail))
        if not keep:
            return TransferPlan(plan.links, plan.start, plan.start, ())
        new_end = min(plan.end, cut * self.slot_duration)
        return TransferPlan(plan.links, plan.start, new_end, keep)

    def plan_bytes(self, plan: TransferPlan, until: Optional[float] = None) -> float:
        if not plan.slot_fracs:
            return 0.0
        cap = float(self.capacity[list(plan.links)].min())
        t1 = plan.end if until is None else min(float(until), plan.end)
        slots = np.array([s for s, _ in plan.slot_fracs])
        fracs = np.array([f for _, f in plan.slot_fracs])
        lo = np.maximum(plan.start, slots * self.slot_duration)
        hi = np.minimum(t1, (slots + 1) * self.slot_duration)
        return float((fracs * cap * np.clip(hi - lo, 0.0, None)).sum())

    # -- convenience --------------------------------------------------------
    def transfer_time(
        self, size: float, rows: Sequence[int], not_before: float = 0.0
    ) -> float:
        plan = self.plan_transfer(size, rows, not_before)
        return plan.end - plan.start if plan.slot_fracs else 0.0

    def utilization(self) -> float:
        """Mean reserved fraction over the union of the shards' live booked
        windows (same allocation-invariance argument as the flat ledger)."""
        tot = 0.0
        cells = 0
        for sh in self._shard_list:
            res = sh.reserved
            booked = np.flatnonzero(res.any(axis=0))
            if booked.size == 0:
                continue
            n = int(booked[-1]) + 1
            tot += float(res[:, :n].sum())
            cells += res.shape[0] * n
        return tot / cells if cells else 0.0
