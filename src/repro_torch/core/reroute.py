"""Batched failure-reroute engine — the failure-storm fast path.

``ClusterController._reroute_dead`` historically replanned dead in-flight
transfers one at a time: per victim, a ``choose_source_path`` candidate
enumeration plus a ``plan_transfer_batch`` whose windows escalate from the
failure instant through the whole ledger backlog, then an
O(nodes × assignments) ``_retime_nodes`` sweep.  A spine kill with
thousands of in-flight transfers made the controller the outage.  This
module replans the same storm in a handful of fused array passes while
staying **byte-identical** to the sequential loop — same
``reroute_log``, same winner plans, same retimed schedules
(property-tested in ``tests/test_reroute_props.py``; the sequential loop
survives below as :func:`sequential_reroute`, the oracle and the recorded
benchmark baseline).

**Why batching is legal.**  The sequential loop interleaves per victim:
release the dead plan's unconsumed tail, replan the remaining bytes,
commit the winner.  Victim *i*'s plan therefore sees the tails of victims
*j > i* still booked.  The greedy policy books the *path* residue on
every link, so when a plan's links were evenly booked (the fleet norm:
plans land on untouched frontier slots) every cell of the committed plan
is **exactly 1.0** reserved — which means (a) the tails of distinct
victims can never share a (link, slot) cell (a full cell is never
selected by a later plan), and (b) the value victim *i* sequentially
reads at any not-yet-released tail cell is exactly ``1.0``.  The engine
exploits this: it releases *every* tail up front, stamps each released
cell with its victim's index in an ``owner`` matrix, and reconstructs
victim *i*'s exact sequential view as ``max(reserved, 1.0·[owner > i])``
— the *phantom overlay*.  Neither fact is assumed: both are verified at
run time (every tail cell must gather as exactly full before any
release, owner stamps must never collide), and a violation — e.g. plans
placed over background cross-traffic, whose non-bottleneck links keep
residue — aborts to :func:`sequential_reroute` (counted in
``controller.reroute_stats["fallbacks"]``) before any byte can diverge.

**The passes.**

1. *Victim sweep* — one pass over the in-flight index in the sequential
   loop's exact order, marking plans that cross the dead-row set.
2. *Release + stamp* — per victim: ``plan_bytes`` / ``release_after`` /
   remaining-bytes arithmetic (unchanged expressions), tail cells stamped
   into ``owner``.
3. *Candidate grid* — every victim's surviving (replica, path) pairs in
   one :meth:`repro.net.paths.PathEngine.route_batch` pass (dead-set
   incidence filter + cached dead-set Yen detours).
4. *Fused compressed-column score* — the cumulative-deliverable sum only
   grows at slots where no path link is effectively full, so the scan
   enumerates exactly those *joint* slots (chunked AND over a dense
   availability mask, owner post-filter for the victim's phantom view)
   and gathers only their columns into one
   :func:`repro.kernels.ts_plan.plan_scan` pass per escalation round —
   O(plan length) per candidate where the sequential escalation pays
   O(frontier distance), with identical floats (``x + 0.0 == x``).
5. *Commit walk* — victims replay in order, pre-scanned in adaptive
   waves.  A victim consumes its precomputed curves iff no earlier
   commit touched any cell its scan read (per-link dirty-slot map, as in
   the wavefront engine); clean winners flush as one grouped scatter
   (:meth:`~repro.core.timeslot.TimeSlotLedger.commit_batch`), dirty
   victims re-score through the same fused scan against the live ledger,
   and a collapsed hit rate turns waves off entirely.  Flow-table
   reinstall, ``RerouteRecord`` logging and ``_live_jobs`` bookkeeping
   are the sequential loop's, line for line.
6. *Grouped retime* — ``_retime_nodes`` over all touched nodes with one
   grouping pass over the assignment set instead of a scan per node.

See DESIGN.md §6 for the algorithm and the complexity table.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..kernels import ts_plan
from .timeslot import TransferPlan
from .topology import UnroutableError

_EPS = 1e-9
_NEVER = np.iinfo(np.int64).max
_MAX_SLOTS = 1 << 16  # plan_transfer's reach, measured from slot_of(nb)
_EMPTY_COLS = np.empty(0, dtype=np.int64)


class _Victim:
    __slots__ = (
        "jid", "rec", "a", "task", "old_plan", "old_names",
        "total", "delivered", "remaining", "nb", "s0", "cands",
        "colstate", "cols", "bw", "resid", "cum", "hit", "end", "winner",
    )

    def __init__(self) -> None:
        self.colstate = None


class RerouteEngine:
    """One failure event's batched replan.  Build per event; :meth:`run`
    is the only entry point."""

    def __init__(self, ctrl) -> None:
        self.ctrl = ctrl
        self.state = ctrl.state
        self.ledger = ctrl.state.ledger
        self.hits = self.misses = 0

    # -- entry --------------------------------------------------------------
    def run(self, at: float) -> None:
        ctrl = self.ctrl
        ledger = self.ledger
        dead_names = ctrl.dataplane.all_dead_links()
        dead_rows = frozenset(ledger.rows((n,))[0] for n in dead_names)
        victims = self._sweep(at, dead_rows)
        if victims:
            if not self._release_and_stamp(victims, at):
                # Invariant guard tripped (a tail cell was not exactly
                # full — e.g. plans placed over background traffic book
                # unevenly): the ledger is untouched (or restored) and the
                # sequential oracle handles the whole event.  Counted, so
                # an operator can see the fast path disengage.
                ctrl.reroute_stats["fallbacks"] += 1
                sequential_reroute(ctrl, at)
                return
            self._candidate_grid(victims)
            self._walk(victims, at, dead_names)
        st = ctrl.reroute_stats
        st["events"] += 1
        st["victims"] += len(victims)
        st["hits"] += self.hits
        st["misses"] += self.misses
        self._suspend_raw_flows(at, dead_rows)
        if self._touched:
            ctrl._retime_nodes(self._touched, self._rerouted_tids)

    # -- pass 1: victim sweep ----------------------------------------------
    def _sweep(self, at: float, dead_rows) -> List[_Victim]:
        ctrl = self.ctrl
        self._touched: set = set()
        self._rerouted_tids: set = set()
        victims: List[_Victim] = []
        for jid, latest_end in list(ctrl._live_jobs.items()):
            rec = ctrl.jobs.get(jid)
            if rec is None or latest_end <= at + _EPS:
                del ctrl._live_jobs[jid]
                continue
            tasks = None
            for a in rec.assignments:
                plan = a.transfer
                if plan is None or not plan.slot_fracs:
                    continue
                if plan.end <= at + _EPS:
                    continue
                if not any(r in dead_rows for r in plan.links):
                    continue
                if tasks is None:
                    tasks = {tk.tid: tk for tk in rec.tasks}
                v = _Victim()
                v.jid, v.rec, v.a, v.task = jid, rec, a, tasks[a.tid]
                v.old_plan = plan
                victims.append(v)
        return victims

    # -- pass 2: release + phantom stamp -------------------------------------
    def _release_and_stamp(self, victims: List[_Victim], at: float) -> bool:
        """Release every victim's unconsumed tail and stamp the released
        cells with the victim index.  Returns False (before any mutation)
        when the exactly-full invariant does not hold."""
        ledger = self.ledger
        res = ledger.reserved
        # Absolute→physical offset for every matrix access this event;
        # retire() only runs on the controller clock, never mid-event, so
        # the origin is frozen here.  Tail slots sit at/after the failure
        # instant's slot, which the retire guard keeps live.
        base = self._base = ledger.base_slot
        tails: List[Tuple[np.ndarray, np.ndarray]] = []
        for v in victims:
            plan = v.old_plan
            cut = (
                plan.slot_fracs[0][0] if at <= plan.start
                else ledger.slot_of(at)
            )
            tail_slots = np.array(
                [s for s, _ in plan.slot_fracs if s >= cut], dtype=np.int64
            )
            tails.append((np.asarray(plan.links), tail_slots))
        # Invariant: every tail cell is exactly full (greedy plans book the
        # full residue) — checked before any release so a violation can
        # abort cleanly to the sequential oracle.
        for rows, slots in tails:
            if slots.size and not (
                res[rows[:, None], (slots - base)[None, :]] == 1.0
            ).all():
                return False
        self._owner = np.full(res.shape, -1, dtype=np.int32)
        owner = self._owner
        for i, v in enumerate(victims):
            plan = v.old_plan
            v.total = ledger.plan_bytes(plan)
            kept = ledger.release_after(plan, at)
            v.delivered = ledger.plan_bytes(kept)
            v.remaining = max(v.total - v.delivered, 0.0)
            v.nb = max(at, plan.start)
            v.s0 = ledger.slot_of(v.nb)
            v.old_names = ledger.link_names(plan.links)
            rows, slots = tails[i]
            if slots.size:
                cells = owner[rows[:, None], (slots - base)[None, :]]
                if (cells != -1).any():
                    # Tails collided — restore every tail released so far
                    # to its exact pre-release value (1.0, verified above)
                    # and let the sequential oracle run the event.
                    for rr, ss in tails[: i + 1]:
                        if ss.size:
                            ledger.reserved[
                                rr[:, None], (ss - base)[None, :]
                            ] = 1.0
                    ledger.mirror_invalidate()  # direct writes bypass the journal
                    return False
                owner[rows[:, None], (slots - base)[None, :]] = i
        self._tails = tails
        # Frontier evidence: one dense availability mask over the stamped
        # horizon — ``avail[l, s]`` ⟺ cell (l, s) is not exactly full in
        # the *all-tails-released* ledger.  Joint enumeration AND-scans
        # path links over it in chunks and post-filters by the owner
        # stamp, so a candidate's potentially-nonzero slots cost a couple
        # of vector ops instead of per-cell membership tests.  Walk
        # commits clear their cells; cells past the stamped width are
        # free until committed (staleness there only wastes a gathered
        # column — it reads its true, now-zero residue).
        self._avail = ledger.reserved != 1.0
        return True

    def _undo_releases(self, victims: List[_Victim], after: int) -> None:
        """Re-book the tails of victims ``> after`` at their exact
        pre-release value (1.0) — the sequential loop raises with those
        tails still committed."""
        for j in range(after + 1, len(victims)):
            rows, slots = self._tails[j]
            if slots.size:
                self.ledger.reserved[
                    rows[:, None], (slots - self._base)[None, :]
                ] = 1.0
        self.ledger.mirror_invalidate()  # direct writes bypass the journal

    # -- pass 3: candidate grid ----------------------------------------------
    def _candidate_grid(self, victims: List[_Victim]) -> None:
        """Every victim's surviving (replica, path-index, rows, cap, hops)
        candidates, in ``choose_source_path``'s exact enumeration order,
        through one :meth:`PathEngine.route_batch` pass."""
        ledger = self.ledger
        dp = self.ctrl.dataplane
        pairs = []
        for v in victims:
            for rep in v.task.replicas:
                if rep != v.a.node:
                    pairs.append((rep, v.a.node))
        cand_map = dp.candidates_batch(pairs)
        mk_cache: Dict[Tuple[str, str], list] = {}
        capacity = ledger.capacity
        for v in victims:
            cands: list = []
            for rep in v.task.replicas:
                if rep == v.a.node:
                    continue
                key = (rep, v.a.node)
                lst = mk_cache.get(key)
                if lst is None:
                    lst = []
                    for pi, p in enumerate(cand_map[key]):
                        rows = ledger.rows(p)
                        cap = (
                            float(capacity[list(rows)].min())
                            if rows else float("inf")
                        )
                        lst.append((pi, rows, cap, len(rows)))
                    mk_cache[key] = lst
                cands.extend((rep,) + c for c in lst)
            v.cands = cands

    # -- pass 4: fused compressed-column scoring ------------------------------
    #
    # The greedy cumulative-deliverable sum only grows at slots where *no*
    # path link is effectively full — every other slot contributes exactly
    # ``0.0``.  The scan therefore enumerates the *joint* potentially-
    # nonzero slots (chunked AND over the availability mask rows, owner
    # post-filter for the victim's phantom view) and gathers only those
    # columns: O(plan length) work per candidate where the sequential
    # escalation pays O(frontier distance), with identical floats
    # (x + 0.0 == x, and column order is slot order).

    def _extend_columns(self, st: list, need: int) -> None:
        """Grow a candidate's collected joint columns to ≥ ``need`` or
        until its scan position exhausts the plan budget.  ``st`` is
        ``[cols, pos, rows_arr, thresh, budget]``.  A column survives iff
        every path link is available (not exactly full post-release, not
        consumed by a walk commit) and carries no phantom stamp above the
        victim's threshold; slots past the stamped width are free until
        committed (a consumed one reads its true zero residue — wasteful,
        never wrong)."""
        cols, pos, rows_arr, thresh, budget = st
        avail = self._avail
        owner = self._owner
        base = self._base          # cols/pos are absolute; masks physical
        w_abs = base + avail.shape[1]
        parts = [cols]
        total = cols.size
        while total < need and pos < budget:
            hi = min(pos + 4096, budget)
            if pos < w_abs:
                hi = min(hi, w_abs)
                joint = np.flatnonzero(
                    avail[rows_arr, pos - base : hi - base].all(axis=0)
                ) + pos
                if joint.size:
                    ow = owner[rows_arr[:, None], (joint - base)[None, :]]
                    joint = joint[(ow <= thresh).all(axis=0)]
            else:
                joint = np.arange(pos, hi, dtype=np.int64)
            if joint.size:
                parts.append(joint)
                total += joint.size
            pos = hi
        if len(parts) > 1:
            st[0] = np.concatenate(parts)
        st[1] = pos

    def _scan(self, victims: List[_Victim], which: Sequence[int]) -> None:
        """Fused greedy scan for every candidate of the given victims —
        one compressed-column gather + plan_scan pass per escalation
        round (frozen: resolved candidates never re-scan).  Results land
        on the victims (curves, per-candidate ends, the winner index)."""
        ledger = self.ledger
        dur = ledger.slot_duration
        live: List[Tuple[int, int]] = []   # (victim idx, candidate idx)
        colstate: List[list] = []  # [cols, pos, rows, thresh, budget]
        for i in which:
            v = victims[i]
            n = len(v.cands)
            v.cols = [None] * n
            v.bw = [None] * n
            v.resid = [None] * n
            v.cum = [None] * n
            v.hit = np.full(n, -1, dtype=np.int64)
            v.end = np.empty(n)
            if v.remaining <= 0:
                v.end.fill(v.nb)
                continue
            if v.colstate is None:
                # one enumeration per victim for the whole event: a later
                # re-score reuses the collected columns — commits only
                # shrink availability, so the cached set stays a superset
                # of a fresh enumeration and consumed cells gather their
                # true zero residue
                v.colstate = [
                    [_EMPTY_COLS, v.s0, np.asarray(cand[2]), i,
                     v.s0 + _MAX_SLOTS]
                    for cand in v.cands
                ]
            for c in range(len(v.cands)):
                live.append((i, c))
                colstate.append(v.colstate[c])
        if not live:
            self._pick_winners(victims, which)
            return
        n_cand = len(live)
        wl = max(victims[i].cands[c][4] for i, c in live)
        pad = np.empty((n_cand, wl), dtype=np.intp)
        caps = np.empty(n_cand)
        sizes = np.empty(n_cand)
        s0c = np.empty(n_cand, dtype=np.int64)
        t0c = np.empty(n_cand)
        for k, (i, c) in enumerate(live):
            v = victims[i]
            _rep, _pi, rows, cap, ln = v.cands[c]
            pad[k, :ln] = rows
            pad[k, ln:] = rows[0]
            caps[k] = cap
            sizes[k] = v.remaining
            s0c[k] = v.s0
            t0c[k] = v.nb
        m = 64
        unresolved = np.arange(n_cand)
        while True:
            sub = unresolved
            cols = np.empty((len(sub), m), dtype=np.int64)
            secs = np.full((len(sub), m), dur)
            capped = np.zeros(len(sub), dtype=bool)
            for j, k in enumerate(sub):
                st = colstate[k]
                self._extend_columns(st, m)
                row = st[0][:m]
                if row.size < m:
                    # exhausted every potentially-nonzero slot below the
                    # plan_transfer budget: pad with zero-second columns
                    capped[j] = True
                    fill = row[-1] if row.size else int(s0c[k])
                    secs[j, row.size:] = 0.0
                    row = np.concatenate([
                        row, np.full(m - row.size, fill, dtype=np.int64)
                    ])
                cols[j] = row
            ledger._ensure(int(cols.max()))
            # first-slot partiality is a property of slot s0 itself
            first_part = cols[:, 0] == s0c[sub]
            secs[first_part, 0] = (s0c[sub][first_part] + 1) * dur - \
                t0c[sub][first_part]
            resid, bw, cum, hits = ts_plan.col_scan(
                ledger, pad[sub], cols, caps[sub], secs, sizes[sub]
            )
            done = hits < m
            for j in np.nonzero(done)[0]:
                i, c = live[sub[j]]
                v = victims[i]
                hit = int(hits[j])
                v.hit[c] = hit
                v.cols[c] = cols[j]
                v.bw[c] = bw[j]
                v.resid[c] = resid[j]
                v.cum[c] = cum[j]
                before = float(cum[j][hit - 1]) if hit > 0 else 0.0
                t_in = max(v.nb, int(cols[j][hit]) * dur)
                v.end[c] = t_in + (v.remaining - before) / float(bw[j][hit])
            if (~done & capped).any():
                # matches the sequential window escalation running out of
                # its s0 + 2^16-slot horizon with the transfer incomplete
                raise RuntimeError(
                    "transfer does not fit within max_slots horizon"
                )
            unresolved = sub[~done]
            if unresolved.size == 0:
                break
            m *= 4
        self._pick_winners(victims, which)

    def _pick_winners(self, victims: List[_Victim], which: Sequence[int]):
        for i in which:
            v = victims[i]
            if not v.cands:
                v.winner = -1
                continue
            e = v.end
            # choose_source_path's key: (plan end, hops, replica, pair idx)
            v.winner = min(
                range(len(v.cands)),
                key=lambda c: (
                    e[c], v.cands[c][4], v.cands[c][0], v.cands[c][1]
                ),
            )

    # -- pass 5: commit walk --------------------------------------------------
    def _clean(self, v: _Victim, dirty: np.ndarray) -> bool:
        """True iff no commit since the prescan touched any cell this
        victim's decision read (every candidate's scan window up to its
        completion slot — ``choose_source_path`` compares every end)."""
        if not v.cands:
            return True
        if v.remaining <= 0:
            return True  # empty plans read no ledger cells
        for c, (_rep, _pi, rows, _cap, _ln) in enumerate(v.cands):
            limit = int(v.cols[c][int(v.hit[c])])
            for r in rows:
                if dirty[r] <= limit:
                    return False
        return True

    def _materialize(self, v: _Victim) -> TransferPlan:
        """The winner's plan from its compressed-column curve — the exact
        tail arithmetic of ``plan_transfer`` with absolute slots read off
        the column list (non-column slots have zero bandwidth in both, so
        the active-slot sets coincide)."""
        c = v.winner
        rows = v.cands[c][2]
        if v.remaining <= 0:
            return TransferPlan(tuple(rows), v.nb, v.nb, ())
        dur = self.ledger.slot_duration
        cols = v.cols[c]
        bw = v.bw[c]
        hit = int(v.hit[c])
        sel = np.nonzero(bw[: hit + 1] > _EPS)[0]
        start = max(v.nb, int(cols[sel[0]]) * dur)
        cum = v.cum[c]
        before = float(cum[hit - 1]) if hit > 0 else 0.0
        t_in = max(v.nb, int(cols[hit]) * dur)
        end = t_in + (v.remaining - before) / float(bw[hit])
        resid = v.resid[c]
        fracs = tuple((int(cols[j]), float(resid[j])) for j in sel)
        return TransferPlan(tuple(rows), start, end, fracs)

    WAVE = 64            # victims speculatively pre-scanned per wave
    MIN_COVERED = 32     # prescan coverage before the hit-rate gate binds
    MIN_HIT_RATE = 0.15  # below this, waves stop paying — go live-only

    def _walk(self, victims, at: float, dead_names) -> None:
        from ..net.events import RerouteRecord

        ctrl = self.ctrl
        ledger = self.ledger
        n = len(victims)
        dirty = np.full(len(ledger.capacity), _NEVER, dtype=np.int64)
        pending: List[TransferPlan] = []
        self.hits = self.misses = 0
        # Adaptive speculation (the wavefront engine's gate): pre-scan
        # victims in waves, and when commits invalidate nearly every
        # curve (heavily contended storms make consecutive replans
        # genuinely data-dependent) stop pre-scanning and run each victim
        # through the same fused scan live — identical results, no
        # wasted batch passes.
        spec_on = True
        scanned_until = 0
        covered = 0

        avail = self._avail

        def flush() -> None:
            if pending:
                ledger.commit_batch(pending)
                # A commit books the *path* residue on every link, so only
                # cells it saturates to exactly 1.0 stop being available —
                # a non-bottleneck link can keep residue the sequential
                # loop would later book, and must stay enumerable.  (Cells
                # past the stamped width stay implicitly free — harmless,
                # they read their true residue at gather time.)
                base = self._base
                w = avail.shape[1]
                for plan in pending:
                    slots = [
                        s - base for s, _ in plan.slot_fracs if s - base < w
                    ]
                    if slots:
                        rr = np.asarray(plan.links)[:, None]
                        cc = np.asarray(slots)[None, :]
                        avail[rr, cc] &= ledger.reserved[rr, cc] != 1.0
                pending.clear()

        for i, v in enumerate(victims):
            if spec_on and i >= scanned_until:
                if covered >= self.MIN_COVERED and (
                    self.hits < self.MIN_HIT_RATE * covered
                ):
                    spec_on = False
                else:
                    flush()
                    dirty.fill(_NEVER)
                    hi = min(n, i + self.WAVE)
                    try:
                        self._scan(victims, range(i, hi))
                        scanned_until = hi
                        covered += hi - i
                    except RuntimeError:
                        # Some wave victim cannot fit the plan horizon —
                        # drop to live-only so the raise lands at that
                        # victim's exact turn, like the sequential loop.
                        spec_on = False
            if not v.cands:
                flush()
                self._undo_releases(victims, i)
                raise UnroutableError(
                    f"task {v.task.tid}: no replica has a surviving "
                    f"path to {v.a.node!r}"
                )
            if spec_on and i < scanned_until and self._clean(v, dirty):
                self.hits += 1
            else:
                self.misses += 1
                flush()
                try:
                    self._scan(victims, [i])
                except RuntimeError:
                    self._undo_releases(victims, i)
                    raise
            src = v.cands[v.winner][0]
            new_plan = self._materialize(v)
            pending.append(new_plan)
            if new_plan.slot_fracs:
                first = new_plan.slot_fracs[0][0]
                for r in new_plan.links:
                    if first < dirty[r]:
                        dirty[r] = first
            cookie = ("job", v.jid, v.a.tid)
            ctrl.dataplane.tables.uninstall(cookie)
            ctrl._install(cookie, src, v.a.node, new_plan)
            ctrl.reroute_log.append(RerouteRecord(
                at=at, flow=cookie, dead_links=tuple(sorted(
                    dead_names & set(v.old_names))),
                src=src, dst=v.a.node,
                old_path=v.old_names,
                new_path=ledger.link_names(new_plan.links),
                delivered=v.delivered, remaining=v.remaining,
                old_end=v.old_plan.end, new_end=new_plan.end,
            ))
            v.a.source, v.a.transfer = src, new_plan
            v.rec.rerouted += 1
            self._rerouted_tids.add(v.a.tid)
            self._touched.add(v.a.node)
            ctrl._live_jobs[v.jid] = max(
                ctrl._live_jobs.get(v.jid, 0.0), new_plan.end
            )
        flush()

    # -- raw flows ------------------------------------------------------------
    def _suspend_raw_flows(self, at: float, dead_rows) -> None:
        ctrl = self.ctrl
        ledger = self.ledger
        for tag, plan in list(ctrl.flows.items()):
            if not plan.slot_fracs or plan.end <= at + _EPS:
                continue
            if not any(r in dead_rows for r in plan.links):
                continue
            total = ledger.plan_bytes(plan)
            kept = ledger.release_after(plan, at)
            delivered = ledger.plan_bytes(kept)
            ctrl.flows[tag] = kept
            ctrl._suspended.append(
                (tag, ledger.link_names(plan.links), total - delivered)
            )


def sequential_reroute(ctrl, at: float) -> None:
    """The historical per-victim reroute loop — the byte-exactness oracle
    the engine is property-tested against, and the recorded baseline of
    ``benchmarks/bench_failover_scale.py``.  Semantics: DESIGN.md §4."""
    from ..net.events import RerouteRecord

    state = ctrl.state
    ledger = state.ledger
    dead_names = ctrl.dataplane.all_dead_links()
    dead_rows = {ledger.rows((n,))[0] for n in dead_names}
    touched_nodes = set()
    rerouted_tids = set()

    for jid, latest_end in list(ctrl._live_jobs.items()):
        rec = ctrl.jobs.get(jid)
        if rec is None or latest_end <= at + _EPS:
            del ctrl._live_jobs[jid]
            continue
        tasks = None
        for a in rec.assignments:
            plan = a.transfer
            if plan is None or not plan.slot_fracs:
                continue
            if plan.end <= at + _EPS or not (set(plan.links) & dead_rows):
                continue
            if tasks is None:
                tasks = {tk.tid: tk for tk in rec.tasks}
            task = tasks[a.tid]
            old_names = ledger.link_names(plan.links)
            # Remaining bytes come from the *current* plan, not task.size —
            # after an earlier reroute the plan already carries only the
            # then-remaining bytes.
            total = ledger.plan_bytes(plan)
            kept = ledger.release_after(plan, at)
            delivered = ledger.plan_bytes(kept)
            remaining = max(total - delivered, 0.0)
            # A transfer that had not started yet keeps its queue position
            # (its original start), it does not jump to the failure
            # instant — rerouting must never act as prefetch.
            nb = max(at, plan.start)
            src, _rows, new_plan = state.choose_source_path(
                task, a.node, nb, size=remaining
            )
            ledger.commit(new_plan)
            cookie = ("job", rec.jid, a.tid)
            ctrl.dataplane.tables.uninstall(cookie)
            ctrl._install(cookie, src, a.node, new_plan)
            ctrl.reroute_log.append(RerouteRecord(
                at=at, flow=cookie, dead_links=tuple(sorted(
                    dead_names & set(old_names))),
                src=src, dst=a.node,
                old_path=old_names,
                new_path=ledger.link_names(new_plan.links),
                delivered=delivered, remaining=remaining,
                old_end=plan.end, new_end=new_plan.end,
            ))
            a.source, a.transfer = src, new_plan
            rec.rerouted += 1
            rerouted_tids.add(a.tid)
            touched_nodes.add(a.node)
            ctrl._live_jobs[jid] = max(
                ctrl._live_jobs.get(jid, 0.0), new_plan.end
            )

    # Raw flows (explicit-link reservations, e.g. grad sync) cannot
    # detour — suspend their remainder until the links recover.
    for tag, plan in list(ctrl.flows.items()):
        if not plan.slot_fracs or plan.end <= at + _EPS:
            continue
        if not (set(plan.links) & dead_rows):
            continue
        total = ledger.plan_bytes(plan)
        kept = ledger.release_after(plan, at)
        delivered = ledger.plan_bytes(kept)
        ctrl.flows[tag] = kept
        ctrl._suspended.append(
            (tag, ledger.link_names(plan.links), total - delivered)
        )

    if touched_nodes:
        ctrl._retime_nodes(touched_nodes, rerouted_tids)
