"""Wavefront placement engine — fused (task × replica × path) planning.

``BassPolicy.place`` decides one task at a time; each remote decision used
to re-scan the same ``[n_links, n_slots]`` ledger window per candidate
(``path_bandwidth_batch`` + ``plan_transfer``), so the controller's
decision loop — not the model — capped fleet throughput near ~2k tasks/s
at 4 096 hosts.  This engine plans *batches* of placements wave-by-wave
while staying **byte-identical** to the sequential greedy loop:

1. **Speculate** — from the exact current state, walk the next ``K``
   pending tasks with overlay-estimated idle times (``state.idle`` and
   the minnow heap are never corrupted), recording each task's likely
   decision context ``(dst = ND_minnow, t0 = ΥI_dst)`` and its candidate
   (replica × path) row sets (tree-LCA row cache / PathEngine).
2. **Broadcast** — score *every* recorded candidate in one array pass: a
   single ``[n_cand, max_path_len, window]`` ledger gather feeds the
   :func:`repro.kernels.ts_plan.plan_scan` residue→cummax→cumsum→
   searchsorted kernel (numpy reference by default, Pallas optional),
   yielding per-candidate residue curves, cumulative-deliverable curves,
   completion slots and plan ends — no per-candidate Python.
3. **Commit walk** — replay the tasks *in task order* against the exact
   state.  A task consumes its precomputed curves only if its speculated
   context matches bit-for-bit **and** no earlier commit this wave touched
   any (link, slot) cell its decision read (per-link dirty-slot map = the
   conflict set between wave winners).  Clean winners commit via the
   ledger's vectorized scatter; a stale or mis-speculated task re-scores
   live through the same fused kernel — the result is identical either
   way, only the work differs.  The next wave re-scores only invalidated
   candidates; still-clean curves carry over.

**Frontier skip.**  The paper's greedy policy consumes the *full* path
residue, so at steady state the ledger holds a backlog of fully-booked
slots and every plan lands at the residue frontier — thousands of slots
past ``slot_of(t0)``.  Scanning that prefix is pure waste: a slot whose
path residue is exactly zero contributes exactly ``0.0`` to the
cumulative-deliverable sum, so skipping it cannot change any float the
plan is built from.  The planner therefore keeps an exactly-full mask
(``reserved == 1.0``, built lazily per batch, updated in place on every
commit) plus per-link first-free pointers whose re-gallops amortize over
the batch, and starts each candidate's scan at the first slot not
covered by any full path link.  Commits only ever *add* reservations, so
a full slot stays full within a batch (releases happen between batches,
and the mask resets with each ``place_batch``).

Wave order replays task order, every float is produced by the same
expressions the sequential loop evaluates, and stale curves are never
consumed — so the emitted schedule is bit-identical to
``[policy.place(t, state) for t in tasks]`` (property-tested in
``tests/test_wavefront.py``, schedule-dump-diffed across the change).
See DESIGN.md §5 for the algorithm, conflict-set semantics and the
complexity table.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels import ts_plan
# One ND_loc implementation, shared with the sequential path (controller
# imports this module lazily inside place_batch, so there is no cycle).
from .controller import pick_local as _pick_local
from .tasks import Assignment, Task, completion_time
from .timeslot import TransferPlan
from .topology import UnroutableError

_EPS = 1e-9
_NEVER = np.iinfo(np.int64).max


class _Entry:
    """One task's scored candidate set + the decision context it was
    computed under.  Single-path entries carry the residue scores of all
    candidates (that is all ``choose_source`` reads) and the full
    ``plan_scan`` curve of the *winner* only; pairs-mode entries carry
    every candidate's curve (``choose_source_path`` compares plan ends)."""

    __slots__ = (
        "dst", "t0", "s0", "win", "cands", "srcs", "rows", "lens",
        "arrs", "caps", "score0", "winner", "best_end",
        # pairs mode: per-candidate curves
        "sz", "bw", "resid", "cum", "hit", "end", "fit_all",
        # single-path mode: winner-only curve (scalars / 1-D rows)
        "wsz", "wbw", "wresid", "wcum", "whit", "wend",
    )


class WavefrontPlanner:
    """Per-state wavefront engine (cached on the state; rebuilt when the
    fabric mutates).  ``place_batch`` is the only entry point."""

    MISS_STREAK = 16     # consecutive misses that force a fresh wave

    def __init__(self, state) -> None:
        self.state = state
        self.ledger = state.ledger
        self.fabric = state.fabric
        self._fab_version = self.fabric.version
        self._tree = self.fabric.tree_routing_ok()
        # node -> (chain nodes incl. self, {ancestor: depth}, uplink rows)
        self._chains: Dict[str, Optional[tuple]] = {}
        self._pair_cache: Dict[Tuple[str, str], tuple] = {}
        self._multi_cache: Dict[tuple, list] = {}
        self._entries: Dict[int, _Entry] = {}
        self._spec_until = 0
        n_links = len(self.ledger.capacity)
        self._dirty = np.full(n_links, _NEVER, dtype=np.int64)
        # Full-slot mask (reserved == 1.0), the frontier-skip evidence:
        # built lazily per batch, updated in place on every commit.  A
        # slot that is exactly full stays exactly full under commits, so
        # the mask only ever gains bits within a batch.
        self._full: Optional[np.ndarray] = None
        self._last_land = 0               # latest committed landing slot
        # Per-link first-free pointers: full on [nfb[l], nf[l]).
        self._nf = [0] * n_links
        self._nfb = [0] * n_links
        self._caplist = self.ledger.capacity.tolist()
        self._w_ema = 16.0                # EMA of observed plan spans
        self._hits_since_spec = 0
        # Adaptive speculation: waves pay only when curves survive to the
        # commit walk, so a persistently low hit rate turns them off and
        # the engine runs on the fused live path alone (re-probing later).
        self._spec_on = True
        self._spec_from = 0
        self._spec_resume = 0
        # Liveness: candidate row sets depend on the data plane's dead
        # set, so the pair/multi caches key on its mutation counter (a
        # fail/recover between batches drops them; healthy batches pay
        # nothing).  ``_dead`` is the current overlay, empty when healthy.
        self._dead: frozenset = frozenset()
        self._live_version = -1
        # Speculation counters live in the state's obs registry (same
        # dict-style surface as the plain dict they replaced); planner
        # rebuilds on the same state keep accumulating into one group.
        self.stats = state.obs.group(
            "wavefront", ("hits", "misses", "waves", "spec_tasks")
        )

    @classmethod
    def for_state(cls, state) -> "WavefrontPlanner":
        planner = getattr(state, "_wavefront", None)
        if (
            planner is None
            or planner.ledger is not state.ledger
            or planner._fab_version != state.fabric.version
        ):
            planner = cls(state)
            state._wavefront = planner
        return planner

    # -- the walk -----------------------------------------------------------
    def place_batch(
        self,
        tasks: Sequence[Task],
        multipath: bool = False,
        k_paths: Optional[int] = None,
    ) -> List[Assignment]:
        state = self.state
        idle = state.idle
        pairs_mode = bool(multipath) and state.dataplane is not None
        dp = state.dataplane
        if dp is not None and dp.liveness_version != self._live_version:
            self._pair_cache.clear()
            self._multi_cache.clear()
            self._live_version = dp.liveness_version
        self._dead = (
            dp.all_dead_links()
            if dp is not None and dp.has_failures()
            else frozenset()
        )
        self._entries = {}
        self._spec_until = 0
        self._dirty.fill(_NEVER)
        # Ledger may have been mutated between batches (releases, occupy,
        # direct writes): frontier evidence starts over.
        self._full = None
        self._last_land = 0
        n_links = len(self._nf)
        self._nf = [0] * n_links
        self._nfb = [0] * n_links
        self._w_ema = 16.0
        self._spec_on = True
        self._spec_from = 0
        self._spec_resume = 0
        self._hits_since_spec = 48  # seeds the first wave's lookahead
        miss_streak = 0
        out: List[Assignment] = []
        for i, task in enumerate(tasks):
            minnow = state.minnow()
            loc = _pick_local(task, idle, state.workers_set)
            if loc is not None and (
                minnow == loc or idle[loc] <= idle[minnow] + _EPS
            ):
                # Case 1.1 — local optimal; no ledger interaction at all.
                out.append(self._record(
                    state.commit_local(task, loc), task, "local-optimal"
                ))
                continue
            if self._spec_on:
                if i >= self._spec_until or miss_streak >= self.MISS_STREAK:
                    self._speculate(tasks, i, pairs_mode, k_paths)
                    miss_streak = 0
            elif i >= self._spec_resume:
                self._spec_on = True
                self._hits_since_spec = 8  # small probe wave
                self._spec_from = self._spec_until = i  # fresh probe stats
                self._speculate(tasks, i, pairs_mode, k_paths)
                miss_streak = 0
            at = idle[minnow]
            e = self._entries.get(i) if self._spec_on else None
            if (
                e is not None
                and e.dst == minnow
                and e.t0 == at
                and self._clean(e)
            ):
                self.stats["hits"] += 1
                self._hits_since_spec += 1
                miss_streak = 0
                src = e.srcs[e.winner]
                plan = self._winner_plan(e, task)
            else:
                self.stats["misses"] += 1
                miss_streak += 1
                src, plan = self._score_live(
                    task, minnow, at, pairs_mode, k_paths, reuse=e
                )
            out.append(self._finish(task, minnow, loc, at, src, plan))
        return out

    def _finish(
        self,
        task: Task,
        minnow: str,
        loc: Optional[str],
        at: float,
        src: str,
        plan: TransferPlan,
    ) -> Assignment:
        """Replay Algorithm 1's Case 1.2/1.3/2 arithmetic exactly as
        ``BassPolicy.place`` evaluates it, then commit + mark conflicts."""
        state = self.state
        idle = state.idle
        if loc is not None:
            yc_loc = completion_time(task.compute, 0.0, idle[loc])
            tm = plan.end - plan.start if plan.slot_fracs else 0.0
            yc_min = completion_time(task.compute, 0.0, idle[minnow]) + tm
            tm_budget = yc_loc - task.compute - idle[minnow]
            bw_needed = (
                task.size / tm_budget if tm_budget > _EPS else float("inf")
            )
            if yc_min < yc_loc - _EPS:
                a = state.commit_remote(task, minnow, src, plan,
                                        bw_needed=bw_needed)
                self._mark_dirty(plan)
                return self._record(a, task, "remote-faster")
            return self._record(
                state.commit_local(task, loc, bw_needed=bw_needed),
                task, "local-bw-insufficient",
            )
        a = state.commit_remote(task, minnow, src, plan)
        self._mark_dirty(plan)
        return self._record(a, task, "locality-starved")

    def _record(self, a: Assignment, task: Task, reason: str) -> Assignment:
        rec = self.state.obs.trace
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
                engine="wavefront",
            )
        return a

    def _mark_dirty(self, plan: TransferPlan) -> None:
        if not plan.slot_fracs:
            return
        first = plan.slot_fracs[0][0]
        if first > self._last_land:
            self._last_land = first
        d = self._dirty
        for r in plan.links:
            if first < d[r]:
                d[r] = first
        full = self._full
        if full is not None:
            # The mask is physical (column j ↔ absolute slot base + j);
            # plan fracs are absolute.  base is frozen for the batch —
            # retire() only runs between controller events.
            base = self.ledger.base_slot
            last = plan.slot_fracs[-1][0] - base
            if last >= full.shape[1]:
                full = self._fullmask()  # extend to the grown horizon
            if len(plan.slot_fracs) == 1:
                res = self.ledger.reserved
                for r in plan.links:
                    full[r, last] = res.item(r, last) == 1.0
            else:
                slots = [s - base for s, _ in plan.slot_fracs]
                rr = np.asarray(plan.links)[:, None]
                cc = np.asarray(slots)
                full[rr, cc] = self.ledger.reserved[rr, cc] == 1.0

    def _fullmask(self) -> np.ndarray:
        """The (links × slots) exactly-full mask, covering the ledger's
        current horizon.  Horizon growth extends with False columns (new
        slots are unbooked) instead of re-comparing the whole ledger."""
        full = self._full
        cols = self.ledger.reserved.shape[1]
        if full is None:
            full = self._full = self.ledger.reserved == 1.0
        elif full.shape[1] < cols:
            # Grow with geometric slack: the capacity-backed ledger view
            # widens a slot at a time, so an exact-fit mask would realloc
            # on nearly every commit.  Slack columns read False — the
            # mask's meaning for slots nothing has booked yet.
            wider = np.zeros(
                (full.shape[0], max(cols, 2 * full.shape[1])), dtype=bool
            )
            wider[:, : full.shape[1]] = full
            full = self._full = wider
        return full

    def _skip_path(self, idx, s0: int) -> int:
        """First slot ≥ s0 where *no* path link is exactly full — every
        slot in [s0, result) has exactly zero path residue, so a scan may
        start there without changing any plan float.

        Computed as a fixed point of per-link first-free pointers: each
        link caches (base, ptr) with "full on [base, ptr)"; queries with
        nondecreasing slots (the walk's ``t0`` is nondecreasing) reuse
        the pointer and only re-gallop the still-unverified tail, so the
        total gallop work per link is amortized over the whole batch.

        ``s0`` and the result are absolute slots; the pointers and the
        mask columns are physical (batch-local — the origin cannot move
        inside a batch)."""
        full = self._fullmask()
        base = self.ledger.base_slot
        horizon = full.shape[1]
        nf, nfb = self._nf, self._nfb
        j = s0 - base
        changed = True
        while changed:
            changed = False
            for l in idx:
                p = nf[l]
                b = nfb[l]
                row = full[l]
                if b <= j <= p and not (p < horizon and row.item(p)):
                    # cached run valid: [j, p) full, p free (or past the
                    # horizon, where nothing is booked yet).
                    if p > j:
                        j = p
                        changed = True
                    continue
                if b <= j <= p:
                    start = p   # commits extended the run: keep the base
                    base_l = b
                else:
                    start = j   # segment behind/ahead of j: start fresh
                    base_l = j
                p = start
                # Commits advance a link's frontier a slot or two at a
                # time: a short scalar walk resolves almost every update
                # without a vector gallop.
                lim = min(p + 16, horizon)
                while p < lim and row.item(p):
                    p += 1
                if p == lim and lim < horizon:
                    width = 64
                    while p < horizon:
                        seg = row[p: p + width]
                        if seg.all():
                            p += len(seg)
                            width *= 4
                            continue
                        p += int(seg.argmin())
                        break
                nf[l] = p
                nfb[l] = base_l
                if p > j:
                    j = p
                    changed = True
        return base + j

    def _clean(self, e: _Entry) -> bool:
        """True iff no commit since this entry's wave touched any
        (link, slot) cell its decision reads — the curves then equal what
        a live re-score would produce, bit for bit."""
        d = self._dirty
        if e.score0 is None:  # pairs mode: all candidate ends are compared
            if not e.fit_all:
                return False
            dmin = d[e.arrs].min(axis=1)
            return bool((dmin > e.sz + e.hit).all())
        # single-path: every candidate's residue at slot s0, winner's curve
        if d[e.arrs].min() <= e.s0:
            return False
        if e.whit >= e.win:
            return False
        return bool(d[e.arrs[e.winner]].min() > e.wsz + e.whit)

    # -- speculation --------------------------------------------------------
    def _speculate(
        self,
        tasks: Sequence[Task],
        i0: int,
        pairs_mode: bool,
        k_paths: Optional[int],
    ) -> None:
        """One wave: estimate the decision contexts of the next ``K``
        tasks, carry over still-clean curves, broadcast-score the rest.

        Speculation must leave the exact state untouched: estimated idle
        times live in an overlay dict (never ``state.idle``) and minnow
        queries run against a throwaway copy of the indexed heap —
        overrides push fresh entries onto the copy and superseded ones
        are discarded on pop.  The first speculated task therefore always
        sees its exact context.  Remote durations are estimated from the
        residue frontier (the last committed landing slot) plus the
        bottleneck transfer time — estimates steer only curve reuse,
        never results."""
        covered = self._spec_until - self._spec_from
        if covered >= 32 and self._hits_since_spec < 0.15 * covered:
            # Waves are not paying for themselves in this regime: drop to
            # the fused live path, re-probe a couple of thousand tasks on.
            self._spec_on = False
            self._spec_resume = i0 + 2048
            self._entries = {}
            return
        state = self.state
        idle = state.idle
        ledger = self.ledger
        dur = ledger.slot_duration
        # Speculation runs on a throwaway copy of the (exact, indexed)
        # minnow heap: overrides push fresh entries, superseded ones are
        # discarded on pop, and the real heap is never touched.
        h = list(state.heap._heap)
        k = int(min(4096, max(32, 2 * self._hits_since_spec + 8)))
        end_i = min(len(tasks), i0 + k)
        old = self._entries
        overrides: Dict[str, float] = {}
        specs: List[tuple] = []
        carried: Dict[int, _Entry] = {}

        def val(n: str) -> float:
            return overrides.get(n, idle[n])

        def bump(n: str, v: float) -> None:
            overrides[n] = v
            heapq.heappush(h, (v, n))

        def spec_minnow() -> str:
            while True:
                t, n = h[0]
                if t == val(n):
                    return n
                heapq.heappop(h)  # superseded by an override

        for j in range(i0, end_i):
            task = tasks[j]
            m = spec_minnow()
            holders = [n for n in task.replicas if n in state.workers_set]
            loc = (
                min(holders, key=lambda n: (val(n), n))
                if holders else None
            )
            if loc is not None and (
                m == loc or val(loc) <= val(m) + _EPS
            ):
                bump(loc, val(loc) + task.compute)
                continue
            at = val(m)
            est_end = None
            e = old.get(j)
            if (
                e is not None and e.dst == m and e.t0 == at
                and self._clean(e)
            ):
                carried[j] = e
                if np.isfinite(e.best_end):
                    est_end = float(e.best_end)
            if est_end is None:
                cands = None
                if j not in carried:
                    try:
                        cands = self._candidates(
                            task, m, pairs_mode, k_paths
                        )
                    except UnroutableError:
                        cands = []  # walk raises at the right task
                    if cands:
                        specs.append((j, task, m, at, cands))
                est_end = at
                if cands and task.size > 0:
                    # Transfers land at the advancing residue frontier;
                    # the last committed landing slot tracks it.
                    front = max(at, self._last_land * dur)
                    est_end = front + min(
                        (task.size / cap if cap > 0 else 0.0)
                        for _s, _rows, cap, _l in cands
                    )
            # Speculative Case 1.2/1.3/2 with the estimated ends.
            if loc is None:
                bump(m, est_end + task.compute)
            elif task.compute + at + (est_end - at) < (
                task.compute + val(loc)
            ) - _EPS:
                bump(m, est_end + task.compute)
            else:
                bump(loc, val(loc) + task.compute)
        self._entries = self._score_batch(specs, pairs_mode)
        self._entries.update(carried)
        self._dirty.fill(_NEVER)
        self._spec_from = i0
        self._spec_until = end_i
        self._hits_since_spec = 0
        self.stats["waves"] += 1
        self.stats["spec_tasks"] += end_i - i0

    # -- scoring ------------------------------------------------------------
    def _initial_window(self) -> int:
        """Power-of-4 initial scan window tracking the observed plan span
        (EMA) — under heavy contention greedy plans crawl through long
        partial-residue regions, and starting near the typical span saves
        the ×4 escalation re-scans."""
        w = 16
        target = min(self._w_ema * 1.25, float(1 << 16))
        while w < target:
            w *= 4
        return w

    def _curve_scan(self, pad, caps, s0c, t0c, sizes, sz, w):
        """Gather + ``plan_scan`` + plan-end extraction for one candidate
        row block — the fused ``ts_plan.wave_scan`` pipeline (device-
        resident when the device backend is live), every float by the
        same expressions ``plan_transfer`` evaluates per scalar
        (max/sub/div are elementwise-identical).  ``sz`` is the
        per-candidate frontier-skipped scan base."""
        ledger = self.ledger
        dur = ledger.slot_duration
        first_secs = np.where(sz > s0c, dur, (s0c + 1) * dur - t0c)
        resid, bw, cum, hit, end = ts_plan.wave_scan(
            ledger, pad, caps, sz, t0c, sizes, w, first_secs
        )
        fit = hit[hit < w]
        if fit.size:
            self._w_ema = 0.8 * self._w_ema + 0.2 * (float(fit.mean()) + 8.0)
        return sz, resid, bw, cum, hit, end

    def _score_batch(
        self,
        specs: List[tuple],
        pairs_mode: bool,
        window: Optional[int] = None,
    ) -> Dict[int, _Entry]:
        """The broadcast pass.  Single-path mode gathers one residue slot
        per candidate (all ``choose_source`` reads), picks each task's
        winner, then deep-scans *only the winners* in one block; pairs
        mode deep-scans every candidate (``choose_source_path`` compares
        every plan end)."""
        if not specs:
            return {}
        ledger = self.ledger
        w = self._initial_window() if window is None else window
        counts = [len(s[4]) for s in specs]
        n_cand = sum(counts)
        wl = max(
            max(c[3] for c in s[4]) for s in specs
        )
        pad = np.empty((n_cand, wl), dtype=np.intp)
        caps = np.empty(n_cand)
        s0c = np.empty(n_cand, dtype=np.int64)
        pos = 0
        for j, task, dst, at, cands in specs:
            s0 = ledger.slot_of(at)
            for _src, rows, cap, ln in cands:
                pad[pos, :ln] = rows
                pad[pos, ln:] = rows[0]
                caps[pos] = cap
                s0c[pos] = s0
                pos += 1

        if pairs_mode:
            t0c = np.empty(n_cand)
            sizes = np.empty(n_cand)
            sz = np.empty(n_cand, dtype=np.int64)
            pos = 0
            for (j, task, dst, at, cands), cnt in zip(specs, counts):
                s0 = int(s0c[pos])
                for c, cand in enumerate(cands):
                    sz[pos + c] = self._skip_path(list(cand[1]), s0)
                t0c[pos: pos + cnt] = at
                sizes[pos: pos + cnt] = task.size
                pos += cnt
            _sz, resid, bw, cum, hit, end = self._curve_scan(
                pad, caps, s0c, t0c, sizes, sz, w
            )
            # choose_source_path's key is (end, hops, name, cand order);
            # each candidate's precomputed rank — its position in the
            # segment's (hops, name, order) sort — reduces the key to
            # (end, rank), so one batched per-segment argmin
            # (ts_plan.wave_select) picks every wave's winners at once.
            ranks = np.empty(n_cand, dtype=np.int64)
            pos = 0
            for (j, task, dst, at, cands), cnt in zip(specs, counts):
                order = sorted(
                    range(cnt), key=lambda c: (cands[c][3], cands[c][0], c)
                )
                for r, c in enumerate(order):
                    ranks[pos + c] = r
                pos += cnt
            winners = ts_plan.wave_select(end, ranks, counts)
            entries: Dict[int, _Entry] = {}
            pos = 0
            for si, ((j, task, dst, at, cands), cnt) in enumerate(
                zip(specs, counts)
            ):
                sl = slice(pos, pos + cnt)
                pos += cnt
                e = _Entry()
                e.dst, e.t0, e.s0 = dst, at, int(s0c[sl.start])
                e.win = w
                e.cands = cands
                e.srcs = [c[0] for c in cands]
                e.rows = [c[1] for c in cands]
                e.lens = [c[3] for c in cands]
                e.arrs = pad[sl]
                e.caps = caps[sl]
                e.score0 = None
                e.sz = sz[sl]
                e.bw = bw[sl]
                e.resid = resid[sl]
                e.cum = cum[sl]
                e.hit = hit[sl]
                e.end = end[sl]
                e.fit_all = bool((e.hit < w).all())
                e.winner = int(winners[si])
                e.best_end = float(e.end[e.winner])
                entries[j] = e
            return entries

        # single-path: residue at slot_of(t0) is the whole selection input
        ledger._ensure(int(s0c.max()))
        booked0 = ledger.reserved[pad, (s0c - ledger.base_slot)[:, None]]
        score0 = ((1.0 - booked0) * ledger.capacity[pad]).min(axis=1)
        entries = {}
        pos = 0
        for (j, task, dst, at, cands), cnt in zip(specs, counts):
            sl = slice(pos, pos + cnt)
            pos += cnt
            e = _Entry()
            e.dst, e.t0, e.s0 = dst, at, int(s0c[sl.start])
            e.cands = cands
            e.srcs = [c[0] for c in cands]
            e.rows = [c[1] for c in cands]
            e.lens = [c[3] for c in cands]
            e.arrs = pad[sl]
            e.caps = caps[sl]
            e.score0 = score0[sl]
            s = e.score0
            # choose_source's key: (-bw, hops, name)
            e.winner = min(
                range(cnt), key=lambda c: (-s[c], e.lens[c], e.srcs[c])
            )
            entries[j] = e
        # deep-scan the winners only, as one block
        n = len(specs)
        padw = np.empty((n, wl), dtype=np.intp)
        capw = np.empty(n)
        s0w = np.empty(n, dtype=np.int64)
        t0w = np.empty(n)
        sizew = np.empty(n)
        szw = np.empty(n, dtype=np.int64)
        for k, (j, task, dst, at, cands) in enumerate(specs):
            e = entries[j]
            c = e.winner
            padw[k] = e.arrs[c]
            capw[k] = e.caps[c]
            s0w[k] = e.s0
            t0w[k] = at
            sizew[k] = task.size
            szw[k] = self._skip_path(list(e.rows[c]), e.s0)
        sz, resid, bw, cum, hit, end = self._curve_scan(
            padw, capw, s0w, t0w, sizew, szw, w
        )
        for k, (j, task, dst, at, cands) in enumerate(specs):
            e = entries[j]
            e.win = w
            e.wsz = int(sz[k])
            e.wbw = bw[k]
            e.wresid = resid[k]
            e.wcum = cum[k]
            e.whit = int(hit[k])
            e.wend = float(end[k])
            e.best_end = e.wend
        return entries

    def _score_live(
        self,
        task: Task,
        dst: str,
        at: float,
        pairs_mode: bool,
        k_paths: Optional[int],
        reuse: Optional[_Entry] = None,
    ) -> Tuple[str, TransferPlan]:
        """Exact re-score of one task against the live ledger — the fused
        fallback for mis-speculated or conflict-invalidated tasks.  A
        stale entry whose context still matches donates its candidate row
        sets, so only the residue reads and the winner scan re-run.
        Scalar-weight on purpose: scores are a handful of residue reads
        (all ``choose_source`` consults) and only the winner pays a plan
        scan, frontier-skipped and window-escalated like
        ``plan_transfer``."""
        if not pairs_mode and self._tree and not self._dead:
            got = self._score_tree(task, dst, at)
            if got is not None:
                return got
        if reuse is not None and reuse.dst == dst and reuse.t0 == at:
            cands = reuse.cands
        else:
            cands = self._candidates(task, dst, pairs_mode, k_paths)
        if not cands:
            if pairs_mode or self._dead:
                raise UnroutableError(
                    f"task {task.tid}: no replica has a surviving path to {dst!r}"
                )
            raise AssertionError(f"task {task.tid} has no off-node replica")
        ledger = self.ledger
        s0 = ledger.slot_of(at)
        if pairs_mode:
            # choose_source_path compares every candidate's plan end.
            plans = [
                self._plan_one(rows, cap, s0, at, task.size)
                for _s, rows, cap, _l in cands
            ]
            best = min(
                range(len(cands)),
                key=lambda c: (plans[c].end, cands[c][3], cands[c][0], c),
            )
            return cands[best][0], plans[best]
        ledger._ensure(s0)
        res = ledger.reserved
        capacity = ledger.capacity
        # path_bandwidth_batch's residue-at-slot: one gather over every
        # candidate link, then pure-float mins (same doubles, no ufunc
        # dispatch per element).
        flat = [r for _s, rows, _cap, _l in cands for r in rows]
        vals = (
            (1.0 - res[flat, s0 - ledger.base_slot]) * capacity[flat]
        ).tolist()
        scores = []
        pos = 0
        for _s, rows, _cap, _l in cands:
            nxt = pos + len(rows)
            scores.append(min(vals[pos:nxt]))
            pos = nxt
        best = 0
        bkey = (-scores[0], cands[0][3], cands[0][0])
        for c in range(1, len(cands)):
            key = (-scores[c], cands[c][3], cands[c][0])
            if key < bkey:
                best, bkey = c, key
        src, rows, cap, _l = cands[best]
        return src, self._plan_one(rows, cap, s0, at, task.size)

    def _score_tree(
        self, task: Task, dst: str, at: float
    ) -> Optional[Tuple[str, TransferPlan]]:
        """Tree-fabric fast path for single-path scoring: evaluate every
        replica's residue score straight off the cached LCA chains
        (python floats — the same doubles ``path_bandwidth_batch``
        computes) and materialize only the winner's row tuple.  Returns
        ``None`` when any endpoint falls outside the routing tree (the
        generic candidate path takes over)."""
        ledger = self.ledger
        s0 = ledger.slot_of(at)
        p0 = s0 - ledger.base_slot
        if p0 >= ledger.reserved.shape[1]:
            ledger._ensure(s0)
        res = ledger.reserved
        caplist = self._caplist
        best = None
        best_key = None
        found = False
        for rep in task.replicas:
            if rep == dst:
                continue
            found = True
            ca = self._chain(rep)
            cb = self._chain(dst)
            if ca is None or cb is None:
                return None
            nodes_a, _anc_a, links_a, pcaps_a = ca
            _nodes_b, anc_b, links_b, pcaps_b = cb
            j = None
            for i, name in enumerate(nodes_a):
                j = anc_b.get(name)
                if j is not None:
                    break
            if j is None:
                return None  # different trees: generic Dijkstra path
            s = float("inf")
            for l in links_a[:i]:
                v = (1.0 - res.item(l, p0)) * caplist[l]
                if v < s:
                    s = v
            for l in links_b[:j]:
                v = (1.0 - res.item(l, p0)) * caplist[l]
                if v < s:
                    s = v
            key = (-s, i + j, rep)
            if best_key is None or key < best_key:
                best_key = key
                best = (rep, i, j, links_a, links_b, pcaps_a, pcaps_b)
        if not found:
            raise AssertionError(f"task {task.tid} has no off-node replica")
        rep, i, j, links_a, links_b, pcaps_a, pcaps_b = best
        rows = links_a[:i] + tuple(reversed(links_b[:j]))
        cap = min(pcaps_a[i], pcaps_b[j])
        return rep, self._plan_one(rows, cap, s0, at, task.size)

    def _plan_one(
        self, rows: Tuple[int, ...], cap: float, s0: int, t0: float,
        size: float,
    ) -> TransferPlan:
        """One candidate's greedy plan — ``plan_transfer`` with the
        frontier skip (bit-identical: the skipped prefix has exactly zero
        path residue, contributing exactly ``0.0`` to the cumsum)."""
        ledger = self.ledger
        if size <= 0 or not rows:
            return TransferPlan(tuple(rows), t0, t0, ())
        idx = list(rows)
        sz = self._skip_path(idx, s0)
        # plan_transfer's horizon: windows escalate 64..65536 *from s0*
        # and a transfer not completing by s0 + 2^16 slots raises.  The
        # skip must not extend that reach, or the batch and sequential
        # paths would diverge on pathological backlogs.
        max_abs = s0 + (1 << 16)
        dur = ledger.slot_duration
        base = ledger.base_slot  # frozen for the batch (slots are absolute)
        # Scalar micro-scan: post-skip, almost every plan completes within
        # a few slots.  numpy's cumsum is a strict sequential accumulation,
        # so a Python walk computing cum_j = cum_{j-1} + bw_j*secs_j with
        # np.float64 scalars produces bit-identical floats — without the
        # ~1.5µs-per-call numpy dispatch the vector path pays ~10× over.
        lim = 24
        if sz + lim - base > ledger.reserved.shape[1]:
            ledger._ensure(sz + lim - 1)
        rowviews = [ledger.reserved[r] for r in idx]
        target = size - _EPS
        cum = 0.0
        sel: List[int] = []
        cums: List[float] = []
        bws: List[float] = []
        resids: List[float] = []
        hit = -1
        for j in range(lim):
            p = sz + j - base
            mx = rowviews[0].item(p)  # python floats: same IEEE doubles,
            for rv in rowviews[1:]:   # no per-element ufunc dispatch
                v = rv.item(p)
                if v > mx:
                    mx = v
            resid = 1.0 - mx
            bw = resid * cap
            secs = dur if (j > 0 or sz != s0) else (s0 + 1) * dur - t0
            cum = cum + bw * secs
            bws.append(bw)
            resids.append(resid)
            cums.append(cum)
            if bw > _EPS:
                sel.append(j)
            if cum >= target:
                hit = j
                break
        if hit >= 0:
            if sz + hit >= max_abs:
                raise RuntimeError(
                    "transfer does not fit within max_slots horizon"
                )
            self._w_ema = 0.8 * self._w_ema + 0.2 * (hit + 8.0)
            first = sel[0]
            start = max(t0, (sz + first) * dur)
            before = cums[hit - 1] if hit > 0 else 0.0
            t_in = max(t0, (sz + hit) * dur)
            end = t_in + (size - before) / bws[hit]
            fracs = tuple((sz + j, resids[j]) for j in sel)
            return TransferPlan(tuple(rows), start, end, fracs)
        reserved = ledger.reserved
        window = self._initial_window()
        while True:
            ledger._ensure(sz + window - 1)
            if reserved is not ledger.reserved:
                reserved = ledger.reserved
            lo = sz - base
            hi = lo + window
            # max over path links as pairwise np.maximum on row slices —
            # bit-identical to .max(axis=0) (max is exact) and ~3× faster
            # on the short windows the frontier skip leaves.
            mx = reserved[idx[0], lo:hi]
            for r in idx[1:]:
                mx = np.maximum(mx, reserved[r, lo:hi])
            resid = 1.0 - mx
            bw = resid * cap
            # deliverable = bw * secs with secs == dur everywhere except a
            # partial first slot — same elementwise products, no secs array.
            deliv = bw * dur
            if sz == s0:
                deliv[0] = bw[0] * ((s0 + 1) * dur - t0)
            cum = np.cumsum(deliv)
            hit = int(np.searchsorted(cum, size - _EPS))
            if hit < window:
                if sz + hit >= max_abs:
                    raise RuntimeError(
                        "transfer does not fit within max_slots horizon"
                    )
                self._w_ema = 0.8 * self._w_ema + 0.2 * (hit + 8.0)
                return ledger._plan_from_scan(
                    tuple(rows), sz, t0, size, bw, resid, cum, hit
                )
            if sz + window >= max_abs:
                raise RuntimeError(
                    "transfer does not fit within max_slots horizon"
                )
            window *= 4

    def _winner_plan(self, e: _Entry, task: Task) -> TransferPlan:
        c = e.winner
        if task.size <= 0:
            return TransferPlan(e.rows[c], e.t0, e.t0, ())
        if e.score0 is not None:
            if e.whit >= e.win:
                # Defensive only: unfit winners are rejected by _clean and
                # escalated by _score_live before reaching here.
                return self.ledger.plan_transfer(
                    task.size, e.rows[c], not_before=e.t0
                )
            return self.ledger._plan_from_scan(
                e.rows[c], e.wsz, e.t0, task.size,
                e.wbw, e.wresid, e.wcum, e.whit,
            )
        if e.hit[c] >= e.win:
            return self.ledger.plan_transfer(
                task.size, e.rows[c], not_before=e.t0
            )
        return self.ledger._plan_from_scan(
            e.rows[c], int(e.sz[c]), e.t0, task.size,
            e.bw[c], e.resid[c], e.cum[c], int(e.hit[c]),
        )

    # -- candidate row sets -------------------------------------------------
    def _candidates(
        self, task: Task, dst: str, pairs_mode: bool, k_paths: Optional[int]
    ) -> list:
        """[(src, rows_tuple, padded_row_array, bottleneck_cap, hops)] in
        the exact enumeration order of the sequential scorers.  Under
        live routing (``self._dead`` non-empty) candidates come from the
        data plane's surviving sets — dead links price replicas out here,
        exactly as ``ClusterState.choose_source`` drops them."""
        out: list = []
        if pairs_mode:
            for rep in task.replicas:
                if rep == dst:
                    continue
                key = (rep, dst, k_paths)
                lst = self._multi_cache.get(key)
                if lst is None:
                    try:
                        paths = self.state.dataplane.candidates(
                            rep, dst, k=k_paths
                        )
                    except UnroutableError:
                        lst = []
                    else:
                        lst = [
                            self._mk_cand(self.ledger.rows(p)) for p in paths
                        ]
                    if len(self._multi_cache) > (1 << 18):
                        self._multi_cache.clear()
                    self._multi_cache[key] = lst
                out.extend((rep,) + c for c in lst)
            return out
        if self._dead:
            # Failure-aware single path: each replica contributes its best
            # surviving path (k=1: Yen's first path, no spur searches);
            # unroutable replicas drop out of the candidate set.
            for rep in task.replicas:
                if rep == dst:
                    continue
                key = (rep, dst)
                hit = self._pair_cache.get(key, False)
                if hit is False:
                    try:
                        paths = self.state.dataplane.candidates(rep, dst, k=1)
                    except UnroutableError:
                        hit = None
                    else:
                        hit = self._mk_cand(self.ledger.rows(paths[0]))
                    if len(self._pair_cache) > (1 << 18):
                        self._pair_cache.clear()
                    self._pair_cache[key] = hit
                if hit is not None:
                    out.append((rep,) + hit)
            return out
        for rep in task.replicas:
            if rep == dst:
                continue
            out.append((rep,) + self._pair(rep, dst))
        return out

    def _pair(self, src: str, dst: str) -> tuple:
        hit = self._pair_cache.get((src, dst))
        if hit is None:
            res = self._tree_rows(src, dst)
            if res is None:
                hit = self._mk_cand(
                    self.ledger.rows(self.fabric.path(src, dst))
                )
            else:
                rows, cap = res
                hit = (rows, cap, len(rows))
            if len(self._pair_cache) > (1 << 18):
                self._pair_cache.clear()
            self._pair_cache[(src, dst)] = hit
        return hit

    def _mk_cand(self, rows: Sequence[int]) -> tuple:
        rows = tuple(rows)
        if rows:
            capacity = self.ledger.capacity
            cap = min(float(capacity[r]) for r in rows)
        else:
            cap = float("inf")
        return (rows, cap, len(rows))

    def _chain(self, node: str):
        hit = self._chains.get(node, False)
        if hit is not False:
            return hit
        try:
            pc = self.fabric.parent_chain(node)
            nodes = (node,) + tuple(p for p, _ in pc)
            # KeyError: the chain leaves the ledger's link subset — a
            # per-pod frontier planning over its shard (core.hierarchy)
            # whose root chain crosses the pod boundary.  Fall back to the
            # Dijkstra/path-cache pair path, which only translates links
            # the (pod-internal) path actually uses.
            rows = self.ledger.rows([l for _, l in pc])
        except (ValueError, KeyError):
            res = None
        else:
            caps = self.ledger.capacity
            pcaps = [float("inf")]  # pcaps[d] = bottleneck of first d links
            m = float("inf")
            for r in rows:
                c = float(caps[r])
                if c < m:
                    m = c
                pcaps.append(m)
            res = (
                nodes,
                {nm: i for i, nm in enumerate(nodes)},
                rows,
                tuple(pcaps),
            )
        self._chains[node] = res
        return res

    def _tree_rows(self, src: str, dst: str) -> Optional[tuple]:
        """Integer-row LCA walk — exactly ``Fabric._tree_path``'s link
        order (up-chain to the LCA, then the reversed down-chain), else
        ``None`` for the Dijkstra/path-cache fallback.  Returns
        ``(rows, bottleneck_cap)``, the cap from the chains' prefix-min
        tables (same min, no per-path capacity reduction)."""
        if not self._tree:
            return None
        ca = self._chain(src)
        cb = self._chain(dst)
        if ca is None or cb is None:
            return None
        nodes_a, anc_a, links_a, pcaps_a = ca
        nodes_b, anc_b, links_b, pcaps_b = cb
        # (no different-trees precheck: the LCA loop below returns None
        # when the chains share no node, which is the same answer
        # ``Fabric._tree_path``'s early-out produces)
        for i, name in enumerate(nodes_a):
            j = anc_b.get(name)
            if j is not None:
                rows = links_a[:i] + tuple(reversed(links_b[:j]))
                return rows, min(pcaps_a[i], pcaps_b[j])
        return None
